// Levers of the bf16 MSDA backward that were measured on the way to the
// shipped design and not shipped, so that tools/tune_msda_torch.py --dtype
// bf16 can time them again beside the shipped kernel
// (monosowa_tpu_torch/ops/csrc/msda_bwd.cu, entry point msda_bwd_bf16) on
// the same inputs.  CUDA C++ for sm_90a; a head of D = 32 channels, 16-byte
// aligned tensors, the block map (order and runs, as the encoder's tiles
// give it) and the resident and grad levels of ops/msda.py msda_plan.
//
// lever_lists_bf16 and lever_sorted_bf16 sum dvalue in the block: by lists
// in shared memory, and by the counting sort that msda_bwd.cu ships, here
// with 8-byte entries and a block size and run length of the caller's.
//
// lever_bwd_bf16 is the float32 form's walk (eight lanes of four channels
// a query, the three folded dots summed by butterflies, dvalue by 16-byte
// vector atomics in L2 and by shared-memory atomics for the grad levels)
// with these levers, chosen by `role`, `dot_warps`, `merge` and the masks:
// * role 0: dots and adds, as shipped; role 1: only the dots (dloc, daw;
//   dvalue untouched); role 2: only the adds (dvalue; dloc, daw untouched).
// * dot_warps > 0: the first dot_warps warps of a block take the dots of
//   all the block's queries and the other warps the adds, which read no
//   value row.
// * merge 1: before its atomic add into L2, a lane finds the lanes of its
//   warp's other lane groups (other queries, same sample) that add into the
//   same channels of the same row, by __match_any_sync on (row, lane), sums
//   their rows by shuffles, and only the lowest of them sends the row.
//   merge 2: the same by two butterfly steps (groups g and g ^ 1, then the
//   groups still adding, g and g ^ 2) that compare the rows' keys, for the
//   adds into L2 and into shared memory alike.  Either only on the levels
//   of merge_mask.
// * skip_mask: the levels whose adds are left out (a diagnostic: dvalue is
//   then wrong), to see what each level's adds cost.
//
// lever_owner_bf16 is the atomic-free dvalue: every in-bounds corner
// becomes an entry (dout row, weight) sorted by its dvalue row with a
// counting sort on the card (a count by integer atomics, a scan, a fill),
// and one warp owns each dvalue row, sums its entries from float32 dout and
// writes the bf16 row (the rounding folded in).  The fill's integer atomics
// place a row's entries in an order that changes from run to run, so this
// form is not yet the same bits every run; a stable order would cost more.
// With role 1 of lever_bwd_bf16 for dloc and daw it is a whole backward.

#include "../../monosowa_tpu_torch/ops/csrc/msda_common.cuh"

#define LEVER_THREADS 1024
#define LEVER_G 8    // lanes a query: 32 channels, four a lane
#define LEVER_VEC 4

enum Mode { DIRECT, RES, RES_GRAD };
enum Role { BOTH, DOTS, ADDS, SPLIT };

__device__ __forceinline__ float group_sum8(float v) {
#pragma unroll
  for (int off = 4; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off, LEVER_G);
  return v;
}

// as msda_bwd.cu: scalar shared-memory atomics, each lane group starting
// at another of its four channels
__device__ __forceinline__ void add_shared(float* p, const Row<4>& d) {
  const int rot = (threadIdx.x / LEVER_G) & 3;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int ee = (e + rot) & 3;
    float val = d.v[0];
#pragma unroll
    for (int f = 1; f < 4; ++f) val = ee == f ? d.v[f] : val;
    atomicAdd(p + ee, val);
  }
}

// d into dvalue's row at p by 16-byte vector atomics, after the lanes of
// the warp that hold the same key (row and channels) are summed: the lowest
// of them adds.  Every lane of the warp calls it.
__device__ __forceinline__ void add_row_match(const Row<4>& d, float* p,
                                              bool hit, int key) {
  const int lane = threadIdx.x & 31;
  const unsigned same =
      __match_any_sync(0xffffffffu, hit ? key : -1 - lane);
  Row<4> s = d;
  if (__any_sync(0xffffffffu, __popc(same) > 1)) {
#pragma unroll
    for (int o = 1; o < 32 / LEVER_G; ++o) {
      const int from = lane ^ (o * LEVER_G);
      float t[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        t[e] = __shfl_xor_sync(0xffffffffu, d.v[e], o * LEVER_G);
      if ((same >> from) & 1) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s.v[e] += t[e];
      }
    }
  }
  if (hit && lane == __ffs(same) - 1) s.add_global(p);
}

// The warp's four groups' rows at this lane's channels summed where their
// keys agree, by two butterfly steps: groups g and g ^ 1, then those still
// adding, g and g ^ 2; the higher of a pair stops adding.  Returns whether
// this lane still adds d.  Every lane of the warp calls it.
__device__ __forceinline__ bool pair_merge(Row<4>& d, bool hit, int key) {
  const int lane = threadIdx.x & 31;
  const int k = hit ? key : -1 - lane;
  bool adds = hit;
#pragma unroll
  for (int step = LEVER_G; step < 32; step *= 2) {
    const bool other_adds = __shfl_xor_sync(0xffffffffu, (int)adds, step);
    const int other_key = __shfl_xor_sync(0xffffffffu, k, step);
    float t[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      t[e] = __shfl_xor_sync(0xffffffffu, d.v[e], step);
    if (adds && other_adds && other_key == k) {
#pragma unroll
      for (int e = 0; e < 4; ++e) d.v[e] += t[e];
      if (lane & step) adds = false;
    }
  }
  return adds;
}

// One sample's four corners for one lane: the dots into (pw, px, py) and
// the adds into dvalue, each where the role asks for it.
template <int MODE, bool DOTS, bool ADDS, int MERGE>
__device__ __forceinline__ void lever_sample(
    float& pw, float& px, float& py, const Corners& cn, float aj,
    const float (&g)[4], bool use, const __nv_bfloat16* rows,
    int row_stride, float* drows, int drow_stride, int key0, bool merge,
    bool skip) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const bool hit = use && cn.inb[k];
    if (DOTS && hit) {
      ValueRow<__nv_bfloat16, 4> r;
      if (MODE == DIRECT)
        r.load_global(rows + (size_t)cn.tok[k] * row_stride);
      else
        r.load_shared(rows + cn.tok[k] * row_stride);
      float vg = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) vg += r.v[e] * g[e];
      pw += cn.cw[k] * vg;
      px += cn.dwx[k] * vg;
      py += cn.dwy[k] * vg;
    }
    if (ADDS) {
      Row<4> d;
      const float coef = aj * cn.cw[k];
#pragma unroll
      for (int e = 0; e < 4; ++e) d.v[e] = coef * g[e];
      const int key = key0 + cn.tok[k] * LEVER_G;
      bool go = hit && !skip;
      if (MERGE == 2 && merge) go = pair_merge(d, go, key);
      if (MODE == RES_GRAD) {
        if (go) add_shared(drows + cn.tok[k] * drow_stride, d);
      } else if (MERGE == 1 && merge) {
        add_row_match(d, drows + (size_t)cn.tok[k] * drow_stride, go, key);
      } else if (go) {
        d.add_global(drows + (size_t)cn.tok[k] * drow_stride);
      }
    }
  }
}

struct Walk {
  const __nv_bfloat16* v_bm;
  const __nv_bfloat16* sm;
  float* smd;
  const float* loc;
  const float* aw;
  const float* dout;
  float* dv_bm;
  float* dloc;
  float* daw;
  const int* order;
  int first, count, n_levels, n_points, b, m, Q, M, D, merge_mask, skip_mask;
};

// The block's queries, walked by n_groups lane groups (this one `group`).
template <bool DOTS, bool ADDS, int MERGE>
__device__ __forceinline__ void walk(const Walk& w, const Levels& lv,
                                     int group, int n_groups) {
  const int gl = threadIdx.x % LEVER_G;
  const int n_samples = w.n_levels * w.n_points;
  const int c = gl * LEVER_VEC;
  for (int i0 = 0; i0 < w.count; i0 += n_groups) {
    const bool live = i0 + group < w.count;
    const int q = w.order[w.first + (live ? i0 + group : 0)];
    const size_t bqm = ((size_t)w.b * w.Q + q) * w.M + w.m;
    const float* loc_q = w.loc + bqm * n_samples * 2;
    const float* aw_q = w.aw + bqm * n_samples;
    float g[4];
    {
      Row<4> r;
      r.load_global(w.dout + bqm * w.D + c);
#pragma unroll
      for (int e = 0; e < 4; ++e) g[e] = live ? r.v[e] : 0.f;
    }
    for (int s0 = 0; s0 < n_samples; s0 += LEVER_G) {
      const int si = s0 + gl;
      float lx = 0.f, ly = 0.f, a = 0.f;
      if (si < n_samples) {
        const float2 xy = __ldg(reinterpret_cast<const float2*>(loc_q) + si);
        lx = xy.x, ly = xy.y;
        a = __ldg(aw_q + si);
      }
      const int l_own = min(si, n_samples - 1) / w.n_points;
      const SamplePlace own(lx, ly, lv.h[l_own], lv.w[l_own]);
      const int ns = min(LEVER_G, n_samples - s0);
      float tot_w = 0.f, tot_x = 0.f, tot_y = 0.f;
#pragma unroll 1
      for (int j = 0; j < ns; ++j) {
        const float dx = __shfl_sync(0xffffffffu, own.dx, j, LEVER_G);
        const float dy = __shfl_sync(0xffffffffu, own.dy, j, LEVER_G);
        const int code = __shfl_sync(0xffffffffu, own.code, j, LEVER_G);
        const float aj = __shfl_sync(0xffffffffu, a, j, LEVER_G);
        const int l = (s0 + j) / w.n_points;
        const Corners cn(dx, dy, code, lv.w[l]);
        const size_t lvl_off = (size_t)lv.start[l] * w.M * w.D + c;
        const int key0 = lv.start[l] * LEVER_G + gl;
        const bool merge = (w.merge_mask >> l) & 1;
        const bool skip = (w.skip_mask >> l) & 1;
        float pw = 0.f, px = 0.f, py = 0.f;
        if ((lv.grad_mask >> l) & 1)
          lever_sample<RES_GRAD, DOTS, ADDS, MERGE>(
              pw, px, py, cn, aj, g, live, w.sm + lv.sm_off[l] + c, w.D,
              w.smd + lv.grad_off[l] + c, w.D, key0, merge, skip);
        else if ((lv.resident_mask >> l) & 1)
          lever_sample<RES, DOTS, ADDS, MERGE>(
              pw, px, py, cn, aj, g, live, w.sm + lv.sm_off[l] + c, w.D,
              w.dv_bm + lvl_off, w.M * w.D, key0, merge, skip);
        else
          lever_sample<DIRECT, DOTS, ADDS, MERGE>(
              pw, px, py, cn, aj, g, live, w.v_bm + lvl_off, w.M * w.D,
              w.dv_bm + lvl_off, w.M * w.D, key0, merge, skip);
        if (DOTS) {
          pw = group_sum8(pw);
          px = group_sum8(px);
          py = group_sum8(py);
          if (gl == j) {
            tot_w += pw;
            tot_x += px;
            tot_y += py;
          }
        }
      }
      if (DOTS && live && si < n_samples) {
        const int l = si / w.n_points;
        w.daw[bqm * n_samples + si] = tot_w;
        reinterpret_cast<float2*>(w.dloc + bqm * n_samples * 2)[si] =
            make_float2(a * (float)lv.w[l] * tot_x,
                        a * (float)lv.h[l] * tot_y);
      }
    }
  }
}

template <int ROLE, int MERGE>
__global__ void __launch_bounds__(LEVER_THREADS, 1)
lever_bwd_kernel(const __nv_bfloat16* __restrict__ value,
                 const float* __restrict__ loc, const float* __restrict__ aw,
                 const float* __restrict__ dout, float* __restrict__ dvalue,
                 float* __restrict__ dloc, float* __restrict__ daw,
                 const int* __restrict__ order, const int* __restrict__ runs,
                 const Levels lv, int n_levels, int n_points, int n_runs,
                 int S, int Q, int M, int D, int dot_warps, int merge_mask,
                 int skip_mask) {
  extern __shared__ float4 smem4[];
  __nv_bfloat16* sm = reinterpret_cast<__nv_bfloat16*>(smem4);
  float* smd = reinterpret_cast<float*>(
      reinterpret_cast<char*>(smem4) + msda_grad_start<__nv_bfloat16>(lv));
  const int run = blockIdx.x % n_runs;
  const int bm = blockIdx.x / n_runs;
  const int b = bm / M, m = bm - b * M;
  const size_t bm_off = ((size_t)b * S * M + m) * D;
  if (lv.resident_mask) {
    msda_stage_levels<__nv_bfloat16, 4>(sm, value, lv, n_levels, S, M, D, b,
                                        m);
    for (int i = threadIdx.x; i < lv.grad_floats; i += blockDim.x)
      smd[i] = 0.f;
    __syncthreads();
  }
  const Walk w = {value + bm_off, sm, smd, loc, aw, dout, dvalue + bm_off,
                  dloc, daw, order, runs[2 * run], runs[2 * run + 1],
                  n_levels, n_points, b, m, Q, M, D, merge_mask, skip_mask};
  const int warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  const int sub = (threadIdx.x & 31) / LEVER_G;
  if constexpr (ROLE == BOTH)
    walk<true, true, MERGE>(w, lv, warp * 4 + sub, warps * 4);
  else if constexpr (ROLE == DOTS)
    walk<true, false, 0>(w, lv, warp * 4 + sub, warps * 4);
  else if constexpr (ROLE == ADDS)
    walk<false, true, MERGE>(w, lv, warp * 4 + sub, warps * 4);
  else if (warp < dot_warps)
    walk<true, false, 0>(w, lv, warp * 4 + sub, dot_warps * 4);
  else
    walk<false, true, MERGE>(w, lv, (warp - dot_warps) * 4 + sub,
                             (warps - dot_warps) * 4);
  if (ROLE != DOTS && lv.grad_mask) {
    __syncthreads();
    for (int l = 0; l < n_levels; ++l) {
      if (!((lv.grad_mask >> l) & 1)) continue;
      const float* src = smd + lv.grad_off[l];
      float* dst = dvalue + bm_off + (size_t)lv.start[l] * M * D;
      const int n = lv.h[l] * lv.w[l] * (D / 4);
      for (int i = threadIdx.x; i < n; i += blockDim.x) {
        const int r = i / (D / 4), c = (i - r * (D / 4)) * 4;
        Row<4> row;
        row.load_shared(src + r * D + c);
        if (row.v[0] != 0.f || row.v[1] != 0.f || row.v[2] != 0.f ||
            row.v[3] != 0.f)
          row.add_global(dst + (size_t)r * M * D + c);
      }
    }
  }
}

template <int ROLE, int MERGE>
static int launch_lever(const __nv_bfloat16* value, const float* loc,
                        const float* aw, const float* dout, float* dvalue,
                        float* dloc, float* daw, const int* order,
                        const int* runs, const Levels& lv, int n_levels,
                        int P, int n_runs, int B, int S, int Q, int M, int D,
                        int threads, int dot_warps, int merge_mask,
                        int skip_mask, int extra_smem, cudaStream_t st) {
  static size_t granted = 48 * 1024;
  const size_t smem = msda_grad_start<__nv_bfloat16>(lv) +
                      (size_t)lv.grad_floats * sizeof(float) + extra_smem;
  cudaError_t err =
      msda_grant_smem(lever_bwd_kernel<ROLE, MERGE>, smem, &granted);
  if (err != cudaSuccess) return (int)err;
  lever_bwd_kernel<ROLE, MERGE><<<(unsigned)((long long)B * M * n_runs),
                                  threads, smem, st>>>(
      value, loc, aw, dout, dvalue, dloc, daw, order, runs, lv, n_levels, P,
      n_runs, S, Q, M, D, dot_warps, merge_mask, skip_mask);
  return (int)cudaGetLastError();
}

// The shipped backward's arguments (dvalue32 the float32 sums, zeroed here
// unless role is 1), then threads a block (a multiple of 32, at most 1,024),
// dot_warps (0: every warp does what role says; else the split, role
// ignored), role, merge (0 none, 1 by __match_any_sync, 2 by pairs), the
// level masks merge_mask and skip_mask, and extra_smem bytes of shared
// memory asked for and not used (what a larger block would take from L1).
extern "C" int lever_bwd_bf16(const void* value, const void* loc,
                              const void* aw, const void* dout,
                              void* dvalue32, void* dloc, void* daw,
                              const void* order, const void* runs,
                              const void* level_hw, int n_levels, int n_runs,
                              int max_run, int resident_mask, int grad_mask,
                              int B, int S, int Q, int M, int D, int P,
                              int threads, int dot_warps, int role,
                              int merge, int merge_mask, int skip_mask,
                              int extra_smem, void* stream) {
  (void)max_run;
  const int warps = threads / 32;
  if (D != LEVER_G * LEVER_VEC || !order || !runs || n_runs < 1 ||
      threads % 32 || threads < 64 || threads > LEVER_THREADS ||
      dot_warps < 0 || dot_warps >= warps || role < BOTH || role > ADDS ||
      merge < 0 || merge > 2 || extra_smem < 0 ||
      !msda_aligned16(value) || !msda_aligned16(dout) ||
      !msda_aligned16(dvalue32))
    return (int)cudaErrorInvalidValue;
  if (dot_warps > 0) role = SPLIT;
  Levels lv = {};
  if (msda_fill_levels(&lv, static_cast<const int*>(level_hw), n_levels,
                       resident_mask, role == DOTS ? 0 : grad_mask, D) != S)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (role != DOTS) {
    const cudaError_t err = cudaMemsetAsync(
        dvalue32, 0, (size_t)B * S * M * D * sizeof(float), st);
    if (err != cudaSuccess) return (int)err;
  }
  const auto* v = static_cast<const __nv_bfloat16*>(value);
  const auto* lo = static_cast<const float*>(loc);
  const auto* a = static_cast<const float*>(aw);
  const auto* g = static_cast<const float*>(dout);
  auto* dv = static_cast<float*>(dvalue32);
  auto* dl = static_cast<float*>(dloc);
  auto* da = static_cast<float*>(daw);
  const auto* ord = static_cast<const int*>(order);
  const auto* rn = static_cast<const int*>(runs);
#define LEVER_CASE(R, MG)                                                    \
  if (role == R && merge == MG)                                              \
    return launch_lever<R, MG>(v, lo, a, g, dv, dl, da, ord, rn, lv,         \
                               n_levels, P, n_runs, B, S, Q, M, D, threads,  \
                               dot_warps, merge_mask, skip_mask, extra_smem, \
                               st);
  LEVER_CASE(BOTH, 0)
  LEVER_CASE(BOTH, 1)
  LEVER_CASE(BOTH, 2)
  LEVER_CASE(DOTS, 0)
  LEVER_CASE(ADDS, 0)
  LEVER_CASE(ADDS, 1)
  LEVER_CASE(ADDS, 2)
  LEVER_CASE(SPLIT, 0)
  LEVER_CASE(SPLIT, 1)
#undef LEVER_CASE
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// dvalue summed in the block by lists: every in-bounds corner of the
// block's run is an entry (next entry, weight) pushed onto its row's list
// in shared memory (one head a token of the head, by atomicExch; the entry
// is the corner's own slot, so its query follows from its place), and the
// run's dout rows are kept in shared memory.  After the walk one lane group
// owns each row that has a list, sums its entries and adds the sum into
// dvalue by one 16-byte vector atomic a lane: one add a row a block in
// place of one a corner, and no float atomic in shared memory.
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(LEVER_THREADS, 1)
lists_kernel(const __nv_bfloat16* __restrict__ value,
             const float* __restrict__ loc, const float* __restrict__ aw,
             const float* __restrict__ dout, float* __restrict__ dvalue,
             float* __restrict__ dloc, float* __restrict__ daw,
             const int* __restrict__ order, const int* __restrict__ runs,
             const Levels lv, int n_levels, int n_points, int n_runs, int S,
             int Q, int M, int D, int max_run) {
  extern __shared__ float4 smem4[];
  char* base = reinterpret_cast<char*>(smem4);
  const __nv_bfloat16* sm = reinterpret_cast<const __nv_bfloat16*>(base);
  const int n_samples = n_levels * n_points;
  size_t at = msda_grad_start<__nv_bfloat16>(lv);
  int* head = reinterpret_cast<int*>(base + at);
  at += ((size_t)S * sizeof(int) + 15) / 16 * 16;
  int2* ent = reinterpret_cast<int2*>(base + at);
  at += (size_t)max_run * n_samples * 4 * sizeof(int2);
  float* sdout = reinterpret_cast<float*>(base + at);

  const int run = blockIdx.x % n_runs;
  const int bm = blockIdx.x / n_runs;
  const int b = bm / M, m = bm - b * M;
  const int first = runs[2 * run], count = runs[2 * run + 1];
  const size_t bm_off = ((size_t)b * S * M + m) * D;
  const __nv_bfloat16* v_bm = value + bm_off;
  if (lv.resident_mask)
    msda_stage_levels<__nv_bfloat16, 4>(
        reinterpret_cast<__nv_bfloat16*>(base), value, lv, n_levels, S, M,
        D, b, m);
  for (int i = threadIdx.x; i < S; i += blockDim.x) head[i] = -1;
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int group = warp * 4 + (threadIdx.x & 31) / LEVER_G;
  const int n_groups = (blockDim.x >> 5) * 4;
  const int gl = threadIdx.x % LEVER_G, c = gl * LEVER_VEC;
  for (int i0 = 0; i0 < count; i0 += n_groups) {
    const int ql = i0 + group;
    const bool live = ql < count;
    const int q = order[first + (live ? ql : 0)];
    const size_t bqm = ((size_t)b * Q + q) * M + m;
    const float* loc_q = loc + bqm * n_samples * 2;
    const float* aw_q = aw + bqm * n_samples;
    float g[4];
    {
      Row<4> r;
      r.load_global(dout + bqm * D + c);
      if (live) r.store(sdout + ql * D + c);
#pragma unroll
      for (int e = 0; e < 4; ++e) g[e] = live ? r.v[e] : 0.f;
    }
    for (int s0 = 0; s0 < n_samples; s0 += LEVER_G) {
      const int si = s0 + gl;
      float lx = 0.f, ly = 0.f, a = 0.f;
      if (si < n_samples) {
        const float2 xy = __ldg(reinterpret_cast<const float2*>(loc_q) + si);
        lx = xy.x, ly = xy.y;
        a = __ldg(aw_q + si);
      }
      const int l_own = min(si, n_samples - 1) / n_points;
      const SamplePlace own(lx, ly, lv.h[l_own], lv.w[l_own]);
      const int ns = min(LEVER_G, n_samples - s0);
      float tot_w = 0.f, tot_x = 0.f, tot_y = 0.f;
#pragma unroll 1
      for (int j = 0; j < ns; ++j) {
        const float dx = __shfl_sync(0xffffffffu, own.dx, j, LEVER_G);
        const float dy = __shfl_sync(0xffffffffu, own.dy, j, LEVER_G);
        const int code = __shfl_sync(0xffffffffu, own.code, j, LEVER_G);
        const float aj = __shfl_sync(0xffffffffu, a, j, LEVER_G);
        const int l = (s0 + j) / n_points;
        const Corners cn(dx, dy, code, lv.w[l]);
        const bool res = (lv.resident_mask >> l) & 1;
        const __nv_bfloat16* rows =
            res ? sm + lv.sm_off[l] + c
                : v_bm + (size_t)lv.start[l] * M * D + c;
        const int stride = res ? D : M * D;
        float pw = 0.f, px = 0.f, py = 0.f;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (!(live && cn.inb[k])) continue;
          ValueRow<__nv_bfloat16, 4> r;
          if (res)
            r.load_shared(rows + cn.tok[k] * stride);
          else
            r.load_global(rows + (size_t)cn.tok[k] * stride);
          float vg = 0.f;
#pragma unroll
          for (int e = 0; e < 4; ++e) vg += r.v[e] * g[e];
          pw += cn.cw[k] * vg;
          px += cn.dwx[k] * vg;
          py += cn.dwy[k] * vg;
          // lane k of the group pushes corner k's entry
          if (gl == k) {
            const int e = (ql * n_samples + s0 + j) * 4 + k;
            const int next = atomicExch(head + lv.start[l] + cn.tok[k], e);
            ent[e] = make_int2(next, __float_as_int(aj * cn.cw[k]));
          }
        }
        pw = group_sum8(pw);
        px = group_sum8(px);
        py = group_sum8(py);
        if (gl == j) {
          tot_w += pw;
          tot_x += px;
          tot_y += py;
        }
      }
      if (live && si < n_samples) {
        const int l = si / n_points;
        daw[bqm * n_samples + si] = tot_w;
        reinterpret_cast<float2*>(dloc + bqm * n_samples * 2)[si] =
            make_float2(a * (float)lv.w[l] * tot_x,
                        a * (float)lv.h[l] * tot_y);
      }
    }
  }
  __syncthreads();
  // each row with a list: its entries summed, one add into dvalue
  for (int r = group; r < S; r += n_groups) {
    int e = head[r];
    if (e < 0) continue;
    Row<4> acc;
#pragma unroll
    for (int k = 0; k < 4; ++k) acc.v[k] = 0.f;
    do {
      const int2 en = ent[e];
      const float coef = __int_as_float(en.y);
      const float4 gg = *reinterpret_cast<const float4*>(
          sdout + e / (n_samples * 4) * D + c);
      acc.v[0] += coef * gg.x, acc.v[1] += coef * gg.y;
      acc.v[2] += coef * gg.z, acc.v[3] += coef * gg.w;
      e = en.x;
    } while (e >= 0);
    acc.add_global(dvalue + bm_off + (size_t)r * M * D + c);
  }
}

// The shipped backward's arguments without grad_mask (dvalue32 the float32
// sums, zeroed here), then threads a block (a multiple of 32, at most
// 1,024).
extern "C" int lever_lists_bf16(const void* value, const void* loc,
                                const void* aw, const void* dout,
                                void* dvalue32, void* dloc, void* daw,
                                const void* order, const void* runs,
                                const void* level_hw, int n_levels,
                                int n_runs, int max_run, int resident_mask,
                                int B, int S, int Q, int M, int D, int P,
                                int threads, void* stream) {
  static size_t granted = 48 * 1024;
  Levels lv = {};
  if (D != LEVER_G * LEVER_VEC || !order || !runs || n_runs < 1 ||
      max_run < 1 || threads % 32 || threads < 32 ||
      threads > LEVER_THREADS || !msda_aligned16(value) ||
      !msda_aligned16(dout) ||
      !msda_aligned16(dvalue32) ||
      msda_fill_levels(&lv, static_cast<const int*>(level_hw), n_levels,
                       resident_mask, 0, D) != S)
    return (int)cudaErrorInvalidValue;
  const size_t smem = msda_grad_start<__nv_bfloat16>(lv) +
                      ((size_t)S * sizeof(int) + 15) / 16 * 16 +
                      (size_t)max_run * n_levels * P * 4 * sizeof(int2) +
                      (size_t)max_run * D * sizeof(float);
  cudaError_t err = msda_grant_smem(lists_kernel, smem, &granted);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(dvalue32, 0, (size_t)B * S * M * D * sizeof(float),
                        st);
  if (err != cudaSuccess) return (int)err;
  lists_kernel<<<(unsigned)((long long)B * M * n_runs), threads, smem,
                 st>>>(static_cast<const __nv_bfloat16*>(value),
                       static_cast<const float*>(loc),
                       static_cast<const float*>(aw),
                       static_cast<const float*>(dout),
                       static_cast<float*>(dvalue32),
                       static_cast<float*>(dloc), static_cast<float*>(daw),
                       static_cast<const int*>(order),
                       static_cast<const int*>(runs), lv, n_levels, P,
                       n_runs, S, Q, M, D, max_run);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// dvalue of the levels in sort_mask summed in the block by a counting
// sort: each in-bounds corner of those levels writes an entry (row of the
// sorted levels, weight) into its own slot and counts its row by an
// integer add with no return; then a scan of the counts, a scatter of the
// entries into row order, and one lane group a row sums its contiguous
// entries from the run's dout rows (kept in shared memory) and adds the
// sum into dvalue by one 16-byte vector atomic a lane.  The other levels
// add by the shipped vector atomics.
// ---------------------------------------------------------------------------

// of each sorted level: its first row among the sorted rows, and its first
// sample among the sorted samples of a query
struct RowStarts {
  int r[MSDA_MAX_LEVELS];
  int s[MSDA_MAX_LEVELS];
};

__global__ void __launch_bounds__(LEVER_THREADS, 1)
sorted_kernel(const __nv_bfloat16* __restrict__ value,
              const float* __restrict__ loc, const float* __restrict__ aw,
              const float* __restrict__ dout, float* __restrict__ dvalue,
              float* __restrict__ dloc, float* __restrict__ daw,
              const int* __restrict__ order, const int* __restrict__ runs,
              const Levels lv, int n_levels, int n_points, int n_runs, int S,
              int Q, int M, int D, int max_run, int sort_mask,
              const RowStarts row0, int rows, int sorted_samples) {
  extern __shared__ float4 smem4[];
  char* base = reinterpret_cast<char*>(smem4);
  const __nv_bfloat16* sm = reinterpret_cast<const __nv_bfloat16*>(base);
  const int n_samples = n_levels * n_points;
  size_t at = msda_grad_start<__nv_bfloat16>(lv);
  int* off = reinterpret_cast<int*>(base + at);  // rows + 1: counts, then
  at += ((size_t)(rows + 1) * sizeof(int) + 15) / 16 * 16;  // offsets
  int* cursor = reinterpret_cast<int*>(base + at);
  at += ((size_t)rows * sizeof(int) + 15) / 16 * 16;
  // a slot a corner of the sorted levels, and the same entries in row order
  const int cap = max_run * sorted_samples * 4;
  int2* ent = reinterpret_cast<int2*>(base + at);
  at += (size_t)cap * sizeof(int2);
  int2* sorted = reinterpret_cast<int2*>(base + at);
  at += (size_t)cap * sizeof(int2);
  float* sdout = reinterpret_cast<float*>(base + at);
  __shared__ int part[33];

  const int run = blockIdx.x % n_runs;
  const int bm = blockIdx.x / n_runs;
  const int b = bm / M, m = bm - b * M;
  const int first = runs[2 * run], count = runs[2 * run + 1];
  const size_t bm_off = ((size_t)b * S * M + m) * D;
  const __nv_bfloat16* v_bm = value + bm_off;
  float* dv_bm = dvalue + bm_off;
  if (lv.resident_mask)
    msda_stage_levels<__nv_bfloat16, 4>(
        reinterpret_cast<__nv_bfloat16*>(base), value, lv, n_levels, S, M,
        D, b, m);
  for (int i = threadIdx.x; i <= rows; i += blockDim.x) off[i] = 0;
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int group = warp * 4 + (threadIdx.x & 31) / LEVER_G;
  const int n_groups = (blockDim.x >> 5) * 4;
  const int gl = threadIdx.x % LEVER_G, c = gl * LEVER_VEC;
  for (int i0 = 0; i0 < count; i0 += n_groups) {
    const int ql = i0 + group;
    const bool live = ql < count;
    const int q = order[first + (live ? ql : 0)];
    const size_t bqm = ((size_t)b * Q + q) * M + m;
    const float* loc_q = loc + bqm * n_samples * 2;
    const float* aw_q = aw + bqm * n_samples;
    float g[4];
    {
      Row<4> r;
      r.load_global(dout + bqm * D + c);
      if (live) r.store(sdout + ql * D + c);
#pragma unroll
      for (int e = 0; e < 4; ++e) g[e] = live ? r.v[e] : 0.f;
    }
    for (int s0 = 0; s0 < n_samples; s0 += LEVER_G) {
      const int si = s0 + gl;
      float lx = 0.f, ly = 0.f, a = 0.f;
      if (si < n_samples) {
        const float2 xy = __ldg(reinterpret_cast<const float2*>(loc_q) + si);
        lx = xy.x, ly = xy.y;
        a = __ldg(aw_q + si);
      }
      const int l_own = min(si, n_samples - 1) / n_points;
      const SamplePlace own(lx, ly, lv.h[l_own], lv.w[l_own]);
      const int ns = min(LEVER_G, n_samples - s0);
      float tot_w = 0.f, tot_x = 0.f, tot_y = 0.f;
#pragma unroll 1
      for (int j = 0; j < ns; ++j) {
        const float dx = __shfl_sync(0xffffffffu, own.dx, j, LEVER_G);
        const float dy = __shfl_sync(0xffffffffu, own.dy, j, LEVER_G);
        const int code = __shfl_sync(0xffffffffu, own.code, j, LEVER_G);
        const float aj = __shfl_sync(0xffffffffu, a, j, LEVER_G);
        const int l = (s0 + j) / n_points;
        const Corners cn(dx, dy, code, lv.w[l]);
        const bool res = (lv.resident_mask >> l) & 1;
        const bool sort = (sort_mask >> l) & 1;
        const __nv_bfloat16* rows_l =
            res ? sm + lv.sm_off[l] + c
                : v_bm + (size_t)lv.start[l] * M * D + c;
        const int stride = res ? D : M * D;
        float* drows = dv_bm + (size_t)lv.start[l] * M * D + c;
        float pw = 0.f, px = 0.f, py = 0.f;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const bool hit = live && cn.inb[k];
          if (hit) {
            ValueRow<__nv_bfloat16, 4> r;
            if (res)
              r.load_shared(rows_l + cn.tok[k] * stride);
            else
              r.load_global(rows_l + (size_t)cn.tok[k] * stride);
            float vg = 0.f;
#pragma unroll
            for (int e = 0; e < 4; ++e) vg += r.v[e] * g[e];
            pw += cn.cw[k] * vg;
            px += cn.dwx[k] * vg;
            py += cn.dwy[k] * vg;
            if (!sort) {
              Row<4> d;
              const float coef = aj * cn.cw[k];
#pragma unroll
              for (int e = 0; e < 4; ++e) d.v[e] = coef * g[e];
              d.add_global(drows + (size_t)cn.tok[k] * M * D);
            }
          }
        }
        // lane k of the group writes corner k's slot and counts its row
        if (sort && live && gl < 4) {
          int tok = cn.tok[0], in = cn.inb[0];
          float w = cn.cw[0];
#pragma unroll
          for (int k = 1; k < 4; ++k)
            if (gl == k) tok = cn.tok[k], in = cn.inb[k], w = cn.cw[k];
          const int e = (ql * sorted_samples + row0.s[l] +
                         (s0 + j - l * n_points)) * 4 + gl;
          const int row = row0.r[l] + tok;
          ent[e] = make_int2(in ? row : -1, __float_as_int(aj * w));
          if (in) atomicAdd(off + row, 1);
        }
        pw = group_sum8(pw);
        px = group_sum8(px);
        py = group_sum8(py);
        if (gl == j) {
          tot_w += pw;
          tot_x += px;
          tot_y += py;
        }
      }
      if (live && si < n_samples) {
        const int l = si / n_points;
        daw[bqm * n_samples + si] = tot_w;
        reinterpret_cast<float2*>(dloc + bqm * n_samples * 2)[si] =
            make_float2(a * (float)lv.w[l] * tot_x,
                        a * (float)lv.h[l] * tot_y);
      }
    }
  }
  __syncthreads();
  // exclusive scan of the counts: a contiguous share of rows a thread
  {
    const int per = (rows + blockDim.x - 1) / blockDim.x;
    const int lo = min(rows, (int)threadIdx.x * per);
    const int hi = min(rows, lo + per);
    int mine = 0;
    for (int i = lo; i < hi; ++i) mine += off[i];
    const int lane = threadIdx.x & 31;
    int inc = mine;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, inc, o);
      if (lane >= o) inc += y;
    }
    if (lane == 31) part[warp] = inc;
    __syncthreads();
    if (warp == 0) {
      const int own = lane < (int)(blockDim.x >> 5) ? part[lane] : 0;
      int w = own;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, w, o);
        if (lane >= o) w += y;
      }
      part[lane] = w - own;
      if (lane == 31) part[32] = w;
    }
    __syncthreads();
    int run_at = part[warp] + inc - mine;
    for (int i = lo; i < hi; ++i) {
      const int n = off[i];
      off[i] = cursor[i] = run_at;
      run_at += n;
    }
    if (threadIdx.x == 0) off[rows] = part[32];
  }
  __syncthreads();
  // the entries into row order
  const int slots = count * sorted_samples * 4;
  for (int e = threadIdx.x; e < slots; e += blockDim.x) {
    const int2 en = ent[e];
    if (en.x < 0) continue;
    const int to = atomicAdd(cursor + en.x, 1);
    sorted[to] = make_int2(e / (sorted_samples * 4), en.y);
  }
  __syncthreads();
  // one lane group a row: its entries summed, one add into dvalue
  for (int r = group; r < rows; r += n_groups) {
    const int lo = off[r], hi = off[r + 1];
    if (lo == hi) continue;
    Row<4> acc;
#pragma unroll
    for (int k = 0; k < 4; ++k) acc.v[k] = 0.f;
#pragma unroll 4
    for (int i = lo; i < hi; ++i) {
      const int2 en = sorted[i];
      const float coef = __int_as_float(en.y);
      const float4 gg =
          *reinterpret_cast<const float4*>(sdout + en.x * D + c);
      acc.v[0] += coef * gg.x, acc.v[1] += coef * gg.y;
      acc.v[2] += coef * gg.z, acc.v[3] += coef * gg.w;
    }
    int l = 0;
    while (l + 1 < n_levels && (!((sort_mask >> l) & 1) ||
                                r >= row0.r[l] + lv.h[l] * lv.w[l]))
      ++l;
    const int tok = lv.start[l] + r - row0.r[l];
    acc.add_global(dv_bm + (size_t)tok * M * D + c);
  }
}

// The shipped backward's arguments without grad_mask (dvalue32 the float32
// sums, zeroed here), then threads a block and sort_mask, the levels
// summed in the block.
extern "C" int lever_sorted_bf16(const void* value, const void* loc,
                                 const void* aw, const void* dout,
                                 void* dvalue32, void* dloc, void* daw,
                                 const void* order, const void* runs,
                                 const void* level_hw, int n_levels,
                                 int n_runs, int max_run, int resident_mask,
                                 int B, int S, int Q, int M, int D, int P,
                                 int threads, int sort_mask, void* stream) {
  static size_t granted = 48 * 1024;
  Levels lv = {};
  if (D != LEVER_G * LEVER_VEC || !order || !runs || n_runs < 1 ||
      max_run < 1 || threads % 32 || threads < 32 ||
      threads > LEVER_THREADS || sort_mask < 1 ||
      (sort_mask >> n_levels) || !msda_aligned16(value) ||
      !msda_aligned16(dout) || !msda_aligned16(dvalue32) ||
      msda_fill_levels(&lv, static_cast<const int*>(level_hw), n_levels,
                       resident_mask, 0, D) != S)
    return (int)cudaErrorInvalidValue;
  int rows = 0, sorted_samples = 0;
  RowStarts row0 = {};
  for (int l = 0; l < n_levels; ++l) {
    row0.r[l] = rows;
    row0.s[l] = sorted_samples;
    if ((sort_mask >> l) & 1) rows += lv.h[l] * lv.w[l], sorted_samples += P;
  }
  const size_t smem = msda_grad_start<__nv_bfloat16>(lv) +
                      ((size_t)(rows + 1) * sizeof(int) + 15) / 16 * 16 +
                      ((size_t)rows * sizeof(int) + 15) / 16 * 16 +
                      2 * (size_t)max_run * sorted_samples * 4 *
                          sizeof(int2) +
                      (size_t)max_run * D * sizeof(float);
  cudaError_t err = msda_grant_smem(sorted_kernel, smem, &granted);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(dvalue32, 0, (size_t)B * S * M * D * sizeof(float),
                        st);
  if (err != cudaSuccess) return (int)err;
  sorted_kernel<<<(unsigned)((long long)B * M * n_runs), threads, smem,
                  st>>>(static_cast<const __nv_bfloat16*>(value),
                        static_cast<const float*>(loc),
                        static_cast<const float*>(aw),
                        static_cast<const float*>(dout),
                        static_cast<float*>(dvalue32),
                        static_cast<float*>(dloc), static_cast<float*>(daw),
                        static_cast<const int*>(order),
                        static_cast<const int*>(runs), lv, n_levels, P,
                        n_runs, S, Q, M, D, max_run, sort_mask, row0, rows,
                        sorted_samples);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// the atomic-free dvalue
// ---------------------------------------------------------------------------

// One thread a sample (b, q, m, l, p): each in-bounds corner's dvalue row
// (b * S + token) * M + m, counted (FILL false) or placed as an entry
// (dout row, weight) at the row's next free place (FILL true).
template <bool FILL>
__global__ void owner_entries(const float* __restrict__ loc,
                              const float* __restrict__ aw,
                              int* __restrict__ count,
                              int* __restrict__ cursor,
                              int2* __restrict__ ent, const Levels lv,
                              int n_levels, int P, int Q, int M, int S,
                              long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int s = (int)(i % (n_levels * P));
  const long long bqm = i / (n_levels * P);
  const int m = (int)(bqm % M);
  const int b = (int)(bqm / ((long long)Q * M));
  const int l = s / P;
  const float2 xy = __ldg(reinterpret_cast<const float2*>(loc) + i);
  const SamplePlace sp(xy.x, xy.y, lv.h[l], lv.w[l]);
  const Corners cn(sp.dx, sp.dy, sp.code, lv.w[l]);
  const float a = FILL ? __ldg(aw + i) : 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (!cn.inb[k]) continue;
    const int row = ((b * S + lv.start[l] + cn.tok[k]) * M) + m;
    if (!FILL) {
      atomicAdd(count + row, 1);
    } else {
      const int at = atomicAdd(cursor + row, 1);
      ent[at] = make_int2((int)bqm, __float_as_int(a * cn.cw[k]));
    }
  }
}

// Sum of x over a block of 1,024 threads, in every thread.
__device__ __forceinline__ int block_sum(int x, int* part) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = x;
  __syncthreads();
  int t = part[threadIdx.x & 31];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
  return t;
}

// The counts of each tile of 1,024 rows.
__global__ void owner_tile_sums(const int* __restrict__ count,
                                int* __restrict__ tile_sum, int R) {
  __shared__ int part[32];
  const int i = blockIdx.x * 1024 + threadIdx.x;
  const int t = block_sum(i < R ? count[i] : 0, part);
  if (threadIdx.x == 0) tile_sum[blockIdx.x] = t;
}

// offset[r] (and cursor[r]) = the entries of rows before r; offset[R] all.
__global__ void owner_scan(const int* __restrict__ count,
                           const int* __restrict__ tile_sum,
                           int* __restrict__ offset, int* __restrict__ cursor,
                           int R) {
  __shared__ int part[32];
  __shared__ int wsum[32];
  int before = 0;
  for (int t = threadIdx.x; t < (int)blockIdx.x; t += 1024) before += tile_sum[t];
  before = block_sum(before, part);
  const int i = blockIdx.x * 1024 + threadIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int x = i < R ? count[i] : 0;
  int inc = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += y;
  }
  if (lane == 31) wsum[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const int own = wsum[lane];
    int w = own;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    wsum[lane] = w - own;
  }
  __syncthreads();
  const int at = before + wsum[warp] + inc - x;
  if (i < R) offset[i] = cursor[i] = at;
  if (i == R - 1) offset[R] = at + x;
}

// One warp a row, heaviest (the coarsest level's) first: four groups of
// eight lanes take every fourth entry, four channels a lane, and a
// butterfly sums the groups; the row is written as bf16.
__global__ void owner_sum(const int2* __restrict__ ent,
                          const int* __restrict__ offset,
                          const float* __restrict__ dout,
                          __nv_bfloat16* __restrict__ dvalue, int R, int D) {
  const int w = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (w >= R) return;
  const int row = R - 1 - w;
  const int lane = threadIdx.x & 31, sub = lane >> 3, c = (lane & 7) * 4;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  const int hi = offset[row + 1];
#pragma unroll 4
  for (int i = offset[row] + sub; i < hi; i += 4) {
    const int2 e = __ldg(ent + i);
    const float coef = __int_as_float(e.y);
    const float4 g =
        __ldg(reinterpret_cast<const float4*>(dout + (size_t)e.x * D + c));
    acc[0] += coef * g.x, acc[1] += coef * g.y;
    acc[2] += coef * g.z, acc[3] += coef * g.w;
  }
#pragma unroll
  for (int o = 8; o < 32; o <<= 1)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], o);
  if (sub == 0) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(acc[0], acc[1]);
    const __nv_bfloat162 hi2 = __floats2bfloat162_rn(acc[2], acc[3]);
    uint2 u;
    u.x = *reinterpret_cast<const unsigned*>(&lo);
    u.y = *reinterpret_cast<const unsigned*>(&hi2);
    *reinterpret_cast<uint2*>(dvalue + (size_t)row * D + c) = u;
  }
}

// dvalue (B, S, M, D) bf16 from loc, aw and dout with no float atomics.
// Scratch: count, cursor (R = B * S * M ints each), offset (R + 1),
// tile_sum (R / 1,024 rounded up), ent (B * Q * M * L * P * 4 int2).
extern "C" int lever_owner_bf16(const void* loc, const void* aw,
                                const void* dout, void* dvalue, void* count,
                                void* offset, void* cursor, void* tile_sum,
                                void* ent, const void* level_hw,
                                int n_levels, int B, int S, int Q, int M,
                                int D, int P, void* stream) {
  Levels lv = {};
  if (D != LEVER_G * LEVER_VEC || !msda_aligned16(dout) ||
      (reinterpret_cast<size_t>(dvalue) & 7) ||
      msda_fill_levels(&lv, static_cast<const int*>(level_hw), n_levels, 0,
                       0, D) != S)
    return (int)cudaErrorInvalidValue;
  const long long R = (long long)B * S * M;
  const long long n = (long long)B * Q * M * n_levels * P;
  if (R < 1 || R >= 0x7fffffffLL || n < 1 || 4 * n >= 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(count, 0, R * sizeof(int), st);
  if (err != cudaSuccess) return (int)err;
  const unsigned sample_blocks = (unsigned)((n + 255) / 256);
  const unsigned tiles = (unsigned)((R + 1023) / 1024);
  auto* cnt = static_cast<int*>(count);
  auto* cur = static_cast<int*>(cursor);
  auto* off = static_cast<int*>(offset);
  auto* ts = static_cast<int*>(tile_sum);
  auto* en = static_cast<int2*>(ent);
  const auto* lo = static_cast<const float*>(loc);
  const auto* a = static_cast<const float*>(aw);
  owner_entries<false><<<sample_blocks, 256, 0, st>>>(
      lo, a, cnt, cur, en, lv, n_levels, P, Q, M, S, n);
  owner_tile_sums<<<tiles, 1024, 0, st>>>(cnt, ts, (int)R);
  owner_scan<<<tiles, 1024, 0, st>>>(cnt, ts, off, cur, (int)R);
  owner_entries<true><<<sample_blocks, 256, 0, st>>>(
      lo, a, cnt, cur, en, lv, n_levels, P, Q, M, S, n);
  owner_sum<<<(unsigned)((R + 7) / 8), 256, 0, st>>>(
      en, off, static_cast<const float*>(dout),
      static_cast<__nv_bfloat16*>(dvalue), (int)R, D);
  return (int)cudaGetLastError();
}
