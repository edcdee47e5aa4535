// Multi-scale deformable attention (MSDA) backward, CUDA C++ for sm_90a.
//
// For out[b, q, m, :] = sum over (l, p) of aw[b, q, m, l, p]
//                       * bilinear(value_l[b, :, m, :], loc[b, q, m, l, p])
// (grid_sample semantics, align_corners=False, zero padding: pixel
// x = loc_x * W_l - 0.5) and the incoming gradient dout (B, Q, M * D), one
// call computes all three input gradients:
//
//   dvalue[b, tok, m, :] += aw * w_corner * dout[b, q, m, :]
//                             over every sample and in-bounds corner;
//   gdot(corner)          = <value[b, tok, m, :], dout[b, q, m, :]>;
//   daw[b, q, m, l, p]    = sum over corners of w_corner * gdot;
//   dloc[.., 0]           = aw * W_l * sum over corners of dw/dx * gdot;
//   dloc[.., 1]           = aw * H_l * sum over corners of dw/dy * gdot.
//
// value (B, S, M, D) float32 (entry point msda_bwd) or bfloat16
// (msda_bwd_bf16); loc (B, Q, M, L, P, 2), aw (B, Q, M, L, P), dout,
// dvalue (B, S, M, D), dloc, daw float32; all contiguous.  dvalue is the
// float32 sum for either value type: the wrapper (ops/msda.py) rounds it to
// bf16 once, as the JAX package casts K3's float32 sums to value's dtype
// outside the kernel (msda_mxu.py:635).  The bf16 form keeps the float32
// form's lanes (four channels a lane: 8 bytes of value, 16 of dout and of
// dvalue's atomics) and computes dloc and daw in float32, as K2 dots bf16
// quad rows with float32 dout (msda_mxu.py:331); its adds into dvalue and
// its shared-memory grad levels stay float32.
//
// Replaces two TPU kernels: msda_gdot_mxu (monosowa_tpu/ops/msda_mxu.py:306,
// kernel _gdot_kernel :269), whose per-slot dots the JAX package folds into
// dLoc and dAttn outside the kernel (ops/msda.py:311-324), and
// msda_dvalue_mxu (msda_mxu.py:544, kernel _dvalue_kernel :452).  Those fetch
// corner rows through one-hot matrix products and accumulate dValue as
// transposed one-hot products into a bank in fast memory, because a TPU
// serialises gathers and scatters.  Here the gather is direct, the scatter
// is atomic adds, and the fold happens in registers.
//
// What bounds it: memory traffic, and not the compulsory bytes.  Those
// (loc, aw and dout read once, the value rows that in-bounds corners touch
// read once, dvalue, dloc and daw written once) are about 125 MB at the
// encoder's shape (B=2, Q=S=10,200, M=8, D=32, L=P=4), about 37 us at
// 3.35 TB/s; the arithmetic, two multiply-adds per channel and corner, is
// about 1.1 GFLOP, 16 us at 67 TFLOP/s.  But every in-bounds corner reads
// one 128-byte value row and adds into one 128-byte dvalue row, about 2 GB
// a launch.  The adds are the limit on the H100: they take over a third of
// the encoder's launch, whichever memory they go to.
//
// The bf16 form, measured on an H100 at the encoder's shape with
// tools/tune_msda_torch.py --dtype bf16 (the levers are in
// tools/csrc/msda_bwd_levers.cu; PERF.md has the numbers): the adds alone
// take about 0.37 of the 0.39 ms of this walk and the dots alone 0.21, so
// the launch is its adds, about the same for each of levels 0, 1 and 2.
// Four neighbouring queries of a warp share few rows at one sample, so
// merging their adds in registers (by __match_any_sync or by pairs of lane
// groups) costs more than it saves.  A block's run shares many rows of the
// coarse levels, and at the encoder the bf16 form sums those in the block
// by a counting sort (msda_bwd_bf16_sorted_kernel below, 0.35 ms).
//
// Design (the block map, the lane groups and the resident levels are set
// out in msda_common.cuh; the forward, msda_fwd.cu, shares them):
// * A block owns one (image, head) and a run of neighbouring queries, so L1
//   serves most corner reads; coarse levels of value can be copied whole
//   into shared memory (the encoder's coarsest level is).
// * dvalue goes out as 16-byte vector atomics (atomicAdd on float4 in
//   global memory), a quarter of the scalar atomics' instructions.
// * For the resident levels whose rows are hottest (grad_mask; the
//   encoder's coarsest level, 1,360 adds to each row a launch) a zeroed
//   copy in shared memory collects the adds with shared-memory atomics, and
//   the block adds it into dvalue once, at its end, skipping rows it never
//   touched.  Shared-memory float atomics cost more an add than L2's
//   vector atomics, so this pays only while it takes load off L2: with the
//   two coarsest levels summed there the kernel was slower than with one.
//   Rows are 32 banks wide, so each lane group starts at another of its
//   lane's four channels, or the groups of a warp would meet in the same
//   banks on every add (without the rotation the launch took half as long
//   again).
// * G lanes share a query, 16 bytes a lane (8 lanes for D = 32); the lane
//   that loaded a sample works out its place on its level once and shuffles
//   hand it round, each lane keeps its channels' share of the three folded
//   dots, and log2(G) butterfly steps
//   within the group sum them (3 for D = 32).
//   The lane that owns a sample keeps its totals until one coalesced write
//   of daw and dloc.  D that is no multiple of the lane's channels, or a
//   pointer off 16 bytes, takes the same kernel with one element a lane.
// * A launch too small to fill the card (the decoder at serving) gives each
//   query to 2 or 4 warps, which share its samples: the time of such a
//   launch is the length of one lane group's sample loop.
//
// dvalue is zeroed on the stream first.  The order of the atomic additions
// is set by the scheduler and changes from run to run, so dvalue's last
// bits do too; the plain version (an index_add_ scatter) sums in another
// order again.  dloc and daw have no atomics and are the same in every run.

#include "msda_common.cuh"

#define MSDA_BWD_THREADS 1024

template <int G>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off, G);
  return v;
}

// Where a sample's corner rows are read and where their gradient goes.
enum Mode {
  DIRECT,        // value from global memory, dvalue by global vector atomics
  RES,           // value from shared memory, dvalue by global vector atomics
  RES_GRAD       // value from shared memory, dvalue by shared-memory atomics
};

// Adds d into a row of the shared-memory share of dvalue, one scalar atomic
// a channel.  The rows are D floats with no padding, so at D = 32 the lane
// groups of a warp meet in the same banks whatever rows they hold; each
// group therefore starts at another of its lane's VEC channels.
template <int VEC, int G>
__device__ __forceinline__ void add_shared(float* p, const Row<VEC>& d) {
  const int rot = (threadIdx.x / G) & (VEC - 1);
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    const int ee = (e + rot) & (VEC - 1);
    float val = d.v[0];
#pragma unroll
    for (int f = 1; f < VEC; ++f) val = ee == f ? d.v[f] : val;
    atomicAdd(p + ee, val);
  }
}

// One sample's corners: the lane's share of the three folded dots into
// (pw, px, py), and aj * w_corner * g added into dvalue's rows.  `rows` and
// `drows` point at the lane's channels of the level's first row.
template <typename T, int VEC, int G, Mode MODE>
__device__ __forceinline__ void bwd_sample(
    float& pw, float& px, float& py, const Corners& cn, float aj,
    const float (&g)[VEC], const T* __restrict__ rows, int row_stride,
    float* drows, int drow_stride) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (cn.inb[k]) {
      ValueRow<T, VEC> r;
      Row<VEC> d;
      if (MODE == DIRECT)
        r.load_global(rows + (size_t)cn.tok[k] * row_stride);
      else
        r.load_shared(rows + cn.tok[k] * row_stride);
      const float coef = aj * cn.cw[k];
      float vg = 0.f;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        vg += r.v[e] * g[e];
        d.v[e] = coef * g[e];
      }
      pw += cn.cw[k] * vg;
      px += cn.dwx[k] * vg;
      py += cn.dwy[k] * vg;
      if (MODE == RES_GRAD)
        add_shared<VEC, G>(drows + cn.tok[k] * drow_stride, d);
      else
        d.add_global(drows + (size_t)cn.tok[k] * drow_stride);
    }
  }
}

template <typename T, int VEC, int G>
__global__ void __launch_bounds__(MSDA_BWD_THREADS, 1)
msda_bwd_kernel(const T* __restrict__ value, const float* __restrict__ loc,
                const float* __restrict__ aw, const float* __restrict__ dout,
                float* __restrict__ dvalue, float* __restrict__ dloc,
                float* __restrict__ daw, const int* __restrict__ order,
                const int* __restrict__ runs, const Levels lv, int n_levels,
                int n_points, int n_runs, int max_run, int split, int S,
                int Q, int M, int D) {
  extern __shared__ float4 smem4[];
  T* sm = reinterpret_cast<T*>(smem4);  // value's resident levels
  float* smd = reinterpret_cast<float*>(  // dvalue's grad levels
      reinterpret_cast<char*>(smem4) + msda_grad_start<T>(lv));

  const int run = blockIdx.x % n_runs;
  const int bm = blockIdx.x / n_runs;
  const int b = bm / M, m = bm - b * M;
  // without a block map: index order, max_run queries a block
  const int first = runs ? runs[2 * run] : run * max_run;
  const int count = runs ? runs[2 * run + 1] : min(max_run, Q - first);
  const int n_samples = n_levels * n_points;
  const size_t bm_off = ((size_t)b * S * M + m) * D;
  const T* v_bm = value + bm_off;
  float* dv_bm = dvalue + bm_off;

  if (lv.resident_mask) {
    msda_stage_levels<T, VEC>(sm, value, lv, n_levels, S, M, D, b, m);
    for (int i = threadIdx.x; i < lv.grad_floats; i += blockDim.x)
      smd[i] = 0.f;
    __syncthreads();
  }

  // `split` warps share their queries: warp w takes the samples s with
  // s % split == w % split of the queries of warps w - w % split .. (the
  // sample loop is the latency of a launch too small to fill the card)
  const int warp = threadIdx.x >> 5, gl = threadIdx.x % G;
  const int part = warp & (split - 1);  // split is 1, 2 or 4
  const int group = warp / split * (32 / G) + (threadIdx.x & 31) / G;
  const int n_groups = (blockDim.x >> 5) / split * (32 / G);
  // every lane of a warp takes every trip (the shuffles need them all); a
  // group past the end of the run reads the first query's samples, gathers
  // nothing, adds nothing and writes nothing
  for (int i0 = 0; i0 < count; i0 += n_groups) {
    const bool live = i0 + group < count;
    const int at = first + (live ? i0 + group : 0);
    const int q = order ? order[at] : at;
    const size_t bqm = ((size_t)b * Q + q) * M + m;
    const float* loc_q = loc + bqm * n_samples * 2;
    const float* aw_q = aw + bqm * n_samples;

    for (int s0 = 0; s0 < n_samples; s0 += G) {
      const int si = s0 + gl;
      float lx = 0.f, ly = 0.f, a = 0.f;
      if (si < n_samples) {
        const float2 xy = __ldg(reinterpret_cast<const float2*>(loc_q) + si);
        lx = xy.x, ly = xy.y;
        a = __ldg(aw_q + si);
      }
      const int l_own = min(si, n_samples - 1) / n_points;
      const SamplePlace own(lx, ly, lv.h[l_own], lv.w[l_own]);
      const int ns = min(G, n_samples - s0);
      // the totals of sample si, kept by its lane
      float tot_w = 0.f, tot_x = 0.f, tot_y = 0.f;
      for (int c0 = 0; c0 < D; c0 += G * VEC) {
        const int c = c0 + gl * VEC;
        const bool active = live && c < D;
        float g[VEC];
#pragma unroll
        for (int e = 0; e < VEC; ++e) g[e] = 0.f;
        if (active) {
          Row<VEC> r;
          r.load_global(dout + bqm * D + c);
#pragma unroll
          for (int e = 0; e < VEC; ++e) g[e] = r.v[e];
        }
#pragma unroll 1  // measured: unrolling the sample loop is slower
        for (int j = 0; j < ns; ++j) {
          // split is 1, 2 or 4; the test is the same for a whole warp
          if (((s0 + j) & (split - 1)) != part) continue;
          const float dx = __shfl_sync(0xffffffffu, own.dx, j, G);
          const float dy = __shfl_sync(0xffffffffu, own.dy, j, G);
          const int code = __shfl_sync(0xffffffffu, own.code, j, G);
          const float aj = __shfl_sync(0xffffffffu, a, j, G);
          float pw = 0.f, px = 0.f, py = 0.f;
          if (active) {
            const int l = (s0 + j) / n_points;
            const Corners cn(dx, dy, code, lv.w[l]);
            const size_t lvl_off = (size_t)lv.start[l] * M * D + c;
            if ((lv.grad_mask >> l) & 1)
              bwd_sample<T, VEC, G, RES_GRAD>(pw, px, py, cn, aj, g,
                                           sm + lv.sm_off[l] + c, D,
                                           smd + lv.grad_off[l] + c, D);
            else if ((lv.resident_mask >> l) & 1)
              bwd_sample<T, VEC, G, RES>(pw, px, py, cn, aj, g,
                                      sm + lv.sm_off[l] + c, D,
                                      dv_bm + lvl_off, M * D);
            else
              bwd_sample<T, VEC, G, DIRECT>(pw, px, py, cn, aj, g,
                                         v_bm + lvl_off, M * D,
                                         dv_bm + lvl_off, M * D);
          }
          pw = group_sum<G>(pw);
          px = group_sum<G>(px);
          py = group_sum<G>(py);
          if (gl == j) {
            tot_w += pw;
            tot_x += px;
            tot_y += py;
          }
        }
      }
      if (live && si < n_samples && (si & (split - 1)) == part) {
        const int l = si / n_points;
        daw[bqm * n_samples + si] = tot_w;
        reinterpret_cast<float2*>(dloc + bqm * n_samples * 2)[si] =
            make_float2(a * (float)lv.w[l] * tot_x,
                        a * (float)lv.h[l] * tot_y);
      }
    }
  }

  if (lv.grad_mask) {
    // the shared-memory share of dvalue, added once; rows that got nothing
    // are skipped
    __syncthreads();
    const int per_row = D / VEC;
    for (int l = 0; l < n_levels; ++l) {
      if (!((lv.grad_mask >> l) & 1)) continue;
      const float* src = smd + lv.grad_off[l];
      float* dst = dv_bm + (size_t)lv.start[l] * M * D;
      const int n = lv.h[l] * lv.w[l] * per_row;
      for (int i = threadIdx.x; i < n; i += blockDim.x) {
        const int r = i / per_row, c = (i - r * per_row) * VEC;
        Row<VEC> row;
        row.load_shared(src + r * D + c);
        bool any = false;
#pragma unroll
        for (int e = 0; e < VEC; ++e) any = any || row.v[e] != 0.f;
        if (any) row.add_global(dst + (size_t)r * M * D + c);
      }
    }
  }
}

template <typename T, int VEC, int G>
static int launch_bwd(const T* value, const float* loc, const float* aw,
                      const float* dout, float* dvalue, float* dloc,
                      float* daw, const int* order, const int* runs,
                      const Levels& lv, int n_levels, int P, int n_runs,
                      int max_run, int B, int S, int Q, int M, int D,
                      cudaStream_t st) {
  static size_t granted = 48 * 1024;
  const size_t smem = (lv.grad_mask ? msda_grad_start<T>(lv)
                                    : (size_t)lv.resident_elems * sizeof(T)) +
                      (size_t)lv.grad_floats * sizeof(float);
  cudaError_t err =
      msda_grant_smem(msda_bwd_kernel<T, VEC, G>, smem, &granted);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)B * M * n_runs;
  // 4 or 2 warps to a query where all of the launch's lane groups, so
  // multiplied, still run at once on half of the card's threads
  static int card_threads = 0;
  if (card_threads == 0) {
    int dev = 0, sms = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    card_threads = sms * 2048;
  }
  const long long lanes = (long long)B * Q * M * G;
  const int split =
      8 * lanes <= card_threads ? 4 : (4 * lanes <= card_threads ? 2 : 1);
  // whole warps of groups, then `split` warps for each
  const int threads = min(
      MSDA_BWD_THREADS,
      msda_block_threads(max_run, G, MSDA_BWD_THREADS / split) * split);
  msda_bwd_kernel<T, VEC, G><<<(unsigned)blocks, threads, smem, st>>>(
      value, loc, aw, dout, dvalue, dloc, daw, order, runs, lv, n_levels, P,
      n_runs, max_run, split, S, Q, M, D);
  return (int)cudaGetLastError();
}

template <typename T>
static int msda_bwd_any(const void* value, const void* loc, const void* aw,
                        const void* dout, void* dvalue, void* dloc, void* daw,
                        const void* order, const void* runs,
                        const void* level_hw, int n_levels, int n_runs,
                        int max_run, int resident_mask, int grad_mask, int B,
                        int S, int Q, int M, int D, int P, void* stream) {
  if (n_levels < 1 || n_levels > MSDA_MAX_LEVELS || P < 1 || D < 1 ||
      n_runs < 0 || max_run < 0)
    return (int)cudaErrorInvalidValue;
  Levels lv = {};
  if (msda_fill_levels(&lv, static_cast<const int*>(level_hw), n_levels,
                       resident_mask, grad_mask, D) != S)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(
      dvalue, 0, (size_t)B * S * M * D * sizeof(float), st);
  if (err != cudaSuccess) return (int)err;
  if ((long long)B * Q * M == 0 || n_runs == 0) return 0;
  if ((long long)B * M * n_runs > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  // loc and dloc move as float2: rows of 2 * L * P floats from 8-byte bases
  if ((reinterpret_cast<size_t>(loc) | reinterpret_cast<size_t>(dloc)) & 7)
    return (int)cudaErrorInvalidValue;
  const T* v = static_cast<const T*>(value);
  const float* lo = static_cast<const float*>(loc);
  const float* a = static_cast<const float*>(aw);
  const float* g = static_cast<const float*>(dout);
  float* dv = static_cast<float*>(dvalue);
  float* dl = static_cast<float*>(dloc);
  float* da = static_cast<float*>(daw);
  const int* ord = static_cast<const int*>(order);
  const int* rn = static_cast<const int*>(runs);
  // four channels a lane (a float4 of dout and of dvalue's atomics; 16 or
  // 8 bytes of value) where the rows allow them, else one element.  Measured
  // on an H100 at the encoder's shape: 16-byte lanes of eight bf16 channels
  // took 0.714 ms (they spill at this kernel's 64 registers), four-channel
  // lanes 0.390, the float32 form 0.380
  const int vec = (D % 4 == 0 && msda_aligned16(value) &&
                   msda_aligned16(dout) && msda_aligned16(dvalue))
                      ? 4
                      : 1;
  const int gw = msda_group_lanes(D, vec);
#define MSDA_BWD_CASE(V, G_)                                                 \
  if (vec == V && gw == G_)                                                  \
    return launch_bwd<T, V, G_>(v, lo, a, g, dv, dl, da, ord, rn, lv,        \
                                n_levels, P, n_runs, max_run, B, S, Q, M, D, \
                                st);
  MSDA_BWD_CASE(4, 8)
  MSDA_BWD_CASE(4, 16)
  MSDA_BWD_CASE(4, 32)
  MSDA_BWD_CASE(1, 8)
  MSDA_BWD_CASE(1, 16)
  MSDA_BWD_CASE(1, 32)
#undef MSDA_BWD_CASE
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// The bf16 form at the encoder: the levels of sort_mask summed in the block
// by a counting sort (msda_bwd_bf16 takes this path where the plan gives a
// sort_mask: queries in tiles, a head of 32 channels, 16-byte aligned
// tensors).  A block's run adds into each row of the coarse levels many
// times (at the encoder about 18 and 26 times into levels 2 and 3), so
// each in-bounds corner of those levels writes an entry (row among the
// sorted levels' rows, weight: 6 bytes) into a slot of its own and counts
// its row by an integer add that returns nothing; a scan of the counts
// gives each row its place, a scatter puts the entries in row order (query
// of the run, weight), and one lane group sums a row's entries from the
// run's dout rows (kept in shared memory) and adds the sum into dvalue by
// one 16-byte vector atomic a lane: one add a row a block in place of one
// a corner, and no float atomic in shared memory.  The other levels add by vector atomics as above.  Blocks of
// MSDA_BWD16_SORT_THREADS threads, two to an SM, so that one block's
// scan, scatter and sums overlap the other's walk.  The scatter's integer
// atomics order a row's entries differently from run to run, as the
// float atomics order the adds.
// ---------------------------------------------------------------------------

#define MSDA_BWD16_SORT_THREADS 512

// of each sorted level: its first row among the sorted rows, and its first
// sample among a query's samples of the sorted levels
struct SortedLevels {
  int row[MSDA_MAX_LEVELS];
  int sample[MSDA_MAX_LEVELS];
};

__global__ void __launch_bounds__(MSDA_BWD16_SORT_THREADS, 2)
msda_bwd_bf16_sorted_kernel(
    const __nv_bfloat16* __restrict__ value, const float* __restrict__ loc,
    const float* __restrict__ aw, const float* __restrict__ dout,
    float* __restrict__ dvalue, float* __restrict__ dloc,
    float* __restrict__ daw, const int* __restrict__ order,
    const int* __restrict__ runs, const Levels lv, int n_levels,
    int n_points, int n_runs, int S, int Q, int M, int max_run,
    int sort_mask, const SortedLevels so, int rows, int sorted_samples) {
  constexpr int G = 8, D = 32;  // four channels a lane
  extern __shared__ float4 smem4[];
  char* base = reinterpret_cast<char*>(smem4);
  const __nv_bfloat16* sm = reinterpret_cast<const __nv_bfloat16*>(base);
  const int n_samples = n_levels * n_points;
  const int cap = max_run * sorted_samples * 4;
  // counts of the rows, then where each row's entries start (after the
  // scatter: where the next row's start)
  size_t at = msda_grad_start<__nv_bfloat16>(lv);
  int* off = reinterpret_cast<int*>(base + at);
  at += ((size_t)(rows + 1) * sizeof(int) + 15) / 16 * 16;
  float* sdout = reinterpret_cast<float*>(base + at);  // the run's dout
  at += (size_t)max_run * D * sizeof(float);
  // entries by corner (row, weight) and by row (query's place, weight)
  float* ent_w = reinterpret_cast<float*>(base + at);
  at += (size_t)cap * sizeof(float);
  float* sorted_w = reinterpret_cast<float*>(base + at);
  at += (size_t)cap * sizeof(float);
  unsigned short* ent_row = reinterpret_cast<unsigned short*>(base + at);
  at += (size_t)cap * sizeof(unsigned short);
  unsigned short* sorted_q = reinterpret_cast<unsigned short*>(base + at);
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
  const int group = warp * (32 / G) + (threadIdx.x & 31) / G;
  const int n_groups = (blockDim.x >> 5) * (32 / G);
  const int gl = threadIdx.x % G, c = gl * 4;
  // every lane of a warp takes every trip (the shuffles need them all)
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
    for (int s0 = 0; s0 < n_samples; s0 += G) {
      const int si = s0 + gl;
      float lx = 0.f, ly = 0.f, a = 0.f;
      if (si < n_samples) {
        const float2 xy = __ldg(reinterpret_cast<const float2*>(loc_q) + si);
        lx = xy.x, ly = xy.y;
        a = __ldg(aw_q + si);
      }
      const int l_own = min(si, n_samples - 1) / n_points;
      const SamplePlace own(lx, ly, lv.h[l_own], lv.w[l_own]);
      const int ns = min(G, n_samples - s0);
      float tot_w = 0.f, tot_x = 0.f, tot_y = 0.f;
#pragma unroll 1
      for (int j = 0; j < ns; ++j) {
        const float dx = __shfl_sync(0xffffffffu, own.dx, j, G);
        const float dy = __shfl_sync(0xffffffffu, own.dy, j, G);
        const int code = __shfl_sync(0xffffffffu, own.code, j, G);
        const float aj = __shfl_sync(0xffffffffu, a, j, G);
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
          if (!(live && cn.inb[k])) continue;
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
        // lane k of the group writes corner k's slot and counts its row
        if (sort && live && gl < 4) {
          int tok = cn.tok[0], in = cn.inb[0];
          float w = cn.cw[0];
#pragma unroll
          for (int k = 1; k < 4; ++k)
            if (gl == k) tok = cn.tok[k], in = cn.inb[k], w = cn.cw[k];
          const int e = (ql * sorted_samples + so.sample[l] + s0 + j -
                         l * n_points) * 4 + gl;
          const int row = so.row[l] + tok;
          ent_row[e] = in ? (unsigned short)row : (unsigned short)0xffffu;
          ent_w[e] = aj * w;
          if (in) atomicAdd(off + row, 1);
        }
        pw = group_sum<G>(pw);
        px = group_sum<G>(px);
        py = group_sum<G>(py);
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
  // the counts' exclusive scan: a contiguous share of rows a thread
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
    int place = part[warp] + inc - mine;
    for (int i = lo; i < hi; ++i) {
      const int n = off[i];
      off[i] = place;
      place += n;
    }
    if (threadIdx.x == 0) off[rows] = part[32];
  }
  __syncthreads();
  // the entries into row order, each with its query's place in the run
  const int slots = count * sorted_samples * 4;
  for (int e = threadIdx.x; e < slots; e += blockDim.x) {
    const int row = ent_row[e];
    if (row == 0xffff) continue;
    const int to = atomicAdd(off + row, 1);
    sorted_q[to] = (unsigned short)(e / (sorted_samples * 4));
    sorted_w[to] = ent_w[e];
  }
  __syncthreads();
  // one lane group a row: its entries summed, one add into dvalue
  for (int r = group; r < rows; r += n_groups) {
    const int lo = r ? off[r - 1] : 0, hi = off[r];
    if (lo == hi) continue;
    Row<4> acc;
#pragma unroll
    for (int e = 0; e < 4; ++e) acc.v[e] = 0.f;
#pragma unroll 4
    for (int i = lo; i < hi; ++i) {
      const float coef = sorted_w[i];
      const float4 gg =
          *reinterpret_cast<const float4*>(sdout + sorted_q[i] * D + c);
      acc.v[0] += coef * gg.x, acc.v[1] += coef * gg.y;
      acc.v[2] += coef * gg.z, acc.v[3] += coef * gg.w;
    }
    int l = 0;
    while (l + 1 < n_levels && (!((sort_mask >> l) & 1) ||
                                r >= so.row[l] + lv.h[l] * lv.w[l]))
      ++l;
    acc.add_global(dv_bm + (size_t)(lv.start[l] + r - so.row[l]) * M * D +
                   c);
  }
}

// The sorted form's launch: dvalue zeroed, then one launch; the arguments
// as msda_bwd_any's.  Refuses what it was not built for.
static int launch_bwd_bf16_sorted(const void* value, const void* loc,
                                  const void* aw, const void* dout,
                                  void* dvalue, void* dloc, void* daw,
                                  const void* order, const void* runs,
                                  const void* level_hw, int n_levels,
                                  int n_runs, int max_run, int resident_mask,
                                  int sort_mask, int B, int S, int Q, int M,
                                  int D, int P, cudaStream_t st) {
  static size_t granted = 48 * 1024;
  Levels lv = {};
  if (n_levels < 1 || n_levels > MSDA_MAX_LEVELS || P < 1 || D != 32 ||
      !order || !runs || n_runs < 1 || max_run < 1 ||
      (sort_mask >> n_levels) || !msda_aligned16(value) ||
      !msda_aligned16(dout) || !msda_aligned16(dvalue) ||
      ((reinterpret_cast<size_t>(loc) | reinterpret_cast<size_t>(dloc)) &
       7) ||
      msda_fill_levels(&lv, static_cast<const int*>(level_hw), n_levels,
                       resident_mask, 0, D) != S ||
      (long long)B * M * n_runs > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  SortedLevels so = {};
  int rows = 0, sorted_samples = 0;
  for (int l = 0; l < n_levels; ++l) {
    so.row[l] = rows;
    so.sample[l] = sorted_samples;
    if ((sort_mask >> l) & 1) rows += lv.h[l] * lv.w[l], sorted_samples += P;
  }
  // rows and places fit the entries' 16-bit fields
  if (rows >= 0xffff || max_run >= 0xffff) return (int)cudaErrorInvalidValue;
  const size_t cap = (size_t)max_run * sorted_samples * 4;
  const size_t smem = msda_grad_start<__nv_bfloat16>(lv) +
                      ((size_t)(rows + 1) * sizeof(int) + 15) / 16 * 16 +
                      (size_t)max_run * D * sizeof(float) +
                      cap * 2 * (sizeof(float) + sizeof(unsigned short));
  cudaError_t err =
      msda_grant_smem(msda_bwd_bf16_sorted_kernel, smem, &granted);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemsetAsync(dvalue, 0, (size_t)B * S * M * D * sizeof(float), st);
  if (err != cudaSuccess) return (int)err;
  msda_bwd_bf16_sorted_kernel<<<(unsigned)((long long)B * M * n_runs),
                                MSDA_BWD16_SORT_THREADS, smem, st>>>(
      static_cast<const __nv_bfloat16*>(value),
      static_cast<const float*>(loc), static_cast<const float*>(aw),
      static_cast<const float*>(dout), static_cast<float*>(dvalue),
      static_cast<float*>(dloc), static_cast<float*>(daw),
      static_cast<const int*>(order), static_cast<const int*>(runs), lv,
      n_levels, P, n_runs, S, Q, M, max_run, sort_mask, so, rows,
      sorted_samples);
  return (int)cudaGetLastError();
}

// Zeroes dvalue and launches on `stream`; returns the first CUDA error
// (0 on success).  level_hw is a host array of n_levels (H, W) pairs; order
// (Q,) and runs (n_runs, 2) are int32 device arrays, the block map of
// msda_common.cuh, and max_run the longest run's length; bit l of
// resident_mask puts level l of value into shared memory, bit l of grad_mask
// (resident levels only) its share of dvalue.  msda_bwd takes a float32
// value, msda_bwd_bf16 a bfloat16 one; every other tensor is float32.
extern "C" int msda_bwd(const void* value, const void* loc, const void* aw,
                        const void* dout, void* dvalue, void* dloc, void* daw,
                        const void* order, const void* runs,
                        const void* level_hw, int n_levels, int n_runs,
                        int max_run, int resident_mask, int grad_mask, int B,
                        int S, int Q, int M, int D, int P, void* stream) {
  return msda_bwd_any<float>(value, loc, aw, dout, dvalue, dloc, daw, order,
                             runs, level_hw, n_levels, n_runs, max_run,
                             resident_mask, grad_mask, B, S, Q, M, D, P,
                             stream);
}

// The bf16 form: the levels of sort_mask summed in the block where the
// plan gives them and the tensors allow (a head of 32 channels, 16-byte
// aligned, queries in tiles; that path reads no grad_mask), else the walk
// above.
extern "C" int msda_bwd_bf16(const void* value, const void* loc,
                             const void* aw, const void* dout, void* dvalue,
                             void* dloc, void* daw, const void* order,
                             const void* runs, const void* level_hw,
                             int n_levels, int n_runs, int max_run,
                             int resident_mask, int grad_mask, int sort_mask,
                             int B, int S, int Q, int M, int D, int P,
                             void* stream) {
  if (sort_mask && D == 32 && order && runs && msda_aligned16(value) &&
      msda_aligned16(dout) && msda_aligned16(dvalue)) {
    return launch_bwd_bf16_sorted(value, loc, aw, dout, dvalue, dloc, daw,
                                  order, runs, level_hw, n_levels, n_runs,
                                  max_run, resident_mask, sort_mask, B, S, Q,
                                  M, D, P, static_cast<cudaStream_t>(stream));
  }
  return msda_bwd_any<__nv_bfloat16>(value, loc, aw, dout, dvalue, dloc, daw,
                                     order, runs, level_hw, n_levels, n_runs,
                                     max_run, resident_mask, grad_mask, B, S,
                                     Q, M, D, P, stream);
}
