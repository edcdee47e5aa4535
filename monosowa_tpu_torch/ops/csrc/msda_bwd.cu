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
// value (B, S, M, D), loc (B, Q, M, L, P, 2), aw (B, Q, M, L, P), dout,
// dvalue (B, S, M, D), dloc, daw: float32 and contiguous.
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
//   of daw and dloc.  D that is no multiple of 4, or a pointer off 16
//   bytes, takes the same kernel with one float a lane.
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
template <int VEC, int G, Mode MODE>
__device__ __forceinline__ void bwd_sample(
    float& pw, float& px, float& py, const Corners& cn, float aj,
    const float (&g)[VEC], const float* __restrict__ rows, int row_stride,
    float* drows, int drow_stride) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (cn.inb[k]) {
      Row<VEC> r, d;
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

template <int VEC, int G>
__global__ void __launch_bounds__(MSDA_BWD_THREADS, 1)
msda_bwd_kernel(const float* __restrict__ value, const float* __restrict__ loc,
                const float* __restrict__ aw, const float* __restrict__ dout,
                float* __restrict__ dvalue, float* __restrict__ dloc,
                float* __restrict__ daw, const int* __restrict__ order,
                const int* __restrict__ runs, const Levels lv, int n_levels,
                int n_points, int n_runs, int max_run, int split, int S,
                int Q, int M, int D) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);  // value's resident levels
  float* smd = sm + lv.resident_floats;         // dvalue's grad levels

  const int run = blockIdx.x % n_runs;
  const int bm = blockIdx.x / n_runs;
  const int b = bm / M, m = bm - b * M;
  // without a block map: index order, max_run queries a block
  const int first = runs ? runs[2 * run] : run * max_run;
  const int count = runs ? runs[2 * run + 1] : min(max_run, Q - first);
  const int n_samples = n_levels * n_points;
  const size_t bm_off = ((size_t)b * S * M + m) * D;
  const float* v_bm = value + bm_off;
  float* dv_bm = dvalue + bm_off;

  if (lv.resident_mask) {
    msda_stage_levels<VEC>(sm, value, lv, n_levels, S, M, D, b, m);
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
              bwd_sample<VEC, G, RES_GRAD>(pw, px, py, cn, aj, g,
                                           sm + lv.sm_off[l] + c, D,
                                           smd + lv.grad_off[l] + c, D);
            else if ((lv.resident_mask >> l) & 1)
              bwd_sample<VEC, G, RES>(pw, px, py, cn, aj, g,
                                      sm + lv.sm_off[l] + c, D,
                                      dv_bm + lvl_off, M * D);
            else
              bwd_sample<VEC, G, DIRECT>(pw, px, py, cn, aj, g,
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

template <int VEC, int G>
static int launch_bwd(const float* value, const float* loc, const float* aw,
                      const float* dout, float* dvalue, float* dloc,
                      float* daw, const int* order, const int* runs,
                      const Levels& lv, int n_levels, int P, int n_runs,
                      int max_run, int B, int S, int Q, int M, int D,
                      cudaStream_t st) {
  static size_t granted = 48 * 1024;
  const size_t smem =
      ((size_t)lv.resident_floats + lv.grad_floats) * sizeof(float);
  cudaError_t err = msda_grant_smem(msda_bwd_kernel<VEC, G>, smem, &granted);
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
  msda_bwd_kernel<VEC, G><<<(unsigned)blocks, threads, smem, st>>>(
      value, loc, aw, dout, dvalue, dloc, daw, order, runs, lv, n_levels, P,
      n_runs, max_run, split, S, Q, M, D);
  return (int)cudaGetLastError();
}

// Zeroes dvalue and launches on `stream`; returns the first CUDA error
// (0 on success).  level_hw is a host array of n_levels (H, W) pairs; order
// (Q,) and runs (n_runs, 2) are int32 device arrays, the block map of
// msda_common.cuh, and max_run the longest run's length; bit l of
// resident_mask puts level l of value into shared memory, bit l of grad_mask
// (resident levels only) its share of dvalue.
extern "C" int msda_bwd(const void* value, const void* loc, const void* aw,
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
  const float* v = static_cast<const float*>(value);
  const float* lo = static_cast<const float*>(loc);
  const float* a = static_cast<const float*>(aw);
  const float* g = static_cast<const float*>(dout);
  float* dv = static_cast<float*>(dvalue);
  float* dl = static_cast<float*>(dloc);
  float* da = static_cast<float*>(daw);
  const int* ord = static_cast<const int*>(order);
  const int* rn = static_cast<const int*>(runs);
  const int vec = (D % 4 == 0 && msda_aligned16(value) &&
                   msda_aligned16(dout) && msda_aligned16(dvalue))
                      ? 4
                      : 1;
  const int gw = msda_group_lanes(D, vec);
#define MSDA_BWD_CASE(V, G_)                                                 \
  if (vec == V && gw == G_)                                                  \
    return launch_bwd<V, G_>(v, lo, a, g, dv, dl, da, ord, rn, lv, n_levels, \
                             P, n_runs, max_run, B, S, Q, M, D, st);
  MSDA_BWD_CASE(4, 8)
  MSDA_BWD_CASE(4, 16)
  MSDA_BWD_CASE(4, 32)
  MSDA_BWD_CASE(1, 8)
  MSDA_BWD_CASE(1, 16)
  MSDA_BWD_CASE(1, 32)
#undef MSDA_BWD_CASE
  return (int)cudaErrorInvalidValue;
}
