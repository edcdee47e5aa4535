// Multi-scale deformable attention (MSDA) forward, CUDA C++ for sm_90a.
//
//   out[b, q, m, :] = sum over (l, p) of aw[b, q, m, l, p]
//                     * bilinear(value_l[b, :, m, :], loc[b, q, m, l, p])
//
// with grid_sample semantics (align_corners=False, zero padding: pixel
// x = loc_x * W_l - 0.5).  value (B, S, M, D), loc (B, Q, M, L, P, 2), aw
// (B, Q, M, L, P), out (B, Q, M * D), all float32 and contiguous (entry
// point msda_fwd).  The kernel is a template over value's type, built here
// for float only: a bfloat16 value has a kernel of its own,
// msda_fwd_bf16.cu.
//
// Replaces the TPU kernels ms_deform_attn_mxu
// (monosowa_tpu/ops/msda_mxu.py:378, kernel _fwd_kernel :238) and
// ms_deform_attn_pallas (monosowa_tpu/ops/msda_pallas.py:71).  Those fetch
// corners through quad rows and one-hot matrix products, or a scalar loop
// over a copy of the pyramid in fast memory, because a TPU serialises
// gathers; both read value in bf16 (msda_mxu.py:235, msda_pallas.py:98)
// and sum in float32.  This kernel gathers float32 rows directly.
//
// What bounds it: memory traffic, and not the compulsory bytes.  value, loc
// and aw read once and out written once are about 73 MB at the encoder's
// shape (B=2, Q=S=10,200, M=8, D=32, L=P=4), about 22 us at 3.35 TB/s; the
// arithmetic, about 0.7 GFLOP, is 10 us at 67 TFLOP/s.  But every in-bounds
// corner reads one 128-byte row, 1.07 GB a launch: 51 reads of each of
// value's rows.  Taken from L2 with a 4-byte load a lane, they cost 0.55 ms
// on an H100; the design's work is to keep the re-reads inside the SM and
// to issue fewer, wider loads.
//
// Design (the block map, the lane groups and the resident levels are set
// out in msda_common.cuh):
// * A block owns one (image, head) and a run of queries that are neighbours
//   in the image (two 8 x 8 tiles of the pyramid's own tokens in the
//   encoder), so consecutive queries read nearly the same rows of the same
//   head and L1 serves the re-reads.  Short runs, many blocks: 1,312 blocks
//   at the encoder's shape, sized so that the card's SMs end together.
// * G lanes share a query, 16 bytes a lane (8 lanes for D = 32): a warp
//   has four queries in flight per load
//   instruction, and the channel sum stays in the lane's registers: no
//   reduction across lanes at all.  D that is no multiple of the lane's
//   channels, or a pointer off 16 bytes, takes the same kernel with one
//   element a lane.
// * Lane gl of a group loads sample gl's location and weight (coalesced)
//   and works out its place on its level once (floor, fractions, bounds);
//   four shuffles within the group hand that round, and each lane rebuilds
//   the four weights from the fractions.
// * Coarse levels can be copied whole into shared memory first (which, is
//   decided from the shapes in ops/msda.py; with none the kernel uses no
//   shared memory).  On the H100 this pays little in the forward once L1
//   has the locality above: the encoder keeps its coarsest level (120 rows,
//   15,360 bytes a head) there, a quarter of all corner reads; keeping the
//   next level too (76,800 bytes) needs runs so long that the blocks no
//   longer balance, and measured slower.
// On an H100 the encoder's launch takes 0.135 ms and consumes corner rows
// at about 8 TB/s, most of them L1 hits (chip_smoke.py prints both).

#include "msda_common.cuh"

#define MSDA_FWD_THREADS 512

template <typename T, int VEC, bool RES>
__device__ __forceinline__ void fwd_sample(
    float (&acc)[VEC], const Corners& cn, float aj,
    const T* __restrict__ rows, int row_stride) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (cn.inb[k]) {
      ValueRow<T, VEC> r;
      if (RES)
        r.load_shared(rows + cn.tok[k] * row_stride);
      else
        r.load_global(rows + (size_t)cn.tok[k] * row_stride);
      const float wk = aj * cn.cw[k];
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[e] += wk * r.v[e];
    }
  }
}

template <typename T, int VEC, int G>
__global__ void __launch_bounds__(MSDA_FWD_THREADS, 2)
msda_fwd_kernel(const T* __restrict__ value, const float* __restrict__ loc,
                const float* __restrict__ aw, float* __restrict__ out,
                const int* __restrict__ order, const int* __restrict__ runs,
                const Levels lv, int n_levels, int n_points, int n_runs,
                int max_run, int S, int Q, int M, int D) {
  extern __shared__ float4 smem4[];
  T* sm = reinterpret_cast<T*>(smem4);

  const int run = blockIdx.x % n_runs;
  const int bm = blockIdx.x / n_runs;
  const int b = bm / M, m = bm - b * M;
  // without a block map: index order, max_run queries a block
  const int first = runs ? runs[2 * run] : run * max_run;
  const int count = runs ? runs[2 * run + 1] : min(max_run, Q - first);
  const int n_samples = n_levels * n_points;
  const T* v_bm = value + ((size_t)b * S * M + m) * D;

  if (lv.resident_mask) {
    msda_stage_levels<T, VEC>(sm, value, lv, n_levels, S, M, D, b, m);
    __syncthreads();
  }

  const int group = threadIdx.x / G, gl = threadIdx.x % G;
  const int n_groups = blockDim.x / G;
  // every lane of a warp takes every trip (the shuffles need them all); a
  // group past the end of the run reads the first query's samples, gathers
  // nothing and writes nothing
  for (int i0 = 0; i0 < count; i0 += n_groups) {
    const bool live = i0 + group < count;
    const int at = first + (live ? i0 + group : 0);
    const int q = order ? order[at] : at;
    const size_t bqm = ((size_t)b * Q + q) * M + m;
    const float* loc_q = loc + bqm * n_samples * 2;
    const float* aw_q = aw + bqm * n_samples;

    for (int c0 = 0; c0 < D; c0 += G * VEC) {
      const int c = c0 + gl * VEC;
      const bool active = live && c < D;
      float acc[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
      for (int s0 = 0; s0 < n_samples; s0 += G) {
        const int si = s0 + gl;
        float lx = 0.f, ly = 0.f, a = 0.f;
        if (si < n_samples) {
          const float2 xy =
              __ldg(reinterpret_cast<const float2*>(loc_q) + si);
          lx = xy.x, ly = xy.y;
          a = __ldg(aw_q + si);
        }
        const int l_own = min(si, n_samples - 1) / n_points;
        const SamplePlace own(lx, ly, lv.h[l_own], lv.w[l_own]);
        const int ns = min(G, n_samples - s0);
#pragma unroll 1  // measured: unrolling the sample loop is slower
        for (int j = 0; j < ns; ++j) {
          const float dx = __shfl_sync(0xffffffffu, own.dx, j, G);
          const float dy = __shfl_sync(0xffffffffu, own.dy, j, G);
          const int code = __shfl_sync(0xffffffffu, own.code, j, G);
          const float aj = __shfl_sync(0xffffffffu, a, j, G);
          if (!active) continue;
          const int l = (s0 + j) / n_points;
          const Corners cn(dx, dy, code, lv.w[l]);
          if ((lv.resident_mask >> l) & 1)
            fwd_sample<T, VEC, true>(acc, cn, aj, sm + lv.sm_off[l] + c, D);
          else
            fwd_sample<T, VEC, false>(
                acc, cn, aj, v_bm + (size_t)lv.start[l] * M * D + c, M * D);
        }
      }
      if (active) {
        Row<VEC> r;
#pragma unroll
        for (int e = 0; e < VEC; ++e) r.v[e] = acc[e];
        r.store(out + bqm * D + c);
      }
    }
  }
}

template <typename T, int VEC, int G>
static int launch_fwd(const T* value, const float* loc, const float* aw,
                      float* out, const int* order, const int* runs,
                      const Levels& lv, int n_levels, int P, int n_runs,
                      int max_run, int B, int S, int Q, int M, int D,
                      cudaStream_t st) {
  static size_t granted = 48 * 1024;
  const size_t smem = (size_t)lv.resident_elems * sizeof(T);
  cudaError_t err =
      msda_grant_smem(msda_fwd_kernel<T, VEC, G>, smem, &granted);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)B * M * n_runs;
  const int threads = msda_block_threads(max_run, G, MSDA_FWD_THREADS);
  msda_fwd_kernel<T, VEC, G><<<(unsigned)blocks, threads, smem, st>>>(
      value, loc, aw, out, order, runs, lv, n_levels, P, n_runs, max_run,
      S, Q, M, D);
  return (int)cudaGetLastError();
}

template <typename T>
static int msda_fwd_any(const void* value, const void* loc, const void* aw,
                        void* out, const void* order, const void* runs,
                        const void* level_hw, int n_levels, int n_runs,
                        int max_run, int resident_mask, int B, int S, int Q,
                        int M, int D, int P, void* stream) {
  if (n_levels < 1 || n_levels > MSDA_MAX_LEVELS || P < 1 || D < 1 ||
      n_runs < 0 || max_run < 0)
    return (int)cudaErrorInvalidValue;
  Levels lv = {};
  if (msda_fill_levels(&lv, static_cast<const int*>(level_hw), n_levels,
                       resident_mask, 0, D) != S)
    return (int)cudaErrorInvalidValue;
  if ((long long)B * Q * M == 0 || n_runs == 0) return 0;
  if ((long long)B * M * n_runs > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const T* v = static_cast<const T*>(value);
  const float* lo = static_cast<const float*>(loc);
  const float* a = static_cast<const float*>(aw);
  float* o = static_cast<float*>(out);
  const int* ord = static_cast<const int*>(order);
  const int* rn = static_cast<const int*>(runs);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // 16-byte lanes of value where the rows allow them, else one element a
  // lane
  constexpr int LANE = 16 / sizeof(T);
  const int vec = (D % LANE == 0 && msda_aligned16(value) &&
                   msda_aligned16(out))
                      ? LANE
                      : 1;
  // loc is read as float2: rows of 2 * L * P floats from an 8-byte base
  if (reinterpret_cast<size_t>(loc) & 7) return (int)cudaErrorInvalidValue;
  const int g = msda_group_lanes(D, vec);
#define MSDA_FWD_CASE(V, G_)                                              \
  if (vec == V && g == G_)                                                \
    return launch_fwd<T, V, G_>(v, lo, a, o, ord, rn, lv, n_levels, P,    \
                                n_runs, max_run, B, S, Q, M, D, st);
  MSDA_FWD_CASE(LANE, 8)
  MSDA_FWD_CASE(LANE, 16)
  MSDA_FWD_CASE(LANE, 32)
  MSDA_FWD_CASE(1, 8)
  MSDA_FWD_CASE(1, 16)
  MSDA_FWD_CASE(1, 32)
#undef MSDA_FWD_CASE
  return (int)cudaErrorInvalidValue;
}

// Launches on `stream` and returns the first CUDA error (0 on success).
// level_hw is a host array of n_levels (H, W) pairs; order (Q,) and runs
// (n_runs, 2) are int32 device arrays, the block map of msda_common.cuh,
// and max_run the longest run's length; bit l of resident_mask puts level l
// into shared memory.  Every tensor is float32.
extern "C" int msda_fwd(const void* value, const void* loc, const void* aw,
                        void* out, const void* order, const void* runs,
                        const void* level_hw, int n_levels, int n_runs,
                        int max_run, int resident_mask, int B, int S, int Q,
                        int M, int D, int P, void* stream) {
  return msda_fwd_any<float>(value, loc, aw, out, order, runs, level_hw,
                             n_levels, n_runs, max_run, resident_mask, B, S,
                             Q, M, D, P, stream);
}
