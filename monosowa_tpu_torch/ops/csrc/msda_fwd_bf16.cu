// Multi-scale deformable attention (MSDA) forward on bf16 value rows, CUDA
// C++ for sm_90a.
//
//   out[b, q, m, :] = sum over (l, p) of aw[b, q, m, l, p]
//                     * bilinear(value_l[b, :, m, :], loc[b, q, m, l, p])
//
// with grid_sample semantics (align_corners=False, zero padding: pixel
// x = loc_x * W_l - 0.5).  value (B, S, M, D) bfloat16, loc (B, Q, M, L, P,
// 2), aw (B, Q, M, L, P) and out (B, Q, M * D) float32, all contiguous.
// Every product and sum is float32.  Entry point msda_fwd_bf16; the float32
// value's kernel is msda_fwd.cu.
//
// Replaces the TPU kernels ms_deform_attn_mxu
// (monosowa_tpu/ops/msda_mxu.py:378, kernel _fwd_kernel :238) on the bf16
// quad rows it reads (:235) and ms_deform_attn_pallas
// (monosowa_tpu/ops/msda_pallas.py:71) on its bf16 value (:98).  Those
// fetch corners through one-hot matrix products or a scalar loop over a
// copy of the pyramid in fast memory, because a TPU serialises gathers.
// Here rows are gathered directly.
//
// What bounds it.  At the encoder's shape (B=2, Q=S=10,200, M=8, D=32,
// L=P=4) the compulsory bytes (value's touched rows at 2 bytes a channel,
// loc and aw read once, out written once) are about 62.7 MB, 19 us at
// 3.35 TB/s; the arithmetic is 10 us at 67 TFLOP/s.  The corner reads are
// 64-byte rows, 0.53 GB a launch, nearly all L1 hits once neighbouring
// queries share a block, so the launch is bound by the latency of the
// corner loads an SM has in flight, not by bytes.  At the decoder (Q = 50
// at serving, 550 in training, 800 under DN-DETR) a launch has only 800 to
// 12,800 (query, head) pairs: its time is one lane's chain of 16 samples x
// 4 dependent corner loads, with a few percent of the card busy.
//
// Design (the block map and the resident levels are msda_common.cuh's, as
// the float32 kernel reads them; the lanes, the split and the block size
// come from ops/msda.py msda_plan):
// * Four lanes share a query of 32 channels, eight bf16 channels (one
//   16-byte load) a lane; the sum stays in the lane's registers, and a bf16
//   becomes float32 by a shift, with no conversion instruction.
// * A lane issues a sample's four corner loads before it sums any of them,
//   from registers that hold the raw 16-byte rows.
// * A launch too small to fill the card gives a query `split` lane groups
//   of one warp (up to 8: 32 lanes), each a contiguous share of its
//   samples; a butterfly of shuffles over the groups sums their partial
//   sums in a fixed order, so a run gives the same bits every time.  The
//   decoder's chain of 16 samples becomes 2 (Q = 50) or 8 (Q = 550, 800).
// * Blocks of at most 512 threads at 64 registers, two to an SM.
// Measured on an H100 against the float32 form's design run on bf16 rows
// (PERF.md): 16-byte lanes of sixteen channels, two samples' loads
// in flight a lane and smaller blocks were each slower at the encoder.
// D that is no multiple of 8, or a pointer off 16 bytes, takes the same
// kernel with one element a lane.

#include "msda_common.cuh"

// the launch bound; ops/msda.py FWD16_THREADS is the same number
#define MSDA_FWD16_THREADS 512

// A lane's VEC channels of one bf16 row, as loaded: 16 bytes for VEC = 8,
// one element for VEC = 1.
template <int VEC>
struct RawRow;

template <>
struct RawRow<8> {
  uint4 u;
  __device__ __forceinline__ void zero() { u = make_uint4(0, 0, 0, 0); }
  __device__ __forceinline__ void load_global(const __nv_bfloat16* p) {
    u = __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ void load_shared(const __nv_bfloat16* p) {
    u = *reinterpret_cast<const uint4*>(p);
  }
  // acc[e] += w * channel e (a bf16 is the high half of its float32)
  __device__ __forceinline__ void fma_into(float (&acc)[8], float w) const {
    const unsigned v[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      acc[2 * i] += w * __uint_as_float(v[i] << 16);
      acc[2 * i + 1] += w * __uint_as_float(v[i] & 0xffff0000u);
    }
  }
};

template <>
struct RawRow<1> {
  unsigned short u;
  __device__ __forceinline__ void zero() { u = 0; }
  __device__ __forceinline__ void load_global(const __nv_bfloat16* p) {
    u = __ldg(reinterpret_cast<const unsigned short*>(p));
  }
  __device__ __forceinline__ void load_shared(const __nv_bfloat16* p) {
    u = *reinterpret_cast<const unsigned short*>(p);
  }
  __device__ __forceinline__ void fma_into(float (&acc)[1], float w) const {
    acc[0] += w * __uint_as_float((unsigned)u << 16);
  }
};

// The corner rows of one sample: raw rows and their weights aj * w_corner
// (zero, and no load, where a corner is out of bounds or `use` is false).
template <int VEC, bool RES>
__device__ __forceinline__ void gather(RawRow<VEC> (&raw)[4], float (&wk)[4],
                                       const Corners& cn, float aj, bool use,
                                       const __nv_bfloat16* rows,
                                       int stride) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const bool hit = use && cn.inb[k];
    wk[k] = hit ? aj * cn.cw[k] : 0.f;
    if (!hit)
      raw[k].zero();
    else if (RES)
      raw[k].load_shared(rows + cn.tok[k] * stride);
    else
      raw[k].load_global(rows + (size_t)cn.tok[k] * stride);
  }
}

template <int VEC, int G>
__global__ void __launch_bounds__(MSDA_FWD16_THREADS, 2)
msda_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ value,
                     const float* __restrict__ loc,
                     const float* __restrict__ aw, float* __restrict__ out,
                     const int* __restrict__ order,
                     const int* __restrict__ runs, const Levels lv,
                     int n_levels, int n_points, int n_runs, int max_run,
                     int split, int S, int Q, int M, int D) {
  extern __shared__ float4 smem4[];
  __nv_bfloat16* sm = reinterpret_cast<__nv_bfloat16*>(smem4);

  const int run = blockIdx.x % n_runs;
  const int bm = blockIdx.x / n_runs;
  const int b = bm / M, m = bm - b * M;
  // without a block map: index order, max_run queries a block
  const int first = runs ? runs[2 * run] : run * max_run;
  const int count = runs ? runs[2 * run + 1] : min(max_run, Q - first);
  const int n_samples = n_levels * n_points;
  const __nv_bfloat16* v_bm = value + ((size_t)b * S * M + m) * D;

  if (lv.resident_mask) {
    msda_stage_levels<__nv_bfloat16, VEC == 1 ? 1 : 8>(sm, value, lv,
                                                       n_levels, S, M, D, b,
                                                       m);
    __syncthreads();
  }

  // lane = (slot * split + part) * G + gl: `split` groups of G lanes share
  // the query of a slot, part p taking samples [p * chunk, (p + 1) * chunk)
  const int span = G * split;
  const int slot = threadIdx.x / span;
  const int part = (threadIdx.x / G) % split;
  const int gl = threadIdx.x % G;
  const int n_slots = blockDim.x / span;
  const int chunk = (n_samples + split - 1) / split;
  const int s_first = part * chunk;
  const int s_end = min(n_samples, s_first + chunk);
  // every lane of a warp takes every trip (the shuffles need them all); a
  // slot past the end of the run reads the first query's samples, gathers
  // nothing and writes nothing
  for (int i0 = 0; i0 < count; i0 += n_slots) {
    const bool live = i0 + slot < count;
    const int at = first + (live ? i0 + slot : 0);
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
      for (int k0 = 0; k0 < chunk; k0 += G) {
        // lane gl loads sample s_first + k0 + gl of its part; a sample past
        // the part's end is placed off every level
        const int si = s_first + k0 + gl;
        float lx = -4.f, ly = -4.f, a = 0.f;
        if (si < s_end) {
          const float2 xy =
              __ldg(reinterpret_cast<const float2*>(loc_q) + si);
          lx = xy.x, ly = xy.y;
          a = __ldg(aw_q + si);
        }
        const int l_own = min(si, n_samples - 1) / n_points;
        const SamplePlace own(lx, ly, lv.h[l_own], lv.w[l_own]);
        const int ns = min(G, chunk - k0);  // the same for the whole warp
#pragma unroll 1
        for (int j = 0; j < ns; ++j) {
          const float dx = __shfl_sync(0xffffffffu, own.dx, j, G);
          const float dy = __shfl_sync(0xffffffffu, own.dy, j, G);
          const int code = __shfl_sync(0xffffffffu, own.code, j, G);
          const float aj = __shfl_sync(0xffffffffu, a, j, G);
          const int sj = s_first + k0 + j;
          const bool use = active && sj < s_end;
          const int l = min(sj, n_samples - 1) / n_points;
          const Corners cn(dx, dy, code, lv.w[l]);
          // the four corner loads go out before any of them is summed
          RawRow<VEC> raw[4];
          float wk[4];
          if ((lv.resident_mask >> l) & 1)
            gather<VEC, true>(raw, wk, cn, aj, use, sm + lv.sm_off[l] + c,
                              D);
          else
            gather<VEC, false>(raw, wk, cn, aj, use,
                               v_bm + (size_t)lv.start[l] * M * D + c,
                               M * D);
#pragma unroll
          for (int k = 0; k < 4; ++k) raw[k].fma_into(acc, wk[k]);
        }
      }
      // the parts' partial sums, in the same order in every lane
      for (int off = G; off < span; off <<= 1)
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], off);
      if (active && part == 0) {
        Row<VEC> r;
#pragma unroll
        for (int e = 0; e < VEC; ++e) r.v[e] = acc[e];
        r.store(out + bqm * D + c);
      }
    }
  }
}

template <int VEC, int G>
static int launch_fwd_bf16(const __nv_bfloat16* value, const float* loc,
                           const float* aw, float* out, const int* order,
                           const int* runs, const Levels& lv, int n_levels,
                           int P, int n_runs, int max_run, int split,
                           int threads, int B, int S, int Q, int M, int D,
                           cudaStream_t st) {
  static size_t granted = 48 * 1024;
  const size_t smem = (size_t)lv.resident_elems * sizeof(__nv_bfloat16);
  cudaError_t err = msda_grant_smem(msda_fwd_bf16_kernel<VEC, G>,
                                    smem, &granted);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)B * M * n_runs;
  msda_fwd_bf16_kernel<VEC, G><<<(unsigned)blocks, threads, smem, st>>>(
          value, loc, aw, out, order, runs, lv, n_levels, P, n_runs, max_run,
          split, S, Q, M, D);
  return (int)cudaGetLastError();
}

// Launches on `stream` and returns the first CUDA error (0 on success).
// level_hw is a host array of n_levels (H, W) pairs; order (Q,) and runs
// (n_runs, 2) are int32 device arrays, the block map of msda_common.cuh,
// and max_run the longest run's length; bit l of resident_mask puts level l
// into shared memory.  split (1, 2, 4 or 8) lane groups share a query and
// `threads` (a multiple of 32, at most MSDA_FWD16_THREADS) make a block:
// ops/msda.py msda_plan.  value is bfloat16; loc, aw and out float32.
extern "C" int msda_fwd_bf16(const void* value, const void* loc,
                             const void* aw, void* out, const void* order,
                             const void* runs, const void* level_hw,
                             int n_levels, int n_runs, int max_run,
                             int resident_mask, int split, int threads,
                             int B, int S, int Q, int M, int D, int P,
                             void* stream) {
  if (n_levels < 1 || n_levels > MSDA_MAX_LEVELS || P < 1 || D < 1 ||
      n_runs < 0 || max_run < 0 || threads < 32 || threads % 32 ||
      threads > MSDA_FWD16_THREADS || (split & (split - 1)) || split < 1 ||
      split > 8)
    return (int)cudaErrorInvalidValue;
  Levels lv = {};
  if (msda_fill_levels(&lv, static_cast<const int*>(level_hw), n_levels,
                       resident_mask, 0, D) != S)
    return (int)cudaErrorInvalidValue;
  if ((long long)B * Q * M == 0 || n_runs == 0) return 0;
  if ((long long)B * M * n_runs > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  // loc is read as float2: rows of 2 * L * P floats from an 8-byte base
  if (reinterpret_cast<size_t>(loc) & 7) return (int)cudaErrorInvalidValue;
  const auto* v = static_cast<const __nv_bfloat16*>(value);
  const auto* lo = static_cast<const float*>(loc);
  const auto* a = static_cast<const float*>(aw);
  auto* o = static_cast<float*>(out);
  const auto* ord = static_cast<const int*>(order);
  const auto* rn = static_cast<const int*>(runs);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // 16-byte lanes of 8 channels where the rows allow them, else one
  // element a lane (and as many groups a query as a warp then holds)
  const int vec = (D % 8 == 0 && msda_aligned16(value) &&
                   msda_aligned16(out))
                      ? 8
                      : 1;
  const int g = msda_group_lanes(D, vec);
  split = min(split, 32 / g);
#define MSDA_FWD16_CASE(V, G_)                                              \
  if (vec == V && g == G_)                                                  \
    return launch_fwd_bf16<V, G_>(v, lo, a, o, ord, rn, lv, n_levels, P,    \
                                  n_runs, max_run, split, threads, B, S, Q, \
                                  M, D, st);
  MSDA_FWD16_CASE(8, 4)
  MSDA_FWD16_CASE(8, 8)
  MSDA_FWD16_CASE(8, 16)
  MSDA_FWD16_CASE(8, 32)
  MSDA_FWD16_CASE(1, 8)
  MSDA_FWD16_CASE(1, 16)
  MSDA_FWD16_CASE(1, 32)
#undef MSDA_FWD16_CASE
  return (int)cudaErrorInvalidValue;
}
