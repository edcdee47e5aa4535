// Windowed row fetch, CUDA C++ for sm_90a, in two forms of one function.
//
//   For block i of `bq` consecutive output rows: lo = the least index of the
//   block that is >= 0 (2^30 if none); base = clip(lo / block, 0,
//   max(T / block - k_win, 0)); the block's window is bank rows
//   [base * block, (base + k_win) * block).
//   out[n, :] = float32(bank[idx[n], :]) if idx[n] lies in its block's
//   window and below T, else 0 (a negative index is in no window).
//
// bank (T, D) bfloat16 or float32, idx (N,) int32, out (N, D) float32, all
// contiguous; D a multiple of 8, so that every row starts on 16 bytes.  The
// last block may hold fewer than bq rows.
//
// Replaces the TPU kernels of tools/bench_gather_micro.py (`run` :61, bodies
// _kernel_gather :26 and _kernel_onehot :45): a micro-benchmark of the row
// gathers that multi-scale deformable attention makes, indices clustered
// per block like the sampling points around an anchor.  There the two bodies
// compare a sublane gather with a one-hot matrix product over the window's
// chunks, both out of VMEM.  A GPU gathers rows natively, so the question
// here is another: rows straight from global memory / L2 (`direct`, what
// msda_fwd.cu does per corner) against the window staged through shared
// memory chunk by chunk and rows picked out of it (`staged`).
//
// What bounds it: bytes.  Nothing is computed but the conversion; at the
// tool's shape (N = T = 10240, D = 128, bf16) idx, bank and out are 7.9 MB,
// 2.4 us at 3.35 TB/s, below a launch; at N = 163,200 rows 86.3 MB, 25.8 us.
//
// Design.  One thread block per block of bq rows, 8 warps.  The block-wide
// lo is a shared-memory reduction (warp shuffles, then one slot per warp).
// A warp owns a row at a time and a lane 4 consecutive channels: an 8-byte
// (bf16) or 16-byte (f32) load and a 16-byte store, neighbouring lanes on
// neighbouring addresses.  bf16 -> f32 is exact (a shift), so both forms
// equal the plain version bit for bit.
//   direct: every row is read where it lies.
//   staged: the whole window (k_win * block rows, 256 KB at the tool's
//   defaults) is more than the 227 KB a block may have, so one chunk of
//   `block` rows is staged at a time (64 KB or 128 KB of dynamic shared
//   memory), as the TPU bodies walk their k_win chunks: a plain cooperative
//   16-byte copy, a barrier, the rows of this chunk picked out of shared
//   memory, a barrier.  Rows outside the window are written as zeros first.
//   Every output row is written exactly once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define RF_THREADS 256
#define RF_WARPS (RF_THREADS / 32)
#define RF_NONE (1 << 30)

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// four bf16 values -> float32: a bf16 is the upper half of a float32
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(raw.x << 16),
                     __uint_as_float(raw.x & 0xffff0000u),
                     __uint_as_float(raw.y << 16),
                     __uint_as_float(raw.y & 0xffff0000u));
}

// Copies the block's `rows` indices into idx_s and returns the window's
// first chunk, base.  Every thread of the block calls it.
__device__ __forceinline__ int window_base(const int* __restrict__ idx,
                                           int* idx_s, int rows, int T,
                                           int block, int k_win) {
  __shared__ int warp_lo[RF_WARPS];
  __shared__ int base_s;
  int lo = RF_NONE;
  for (int r = threadIdx.x; r < rows; r += RF_THREADS) {
    const int i = idx[r];
    idx_s[r] = i;
    if (i >= 0) lo = min(lo, i);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
  if ((threadIdx.x & 31) == 0) warp_lo[threadIdx.x >> 5] = lo;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < RF_WARPS; ++w) lo = min(lo, warp_lo[w]);
    base_s = min(max(lo / block, 0), max(T / block - k_win, 0));
  }
  __syncthreads();
  return base_s;
}

template <typename E>
__global__ void __launch_bounds__(RF_THREADS)
row_fetch_direct_kernel(const E* __restrict__ bank,
                        const int* __restrict__ idx, float* __restrict__ out,
                        int N, int T, int D, int bq, int block, int k_win) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* idx_s = reinterpret_cast<int*>(smem);
  const size_t row0 = (size_t)blockIdx.x * bq;
  const int rows = (int)min((size_t)bq, (size_t)N - row0);
  const int base = window_base(idx + row0, idx_s, rows, T, block, k_win);
  const long long w_lo = (long long)base * block;
  const long long w_hi = min((long long)(base + k_win) * block, (long long)T);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < rows; r += RF_WARPS) {
    const int i = idx_s[r];
    const bool in = i >= w_lo && i < w_hi;
    const E* src = bank + (size_t)(in ? i : 0) * D;
    float* dst = out + (row0 + r) * D;
    for (int c = lane * 4; c < D; c += 128) {
      const float4 v = in ? load4(src + c) : make_float4(0.f, 0.f, 0.f, 0.f);
      *reinterpret_cast<float4*>(dst + c) = v;
    }
  }
}

template <typename E>
__global__ void __launch_bounds__(RF_THREADS)
row_fetch_staged_kernel(const E* __restrict__ bank,
                        const int* __restrict__ idx, float* __restrict__ out,
                        int N, int T, int D, int bq, int block, int k_win) {
  extern __shared__ __align__(16) unsigned char smem[];
  E* chunk = reinterpret_cast<E*>(smem);                  // block x D
  int* idx_s = reinterpret_cast<int*>(smem + (size_t)block * D * sizeof(E));
  const size_t row0 = (size_t)blockIdx.x * bq;
  const int rows = (int)min((size_t)bq, (size_t)N - row0);
  const int base = window_base(idx + row0, idx_s, rows, T, block, k_win);
  const long long w_lo = (long long)base * block;
  const long long w_hi = min((long long)(base + k_win) * block, (long long)T);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // rows outside the window: zeros
  for (int r = warp; r < rows; r += RF_WARPS) {
    const int i = idx_s[r];
    if (i >= w_lo && i < w_hi) continue;
    float* dst = out + (row0 + r) * D;
    for (int c = lane * 4; c < D; c += 128)
      *reinterpret_cast<float4*>(dst + c) = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  for (int k = 0; k < k_win; ++k) {
    const long long w0 = w_lo + (long long)k * block;
    if (w0 >= w_hi) break;
    const int n_rows = (int)min((long long)block, w_hi - w0);
    // stage the chunk: 16 bytes a thread, neighbouring threads on
    // neighbouring addresses
    const uint4* src16 =
        reinterpret_cast<const uint4*>(bank + (size_t)w0 * D);
    uint4* dst16 = reinterpret_cast<uint4*>(chunk);
    const int n16 = (int)((size_t)n_rows * D * sizeof(E) / 16);
    for (int j = threadIdx.x; j < n16; j += RF_THREADS) dst16[j] = src16[j];
    __syncthreads();
    for (int r = warp; r < rows; r += RF_WARPS) {
      const long long il = (long long)idx_s[r] - w0;
      if (il < 0 || il >= n_rows) continue;
      const E* src = chunk + (size_t)il * D;
      float* dst = out + (row0 + r) * D;
      for (int c = lane * 4; c < D; c += 128)
        *reinterpret_cast<float4*>(dst + c) = load4(src + c);
    }
    __syncthreads();
  }
}

static bool bad_args(int N, int T, int D, int bq, int block, int k_win) {
  return N < 0 || T < 1 || D < 8 || D % 8 != 0 || bq < 1 || block < 1 ||
         k_win < 1;
}

template <typename E>
static int launch_direct(const void* bank, const void* idx, void* out, int N,
                         int T, int D, int bq, int block, int k_win,
                         void* stream) {
  const size_t smem = (size_t)bq * sizeof(int);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)(((size_t)N + bq - 1) / bq);
  row_fetch_direct_kernel<E><<<grid, RF_THREADS, smem,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const E*>(bank), static_cast<const int*>(idx),
      static_cast<float*>(out), N, T, D, bq, block, k_win);
  return (int)cudaGetLastError();
}

template <typename E>
static int launch_staged(const void* bank, const void* idx, void* out, int N,
                         int T, int D, int bq, int block, int k_win,
                         void* stream) {
  const size_t smem =
      (size_t)block * D * sizeof(E) + (size_t)bq * sizeof(int);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        row_fetch_staged_kernel<E>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const unsigned grid = (unsigned)(((size_t)N + bq - 1) / bq);
  row_fetch_staged_kernel<E><<<grid, RF_THREADS, smem,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const E*>(bank), static_cast<const int*>(idx),
      static_cast<float*>(out), N, T, D, bq, block, k_win);
  return (int)cudaGetLastError();
}

// Both entry points launch on `stream` and return cudaGetLastError() (0 on
// success).  bank_is_bf16: 1 for a bfloat16 bank, 0 for float32.
extern "C" int row_fetch_direct(const void* bank, const void* idx, void* out,
                                int N, int T, int D, int bq, int block,
                                int k_win, int bank_is_bf16, void* stream) {
  if (bad_args(N, T, D, bq, block, k_win)) return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  return bank_is_bf16
             ? launch_direct<__nv_bfloat16>(bank, idx, out, N, T, D, bq,
                                            block, k_win, stream)
             : launch_direct<float>(bank, idx, out, N, T, D, bq, block,
                                    k_win, stream);
}

extern "C" int row_fetch_staged(const void* bank, const void* idx, void* out,
                                int N, int T, int D, int bq, int block,
                                int k_win, int bank_is_bf16, void* stream) {
  if (bad_args(N, T, D, bq, block, k_win)) return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  return bank_is_bf16
             ? launch_staged<__nv_bfloat16>(bank, idx, out, N, T, D, bq,
                                            block, k_win, stream)
             : launch_staged<float>(bank, idx, out, N, T, D, bq, block,
                                    k_win, stream);
}
