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
// last block may hold fewer than bq rows.  ("Block" above is the function's
// group of bq rows; a thread block is called a CTA below.)
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
// 2.4 us at 3.35 TB/s; at N = 163,200 rows 86.8 MB, 25.9 us.  A short launch
// is bound by latency first: what matters is how many bytes are in flight.
//
// Design.  The row loop, shared by both forms: a row is D * sizeof(E) / 16
// chunks of 16 bytes; the CTA numbers (row, chunk) pairs of its rows in row
// order and thread t takes pairs t, t + threads, ..., RF_UNROLL of them at
// once, all loads issued before any store: with bf16 at D = 128 a warp
// instruction reads 2 rows, and at 16 rows a CTA each warp has 4 in flight
// (8, at 32 rows a CTA, measured slower).  A bf16 chunk becomes 32 bytes of
// float32 (the conversion is a shift, so both forms equal the plain version
// bit for bit), written with streaming stores (the output is written once
// and not read here).
//   direct: each group of bq rows is split over ceil(bq / RF_ROWS_PER_CTA)
//   CTAs of 128 threads (16 CTAs of 16 rows at bq = 256), so that a short
//   call fills the 132 SMs: 640 CTAs at N = 10,240 where one CTA a group
//   gave 40.  Every CTA of a group reads the group's bq indices (1 KB) and
//   reduces its window itself.  16 rows a CTA and 4 chunks a thread were
//   the fastest at both of the tool's sizes of those measured (8 to 64
//   rows, 2 to 8 chunks; PERF.md, Findings).
//   staged: one CTA of 256 threads a group.  The whole window (k_win *
//   block rows, 256 KB at the tool's defaults) is more than the 227 KB a
//   CTA may have, so one chunk of `block` rows is staged at a time (64 KB or
//   128 KB of dynamic shared memory), as the TPU bodies walk their k_win
//   chunks: a plain cooperative 16-byte copy, a barrier, the rows of this
//   chunk picked out of shared memory by the row loop, a barrier.  Rows
//   outside the window are written as zeros first.  Every output row is
//   written exactly once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define RF_DIRECT_THREADS 128
#define RF_STAGED_THREADS 256
#define RF_UNROLL 4
#define RF_ROWS_PER_CTA 16   // direct: at most this many output rows a CTA
#define RF_NONE (1 << 30)

// one 16-byte chunk of a bank row -> float32, streamed to dst
__device__ __forceinline__ void store_chunk(float* dst, uint4 raw, float) {
  __stcs(reinterpret_cast<float4*>(dst),
         make_float4(__uint_as_float(raw.x), __uint_as_float(raw.y),
                     __uint_as_float(raw.z), __uint_as_float(raw.w)));
}

// eight bf16 values -> float32: a bf16 is the upper half of a float32
__device__ __forceinline__ void store_chunk(float* dst, uint4 raw,
                                            __nv_bfloat16) {
  float4* d4 = reinterpret_cast<float4*>(dst);
  __stcs(d4, make_float4(__uint_as_float(raw.x << 16),
                         __uint_as_float(raw.x & 0xffff0000u),
                         __uint_as_float(raw.y << 16),
                         __uint_as_float(raw.y & 0xffff0000u)));
  __stcs(d4 + 1, make_float4(__uint_as_float(raw.z << 16),
                             __uint_as_float(raw.z & 0xffff0000u),
                             __uint_as_float(raw.w << 16),
                             __uint_as_float(raw.w & 0xffff0000u)));
}

// The first row of the group's window, from the group's `rows` indices;
// copies indices [keep0, keep0 + n_keep) of the group into idx_s.  Every
// thread of the CTA calls it.
template <int THREADS>
__device__ __forceinline__ int window_base(const int* __restrict__ idx,
                                           int* idx_s, int rows, int keep0,
                                           int n_keep, int T, int block,
                                           int k_win) {
  __shared__ int warp_lo[THREADS / 32];
  __shared__ int base_s;
  int lo = RF_NONE;
  for (int r = threadIdx.x; r < rows; r += THREADS) {
    const int i = idx[r];
    if (r >= keep0 && r < keep0 + n_keep) idx_s[r - keep0] = i;
    if (i >= 0) lo = min(lo, i);
  }
  lo = __reduce_min_sync(0xffffffffu, lo);
  if ((threadIdx.x & 31) == 0) warp_lo[threadIdx.x >> 5] = lo;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < THREADS / 32; ++w) lo = min(lo, warp_lo[w]);
    base_s = min(max(lo / block, 0), max(T / block - k_win, 0));
  }
  __syncthreads();
  return base_s;
}

// The row loop over rows [0, n_rows) of the CTA, row r's bank index
// idx_s[r].  what(i): 0 leaves the row alone, 1 copies row src_row(i) of
// `src` (16-byte chunks), 2 writes zeros; the row goes to out_rows + r * D.
template <typename E, int THREADS, typename What, typename Src>
__device__ __forceinline__ void copy_rows(const uint4* __restrict__ src,
                                          const int* idx_s, int n_rows,
                                          int D, float* out_rows, What what,
                                          Src src_row) {
  constexpr int CE = 16 / sizeof(E);       // elements of a chunk
  const int chunks = D / CE;
  const int n_items = n_rows * chunks;
  for (int i0 = 0; i0 < n_items; i0 += THREADS * RF_UNROLL) {
    uint4 v[RF_UNROLL];
    int row[RF_UNROLL], ch[RF_UNROLL], op[RF_UNROLL];
#pragma unroll
    for (int u = 0; u < RF_UNROLL; ++u) {
      const int item = i0 + u * THREADS + threadIdx.x;
      op[u] = 0;
      row[u] = item / chunks;
      ch[u] = item - row[u] * chunks;
      v[u] = make_uint4(0u, 0u, 0u, 0u);
      if (item < n_items) {
        const int i = idx_s[row[u]];
        op[u] = what(i);
        if (op[u] == 1) v[u] = src[(size_t)src_row(i) * chunks + ch[u]];
      }
    }
#pragma unroll
    for (int u = 0; u < RF_UNROLL; ++u)
      if (op[u])
        store_chunk(out_rows + (size_t)row[u] * D + ch[u] * CE, v[u], E());
  }
}

template <typename E>
__global__ void __launch_bounds__(RF_DIRECT_THREADS)
row_fetch_direct_kernel(const E* __restrict__ bank,
                        const int* __restrict__ idx, float* __restrict__ out,
                        int N, int T, int D, int bq, int block, int k_win,
                        int split) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* idx_s = reinterpret_cast<int*>(smem);             // rows of this CTA
  const int per_cta = (bq + split - 1) / split;
  const size_t group = blockIdx.x / split;
  const int part = blockIdx.x - (int)group * split;
  const size_t row0 = group * bq;
  const int rows = (int)min((size_t)bq, (size_t)N - row0);
  const int keep0 = part * per_cta;
  const int n_keep = max(min(per_cta, rows - keep0), 0);
  const int base = window_base<RF_DIRECT_THREADS>(idx + row0, idx_s, rows,
                                                  keep0, n_keep, T, block,
                                                  k_win);
  const long long w_lo = (long long)base * block;
  const long long w_hi = min((long long)(base + k_win) * block, (long long)T);
  // in the window: the bank row; outside: zeros
  copy_rows<E, RF_DIRECT_THREADS>(
      reinterpret_cast<const uint4*>(bank), idx_s, n_keep, D,
      out + (row0 + keep0) * D,
      [=](int i) { return i >= w_lo && i < w_hi ? 1 : 2; },
      [](int i) { return i; });
}

template <typename E>
__global__ void __launch_bounds__(RF_STAGED_THREADS)
row_fetch_staged_kernel(const E* __restrict__ bank,
                        const int* __restrict__ idx, float* __restrict__ out,
                        int N, int T, int D, int bq, int block, int k_win) {
  extern __shared__ __align__(16) unsigned char smem[];
  E* chunk = reinterpret_cast<E*>(smem);                  // block x D
  int* idx_s = reinterpret_cast<int*>(smem + (size_t)block * D * sizeof(E));
  const size_t row0 = (size_t)blockIdx.x * bq;
  const int rows = (int)min((size_t)bq, (size_t)N - row0);
  const int base = window_base<RF_STAGED_THREADS>(idx + row0, idx_s, rows, 0,
                                                  rows, T, block, k_win);
  const long long w_lo = (long long)base * block;
  const long long w_hi = min((long long)(base + k_win) * block, (long long)T);
  float* out_rows = out + row0 * D;
  // rows outside the window: zeros
  copy_rows<E, RF_STAGED_THREADS>(
      nullptr, idx_s, rows, D, out_rows,
      [=](int i) { return i >= w_lo && i < w_hi ? 0 : 2; },
      [](int) { return 0; });

  const uint4* chunk16 = reinterpret_cast<const uint4*>(chunk);
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
    for (int j = threadIdx.x; j < n16; j += RF_STAGED_THREADS)
      dst16[j] = src16[j];
    __syncthreads();
    copy_rows<E, RF_STAGED_THREADS>(
        chunk16, idx_s, rows, D, out_rows,
        [=](int i) { return i >= w0 && i < w0 + n_rows ? 1 : 0; },
        [=](int i) { return (int)(i - w0); });
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
  const int split = (bq + RF_ROWS_PER_CTA - 1) / RF_ROWS_PER_CTA;
  const size_t smem = (size_t)((bq + split - 1) / split) * sizeof(int);
  const size_t groups = ((size_t)N + bq - 1) / bq;
  if (groups * split > 0x7fffffffu) return (int)cudaErrorInvalidValue;
  row_fetch_direct_kernel<E><<<(unsigned)(groups * split), RF_DIRECT_THREADS,
                               smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const E*>(bank), static_cast<const int*>(idx),
      static_cast<float*>(out), N, T, D, bq, block, k_win, split);
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
  row_fetch_staged_kernel<E><<<grid, RF_STAGED_THREADS, smem,
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
