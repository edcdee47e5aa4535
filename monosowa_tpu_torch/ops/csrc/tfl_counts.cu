// Exact two-way template-fitting coverage counts, CUDA C++ for sm_90a.
//
//   t_count[b, p] = number of the T posed template points templates[b, p]
//                   with a valid scan point of car b at squared distance
//                   < r2,
//   s_count[b, p] = number of the valid scan points of car b with a point
//                   of templates[b, p] at squared distance < r2.
//
// scan (B, S, 3) float32, mask (B, S) one byte per point (0 = padding),
// templates (B, P, T, 3) float32, t_count and s_count (B, P) float32, all
// contiguous.  The wrapper divides by T and by the number of valid points.
//
// Replaces the TPU kernel binary_both_way_counts_pallas
// (monosowa_tpu/ops/tfl_pallas.py:67, kernel _kernel :28).  That one walks a
// (P, t_tiles) grid in order, holds a (256, S) distance tile and four (1, S)
// scan planes in VMEM and carries a running column-min across the grid steps
// of a pose.  Blocks on a GPU run in no order and share nothing, so here one
// block owns one (b, p) and the grid step becomes a loop inside the block.
//
// What bounds it: operations.  At the fit's fine pass (B = 48, P = 360,
// T = 1000, S = 2048) the compulsory bytes are 208 MB (0.06 ms at
// 3.35 TB/s) while the 35.4 G pairs take 8 float32 operations each
// (3 subtractions, 3 products, 2 sums), 4.2 ms at 67 TFLOP/s; the compare
// and the two flag updates per pair come on top.
//
// Design.  min(d2) < r2 holds exactly when some d2 < r2, so neither min is
// kept: a template point is covered once any pair hits, and so is a scan
// point.  The block compacts the car's valid scan points into shared memory
// as float4 (the order does not matter for an "any"), so a masked point
// costs nothing and one 16-byte broadcast load serves a scan point.  Each
// thread keeps TPT template points in registers, which divides the shared
// loads per pair by TPT, sweeps the staged scan once, ORs its points' hits
// into registers and sets the scan point's flag in shared memory when any
// of them hit (every writer stores the same 1).  Counts are sums of flags:
// deterministic.
//
// d2 is ((dx*dx + dy*dy) + dz*dz) with every product and sum rounded to
// float32 on its own (no fused multiply-add), the arithmetic of the plain
// version: one pair that flips at the threshold moves a count by one.

#include <cuda_runtime.h>

#define TFL_THREADS 256
#define TFL_TPT 4   // template points per thread

__global__ void __launch_bounds__(TFL_THREADS)
tfl_counts_kernel(const float* __restrict__ scan,
                  const unsigned char* __restrict__ mask,
                  const float* __restrict__ templates,
                  float* __restrict__ t_count, float* __restrict__ s_count,
                  int S, int P, int T, float r2) {
  extern __shared__ float4 smem[];          // S staged points, then S flags
  float4* pts = smem;
  unsigned char* s_hit = reinterpret_cast<unsigned char*>(smem + S);
  __shared__ int n_valid, t_hits, s_hits;

  const int p = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  if (tid == 0) { n_valid = 0; t_hits = 0; s_hits = 0; }
  __syncthreads();

  const float* scan_b = scan + (size_t)b * S * 3;
  const unsigned char* mask_b = mask + (size_t)b * S;
  for (int j = tid; j < S; j += TFL_THREADS) {
    s_hit[j] = 0;
    if (mask_b[j]) {
      const int slot = atomicAdd(&n_valid, 1);
      pts[slot] = make_float4(scan_b[3 * j], scan_b[3 * j + 1],
                              scan_b[3 * j + 2], 0.f);
    }
  }
  __syncthreads();
  const int n = n_valid;

  const float* tmpl = templates + ((size_t)b * P + p) * (size_t)T * 3;
  int my_t_hits = 0;
  for (int t0 = 0; t0 < T; t0 += TFL_THREADS * TFL_TPT) {
    float tx[TFL_TPT], ty[TFL_TPT], tz[TFL_TPT];
    bool hit[TFL_TPT];
#pragma unroll
    for (int k = 0; k < TFL_TPT; ++k) {
      const int t = t0 + k * TFL_THREADS + tid;
      hit[k] = false;
      // a slot past the end repeats the last point and is not counted
      const int tc = min(t, T - 1);
      tx[k] = tmpl[3 * tc];
      ty[k] = tmpl[3 * tc + 1];
      tz[k] = tmpl[3 * tc + 2];
    }
    for (int j = 0; j < n; ++j) {
      const float4 q = pts[j];
      bool any = false;
#pragma unroll
      for (int k = 0; k < TFL_TPT; ++k) {
        const float dx = tx[k] - q.x, dy = ty[k] - q.y, dz = tz[k] - q.z;
        const float d2 = __fadd_rn(
            __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
            __fmul_rn(dz, dz));
        const bool h = d2 < r2;
        hit[k] |= h;
        any |= h;
      }
      if (any) s_hit[j] = 1;
    }
#pragma unroll
    for (int k = 0; k < TFL_TPT; ++k)
      if (hit[k] && t0 + k * TFL_THREADS + tid < T) ++my_t_hits;
  }
  if (my_t_hits) atomicAdd(&t_hits, my_t_hits);
  __syncthreads();

  int my_s_hits = 0;
  for (int j = tid; j < n; j += TFL_THREADS) my_s_hits += s_hit[j];
  if (my_s_hits) atomicAdd(&s_hits, my_s_hits);
  __syncthreads();
  if (tid == 0) {
    t_count[(size_t)b * P + p] = (float)t_hits;
    s_count[(size_t)b * P + p] = (float)s_hits;
  }
}

// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int tfl_counts(const void* scan, const void* mask,
                          const void* templates, void* t_count,
                          void* s_count, int B, int S, int P, int T,
                          float r2, void* stream) {
  if (B < 0 || S < 0 || P < 0 || T < 1 || B > 65535)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || P == 0) return 0;
  const size_t smem = (size_t)S * (sizeof(float4) + 1);
  if (smem > 48 * 1024) {
    if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(
        tfl_counts_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  tfl_counts_kernel<<<dim3((unsigned)P, (unsigned)B), TFL_THREADS, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(scan),
      static_cast<const unsigned char*>(mask),
      static_cast<const float*>(templates), static_cast<float*>(t_count),
      static_cast<float*>(s_count), S, P, T, r2);
  return (int)cudaGetLastError();
}
