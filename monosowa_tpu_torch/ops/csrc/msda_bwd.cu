// Multi-scale deformable attention (MSDA) backward, CUDA C++ for sm_90a.
//
// For out[b, q, m, :] = sum over (l, p) of aw[b, q, m, l, p]
//                       * bilinear(value_l[b, :, m, :], loc[b, q, m, l, p])
// (grid_sample semantics, align_corners=False, zero padding: pixel
// x = loc_x * W_l - 0.5) and the incoming gradient dout (B, Q, M * D), one
// launch computes all three input gradients:
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
// transposed one-hot products into a VMEM-resident bank, because a TPU
// serialises gathers and scatters.  On Hopper a direct gather and a float32
// atomicAdd are the natural forms, and the fold happens in registers.
//
// What bounds it: memory traffic, as in the forward.  The compulsory bytes
// (loc, aw and dout read once, the value rows that in-bounds corners touch
// read once, dvalue, dloc and daw written once) are about 125 MB at the
// encoder's shape (B=2, Q=S=10,200, M=8, D=32, L=P=4), about 37 us at
// 3.35 TB/s; the arithmetic, two multiply-adds per channel and corner, is
// about 1.1 GFLOP, 16 us at the 67 TFLOP/s float32 rate.  The real traffic is L2: every in-bounds corner reads one
// 128-byte value row and adds into one 128-byte dvalue row, about 2 GB per
// encoder launch against value and dvalue (21 MB each) that fit in the
// 50 MB L2 together.
//
// Design: the forward's warp layout.  One warp per (b, q, m), lane =
// channel, so each corner is one coalesced row read and one coalesced row of
// atomics.  Lane i loads sample i's location and weight; each sample is then
// broadcast with shuffles and every lane computes the same corner geometry,
// with the forward's explicit round-to-nearest multiply and subtract, so the
// kernel picks the same corners as the plain version even on the integer
// pixel grid.  Each lane keeps its channel's share of the three folded dots;
// a butterfly reduction over the warp sums them, and the lane that owns the
// sample keeps the totals until one coalesced write of daw and dloc.
//
// dvalue is zeroed on the stream first, then summed with float32 atomicAdd.
// The order of those additions is set by the scheduler and changes from run
// to run, so dvalue's last bits do too; the plain version (an index_add_
// scatter) sums in another order again.  dloc and daw have no atomics and
// are the same in every run.

#include <cuda_runtime.h>

#define MSDA_MAX_LEVELS 8

struct Levels {
  int h[MSDA_MAX_LEVELS];
  int w[MSDA_MAX_LEVELS];
  int start[MSDA_MAX_LEVELS];
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(256)
msda_bwd_kernel(const float* __restrict__ value, const float* __restrict__ loc,
                const float* __restrict__ aw, const float* __restrict__ dout,
                float* __restrict__ dvalue, float* __restrict__ dloc,
                float* __restrict__ daw, const Levels lv, int n_levels,
                int n_points, int S, int Q, int M, int D, long long n_warps) {
  const long long warp =
      (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (warp >= n_warps) return;  // whole warps only: n_warps is in warps

  const int m = (int)(warp % M);
  const long long b = warp / M / Q;
  const int n_samples = n_levels * n_points;
  const float* loc_w = loc + warp * n_samples * 2;
  const float* aw_w = aw + warp * n_samples;
  const float* dout_w = dout + warp * D;
  const float* v_b = value + b * S * M * D;
  float* dv_b = dvalue + b * S * M * D;
  float* dloc_w = dloc + warp * n_samples * 2;
  float* daw_w = daw + warp * n_samples;

  for (int s0 = 0; s0 < n_samples; s0 += 32) {
    const int si = s0 + lane;
    float lx = 0.f, ly = 0.f, a = 0.f;
    if (si < n_samples) {
      lx = loc_w[2 * si];
      ly = loc_w[2 * si + 1];
      a = aw_w[si];
    }
    const int ns = min(32, n_samples - s0);
    // the totals of sample si, kept by its lane
    float tot_w = 0.f, tot_x = 0.f, tot_y = 0.f;
    for (int c0 = 0; c0 < D; c0 += 32) {
      const int c = c0 + lane;
      const bool active = c < D;
      const float g = active ? __ldg(dout_w + c) : 0.f;
      for (int j = 0; j < ns; ++j) {
        const float ux = __shfl_sync(0xffffffffu, lx, j);
        const float uy = __shfl_sync(0xffffffffu, ly, j);
        const float aj = __shfl_sync(0xffffffffu, a, j);
        const int l = (s0 + j) / n_points;
        const int h = lv.h[l], w = lv.w[l];
        // the same roundings as the plain version: no fused multiply-add
        const float x = __fsub_rn(__fmul_rn(ux, (float)w), 0.5f);
        const float y = __fsub_rn(__fmul_rn(uy, (float)h), 0.5f);
        const float x0 = floorf(x), y0 = floorf(y);
        const float dx = x - x0, dy = y - y0;
        const float cxs[4] = {x0, x0 + 1.f, x0, x0 + 1.f};
        const float cys[4] = {y0, y0, y0 + 1.f, y0 + 1.f};
        const float cws[4] = {(1.f - dx) * (1.f - dy), dx * (1.f - dy),
                              (1.f - dx) * dy, dx * dy};
        const float dwxs[4] = {-(1.f - dy), 1.f - dy, -dy, dy};
        const float dwys[4] = {-(1.f - dx), -dx, 1.f - dx, dx};
        float pw = 0.f, px = 0.f, py = 0.f;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float cx = cxs[k], cy = cys[k];
          if (cx >= 0.f && cx < (float)w && cy >= 0.f && cy < (float)h &&
              active) {
            const long long row =
                ((long long)(lv.start[l] + (int)cy * w + (int)cx) * M + m) *
                    D + c;
            const float vg = __ldg(v_b + row) * g;
            pw += cws[k] * vg;
            px += dwxs[k] * vg;
            py += dwys[k] * vg;
            atomicAdd(dv_b + row, (aj * cws[k]) * g);
          }
        }
        pw = warp_sum(pw);
        px = warp_sum(px);
        py = warp_sum(py);
        if (lane == j) {
          tot_w += pw;
          tot_x += px;
          tot_y += py;
        }
      }
    }
    if (si < n_samples) {
      const int l = si / n_points;
      daw_w[si] = tot_w;
      dloc_w[2 * si] = a * (float)lv.w[l] * tot_x;
      dloc_w[2 * si + 1] = a * (float)lv.h[l] * tot_y;
    }
  }
}

// Zeroes dvalue and launches on `stream`; returns the first CUDA error
// (0 on success).  level_hw is a host array of n_levels (H, W) pairs.
extern "C" int msda_bwd(const void* value, const void* loc, const void* aw,
                        const void* dout, void* dvalue, void* dloc, void* daw,
                        const void* level_hw, int n_levels, int B, int S,
                        int Q, int M, int D, int P, void* stream) {
  if (n_levels < 1 || n_levels > MSDA_MAX_LEVELS || P < 1 || D < 1)
    return (int)cudaErrorInvalidValue;
  Levels lv = {};
  const int* hw = static_cast<const int*>(level_hw);
  int start = 0;
  for (int l = 0; l < n_levels; ++l) {
    lv.h[l] = hw[2 * l];
    lv.w[l] = hw[2 * l + 1];
    lv.start[l] = start;
    start += lv.h[l] * lv.w[l];
  }
  if (start != S) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(
      dvalue, 0, (size_t)B * S * M * D * sizeof(float), st);
  if (err != cudaSuccess) return (int)err;
  const long long n_warps = (long long)B * Q * M;
  if (n_warps == 0) return 0;
  const int threads = 256;
  const long long blocks = (n_warps + threads / 32 - 1) / (threads / 32);
  msda_bwd_kernel<<<(unsigned)blocks, threads, 0, st>>>(
      static_cast<const float*>(value), static_cast<const float*>(loc),
      static_cast<const float*>(aw), static_cast<const float*>(dout),
      static_cast<float*>(dvalue), static_cast<float*>(dloc),
      static_cast<float*>(daw), lv, n_levels, P, S, Q, M, D, n_warps);
  return (int)cudaGetLastError();
}
