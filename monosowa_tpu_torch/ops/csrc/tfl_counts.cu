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
// of a pose: it tests every pair.  Blocks on a GPU run in no order and share
// nothing, so here one block owns one (b, p).
//
// What bounds it.  Testing every pair (the design this one replaced) issues
// at least ~10 instructions a pair: 1.0 ms at the fit's rescore shape
// however well it is scheduled.  r is 0.2 m and a car is metres wide, so a
// template point has a few tens of scan points within reach of the ~1,700;
// this design tests only the pairs in neighbouring cells of a grid whose
// edge is at least r, about 1% of them at the fit's shapes.  The least time
// is then the bytes' (the templates read once, 0.007 ms at the rescore);
// what keeps the kernel ~20x above it is the walk below: shared-memory
// loads of scattered slots, and lanes of a warp whose ranges differ.
//
// Design: a cell list in shared memory, built per block.
//   1. A block reduction gives the box of the block's finite template
//      points; thread 0 derives the grid from it (cell edge c, origin lo,
//      cells per axis n; the rule below).
//   2. The car's valid scan points whose cell lies inside the grid are
//      counting-sorted by cell into shared memory as float4: a histogram
//      with shared atomics, an exclusive scan, a scatter through per-cell
//      cursors.  After the scatter cell[k] is the first slot of cell k and
//      cell[k + 1] its end.  The w lane of a sorted point is its hit flag.
//   3. Each template point walks its 3 x 3 neighbouring rows of cells; a
//      row's 3 cells along the innermost axis are one contiguous range of
//      sorted points, so 9 ranges, not 27 cells.  Hits are ORed into the
//      point's flag and into the slot's flag (every writer stores the same
//      1).  The counts are sums of flags: deterministic whatever the order
//      inside a cell.  During the walk a thread loads a whole float4 slot
//      while others may store its w lane: a race on w alone, and benign.
//      The walk reads only x, y and z, which nothing writes after the
//      scatter's barrier; w is read only after the walk's barrier, when
//      every store to it (all of the same 1) has landed.
//   512 threads a block and at most 8,192 cells (the wrapper's cap), 3
//   blocks an SM (40 registers): the fastest on the card of 256 threads,
//   4,096 or 12,000 cells, other block counts and a walk that streams the
//   9 ranges as one (PERF.md, Findings).  The walk takes ~3/4 of the time.
//
// The grid rule (mirrored, bit for bit, by ops/tfl.py cell_grid; the
// numbers come from the wrapper in a TflCellPlan):
//   u(x) = fl(fl(x - lo) * fl(1 / c)) per axis, cell = floor(u);
//   c starts at max(c_min, M * mag, e / (axis_max - 4)) with M the box's
//   largest |coordinate| and e its largest extent, and grows by `grow`
//   until every axis has at most axis_max cells and all of them at most
//   cell_cap; lo = min - fl(margin * c), n = floor(u(max)) + 2.
//   A template point's cell lies in [1, n - 2] on every axis: the top by
//   construction and monotone rounding, the bottom because
//   min - lo >= 1.5 c less the rounding of lo, at most 2^-24 M <= c / 64.
//
// Why no pair is lost.  A computed d2 < r2 implies fl(dx^2) <= d2 < r2 (sums
// of non-negative terms rounded to nearest never decrease), so |tx - qx| <
// sqrt(r2) (1 + 2^-22) on every axis.  c >= c_min = sqrt(r2) (1 + 2^-9),
// and u carries at most 2 (n + 1) 2^-23 <= 2.5e-4 of rounding at n <= 1024,
// so |u(tx) - u(qx)| < 1 and the scan point's cell is the template point's
// or a neighbour of it, inside [0, n - 1]: staged, and walked.
//   A point with a NaN or infinite coordinate hits nothing (its d2 is NaN or
// infinite): such template points take no part in the box or the walk,
// such scan points are never staged.  But the plain version takes minima,
// and a NaN d2 makes a minimum NaN: a template point with a NaN coordinate
// zeroes its pose's s_count, a valid scan point with one zeroes its car's
// t_count (an infinity makes NaN only against another infinity, in a row
// or column that cannot hit anyway).  The kernel keeps the two flags.  A
// box whose M exceeds mag_limit (2^100; far beyond any scene) is one cell
// holding every finite valid scan point: the all-pairs test, exact at any
// magnitude.
//
// d2 is ((dx*dx + dy*dy) + dz*dz) with every product and sum rounded to
// float32 on its own (no fused multiply-add), the arithmetic of the plain
// version: one pair that flips at the threshold moves a count by one.

#include <cuda_runtime.h>
#include <math.h>

#define TFL_THREADS 512
#define TFL_WARPS (TFL_THREADS / 32)
#define TFL_MIN_CTAS 3   // 64 KB of shared memory each at S = 2048
#define TFL_SMEM_LIMIT (227 * 1024)

// The launch numbers; ops/tfl.py TflCellPlan has the same fields in the
// same order.
struct TflCellPlan {
  float r2;          // squared radius, the float32 both versions compare to
  float c_min;       // least cell edge, sqrt(r2) (1 + 2^-9) rounded up
  float margin;      // lo = min - margin * c
  float grow;        // c grows by this factor until the grid fits
  float mag;         // c >= M * mag keeps lo's rounding under c / 64
  float mag_limit;   // beyond: one cell
  int cell_cap;      // cells the dynamic shared memory holds
  int axis_max;      // cells along one axis
};

// One block's grid.  mode 0: no finite template point; 1: the cell grid;
// 2: one cell.
struct Grid {
  float lo[3];
  float inv;
  int n[3];
  int mode;
};

__device__ __forceinline__ bool finite3(float x, float y, float z) {
  return isfinite(x) && isfinite(y) && isfinite(z);
}

__device__ __forceinline__ float cell_coord(float x, float lo, float inv) {
  return __fmul_rn(__fsub_rn(x, lo), inv);
}

// Thread 0: the grid of a box [mn, mx] of finite points (the rule above).
__device__ void make_grid(const float* mn, const float* mx,
                          const TflCellPlan& pl, Grid& g) {
  if (!(mn[0] <= mx[0])) {          // no finite template point
    g.mode = 0;
    return;
  }
  float m = 0.f, e = 0.f;
  for (int a = 0; a < 3; ++a) {
    m = fmaxf(m, fmaxf(fabsf(mn[a]), fabsf(mx[a])));
    e = fmaxf(e, __fsub_rn(mx[a], mn[a]));
  }
  if (!(m <= pl.mag_limit)) {
    g.mode = 2;
    for (int a = 0; a < 3; ++a) {
      g.lo[a] = 0.f;
      g.n[a] = 1;
    }
    g.inv = 0.f;
    return;
  }
  float c = fmaxf(pl.c_min, __fmul_rn(m, pl.mag));
  c = fmaxf(c, __fdiv_rn(e, (float)(pl.axis_max - 4)));
  for (;;) {
    const float off = __fmul_rn(c, pl.margin);
    const float inv = __frcp_rn(c);
    bool fits = true;
    for (int a = 0; a < 3; ++a) {
      g.lo[a] = __fsub_rn(mn[a], off);
      g.n[a] = (int)cell_coord(mx[a], g.lo[a], inv) + 2;
      fits = fits && g.n[a] <= pl.axis_max;
    }
    g.inv = inv;
    if (fits && g.n[0] * g.n[1] * g.n[2] <= pl.cell_cap) break;
    c = __fmul_rn(c, pl.grow);
  }
  g.mode = 1;
}

// The cell of a scan point, -1 if it lies outside the grid (or is not
// finite).  Float compares first: NaN and infinities fail them.
__device__ __forceinline__ int scan_cell(float x, float y, float z,
                                         const Grid& g) {
  if (g.mode == 2) return finite3(x, y, z) ? 0 : -1;
  const float ux = cell_coord(x, g.lo[0], g.inv);
  const float uy = cell_coord(y, g.lo[1], g.inv);
  const float uz = cell_coord(z, g.lo[2], g.inv);
  if (!(ux >= 0.f && ux < (float)g.n[0] && uy >= 0.f &&
        uy < (float)g.n[1] && uz >= 0.f && uz < (float)g.n[2]))
    return -1;
  return ((int)ux * g.n[1] + (int)uy) * g.n[2] + (int)uz;
}

// In place, a[0..n) -> its exclusive prefix sums.  Thread i takes K
// consecutive entries with K odd, so the 32 lanes of a warp fall on 32
// different banks.
__device__ void block_exclusive_scan(int* a, int n, int* warp_tot) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int k_per = ((n + TFL_THREADS - 1) / TFL_THREADS) | 1;
  const int base = tid * k_per;
  int sum = 0;
  for (int k = 0; k < k_per; ++k)
    if (base + k < n) sum += a[base + k];
  int incl = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) warp_tot[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int w = lane < TFL_WARPS ? warp_tot[lane] : 0;
    int wi = w;
#pragma unroll
    for (int o = 1; o < TFL_WARPS; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, wi, o);
      if (lane >= o) wi += v;
    }
    if (lane < TFL_WARPS) warp_tot[lane] = wi - w;
  }
  __syncthreads();
  int run = warp_tot[warp] + incl - sum;
  for (int k = 0; k < k_per; ++k)
    if (base + k < n) {
      const int v = a[base + k];
      a[base + k] = run;
      run += v;
    }
}

__global__ void __launch_bounds__(TFL_THREADS, TFL_MIN_CTAS)
tfl_counts_kernel(const float* __restrict__ scan,
                  const unsigned char* __restrict__ mask,
                  const float* __restrict__ templates,
                  float* __restrict__ t_count, float* __restrict__ s_count,
                  int S, int P, int T, TflCellPlan pl) {
  extern __shared__ float4 smem[];
  float4* pts = smem;                                   // S sorted points
  int* cell = reinterpret_cast<int*>(smem + S);         // cell_cap + 2
  __shared__ float red[6][TFL_WARPS];
  __shared__ int warp_tot[TFL_WARPS];
  __shared__ Grid g;
  __shared__ int t_hits, s_hits, nan_t, nan_s;

  const int p = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const float* tmpl = templates + ((size_t)b * P + p) * (size_t)T * 3;
  const float* scan_b = scan + (size_t)b * S * 3;
  const unsigned char* mask_b = mask + (size_t)b * S;

  // 1. the box of the finite template points
  float mn[3] = {INFINITY, INFINITY, INFINITY};
  float mx[3] = {-INFINITY, -INFINITY, -INFINITY};
  bool my_nan = false;
  for (int t = tid; t < T; t += TFL_THREADS) {
    const float x = tmpl[3 * t], y = tmpl[3 * t + 1], z = tmpl[3 * t + 2];
    if (!finite3(x, y, z)) {
      my_nan = my_nan || isnan(x) || isnan(y) || isnan(z);
      continue;
    }
    mn[0] = fminf(mn[0], x); mn[1] = fminf(mn[1], y); mn[2] = fminf(mn[2], z);
    mx[0] = fmaxf(mx[0], x); mx[1] = fmaxf(mx[1], y); mx[2] = fmaxf(mx[2], z);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      mn[a] = fminf(mn[a], __shfl_xor_sync(0xffffffffu, mn[a], o));
      mx[a] = fmaxf(mx[a], __shfl_xor_sync(0xffffffffu, mx[a], o));
    }
  my_nan = __any_sync(0xffffffffu, my_nan);
  if (tid == 0) {
    nan_t = 0;
    nan_s = 0;
  }
  if (lane == 0)
    for (int a = 0; a < 3; ++a) {
      red[a][warp] = mn[a];
      red[3 + a][warp] = mx[a];
    }
  __syncthreads();
  if (lane == 0 && my_nan) nan_t = 1;
  if (tid == 0) {
    for (int w = 1; w < TFL_WARPS; ++w)
      for (int a = 0; a < 3; ++a) {
        mn[a] = fminf(mn[a], red[a][w]);
        mx[a] = fmaxf(mx[a], red[3 + a][w]);
      }
    make_grid(mn, mx, pl, g);
    t_hits = 0;
    s_hits = 0;
  }
  __syncthreads();
  if (g.mode == 0) {
    if (tid == 0) {
      t_count[(size_t)b * P + p] = 0.f;
      s_count[(size_t)b * P + p] = 0.f;
    }
    return;
  }
  const int n_cells = g.n[0] * g.n[1] * g.n[2];

  // 2. counting sort of the staged scan points by cell
  for (int k = tid; k < n_cells + 2; k += TFL_THREADS) cell[k] = 0;
  __syncthreads();
  for (int j = tid; j < S; j += TFL_THREADS) {
    if (!mask_b[j]) continue;
    const float x = scan_b[3 * j], y = scan_b[3 * j + 1],
                z = scan_b[3 * j + 2];
    const int c = scan_cell(x, y, z, g);
    if (c >= 0)
      atomicAdd(&cell[1 + c], 1);
    else if (isnan(x) || isnan(y) || isnan(z))
      nan_s = 1;
  }
  __syncthreads();
  block_exclusive_scan(cell + 1, n_cells, warp_tot);
  __syncthreads();
  for (int j = tid; j < S; j += TFL_THREADS) {
    if (!mask_b[j]) continue;
    const float x = scan_b[3 * j], y = scan_b[3 * j + 1],
                z = scan_b[3 * j + 2];
    const int c = scan_cell(x, y, z, g);
    if (c >= 0) pts[atomicAdd(&cell[1 + c], 1)] = make_float4(x, y, z, 0.f);
  }
  __syncthreads();
  const int n_staged = cell[n_cells];

  // 3. the neighbour walk
  const int nx = g.n[0], ny = g.n[1], nz = g.n[2];
  int my_t_hits = 0;
  if (n_staged > 0)
    for (int t = tid; t < T; t += TFL_THREADS) {
      const float tx = tmpl[3 * t], ty = tmpl[3 * t + 1], tz = tmpl[3 * t + 2];
      if (!finite3(tx, ty, tz)) continue;
      int ix = 0, iy = 0, iz = 0;
      if (g.mode == 1) {
        ix = (int)cell_coord(tx, g.lo[0], g.inv);
        iy = (int)cell_coord(ty, g.lo[1], g.inv);
        iz = (int)cell_coord(tz, g.lo[2], g.inv);
      }
      const int x0 = max(ix - 1, 0), x1 = min(ix + 1, nx - 1);
      const int y0 = max(iy - 1, 0), y1 = min(iy + 1, ny - 1);
      const int z0 = max(iz - 1, 0), z1 = min(iz + 1, nz - 1);
      bool hit = false;
      for (int cx = x0; cx <= x1; ++cx)
        for (int cy = y0; cy <= y1; ++cy) {
          const int row = (cx * ny + cy) * nz;
          const int j1 = cell[row + z1 + 1];
          for (int j = cell[row + z0]; j < j1; ++j) {
            const float4 q = pts[j];
            const float dx = tx - q.x, dy = ty - q.y, dz = tz - q.z;
            const float d2 = __fadd_rn(
                __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                __fmul_rn(dz, dz));
            if (d2 < pl.r2) {
              hit = true;
              pts[j].w = 1.f;
            }
          }
        }
      my_t_hits += hit;
    }
  my_t_hits = __reduce_add_sync(0xffffffffu, my_t_hits);
  if (lane == 0 && my_t_hits) atomicAdd(&t_hits, my_t_hits);
  __syncthreads();

  int my_s_hits = 0;
  for (int j = tid; j < n_staged; j += TFL_THREADS)
    my_s_hits += pts[j].w != 0.f;
  my_s_hits = __reduce_add_sync(0xffffffffu, my_s_hits);
  if (lane == 0 && my_s_hits) atomicAdd(&s_hits, my_s_hits);
  __syncthreads();
  if (tid == 0) {
    t_count[(size_t)b * P + p] = nan_s ? 0.f : (float)t_hits;
    s_count[(size_t)b * P + p] = nan_t ? 0.f : (float)s_hits;
  }
}

// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int tfl_counts(const void* scan, const void* mask,
                          const void* templates, void* t_count,
                          void* s_count, int B, int S, int P, int T,
                          TflCellPlan plan, void* stream) {
  if (B < 0 || S < 0 || P < 0 || T < 1 || B > 65535 || plan.cell_cap < 27 ||
      plan.axis_max < 5)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || P == 0) return 0;
  // the all-pairs kernel's limit on S (16 bytes of point and one of flag)
  if ((size_t)S * 17 > TFL_SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  const size_t smem =
      (size_t)S * sizeof(float4) + (size_t)(plan.cell_cap + 2) * sizeof(int);
  if (smem + 1024 > TFL_SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
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
      static_cast<float*>(s_count), S, P, T, plan);
  return (int)cudaGetLastError();
}
