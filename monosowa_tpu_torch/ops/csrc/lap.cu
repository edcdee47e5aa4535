// Linear assignment for the set matcher, CUDA C++ for sm_90a: a batch of
// padded problems, one block each.
//
//   cost (N, Q, M) float32, n_valid (N,) int32 -> out (N, Q) int64: the
//   column assigned to each of the Q rows, or -1.  Only the first
//   min(n_valid, Q, M) columns take part.
//
// Replaces the JAX package's on-device solvers of monosowa_tpu/ops/lap.py,
// which are XLA programs (lax.while_loop), not Pallas kernels:
//   lap_jv       solve_lap_jv :54, exact shortest augmenting paths (two
//                forms: one warp a problem in shared memory, and
//                lap_jv_tall, one block a tall problem);
//   lap_auction  solve_lap_auction :219, Jacobi auction with eps scaling.
// Both follow the JAX functions step by step, so that they give the same
// assignments as the port's plain versions (ops/lap.py solve_lap_jv,
// solve_lap_auction) and the JAX solvers: the same float32 operations in
// the same order, the first index on ties.  Nothing here multiplies, so no
// multiply-add can be contracted; the auction's epsilons come from the
// wrapper (ops/lap.py auction_eps), computed once for the kernel and the
// plain version alike.
//
// What bounds it: latency.  At the train step a match is 22 problems of
// Q = 50 queries x M = 50 padded targets (one per image and Group-DETR
// group), 3 matches a step.  The bytes are 220 KB of cost in and 8.8 KB out
// (0.07 us at 3.35 TB/s); the work is a chain of dependent steps (one
// Dijkstra step of a JV augmentation, one auction round) with a reduction
// over 50 values in each.  So a problem stays in one block, every array in
// shared memory, and a step costs a few shuffles or barriers.
//
// lap_jv: one warp a problem.  Person i < m (a target column) is augmented
// in order: a Dijkstra over the Q objects (rows) with reduced costs
// c[i][j] - u[i] - v[j]; each step takes the unused object of least minv
// (a warp reduction on (value, index), the lower index winning a tie, as
// jnp.argmin), moves the potentials exactly as lap.py:86-94 does
// (u[owner] += delta over used objects, u[i] += delta, v -= delta on used
// objects, minv -= delta on the others), and stops at an unassigned
// object.  Lane 0 flips the path.  The transposed cost (M x Q, 10 KB at
// 50 x 50), u, v, p, minv, way and used live in shared memory.
//
// lap_jv_tall: the same augmentations for a tall problem, the two-stage
// encoder match of 10,200 encoder tokens x 50 targets an image, whose cost
// (2 MB) cannot sit in a block's shared memory.  One block of 1,024
// threads a problem.  The cost stays in device memory, transposed once by
// the wrapper (ops/lap.py) so that a person's row of Q objects is
// contiguous: a Dijkstra step reads one row of 40 KB, which L2 serves after
// the first touch.  The Q-length state (v, minv, p, way, used: 20 bytes an
// object, 204,000 at Q = 10,200) lives in shared memory where it fits and
// in a device-memory scratch where it does not (the wrapper chooses); u and
// the reduction's partials are always in shared memory.  Each Dijkstra
// step is a block-wide argmin over Q (a thread's strided objects, a warp
// shuffle, the warps' partials through shared memory; the lower index wins
// a tie) and two passes over the objects, the same float32 operations in
// the same order as the one-warp form.  What bounds it: the chain of
// dependent steps, each a few barriers and passes over Q in shared memory;
// the bytes (4.08 MB of cost for two problems) take 1.2 us at 3.35 TB/s.
//
// lap_auction: one thread a column and a row of the squared Q x Q problem
// (real columns j < m with benefit -cost[:, j], the others 0).  A round:
// each unassigned column finds its best and second-best row (benefit -
// price) and bids price + best - second + eps; each row scans the bidders
// in column order and takes the highest bid (the first column on ties, as
// jnp.argmax); displaced columns lose their row; winners take theirs.  10
// phases of at most 200 rounds, eps shrinking, prices kept across phases.
// The benefit is kept transposed (row-major by row), so that the columns'
// scan reads consecutive words.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#define LAP_FULL 0xffffffffu

__global__ void __launch_bounds__(32) lap_jv_kernel(
    const float* __restrict__ cost, const int* __restrict__ n_valid,
    int64_t* __restrict__ out, int Q, int M) {
  extern __shared__ float smem[];
  float* c = smem;                  // M x Q: c[i * Q + j] = cost[j][i]
  float* u = c + M * Q;             // M   persons' potentials
  float* v = u + M;                 // Q   objects' potentials
  float* minv = v + Q;              // Q
  int* p = reinterpret_cast<int*>(minv + Q);   // Q  object -> person
  int* way = p + Q;                 // Q
  int* used = way + Q;              // Q

  const int lane = threadIdx.x;
  const float* cp = cost + (size_t)blockIdx.x * Q * M;
  for (int t = lane; t < Q * M; t += 32) {
    const int j = t / M, i = t - j * M;
    c[i * Q + j] = cp[t];
  }
  for (int j = lane; j < Q; j += 32) {
    v[j] = 0.f;
    p[j] = -1;
  }
  for (int i = lane; i < M; i += 32) u[i] = 0.f;
  int m = n_valid[blockIdx.x];
  m = max(0, min(m, min(Q, M)));
  __syncwarp();

  for (int i = 0; i < m; ++i) {
    const float ui = u[i];
    for (int j = lane; j < Q; j += 32) {
      minv[j] = (c[i * Q + j] - ui) - v[j];
      way[j] = -1;
      used[j] = 0;
    }
    __syncwarp();
    int j_end;
    while (true) {
      // argmin over the unused objects, lowest index on ties
      float bv = CUDART_INF_F;
      int bj = Q;
      for (int j = lane; j < Q; j += 32) {
        const float mv = used[j] ? CUDART_INF_F : minv[j];
        if (mv < bv || (mv == bv && j < bj)) {
          bv = mv;
          bj = j;
        }
      }
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(LAP_FULL, bv, off);
        const int oj = __shfl_xor_sync(LAP_FULL, bj, off);
        if (ov < bv || (ov == bv && oj < bj)) {
          bv = ov;
          bj = oj;
        }
      }
      const int j1 = bj;
      const float delta = bv;
      // the potentials (used objects have distinct persons, none of them i)
      for (int j = lane; j < Q; j += 32) {
        if (used[j]) {
          u[p[j]] = u[p[j]] + delta;
          v[j] = v[j] - delta;
        } else {
          minv[j] = minv[j] - delta;
        }
      }
      if (lane == 0) u[i] = u[i] + delta;
      __syncwarp();
      if (lane == 0) used[j1] = 1;
      const int pj1 = p[j1];
      __syncwarp();
      if (pj1 < 0) {
        j_end = j1;
        break;
      }
      // extend the search tree through j1's current person
      const float ui2 = u[pj1];
      const float* ci2 = c + pj1 * Q;
      for (int j = lane; j < Q; j += 32) {
        if (!used[j]) {
          const float cur = (ci2[j] - ui2) - v[j];
          if (cur < minv[j]) {
            minv[j] = cur;
            way[j] = j1;
          }
        }
      }
      __syncwarp();
    }
    // flip the augmenting path back to its root
    if (lane == 0) {
      int j = j_end;
      while (j >= 0) {
        const int jprev = way[j];
        p[j] = jprev < 0 ? i : p[jprev];
        j = jprev;
      }
    }
    __syncwarp();
  }
  int64_t* o = out + (size_t)blockIdx.x * Q;
  for (int j = lane; j < Q; j += 32) o[j] = p[j];
}

#define LAP_TALL_THREADS 1024

__device__ __forceinline__ void lap_argmin_step(float& bv, int& bj, float ov,
                                                int oj) {
  if (ov < bv || (ov == bv && oj < bj)) {
    bv = ov;
    bj = oj;
  }
}

__global__ void __launch_bounds__(LAP_TALL_THREADS) lap_jv_tall_kernel(
    const float* __restrict__ costT, const int* __restrict__ n_valid,
    int64_t* __restrict__ out, float* __restrict__ scratch, int Q, int M) {
  extern __shared__ float smem[];
  __shared__ float red_v[LAP_TALL_THREADS / 32];
  __shared__ int red_j[LAP_TALL_THREADS / 32];
  __shared__ float s_delta;
  __shared__ int s_j1;
  float* u = smem;                  // M persons' potentials
  // v, minv (float), p, way, used (int): Q each, in shared memory after u
  // or, with a scratch, in the problem's slice of it
  float* v = scratch ? scratch + (size_t)blockIdx.x * 5 * Q : u + M;
  float* minv = v + Q;
  int* p = reinterpret_cast<int*>(minv + Q);
  int* way = p + Q;
  int* used = way + Q;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const float* cp = costT + (size_t)blockIdx.x * M * Q;   // M x Q
  for (int j = tid; j < Q; j += blockDim.x) {
    v[j] = 0.f;
    p[j] = -1;
  }
  for (int i = tid; i < M; i += blockDim.x) u[i] = 0.f;
  int m = n_valid[blockIdx.x];
  m = max(0, min(m, min(Q, M)));
  __syncthreads();

  for (int i = 0; i < m; ++i) {
    const float ui = u[i];
    const float* ci = cp + (size_t)i * Q;
    for (int j = tid; j < Q; j += blockDim.x) {
      minv[j] = (ci[j] - ui) - v[j];
      way[j] = -1;
      used[j] = 0;
    }
    __syncthreads();
    int j_end;
    while (true) {
      // argmin over the unused objects, lowest index on ties
      float bv = CUDART_INF_F;
      int bj = Q;
      for (int j = tid; j < Q; j += blockDim.x)
        lap_argmin_step(bv, bj, used[j] ? CUDART_INF_F : minv[j], j);
      for (int off = 16; off > 0; off >>= 1)
        lap_argmin_step(bv, bj, __shfl_xor_sync(LAP_FULL, bv, off),
                        __shfl_xor_sync(LAP_FULL, bj, off));
      if (lane == 0) {
        red_v[warp] = bv;
        red_j[warp] = bj;
      }
      __syncthreads();
      if (warp == 0) {
        bv = lane < nwarps ? red_v[lane] : CUDART_INF_F;
        bj = lane < nwarps ? red_j[lane] : Q;
        for (int off = 16; off > 0; off >>= 1)
          lap_argmin_step(bv, bj, __shfl_xor_sync(LAP_FULL, bv, off),
                          __shfl_xor_sync(LAP_FULL, bj, off));
        if (lane == 0) {
          s_delta = bv;
          s_j1 = bj;
        }
      }
      __syncthreads();
      const int j1 = s_j1;
      const float delta = s_delta;
      // the potentials (used objects have distinct persons, none of them i)
      for (int j = tid; j < Q; j += blockDim.x) {
        if (used[j]) {
          u[p[j]] = u[p[j]] + delta;
          v[j] = v[j] - delta;
        } else {
          minv[j] = minv[j] - delta;
        }
      }
      if (tid == 0) u[i] = u[i] + delta;
      __syncthreads();
      if (tid == 0) used[j1] = 1;
      const int pj1 = p[j1];
      __syncthreads();
      if (pj1 < 0) {
        j_end = j1;
        break;
      }
      // extend the search tree through j1's current person
      const float ui2 = u[pj1];
      const float* ci2 = cp + (size_t)pj1 * Q;
      for (int j = tid; j < Q; j += blockDim.x) {
        if (!used[j]) {
          const float cur = (ci2[j] - ui2) - v[j];
          if (cur < minv[j]) {
            minv[j] = cur;
            way[j] = j1;
          }
        }
      }
      __syncthreads();
    }
    // flip the augmenting path back to its root
    if (tid == 0) {
      int j = j_end;
      while (j >= 0) {
        const int jprev = way[j];
        p[j] = jprev < 0 ? i : p[jprev];
        j = jprev;
      }
    }
    __syncthreads();
  }
  int64_t* o = out + (size_t)blockIdx.x * Q;
  for (int j = tid; j < Q; j += blockDim.x) o[j] = p[j];
}

__global__ void lap_auction_kernel(const float* __restrict__ cost,
                                   const int* __restrict__ n_valid,
                                   const float* __restrict__ eps_all,
                                   int64_t* __restrict__ out, int Q, int M,
                                   int phases, int rounds) {
  extern __shared__ float smem[];
  const int n = Q;                   // columns of the squared problem
  float* bT = smem;                  // Q x n: bT[r * n + j] = benefit[j][r]
  float* prices = bT + Q * n;        // rows
  float* bid = prices + Q;           // columns
  float* win_val = bid + n;          // rows
  int* owner = reinterpret_cast<int*>(win_val + Q);  // row -> column
  int* assigned = owner + Q;         // column -> row
  int* best = assigned + n;          // column -> its best row
  int* bidding = best + n;           // column bids this round
  int* win_col = bidding + n;        // rows
  int* has_bid = win_col + Q;        // rows
  int* out_row = has_bid + Q;        // rows

  const int t = threadIdx.x;
  const int prob = blockIdx.x;
  const float* cp = cost + (size_t)prob * Q * M;
  int m = n_valid[prob];
  m = max(0, min(m, min(Q, M)));
  for (int k = t; k < Q * n; k += blockDim.x) {
    const int r = k / n, j = k - r * n;
    bT[k] = j < m ? -cp[r * M + j] : 0.f;
  }
  if (t < Q) prices[t] = 0.f;
  __syncthreads();

  for (int ph = 0; ph < phases; ++ph) {
    const float eps = eps_all[(size_t)prob * phases + ph];
    if (t < Q) owner[t] = -1;
    if (t < n) assigned[t] = -1;
    __syncthreads();
    int open = 1;                    // some column holds no row
    for (int it = 0; it < rounds && open; ++it) {
      // columns bid
      if (t < n) {
        const int un = assigned[t] < 0;
        bidding[t] = un;
        if (un) {
          float bv = -CUDART_INF_F, sv = -CUDART_INF_F;
          int br = 0;
          for (int r = 0; r < Q; ++r) {
            const float val = bT[r * n + t] - prices[r];
            if (val > bv) {
              sv = bv;
              bv = val;
              br = r;
            } else if (val > sv) {
              sv = val;
            }
          }
          best[t] = br;
          bid[t] = ((prices[br] + bv) - sv) + eps;
        }
      }
      __syncthreads();
      // rows take the highest bid, the first column on ties; the columns
      // they held before lose them
      int wc = 0, hb = 0;
      float wv = -CUDART_INF_F;
      if (t < Q) {
        for (int j = 0; j < n; ++j) {
          if (bidding[j] && best[j] == t && bid[j] > wv) {
            wv = bid[j];
            wc = j;
          }
        }
        hb = isfinite(wv);
        const int old = owner[t];
        if (hb && old >= 0 && old != wc) assigned[old] = -1;
      }
      __syncthreads();
      if (t < Q && hb) {
        assigned[wc] = t;
        owner[t] = wc;
        prices[t] = wv;
      }
      __syncthreads();
      open = __syncthreads_or(t < n && assigned[t] < 0);
    }
  }
  if (t < Q) out_row[t] = -1;
  __syncthreads();
  if (t < n && assigned[t] >= 0 && t < m) atomicMax(&out_row[assigned[t]], t);
  __syncthreads();
  if (t < Q) out[(size_t)prob * Q + t] = out_row[t];
}

static int set_smem(const void* fn, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

extern "C" int lap_jv(const void* cost, const void* n_valid, void* out,
                      int N, int Q, int M, void* stream) {
  if (N < 0 || Q < 1 || M < 1) return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  const size_t smem = sizeof(float) * ((size_t)M * Q + M + 5 * (size_t)Q);
  int err = set_smem((const void*)lap_jv_kernel, smem);
  if (err) return err;
  lap_jv_kernel<<<N, 32, smem, (cudaStream_t)stream>>>(
      (const float*)cost, (const int*)n_valid, (int64_t*)out, Q, M);
  return (int)cudaGetLastError();
}

// costT (N, M, Q): the cost transposed; scratch: NULL to keep the state in
// shared memory, else N * 5 * Q words of device memory for it
extern "C" int lap_jv_tall(const void* costT, const void* n_valid, void* out,
                           void* scratch, int N, int Q, int M, void* stream) {
  if (N < 0 || Q < 1 || M < 1) return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  const size_t smem =
      sizeof(float) * ((size_t)M + (scratch ? 0 : 5 * (size_t)Q));
  int err = set_smem((const void*)lap_jv_tall_kernel, smem);
  if (err) return err;
  lap_jv_tall_kernel<<<N, LAP_TALL_THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)costT, (const int*)n_valid, (int64_t*)out,
      (float*)scratch, Q, M);
  return (int)cudaGetLastError();
}

extern "C" int lap_auction(const void* cost, const void* n_valid,
                           const void* eps, void* out, int N, int Q, int M,
                           int phases, int rounds, void* stream) {
  if (N < 0 || Q < 1 || M < 1 || M > Q || Q > 1024 || phases < 0 ||
      rounds < 0)
    return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  const size_t smem = sizeof(float) * ((size_t)Q * Q + 10 * (size_t)Q);
  int err = set_smem((const void*)lap_auction_kernel, smem);
  if (err) return err;
  const int threads = (Q + 31) / 32 * 32;
  lap_auction_kernel<<<N, threads, smem, (cudaStream_t)stream>>>(
      (const float*)cost, (const int*)n_valid, (const float*)eps,
      (int64_t*)out, Q, M, phases, rounds);
  return (int)cudaGetLastError();
}
