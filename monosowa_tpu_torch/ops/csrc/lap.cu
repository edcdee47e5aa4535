// Linear assignment for the set matcher, CUDA C++ for sm_90a: a batch of
// padded problems.
//
//   cost (N, Q, M) float32, n_valid (N,) int32 -> out (N, Q) int64: the
//   column assigned to each of the Q rows, or -1.  Only the first
//   min(n_valid, Q, M) columns take part.
//
// Replaces the JAX package's on-device solvers of monosowa_tpu/ops/lap.py,
// which are XLA programs (lax.while_loop), not Pallas kernels:
//   lap_jv       solve_lap_jv :54, exact shortest augmenting paths, in three
//                forms: lap_jv_warp (one warp a problem, its state in
//                registers), lap_jv_cluster (a thread-block cluster a tall
//                problem, its cost resident in the CTAs' shared memory) and
//                lap_jv_tall (one block a problem too large for a cluster,
//                the cost in device memory);
//   lap_auction  solve_lap_auction :219, Jacobi auction with eps scaling.
// The wrapper (ops/lap.py jv_plan / auction_plan) picks the form, block,
// cluster and objects a lane from the shape alone and passes the shared
// memory it expects, which each entry point checks against its own count.
// Each form follows the JAX function step by step, so that it gives the
// same assignments as the port's plain versions (ops/lap.py solve_lap_jv,
// solve_lap_auction) and the JAX solvers: the same float32 operations in
// the same order, the first index on ties.  Nothing here multiplies, so no
// multiply-add can be contracted; the auction's epsilons come from the
// wrapper (ops/lap.py auction_eps), computed once for the kernel and the
// plain version alike.
//
// What bounds them: latency.  At the train step a match is 22 problems of
// Q = 50 queries x M = 50 padded targets (one per image and Group-DETR
// group), 3 matches a step: 220 KB of cost in, 0.07 us at 3.35 TB/s.  The
// work is a chain of dependent steps (a Dijkstra step of a JV
// augmentation, an auction round), each a reduction over the problem's
// objects; a problem's longest chain sets the launch's time.  So each form
// shortens the time of one step: state in registers, reductions by
// redux.sync on order-preserving integer keys, one barrier a step where a
// problem spans warps.
//
// The float key (lap_key): -0.0 is folded onto +0.0 and the bits mapped so
// that unsigned order is float order; equal keys are equal floats.  Where a
// value travels as its key (a cluster's candidates, the auction's bids and
// top-2) the sign of a zero may be lost.  Only + and - follow, so no
// comparison and no non-zero value can change: the assignment is the same.
//
// JV state.  Person i < m (a target column) is augmented in order: a
// Dijkstra over the Q objects (rows) with reduced costs c[i][j] - u[i] -
// v[j]; each step takes the unused object of least minv (lowest index on
// ties, as jnp.argmin), moves the potentials as lap.py:86-94 does (u[owner]
// += delta over used objects, u[i] += delta, v -= delta on used objects,
// minv -= delta on the others), and stops at an unassigned object.  Used
// objects have distinct owners, so each object carries its owner's
// potential (uo[j] = u[p[j]]) and receives the same + delta; the root's
// u[i] is a scalar, 0 when its augmentation starts.  At the end of an
// augmentation the path is flipped: p and uo move one object along the
// path, the root's potential to its first object (the warp form through
// shared memory, the cluster form from its list of the steps).  The
// persons' u never need their own array.
//
// Cost layout in shared memory: object-major, a row of min(Q, M) costs an
// object at an odd stride MS, so the 32 lanes reading person pj1's costs of
// 32 consecutive objects hit 32 banks; the rows copy from (Q, M) as they
// lie, with no transpose and no division per element.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace cg = cooperative_groups;

#define LAP_FULL 0xffffffffu
#define LAP_NONE 0xffffffffu                // the key of no object
#define LAP_WARP_THREADS 128                // the warp form's prologue
#define LAP_CLUSTER_THREADS 256             // a cluster form CTA
#define LAP_CLUSTER_WARPS (LAP_CLUSTER_THREADS / 32)
#define LAP_CLUSTER_MAX_Q 65534             // indices and way steps: 16 bits

__device__ __forceinline__ unsigned lap_key(float x) {
  unsigned b = __float_as_uint(x);
  if ((b << 1) == 0) b = 0;                  // -0.0 -> +0.0
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float lap_unkey(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

__host__ __device__ __forceinline__ int lap_stride(int persons) {
  return persons | 1;
}

// Copy objects [j0, j0 + n) of one problem's (Q, M) cost, their first
// `persons` columns, into c[jl * ms + i]; every thread of the block.  The
// rows lie contiguous in device memory, so the threads read the span in
// order by asynchronous copies (cp.async, as many in flight as the
// hardware holds, none waiting on a register), stepping their (row,
// column) by the block's width with no division, and wait for them all.
__device__ __forceinline__ void lap_load_rows(float* c, const float* cp,
                                              int j0, int n, int M,
                                              int persons, int ms) {
  const float* src = cp + (size_t)j0 * M;
  const int total = n * M, nt = blockDim.x;
  const int dr = nt / M, dc = nt - dr * M;
  int row = threadIdx.x / M, col = threadIdx.x - row * M;
  for (int e = threadIdx.x; e < total; e += nt) {
    if (col < persons) {
      const unsigned dst =
          (unsigned)__cvta_generic_to_shared(c + row * ms + col);
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
                   "l"(src + e)
                   : "memory");
    }
    col += dc;
    row += dr;
    if (col >= M) {
      col -= M;
      ++row;
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The least (key, index) of a warp: two redux.sync, the lower index on a
// tie.  Lanes without an object hold (LAP_NONE, any).
__device__ __forceinline__ unsigned lap_warp_min(unsigned key, unsigned j,
                                                 unsigned& jmin) {
  const unsigned kmin = __reduce_min_sync(LAP_FULL, key);
  jmin = __reduce_min_sync(LAP_FULL, key == kmin ? j : LAP_NONE);
  return kmin;
}

// Flip the augmenting path ending at j_end back to its root, one thread:
// each object on it takes the person and the potential of the object
// before it, the first the root person i and its potential ui.
__device__ __forceinline__ void lap_flip(int* p, float* uo, const int* way,
                                         int j_end, int i, float ui) {
  int j = j_end;
  while (j >= 0) {
    const int jp = way[j];
    if (jp < 0) {
      p[j] = i;
      uo[j] = ui;
    } else {
      p[j] = p[jp];
      uo[j] = uo[jp];
    }
    j = jp;
  }
}

// ---------------------------------------------------------------------------
// lap_jv_warp: one warp a problem (the decoder's 50 x 50 matches).  Lane l
// owns objects l + 32k, k < K, and keeps their minv, v, owner p, owner's
// potential uo and used bit in registers.  A Dijkstra step: each lane's
// least key over its K objects (used ones at +inf), two redux.sync for the
// warp's, three shuffles from the owning lane (j1 & 31) for delta, pj1 and
// u[pj1]; the updates in registers; the extension reads pj1's costs from
// shared memory.  No barrier in a step.  A block of 128 threads loads the
// cost; then three warps leave.
// ---------------------------------------------------------------------------

template <int K>
__global__ void __launch_bounds__(LAP_WARP_THREADS, 1) lap_jv_warp_kernel(
    const float* __restrict__ cost, const int* __restrict__ n_valid,
    int64_t* __restrict__ out, int Q, int M) {
  extern __shared__ __align__(16) float smem[];
  const int persons = min(Q, M), ms = lap_stride(persons);
  float* c = smem;                              // Q x ms
  float* uo_s = c + (size_t)Q * ms;             // Q owners' potentials
  int* p_s = reinterpret_cast<int*>(uo_s + Q);  // Q object -> person
  int* way_s = p_s + Q;                         // Q

  const int prob = blockIdx.x;
  lap_load_rows(c, cost + (size_t)prob * Q * M, 0, Q, M, persons, ms);
  for (int j = threadIdx.x; j < Q; j += blockDim.x) p_s[j] = -1;
  int m = n_valid[prob];
  m = max(0, min(m, persons));
  __syncthreads();
  if (threadIdx.x >= 32) return;

  const int lane = threadIdx.x;
  float minv[K], v[K], uo[K];
  int p[K];
  bool used[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    v[k] = 0.f;
    uo[k] = 0.f;
    p[k] = -1;
  }

  for (int i = 0; i < m; ++i) {
    float ui = 0.f;                   // u[i]: person i has owned nothing
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int j = lane + 32 * k;
      used[k] = false;
      minv[k] = 0.f;
      if (j < Q) {
        minv[k] = (c[j * ms + i] - ui) - v[k];
        way_s[j] = -1;
      }
    }
    int j_end;
    while (true) {
      // argmin over the unused objects, the lowest index on ties
      unsigned bk = LAP_NONE, bj = LAP_NONE;
      float bval = 0.f, buo = 0.f;
      int bp = -1;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int j = lane + 32 * k;
        const float mv = used[k] ? CUDART_INF_F : minv[k];
        const unsigned key = j < Q ? lap_key(mv) : LAP_NONE;
        if (key < bk) {
          bk = key;
          bj = j;
          bval = mv;
          bp = p[k];
          buo = uo[k];
        }
      }
      unsigned jmin;
      lap_warp_min(bk, bj, jmin);
      const int j1 = (int)jmin, src = j1 & 31;
      const float delta = __shfl_sync(LAP_FULL, bval, src);
      const int pj1 = __shfl_sync(LAP_FULL, bp, src);
      const float ui2 = __shfl_sync(LAP_FULL, buo, src);
      // the potentials (used objects have distinct persons, none of them i)
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (used[k]) {
          uo[k] = uo[k] + delta;
          v[k] = v[k] - delta;
        } else {
          minv[k] = minv[k] - delta;
        }
      }
      ui = ui + delta;
#pragma unroll
      for (int k = 0; k < K; ++k)
        if (lane + 32 * k == j1) used[k] = true;
      if (pj1 < 0) {
        j_end = j1;
        break;
      }
      // extend the search tree through j1's person (its potential was not
      // moved in this step: j1 was unused)
      const float* ci2 = c + pj1;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int j = lane + 32 * k;
        if (j < Q && !used[k]) {
          const float cur = (ci2[j * ms] - ui2) - v[k];
          if (cur < minv[k]) {
            minv[k] = cur;
            way_s[j] = j1;
          }
        }
      }
    }
    // the owners' potentials to shared memory, the path flipped, back
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (lane + 32 * k < Q) uo_s[lane + 32 * k] = uo[k];
    __syncwarp();
    if (lane == 0) lap_flip(p_s, uo_s, way_s, j_end, i, ui);
    __syncwarp();
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int j = lane + 32 * k;
      if (j < Q) {
        p[k] = p_s[j];
        uo[k] = uo_s[j];
      }
    }
  }
  int64_t* o = out + (size_t)prob * Q;
#pragma unroll
  for (int k = 0; k < K; ++k)
    if (lane + 32 * k < Q) o[lane + 32 * k] = p[k];
}

// ---------------------------------------------------------------------------
// lap_jv_cluster: a cluster of C CTAs a tall problem (two_stage's encoder
// match, 10,200 encoder tokens x 50 targets, whose 2 MB of cost no block
// holds).  CTA r owns objects [r * Qc, (r + 1) * Qc), loads their costs once
// into its shared memory and keeps them there for the whole launch; thread
// t owns its objects t + 256k, k < K, in registers as the warp form, with
// each object's way as the step of the augmentation that last lowered its
// minv.  A Dijkstra step:
//   1. each warp's least (key, index) by two redux.sync;
//   2. lanes 0..C-1 write the warp's candidate (key, index and way step,
//      owner, owner's potential) into its slot in each CTA's shared memory,
//      one of two buffers by the step's parity;
//   3. one cluster barrier;
//   4. every warp reduces the C x 8 candidates in its own shared memory in
//      the same way, so all agree on j1, delta, pj1, u[pj1] and j1's way;
//   5. each CTA notes the step (j1, its way step, pj1, and u[pj1], to which
//      it adds the later steps' deltas as the owner of j1 does); each
//      thread updates its objects and extends through pj1's costs.
// No read of device memory and one barrier a step.  The path flip needs
// no other CTA: every CTA holds every step, so each thread walks the path
// back from the last step through the way steps and gives its own objects
// on it the person and the potential of the object before them.  A step
// pops a distinct object and each step but the last one owned by one of
// the i persons already placed, so an augmentation takes at most
// min(Q, M) steps.  Candidates carry an index and a way step in 16 bits
// each (Q and min(Q, M) + 1 below 65,536, the plan's limit).
// ---------------------------------------------------------------------------

template <int K>
__global__ void __launch_bounds__(LAP_CLUSTER_THREADS) lap_jv_cluster_kernel(
    const float* __restrict__ cost, const int* __restrict__ n_valid,
    int64_t* __restrict__ out, int Q, int M, int qc) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int prob = blockIdx.x / C;
  const int persons = min(Q, M), ms = lap_stride(persons);
  const int nslots = C * LAP_CLUSTER_WARPS;
  uint4* cand = reinterpret_cast<uint4*>(smem);     // 2 x nslots
  float* c = reinterpret_cast<float*>(cand + 2 * nslots);  // qc x ms
  // the augmentation's steps: the object popped, the step of its way (-1:
  // none), its owner and its owner's potential, moved as the owner's
  int* st_j = reinterpret_cast<int*>(c + (size_t)qc * ms);  // persons
  int* st_way = st_j + persons;                     // persons
  int* st_p = st_way + persons;                     // persons
  float* st_u = reinterpret_cast<float*>(st_p + persons);  // persons

  const int j0 = rank * qc;
  const int nloc = max(0, min(qc, Q - j0));
  lap_load_rows(c, cost + (size_t)prob * Q * M, j0, nloc, M, persons, ms);
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  int m = n_valid[prob];
  m = max(0, min(m, persons));

  float minv[K], v[K], uo[K];
  int p[K], way[K];
  bool used[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    v[k] = 0.f;
    uo[k] = 0.f;
    p[k] = -1;
  }
  cluster.sync();                     // every CTA started: its memory is live

  int parity = 0;
  for (int i = 0; i < m; ++i) {
    float ui = 0.f;                   // u[i]: person i has owned nothing
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int jl = t + LAP_CLUSTER_THREADS * k;
      used[k] = false;
      way[k] = -1;
      minv[k] = jl < nloc ? (c[jl * ms + i] - ui) - v[k] : 0.f;
    }
    int j1, way1;
    for (int step = 0;; ++step) {
      unsigned bk = LAP_NONE, bj = LAP_NONE, buo = 0;
      int bp = -1, bw = -1;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int jl = t + LAP_CLUSTER_THREADS * k;
        const unsigned key =
            jl < nloc ? lap_key(used[k] ? CUDART_INF_F : minv[k]) : LAP_NONE;
        if (key < bk) {
          bk = key;
          bj = j0 + jl;
          bp = p[k];
          buo = __float_as_uint(uo[k]);
          bw = way[k];
        }
      }
      unsigned jmin;
      const unsigned kmin = lap_warp_min(bk, bj, jmin);
      const int src = __ffs(__ballot_sync(LAP_FULL, bk == kmin && bj == jmin))
                      - 1;
      const uint4 mine = make_uint4(
          kmin, (jmin << 16) | (unsigned)(__shfl_sync(LAP_FULL, bw, src) + 1),
          __shfl_sync(LAP_FULL, bp, src), __shfl_sync(LAP_FULL, buo, src));
      uint4* buf = cand + parity * nslots;
      if (lane < C)
        cluster.map_shared_rank(buf, lane)[rank * LAP_CLUSTER_WARPS + warp] =
            mine;
      cluster.sync();
      // every warp: the least of the cluster's candidates
      bk = LAP_NONE;
      bj = LAP_NONE;
      bp = -1;
      buo = 0;
      for (int s = lane; s < nslots; s += 32) {
        const uint4 cs = buf[s];
        if (cs.x < bk || (cs.x == bk && cs.y < bj)) {
          bk = cs.x;
          bj = cs.y;
          bp = (int)cs.z;
          buo = cs.w;
        }
      }
      unsigned yw;
      const unsigned kw = lap_warp_min(bk, bj, yw);
      const int src2 = __ffs(__ballot_sync(LAP_FULL, bk == kw && bj == yw))
                       - 1;
      j1 = (int)(yw >> 16);
      way1 = (int)(yw & 0xffffu) - 1;
      const float delta = lap_unkey(kw);
      const int pj1 = __shfl_sync(LAP_FULL, bp, src2);
      const float ui2 = __uint_as_float(__shfl_sync(LAP_FULL, buo, src2));
      parity ^= 1;
      // the step noted; the potentials of the owners of the objects the
      // earlier steps popped move as those objects' owners do
      if (t == 0) {
        st_j[step] = j1;
        st_way[step] = way1;
        st_p[step] = pj1;
      }
      for (int e = t; e < step; e += LAP_CLUSTER_THREADS)
        st_u[e] = st_u[e] + delta;
      if (step % LAP_CLUSTER_THREADS == t) st_u[step] = ui2;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (used[k]) {
          uo[k] = uo[k] + delta;
          v[k] = v[k] - delta;
        } else {
          minv[k] = minv[k] - delta;
        }
      }
      ui = ui + delta;
#pragma unroll
      for (int k = 0; k < K; ++k)
        if (j0 + t + LAP_CLUSTER_THREADS * k == j1) used[k] = true;
      if (pj1 < 0) break;
      const float* ci2 = c + pj1;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int jl = t + LAP_CLUSTER_THREADS * k;
        if (jl < nloc && !used[k]) {
          const float cur = (ci2[jl * ms] - ui2) - v[k];
          if (cur < minv[k]) {
            minv[k] = cur;
            way[k] = step;
          }
        }
      }
    }
    // the path flipped: each object on it takes the person and potential
    // of the object before it, the first person i and u[i]
    __syncthreads();
    for (int j = j1, w = way1;;) {
      const int np = w < 0 ? i : st_p[w];
      const float nu = w < 0 ? ui : st_u[w];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (j0 + t + LAP_CLUSTER_THREADS * k == j) {
          p[k] = np;
          uo[k] = nu;
        }
      }
      if (w < 0) break;
      j = st_j[w];
      w = st_way[w];
    }
  }
  int64_t* o = out + (size_t)prob * Q + j0;
#pragma unroll
  for (int k = 0; k < K; ++k)
    if (t + LAP_CLUSTER_THREADS * k < nloc)
      o[t + LAP_CLUSTER_THREADS * k] = p[k];
}

// ---------------------------------------------------------------------------
// lap_jv_tall: the same augmentations for a problem that no cluster holds,
// one block of 1,024 threads a problem.  The cost stays in device memory,
// transposed once by the wrapper (ops/lap.py) so that a person's row of Q
// objects is contiguous: a Dijkstra step reads one row, which L2 serves
// after the first touch.  The Q-length state (v, minv, p, way, used: 20
// bytes an object) lives in shared memory where it fits and in a
// device-memory scratch where it does not (the plan chooses); u and the
// reduction's partials are always in shared memory.  Each Dijkstra step is
// a block-wide argmin over Q (a thread's strided objects, a warp shuffle,
// the warps' partials through shared memory; the lower index wins a tie)
// and two passes over the objects.
// ---------------------------------------------------------------------------

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
  extern __shared__ __align__(16) float smem[];
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

// ---------------------------------------------------------------------------
// lap_auction: one block a problem, exact to the JAX round
// (monosowa_tpu/ops/lap.py:264-297) on the squared Q x Q problem, whose
// columns j >= m have benefit 0 everywhere.  Those columns' values are
// 0 - prices for all of them, so their best row, best and second values and
// bid are the same: one warp computes them once a round from the prices,
// and of those columns only the lowest-indexed unassigned one (a bitmask,
// __ffs) can win that row, since real columns have lower indices.  Each
// unassigned real column j < m is one warp's: lanes take rows in a stride,
// keep the serial (best, first row, second) of their rows, and three
// redux.sync give the column's best value, its first row and the largest of
// the rest, what the serial scan over all rows gives (val > bv, else
// val > sv, as the JAX round's argmax and second max).  Its bid goes to
// its row by a 64-bit
// atomicMax in shared memory of (bid's key, ~column): the highest bid,
// the first column on a tie.  Then thread r resolves row r: its best real
// bid against the zero columns' bid where they bid on r (a real column
// wins a tie), no bid where the winning bid is not finite (a problem of one
// row: its second value is -inf), the old owner displaced, the winner in.
// Two barriers a round; the displacement and the assignment touch distinct
// columns (a displaced column held a row, a winner did not), so they need
// no barrier between them.  Where every real column holds a row, the
// zero columns' bid is a round's only one, and warp 0 runs such rounds
// alone with no barrier (lap_zero_rounds) until a real column loses its
// row: the Q - m rounds a phase that the zero columns take one at a time.
// The phase ends when every column holds a row (running counts of the
// columns and of the real columns without one) or after `rounds` rounds.
// The cost sits transposed and negated in shared memory; a problem
// without a real column returns all -1 at once, the output no round can
// change.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void lap_top2_step(float val, int r, float& bv,
                                              int& br, float& sv) {
  if (val > bv) {
    sv = bv;
    bv = val;
    br = r;
  } else if (val > sv) {
    sv = val;
  }
}

// The warp's best value, first row and second value over rows r = lane +
// 32k of the values vals(r); rows past Q count as none.
template <typename Vals>
__device__ __forceinline__ void lap_warp_top2(int Q, Vals vals, float& best,
                                              int& row, float& second) {
  const int lane = threadIdx.x & 31;
  float bv = -CUDART_INF_F, sv = -CUDART_INF_F;
  int br = Q;
  for (int r = lane; r < Q; r += 32) lap_top2_step(vals(r), r, bv, br, sv);
  const unsigned kb = lap_key(bv);
  const unsigned kmax = __reduce_max_sync(LAP_FULL, kb);
  row = (int)__reduce_min_sync(LAP_FULL, kb == kmax ? (unsigned)br : LAP_NONE);
  const unsigned ks = __reduce_max_sync(
      LAP_FULL, lap_key(kb == kmax && br == row ? sv : bv));
  best = lap_unkey(kmax);
  second = lap_unkey(ks);
}

// Rounds in which no real column bids (every real column holds a row),
// one warp: the zero columns' bid, made by the lowest-indexed one without
// a row, is the round's only bid, and its row takes it where it is finite
// (else no round of the phase can change anything).  They run until a
// real column loses its row, every column holds one, or the phase's
// rounds are spent: the block's round, with its barriers, for a round of
// one bid.
//
// The zero columns' values are 0 - prices, so their best row is the first
// of the cheapest and their second value that of the next cheapest.  The
// warp holds the rows sorted by (price key, row), lane l elements lK ..
// lK + K - 1 in registers, each a key and a tag (row << 16 | owner + 1),
// sorted on entry into `list` by the block.  A round reads the first two
// elements, bids as lap_warp_top2's round would (((p + b) - s) + eps), and
// takes out the first element and puts the row back at its new key: an
// element moves down one place where the next one sorts before the new
// one, takes the new one where it is the first not to, else stays.  One
// level of shuffles in a round's chain, and no reduction.  On exit the
// prices and owners go back to their rows and `list` to zero.
template <int K>
__device__ __forceinline__ void lap_zero_rounds(
    int Q, int m, float eps, int rounds, unsigned long long* list,
    float* prices, int* owner, int* assigned, unsigned* zfree, int& it,
    int& open, int& real_open) {
  const int lane = threadIdx.x & 31;
  unsigned key[K], tag[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int n = lane * K + k;
    const unsigned long long e = n < Q ? list[n] : ~0ull;
    key[k] = (unsigned)(e >> 32);
    tag[k] = (unsigned)e;
  }
  unsigned zw = zfree[lane];
  while (it < rounds && open > 0) {
    const unsigned any = __ballot_sync(LAP_FULL, zw != 0u);
    if (any == 0u) break;              // no column to bid (open counts one)
    const int w = __ffs(any) - 1;
    const int col = 32 * w + __ffs(__shfl_sync(LAP_FULL, zw, w)) - 1;
    const unsigned k0 = __shfl_sync(LAP_FULL, key[0], 0);
    const unsigned t0 = __shfl_sync(LAP_FULL, tag[0], 0);
    const unsigned k1 = __shfl_sync(LAP_FULL, key[K > 1 ? 1 : 0], K > 1 ? 0 : 1);
    const unsigned nk = __shfl_down_sync(LAP_FULL, key[0], 1);
    const unsigned nt = __shfl_down_sync(LAP_FULL, tag[0], 1);
    const float p0 = lap_unkey(k0);
    const float bv = 0.f - p0;
    const float sv = Q > 1 ? 0.f - lap_unkey(k1) : -CUDART_INF_F;
    const float bid = ((p0 + bv) - sv) + eps;
    ++it;
    if (!isfinite(bid)) {
      it = rounds;
      break;
    }
    const int old = (int)(t0 & 0xffffu) - 1;
    const unsigned ek = lap_key(bid);
    const unsigned et = (t0 & 0xffff0000u) | (unsigned)(col + 1);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const unsigned xk = k + 1 < K ? key[k + 1] : (lane < 31 ? nk : LAP_NONE);
      const unsigned xt = k + 1 < K ? tag[k + 1] : (lane < 31 ? nt : ~0u);
      if (xk < ek || (xk == ek && xt < et)) {
        key[k] = xk;
        tag[k] = xt;
      } else if ((lane == 0 && k == 0) || key[k] < ek ||
                 (key[k] == ek && tag[k] < et)) {
        key[k] = ek;
        tag[k] = et;
      }
    }
    if (lane == w) zw &= ~(1u << (col & 31));
    if (old >= m && lane == (old >> 5)) zw |= 1u << (old & 31);
    if (old < 0) {
      --open;
    } else if (old < m) {
      if (lane == 0) assigned[old] = -1;
      real_open = 1;
      break;
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int n = lane * K + k;
    if (n < Q) {
      const int r = (int)(tag[k] >> 16);
      prices[r] = lap_unkey(key[k]);
      owner[r] = (int)(tag[k] & 0xffffu) - 1;
      list[n] = 0ull;
    }
  }
  zfree[lane] = zw;
}

template <int K>
__global__ void __launch_bounds__(1024, 1) lap_auction_kernel(
    const float* __restrict__ cost, const int* __restrict__ n_valid,
    const float* __restrict__ eps_all, int64_t* __restrict__ out, int Q,
    int M, int phases, int rounds) {
  extern __shared__ __align__(16) float smem[];
  const int persons = min(Q, M);
  unsigned long long* slot =
      reinterpret_cast<unsigned long long*>(smem);   // Q rows' best real bid
  float* bT = reinterpret_cast<float*>(slot + Q);    // persons x Q: -cost
  float* prices = bT + (size_t)persons * Q;          // Q
  int* owner = reinterpret_cast<int*>(prices + Q);   // Q row -> column
  int* assigned = owner + Q;                         // persons: column -> row
  unsigned* zfree = reinterpret_cast<unsigned*>(assigned + persons);  // 32
  // the zero columns' bid of the round: its row (-1: none), value, column
  int& s_zrow = *reinterpret_cast<int*>(zfree + 32);
  float& s_zbid = *reinterpret_cast<float*>(zfree + 33);
  int& s_zcol = *reinterpret_cast<int*>(zfree + 34);
  // after a run of zero rounds: the round, the columns and the real
  // columns holding no row
  int* s_zrun = reinterpret_cast<int*>(zfree + 35);
  // a block round's change to the real columns holding no row, by the
  // parity of the block rounds: read after the round's last barrier,
  // zeroed in the next round's, added to in the one after
  int* s_dreal = s_zrun + 3;

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int nwarps = blockDim.x >> 5;
  const int prob = blockIdx.x;
  int m = n_valid[prob];
  m = max(0, min(m, persons));
  int64_t* o = out + (size_t)prob * Q;
  if (m == 0) {
    for (int r = t; r < Q; r += blockDim.x) o[r] = -1;
    return;
  }
  const float* cp = cost + (size_t)prob * Q * M;
  for (int k = t; k < Q * m; k += blockDim.x) {
    const int r = k / m, j = k - r * m;
    bT[j * Q + r] = -cp[(size_t)r * M + j];
  }
  for (int r = t; r < Q; r += blockDim.x) {
    prices[r] = 0.f;
    slot[r] = 0ull;
  }
  if (t < 2) s_dreal[t] = 0;
  // warps 0..nwarps-2 take the real columns, the last the zero columns
  const int real_warps = nwarps > 1 ? nwarps - 1 : 1;
  const int zero_warp = nwarps - 1;
  int g = 0;                           // block rounds, over all phases
  __syncthreads();

  for (int ph = 0; ph < phases; ++ph) {
    const float eps = eps_all[(size_t)prob * phases + ph];
    for (int r = t; r < Q; r += blockDim.x) owner[r] = -1;
    for (int j = t; j < m; j += blockDim.x) assigned[j] = -1;
    for (int w = t; w < 32; w += blockDim.x) {
      unsigned bits = 0u;            // the unassigned zero columns m..Q-1
      for (int b = 0; b < 32; ++b)
        if (32 * w + b >= m && 32 * w + b < Q) bits |= 1u << b;
      zfree[w] = bits;
    }
    int open = Q, real_open = m;       // columns holding no row
    __syncthreads();
    for (int it = 0; it < rounds && open > 0;) {
      if (real_open == 0) {
        // only zero columns bid: the rows sorted by (price, row) into the
        // bids' slots (zero between block rounds), a thread a row; then
        // warp 0 runs the rounds alone
        if (t < Q) {
          const unsigned kt = lap_key(prices[t]);
          int rank = 0;
          for (int r = 0; r < Q; ++r) {
            const unsigned kr = lap_key(prices[r]);
            rank += kr < kt || (kr == kt && r < t);
          }
          slot[rank] = ((unsigned long long)kt << 32) |
                       ((unsigned)t << 16) | (unsigned)(owner[t] + 1);
        }
        __syncthreads();
        if (warp == 0) {
          lap_zero_rounds<K>(Q, m, eps, rounds, slot, prices, owner,
                             assigned, zfree, it, open, real_open);
          if (lane == 0) {
            s_zrun[0] = it;
            s_zrun[1] = open;
            s_zrun[2] = real_open;
          }
        }
        __syncthreads();
        it = s_zrun[0];
        open = s_zrun[1];
        real_open = s_zrun[2];
        continue;
      }
      // columns bid
      if (warp < real_warps) {
        for (int j = warp; j < m; j += real_warps) {
          if (assigned[j] >= 0) continue;
          const float* bj = bT + (size_t)j * Q;
          float bv, sv;
          int br;
          lap_warp_top2(Q, [&](int r) { return bj[r] - prices[r]; }, bv, br,
                        sv);
          if (lane == 0) {
            const float bid = ((prices[br] + bv) - sv) + eps;
            atomicMax(&slot[br],
                      ((unsigned long long)lap_key(bid) << 32) | ~(unsigned)j);
          }
        }
      }
      if (warp == zero_warp) {
        const unsigned word = zfree[lane];
        const unsigned any = __ballot_sync(LAP_FULL, word != 0u);
        if (any) {
          float bv, sv;
          int br;
          lap_warp_top2(Q, [&](int r) { return 0.f - prices[r]; }, bv, br,
                        sv);
          const int w = __ffs(any) - 1;
          const unsigned wbits = __shfl_sync(LAP_FULL, word, w);
          if (lane == 0) {
            s_zrow = br;
            s_zbid = ((prices[br] + bv) - sv) + eps;
            s_zcol = 32 * w + __ffs(wbits) - 1;
          }
        } else if (lane == 0) {
          s_zrow = -1;
        }
      }
      __syncthreads();
      // rows take the highest bid, the first column on ties; the columns
      // they held lose them
      int filled = 0;
      if (t == 0) s_dreal[(g & 1) ^ 1] = 0;
      if (t < Q) {
        const unsigned long long s = slot[t];
        slot[t] = 0ull;
        float wv = -CUDART_INF_F;
        int wc = -1;
        if (s) {
          wv = lap_unkey((unsigned)(s >> 32));
          wc = (int)~(unsigned)s;
        }
        if (t == s_zrow && !(s && wv >= s_zbid)) {
          wv = s_zbid;
          wc = s_zcol;
        }
        if (isfinite(wv)) {
          const int old = owner[t];
          int dreal = 0;
          if (old < 0) {
            filled = 1;
          } else if (old < m) {
            assigned[old] = -1;
            dreal = 1;
          } else {
            atomicOr(&zfree[old >> 5], 1u << (old & 31));
          }
          if (wc < m) {
            assigned[wc] = t;
            dreal -= 1;
          } else {
            atomicAnd(&zfree[wc >> 5], ~(1u << (wc & 31)));
          }
          if (dreal) atomicAdd(&s_dreal[g & 1], dreal);
          owner[t] = wc;
          prices[t] = wv;
        }
      }
      open -= __syncthreads_count(filled);
      real_open += s_dreal[g & 1];
      ++g;
      ++it;
    }
  }
  for (int r = t; r < Q; r += blockDim.x) {
    const int j = owner[r];
    o[r] = j >= 0 && j < m ? j : -1;
  }
}

// ---------------------------------------------------------------------------
// entry points: the shared memory each launch needs (the plan's count must
// equal it), the launch, its error
// ---------------------------------------------------------------------------

static int set_smem(const void* fn, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

static size_t jv_warp_smem(int Q, int M) {
  const size_t persons = Q < M ? Q : M;
  return 4 * ((size_t)Q * lap_stride((int)persons) + 3 * (size_t)Q);
}

static size_t jv_cluster_smem(int Q, int M, int cluster, int qc) {
  const size_t persons = Q < M ? Q : M;
  return 16 * 2 * (size_t)cluster * LAP_CLUSTER_WARPS +
         4 * ((size_t)qc * lap_stride((int)persons) + 4 * persons);
}

static size_t auction_smem(int Q, int M) {
  const size_t persons = Q < M ? Q : M;
  return 8 * (size_t)Q + 4 * (persons * Q + 2 * (size_t)Q + persons + 40);
}

template <int K>
static int launch_jv_warp(const void* cost, const void* n_valid, void* out,
                          int N, int Q, int M, size_t smem,
                          cudaStream_t stream) {
  int err = set_smem((const void*)lap_jv_warp_kernel<K>, smem);
  if (err) return err;
  lap_jv_warp_kernel<K><<<N, LAP_WARP_THREADS, smem, stream>>>(
      (const float*)cost, (const int*)n_valid, (int64_t*)out, Q, M);
  return (int)cudaGetLastError();
}

// slots: objects a lane (1, 2, 4, 8 or 16; Q <= 32 * slots); smem: the
// plan's bytes
extern "C" int lap_jv_warp(const void* cost, const void* n_valid, void* out,
                           int N, int Q, int M, int slots, long long smem,
                           void* stream) {
  if (N < 0 || Q < 1 || M < 1 || Q > 32 * slots ||
      (size_t)smem != jv_warp_smem(Q, M))
    return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (slots) {
    case 1: return launch_jv_warp<1>(cost, n_valid, out, N, Q, M, smem, s);
    case 2: return launch_jv_warp<2>(cost, n_valid, out, N, Q, M, smem, s);
    case 4: return launch_jv_warp<4>(cost, n_valid, out, N, Q, M, smem, s);
    case 8: return launch_jv_warp<8>(cost, n_valid, out, N, Q, M, smem, s);
    case 16: return launch_jv_warp<16>(cost, n_valid, out, N, Q, M, smem, s);
  }
  return (int)cudaErrorInvalidValue;
}

template <int K>
static int launch_jv_cluster(const void* cost, const void* n_valid,
                             void* out, int N, int Q, int M, int cluster,
                             int qc, size_t smem, cudaStream_t stream) {
  const void* fn = (const void*)lap_jv_cluster_kernel<K>;
  int err = set_smem(fn, smem);
  if (err) return err;
  if (cluster > 8) {
    err = (int)cudaFuncSetAttribute(
        fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(N * cluster);
  cfg.blockDim = dim3(LAP_CLUSTER_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = (int)cudaLaunchKernelEx(&cfg, lap_jv_cluster_kernel<K>,
                                (const float*)cost, (const int*)n_valid,
                                (int64_t*)out, Q, M, qc);
  if (err) return err;
  return (int)cudaGetLastError();
}

// cluster: CTAs a problem (1..16); slots: objects a thread (1, 2, 4, 8 or
// 16), the CTA's ceil(Q / cluster) objects over 256 threads
extern "C" int lap_jv_cluster(const void* cost, const void* n_valid,
                              void* out, int N, int Q, int M, int cluster,
                              int slots, long long smem, void* stream) {
  if (N < 0 || Q < 1 || M < 1 || Q > LAP_CLUSTER_MAX_Q || cluster < 1 ||
      cluster > 16)
    return (int)cudaErrorInvalidValue;
  const int qc = (Q + cluster - 1) / cluster;
  if (qc > LAP_CLUSTER_THREADS * slots ||
      (size_t)smem != jv_cluster_smem(Q, M, cluster, qc))
    return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (slots) {
    case 1: return launch_jv_cluster<1>(cost, n_valid, out, N, Q, M, cluster,
                                        qc, smem, s);
    case 2: return launch_jv_cluster<2>(cost, n_valid, out, N, Q, M, cluster,
                                        qc, smem, s);
    case 4: return launch_jv_cluster<4>(cost, n_valid, out, N, Q, M, cluster,
                                        qc, smem, s);
    case 8: return launch_jv_cluster<8>(cost, n_valid, out, N, Q, M, cluster,
                                        qc, smem, s);
    case 16: return launch_jv_cluster<16>(cost, n_valid, out, N, Q, M,
                                          cluster, qc, smem, s);
  }
  return (int)cudaErrorInvalidValue;
}

// costT (N, M, Q): the cost transposed; scratch: NULL to keep the state in
// shared memory, else N * 5 * Q words of device memory for it
extern "C" int lap_jv_tall(const void* costT, const void* n_valid, void* out,
                           void* scratch, int N, int Q, int M, long long smem,
                           void* stream) {
  if (N < 0 || Q < 1 || M < 1 ||
      (size_t)smem !=
          sizeof(float) * ((size_t)M + (scratch ? 0 : 5 * (size_t)Q)))
    return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  int err = set_smem((const void*)lap_jv_tall_kernel, smem);
  if (err) return err;
  lap_jv_tall_kernel<<<N, LAP_TALL_THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)costT, (const int*)n_valid, (int64_t*)out,
      (float*)scratch, Q, M);
  return (int)cudaGetLastError();
}

template <int K>
static int launch_auction(const void* cost, const void* n_valid,
                          const void* eps, void* out, int N, int Q, int M,
                          int phases, int rounds, int threads, size_t smem,
                          cudaStream_t stream) {
  int err = set_smem((const void*)lap_auction_kernel<K>, smem);
  if (err) return err;
  lap_auction_kernel<K><<<N, threads, smem, stream>>>(
      (const float*)cost, (const int*)n_valid, (const float*)eps,
      (int64_t*)out, Q, M, phases, rounds);
  return (int)cudaGetLastError();
}

// threads: the block (a multiple of 32, at least Q, at most 1,024); slots:
// rows a lane of the zero columns' warp (1, 2, 4, 8, 16 or 32; Q <= 32 *
// slots)
extern "C" int lap_auction(const void* cost, const void* n_valid,
                           const void* eps, void* out, int N, int Q, int M,
                           int phases, int rounds, int threads, int slots,
                           long long smem, void* stream) {
  if (N < 0 || Q < 1 || M < 1 || M > Q || Q > 1024 || phases < 0 ||
      rounds < 0 || threads % 32 || threads < Q || threads > 1024 ||
      Q > 32 * slots || (size_t)smem != auction_smem(Q, M))
    return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (slots) {
    case 1: return launch_auction<1>(cost, n_valid, eps, out, N, Q, M,
                                     phases, rounds, threads, smem, s);
    case 2: return launch_auction<2>(cost, n_valid, eps, out, N, Q, M,
                                     phases, rounds, threads, smem, s);
    case 4: return launch_auction<4>(cost, n_valid, eps, out, N, Q, M,
                                     phases, rounds, threads, smem, s);
    case 8: return launch_auction<8>(cost, n_valid, eps, out, N, Q, M,
                                     phases, rounds, threads, smem, s);
    case 16: return launch_auction<16>(cost, n_valid, eps, out, N, Q, M,
                                       phases, rounds, threads, smem, s);
    case 32: return launch_auction<32>(cost, n_valid, eps, out, N, Q, M,
                                       phases, rounds, threads, smem, s);
  }
  return (int)cudaErrorInvalidValue;
}
