// Levers of lap_auction's rounds in which only the zero columns bid, tried
// on the way to the design that monosowa_tpu_torch/ops/csrc/lap.cu ships
// (lap_zero_rounds: warp 0 alone on the rows kept sorted by price in its
// registers) and not shipped, so that tools/bench_lap_torch.py --levers
// can time them again beside the shipped kernel on the same inputs.  CUDA
// C++ for sm_90a.  The kernel is the shipped one but for those rounds; the
// keys, the top two and the sizes come from lap.cu.
//
// lever 0: no such rounds: every round is the block's, with its barriers.
// lever 1: warp 0 runs them alone on the prices and owners in shared
//          memory: lap_warp_top2, lane 0 moves the row to its new owner.
// lever 2: the same in registers, lane l the rows l + 32k: the top two by
//          three redux.sync, the row's price and owner by shuffles from
//          the lane that holds them.
// lever 3: the same in registers, lane l a block of K rows: the first row
//          at the best lies in the lowest lane holding it, the second is
//          read with the count of lanes at the best, and the winning lane
//          bids and broadcasts what its row held.

#include <limits.h>

#include "../../monosowa_tpu_torch/ops/csrc/lap.cu"

__device__ __forceinline__ void lever_zero_smem(
    int Q, int m, float eps, int rounds, float* prices, int* owner,
    int* assigned, unsigned* zfree, int& it, int& open, int& real_open) {
  const int lane = threadIdx.x & 31;
  while (it < rounds && open > 0) {
    const unsigned any = __ballot_sync(LAP_FULL, zfree[lane] != 0u);
    if (any == 0u) break;
    float bv, sv;
    int br;
    lap_warp_top2(Q, [&](int r) { return 0.f - prices[r]; }, bv, br, sv);
    const float bid = ((prices[br] + bv) - sv) + eps;
    ++it;
    if (!isfinite(bid)) {
      it = rounds;
      break;
    }
    int delta = 0;                     // 1: a row filled; 2: a real column out
    if (lane == 0) {
      const int w = __ffs(any) - 1;
      const int col = 32 * w + __ffs(zfree[w]) - 1;
      const int old = owner[br];
      if (old < 0) {
        delta = 1;
      } else if (old < m) {
        assigned[old] = -1;
        delta = 2;
      } else {
        zfree[old >> 5] |= 1u << (old & 31);
      }
      zfree[w] &= ~(1u << (col & 31));
      owner[br] = col;
      prices[br] = bid;
    }
    __syncwarp();
    delta = __shfl_sync(LAP_FULL, delta, 0);
    if (delta == 1) --open;
    if (delta == 2) {
      real_open = 1;
      break;
    }
  }
}

template <int K>
__device__ __forceinline__ void lever_zero_strided(
    int Q, int m, float eps, int rounds, float* prices, int* owner,
    int* assigned, unsigned* zfree, int& it, int& open, int& real_open) {
  const int lane = threadIdx.x & 31;
  float pr[K];
  int ow[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int r = lane + 32 * k;
    pr[k] = r < Q ? prices[r] : 0.f;
    ow[k] = r < Q ? owner[r] : -1;
  }
  unsigned zw = zfree[lane];
  while (it < rounds && open > 0) {
    const unsigned any = __ballot_sync(LAP_FULL, zw != 0u);
    if (any == 0u) break;
    float bv = -CUDART_INF_F, sv = -CUDART_INF_F;
    int br = Q;
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (lane + 32 * k < Q)
        lap_top2_step(0.f - pr[k], lane + 32 * k, bv, br, sv);
    const unsigned kb = lap_key(bv);
    const unsigned kmax = __reduce_max_sync(LAP_FULL, kb);
    const int row =
        (int)__reduce_min_sync(LAP_FULL, kb == kmax ? (unsigned)br : LAP_NONE);
    const unsigned ks = __reduce_max_sync(
        LAP_FULL, lap_key(kb == kmax && br == row ? sv : bv));
    const int src = row & 31, kr = row >> 5;
    float pm = 0.f;
    int om = -1;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (k == kr) {
        pm = pr[k];
        om = ow[k];
      }
    }
    const float prow = __shfl_sync(LAP_FULL, pm, src);
    const int old = __shfl_sync(LAP_FULL, om, src);
    const float bid = ((prow + lap_unkey(kmax)) - lap_unkey(ks)) + eps;
    ++it;
    if (!isfinite(bid)) {
      it = rounds;
      break;
    }
    const int w = __ffs(any) - 1;
    const int col = 32 * w + __ffs(__shfl_sync(LAP_FULL, zw, w)) - 1;
    if (lane == src) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (k == kr) {
          pr[k] = bid;
          ow[k] = col;
        }
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
    const int r = lane + 32 * k;
    if (r < Q) {
      prices[r] = pr[k];
      owner[r] = ow[k];
    }
  }
  zfree[lane] = zw;
}

template <int K>
__device__ __forceinline__ void lever_zero_blocks(
    int Q, int m, float eps, int rounds, float* prices, int* owner,
    int* assigned, unsigned* zfree, int& it, int& open, int& real_open) {
  const int lane = threadIdx.x & 31;
  float pr[K];
  int ow[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int r = lane * K + k;
    pr[k] = r < Q ? prices[r] : 0.f;
    ow[k] = r < Q ? owner[r] : -1;
  }
  unsigned zw = zfree[lane];
  while (it < rounds && open > 0) {
    const unsigned any = __ballot_sync(LAP_FULL, zw != 0u);
    if (any == 0u) break;
    const int w = __ffs(any) - 1;
    const int col = 32 * w + __ffs(__shfl_sync(LAP_FULL, zw, w)) - 1;
    float bv = -CUDART_INF_F, sv = -CUDART_INF_F;
    int kb = K;
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (lane * K + k < Q) lap_top2_step(0.f - pr[k], k, bv, kb, sv);
    const unsigned key = lap_key(bv);
    const unsigned kmax = __reduce_max_sync(LAP_FULL, key);
    const unsigned tied = __ballot_sync(LAP_FULL, key == kmax);
    const unsigned ks =
        __reduce_max_sync(LAP_FULL, lap_key(key == kmax ? sv : bv));
    const int win = __ffs(tied) - 1;
    int code = 0;                      // the row's old owner, or INT_MIN
    if (lane == win) {
      const unsigned k2 = (tied & (tied - 1u)) ? kmax : ks;
      float prow = 0.f;
      int old = -1;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (k == kb) {
          prow = pr[k];
          old = ow[k];
        }
      }
      const float bid = ((prow + lap_unkey(kmax)) - lap_unkey(k2)) + eps;
      code = INT_MIN;
      if (isfinite(bid)) {
        code = old;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          if (k == kb) {
            pr[k] = bid;
            ow[k] = col;
          }
        }
      }
    }
    code = __shfl_sync(LAP_FULL, code, win);
    ++it;
    if (code == INT_MIN) {
      it = rounds;
      break;
    }
    if (lane == w) zw &= ~(1u << (col & 31));
    if (code >= m && lane == (code >> 5)) zw |= 1u << (code & 31);
    if (code < 0) {
      --open;
    } else if (code < m) {
      if (lane == 0) assigned[code] = -1;
      real_open = 1;
      break;
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int r = lane * K + k;
    if (r < Q) {
      prices[r] = pr[k];
      owner[r] = ow[k];
    }
  }
  zfree[lane] = zw;
}

template <int K, int LEVER>
__global__ void __launch_bounds__(1024, 1) lever_auction_kernel(
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
      if (LEVER > 0 && real_open == 0) {
        // only zero columns bid: warp 0 runs the rounds alone
        if (warp == 0) {
          if (LEVER == 1)
            lever_zero_smem(Q, m, eps, rounds, prices, owner, assigned, zfree,
                            it, open, real_open);
          else if (LEVER == 2)
            lever_zero_strided<K>(Q, m, eps, rounds, prices, owner, assigned,
                                  zfree, it, open, real_open);
          else
            lever_zero_blocks<K>(Q, m, eps, rounds, prices, owner, assigned,
                                 zfree, it, open, real_open);
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


template <int K, int LEVER>
static int launch_lever(const void* cost, const void* n_valid,
                        const void* eps, void* out, int N, int Q, int M,
                        int phases, int rounds, int threads, size_t smem,
                        cudaStream_t stream) {
  int err = set_smem((const void*)lever_auction_kernel<K, LEVER>, smem);
  if (err) return err;
  lever_auction_kernel<K, LEVER><<<N, threads, smem, stream>>>(
      (const float*)cost, (const int*)n_valid, (const float*)eps,
      (int64_t*)out, Q, M, phases, rounds);
  return (int)cudaGetLastError();
}

template <int K>
static int launch_lever_k(int lever, const void* cost, const void* n_valid,
                          const void* eps, void* out, int N, int Q, int M,
                          int phases, int rounds, int threads, size_t smem,
                          cudaStream_t s) {
  switch (lever) {
    case 0: return launch_lever<K, 0>(cost, n_valid, eps, out, N, Q, M,
                                      phases, rounds, threads, smem, s);
    case 1: return launch_lever<K, 1>(cost, n_valid, eps, out, N, Q, M,
                                      phases, rounds, threads, smem, s);
    case 2: return launch_lever<K, 2>(cost, n_valid, eps, out, N, Q, M,
                                      phases, rounds, threads, smem, s);
    case 3: return launch_lever<K, 3>(cost, n_valid, eps, out, N, Q, M,
                                      phases, rounds, threads, smem, s);
  }
  return (int)cudaErrorInvalidValue;
}

// lap_auction's arguments (its plan's threads, slots and shared memory),
// and the lever (0-3); slots 1, 2 or 4 (Q <= 128)
extern "C" int lap_lever_auction(const void* cost, const void* n_valid,
                                 const void* eps, void* out, int N, int Q,
                                 int M, int phases, int rounds, int threads,
                                 int slots, int lever, long long smem,
                                 void* stream) {
  if (N < 0 || Q < 1 || M < 1 || M > Q || Q > 32 * slots || phases < 0 ||
      rounds < 0 || threads % 32 || threads < Q || threads > 1024 ||
      (size_t)smem != auction_smem(Q, M))
    return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (slots) {
    case 1: return launch_lever_k<1>(lever, cost, n_valid, eps, out, N, Q, M,
                                     phases, rounds, threads, smem, s);
    case 2: return launch_lever_k<2>(lever, cost, n_valid, eps, out, N, Q, M,
                                     phases, rounds, threads, smem, s);
    case 4: return launch_lever_k<4>(lever, cost, n_valid, eps, out, N, Q, M,
                                     phases, rounds, threads, smem, s);
  }
  return (int)cudaErrorInvalidValue;
}
