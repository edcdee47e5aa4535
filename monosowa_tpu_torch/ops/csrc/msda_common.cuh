// Shared by msda_fwd.cu and msda_bwd.cu: the pyramid's levels, the block map
// and the bilinear corner geometry of multi-scale deformable attention.
//
// The block map.  A block owns one (image, head) pair and one run of
// queries: runs[2 * r] is the run's first place in `order`, runs[2 * r + 1]
// its length, and order[] lists query indices (a permutation of 0..Q-1
// built in ops/msda.py: image tiles where the queries are the pyramid's own
// tokens, index order otherwise).  blockIdx.x = (b * M + m) * n_runs + r.
// With null `order` and `runs` the queries go in index order, max_run to a
// block, and a block reads neither array before it starts.
//
// Value's element type T is float or __nv_bfloat16 (the bf16 value rows
// that the TPU kernels read); every product, sum and output is float32.
//
// Inside a block, G lanes (4, 8, 16 or 32) share one query: lane gl of a
// group owns channels [c0 + gl * VEC, c0 + gl * VEC + VEC) of the head's
// row: VEC = 4 (one 16-byte float4 of a float32 value, 8 bytes of a bf16
// one), VEC = 8 (16 bytes of bf16: the forward's bf16 form, where a head of
// 32 channels is four lanes), or one element where VEC = 1.  A warp so works
// on 32 / G queries at once, all at the same sample index and therefore at
// the same level.
//
// Resident levels.  The levels in `resident_mask` are copied whole, for the
// block's (image, head), into dynamic shared memory at sm_off[level]
// (elements of T, rows of D), in value's own type.  A whole level has no
// window edge: every in-bounds corner of a resident level is read from
// shared memory.  Above 48 KB the entry points raise the kernel's limit
// once (msda_grant_smem).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define MSDA_MAX_LEVELS 8
#define MSDA_TOKEN_BITS 27  // of a SamplePlace's code

struct Levels {
  int h[MSDA_MAX_LEVELS];
  int w[MSDA_MAX_LEVELS];
  int start[MSDA_MAX_LEVELS];
  int sm_off[MSDA_MAX_LEVELS];  // elements of T from the resident copy's start
  int resident_mask;            // bit l: level l of value is in shared memory
  int resident_elems;           // elements of T of the resident copy
  // the backward only: the resident levels whose share of dvalue is summed
  // in shared memory too, in a block of grad_floats floats (float32 for
  // every T) after the copy (msda_grad_start)
  int grad_off[MSDA_MAX_LEVELS];
  int grad_mask;
  int grad_floats;
};

// Fills lv from a host array of n_levels (H, W) pairs.  Returns the number
// of tokens, or -1 for a level that is empty or too large, a mask that names
// a level that does not exist, or a grad level that is not resident.
static inline int msda_fill_levels(Levels* lv, const int* hw, int n_levels,
                                   int resident_mask, int grad_mask, int D) {
  int start = 0, off = 0, goff = 0;
  if ((resident_mask >> n_levels) || (grad_mask & ~resident_mask)) return -1;
  for (int l = 0; l < n_levels; ++l) {
    // a level's tokens, and w + 1 more, fit a SamplePlace's code
    if (hw[2 * l] < 1 || hw[2 * l + 1] < 1 ||
        ((long long)hw[2 * l] + 1) * ((long long)hw[2 * l + 1] + 1) >=
            (1LL << MSDA_TOKEN_BITS))
      return -1;
    const int elems = hw[2 * l] * hw[2 * l + 1] * D;
    lv->h[l] = hw[2 * l];
    lv->w[l] = hw[2 * l + 1];
    lv->start[l] = start;
    lv->sm_off[l] = off;
    lv->grad_off[l] = goff;
    start += lv->h[l] * lv->w[l];
    if ((resident_mask >> l) & 1) off += elems;
    if ((grad_mask >> l) & 1) goff += elems;
  }
  lv->resident_mask = resident_mask;
  lv->resident_elems = off;
  lv->grad_mask = grad_mask;
  lv->grad_floats = goff;
  return start;
}

// Bytes from the start of shared memory to the backward's float32 grad
// levels: the resident copy in T, rounded up to 16 bytes.
template <typename T>
__host__ __device__ __forceinline__ size_t msda_grad_start(const Levels& lv) {
  return ((size_t)lv.resident_elems * sizeof(T) + 15) / 16 * 16;
}

// Lanes that share a query for a head of D channels at VEC channels a lane:
// 8 at the least, 4 for 16-byte lanes of 8 bf16 channels.
static inline int msda_group_lanes(int D, int vec) {
  for (int g = vec == 8 ? 4 : 8; g < 32; g *= 2)
    if (D <= g * vec) return g;
  return 32;
}

// Threads of a block: a lane group for each query of the longest run, in
// whole warps, at most `most`.
static inline int msda_block_threads(int max_run, int group_lanes, int most) {
  const long long want = ((long long)max_run * group_lanes + 31) / 32 * 32;
  return (int)(want < 32 ? 32 : (want > most ? most : want));
}

static inline bool msda_aligned16(const void* p) {
  return (reinterpret_cast<size_t>(p) & 15) == 0;
}

// Raises the kernel's dynamic shared memory limit where the launch needs
// more than `*granted` bytes (48 KB without asking).
template <typename K>
static inline cudaError_t msda_grant_smem(K kernel, size_t bytes,
                                          size_t* granted) {
  if (bytes <= *granted) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) *granted = bytes;
  return err;
}

// VEC float32 channels of a row of out, dout or dvalue (or of the
// shared-memory grad levels): VEC / 4 16-byte vectors, or one float.
template <int VEC>
struct Row {
  static_assert(VEC == 1 || VEC % 4 == 0, "1 or whole float4s");
  float v[VEC];
  __device__ __forceinline__ void load_global(const float* p) {
    if constexpr (VEC == 1) {
      v[0] = __ldg(p);
    } else {
#pragma unroll
      for (int i = 0; i < VEC / 4; ++i)
        set4(i, __ldg(reinterpret_cast<const float4*>(p) + i));
    }
  }
  __device__ __forceinline__ void load_shared(const float* p) {
    if constexpr (VEC == 1) {
      v[0] = *p;
    } else {
#pragma unroll
      for (int i = 0; i < VEC / 4; ++i)
        set4(i, reinterpret_cast<const float4*>(p)[i]);
    }
  }
  __device__ __forceinline__ void store(float* p) const {
    if constexpr (VEC == 1) {
      *p = v[0];
    } else {
#pragma unroll
      for (int i = 0; i < VEC / 4; ++i)
        reinterpret_cast<float4*>(p)[i] = get4(i);
    }
  }
  // 16-byte vector atomics in global memory (one float: a scalar one)
  __device__ __forceinline__ void add_global(float* p) const {
    if constexpr (VEC == 1) {
      atomicAdd(p, v[0]);
    } else {
#pragma unroll
      for (int i = 0; i < VEC / 4; ++i)
        atomicAdd(reinterpret_cast<float4*>(p) + i, get4(i));
    }
  }
  __device__ __forceinline__ void set4(int i, float4 t) {
    v[4 * i] = t.x, v[4 * i + 1] = t.y, v[4 * i + 2] = t.z,
    v[4 * i + 3] = t.w;
  }
  __device__ __forceinline__ float4 get4(int i) const {
    return make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
  }
};

// VEC channels of a row of value (type T), as float32.
template <typename T, int VEC>
struct ValueRow;

template <int VEC>
struct ValueRow<float, VEC> : Row<VEC> {};

// eight bf16 channels: one 16-byte load, converted in pairs by the
// intrinsics
template <>
struct ValueRow<__nv_bfloat16, 8> {
  float v[8];
  __device__ __forceinline__ void load_global(const __nv_bfloat16* p) {
    convert(__ldg(reinterpret_cast<const uint4*>(p)));
  }
  __device__ __forceinline__ void load_shared(const __nv_bfloat16* p) {
    convert(*reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ void convert(uint4 t) {
    const unsigned u[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      __nv_bfloat162 h;
      h.x = __ushort_as_bfloat16((unsigned short)(u[i] & 0xffffu));
      h.y = __ushort_as_bfloat16((unsigned short)(u[i] >> 16));
      const float2 f = __bfloat1622float2(h);
      v[2 * i] = f.x, v[2 * i + 1] = f.y;
    }
  }
};

// four bf16 channels: one 8-byte load (the backward's lanes, laid out as
// its float32 form's: dout and dvalue stay 16 bytes a lane)
template <>
struct ValueRow<__nv_bfloat16, 4> {
  float v[4];
  __device__ __forceinline__ void load_global(const __nv_bfloat16* p) {
    convert(__ldg(reinterpret_cast<const uint2*>(p)));
  }
  __device__ __forceinline__ void load_shared(const __nv_bfloat16* p) {
    convert(*reinterpret_cast<const uint2*>(p));
  }
  __device__ __forceinline__ void convert(uint2 t) {
    const unsigned u[2] = {t.x, t.y};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      __nv_bfloat162 h;
      h.x = __ushort_as_bfloat16((unsigned short)(u[i] & 0xffffu));
      h.y = __ushort_as_bfloat16((unsigned short)(u[i] >> 16));
      const float2 f = __bfloat1622float2(h);
      v[2 * i] = f.x, v[2 * i + 1] = f.y;
    }
  }
};

template <>
struct ValueRow<__nv_bfloat16, 1> {
  float v[1];
  __device__ __forceinline__ void load_global(const __nv_bfloat16* p) {
    v[0] = __bfloat162float(__ldg(p));
  }
  __device__ __forceinline__ void load_shared(const __nv_bfloat16* p) {
    v[0] = __bfloat162float(*p);
  }
};

// A sample's place on its level, computed once by the lane that loaded the
// sample and handed round its lane group by shuffles: the fractions (dx, dy)
// and `code`, the token of the corner (x0, y0) plus w + 1 (so that it is not
// negative) in the low 27 bits and the four corners' in-bounds flags above.
// grid_sample semantics (align_corners=False, zero padding); the explicit
// round-to-nearest multiply and subtract are the plain version's roundings
// (no fused multiply-add), so both pick the same corners even on the integer
// pixel grid.  Corner k is (x0 + (k & 1), y0 + (k >> 1)).
struct SamplePlace {
  float dx, dy;
  int code;

  __device__ __forceinline__ SamplePlace(float ux, float uy, int h, int w) {
    const float x = __fsub_rn(__fmul_rn(ux, (float)w), 0.5f);
    const float y = __fsub_rn(__fmul_rn(uy, (float)h), 0.5f);
    const float x0 = floorf(x), y0 = floorf(y);
    dx = x - x0, dy = y - y0;
    // the float tests keep huge and non-finite coordinates out before any
    // conversion to int
    const bool x_lo = x0 >= 0.f && x0 < (float)w;
    const bool x_hi = x0 + 1.f >= 0.f && x0 + 1.f < (float)w;
    const bool y_lo = y0 >= 0.f && y0 < (float)h;
    const bool y_hi = y0 + 1.f >= 0.f && y0 + 1.f < (float)h;
    const int flags = (x_lo && y_lo) | (x_hi && y_lo) << 1 |
                      (x_lo && y_hi) << 2 | (x_hi && y_hi) << 3;
    const int t = flags ? (int)y0 * w + (int)x0 : 0;
    code = (t + w + 1) | flags << MSDA_TOKEN_BITS;
  }
};

// The four bilinear corners of a sample, rebuilt from its SamplePlace by
// every lane of the group.
struct Corners {
  float cw[4];   // bilinear weight
  float dwx[4];  // d weight / d x
  float dwy[4];  // d weight / d y
  int tok[4];    // token within the level, row-major
  bool inb[4];

  __device__ __forceinline__ Corners(float dx, float dy, int code, int w) {
    cw[0] = (1.f - dx) * (1.f - dy), cw[1] = dx * (1.f - dy);
    cw[2] = (1.f - dx) * dy, cw[3] = dx * dy;
    dwx[0] = -(1.f - dy), dwx[1] = 1.f - dy, dwx[2] = -dy, dwx[3] = dy;
    dwy[0] = -(1.f - dx), dwy[1] = -dx, dwy[2] = 1.f - dx, dwy[3] = dx;
    const int t = (code & ((1 << MSDA_TOKEN_BITS) - 1)) - w - 1;
    tok[0] = t, tok[1] = t + 1, tok[2] = t + w, tok[3] = t + w + 1;
#pragma unroll
    for (int k = 0; k < 4; ++k) inb[k] = (code >> (MSDA_TOKEN_BITS + k)) & 1;
  }
};

// Copies the resident levels of (b, m) from `src` (B, S, M, D) into `sm`,
// VEC elements of T at a time (one 16- or 8-byte vector where VEC elements
// make one), in value's own type.
template <typename T, int VEC>
__device__ __forceinline__ void msda_stage_levels(
    T* sm, const T* __restrict__ src, const Levels& lv, int n_levels, int S,
    int M, int D, int b, int m) {
  const int per_row = D / VEC;
  for (int l = 0; l < n_levels; ++l) {
    if (!((lv.resident_mask >> l) & 1)) continue;
    const T* base = src + (((size_t)b * S + lv.start[l]) * M + m) * D;
    T* dst = sm + lv.sm_off[l];
    const int n = lv.h[l] * lv.w[l] * per_row;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const int r = i / per_row, c = (i - r * per_row) * VEC;
      const T* from = base + (size_t)r * M * D + c;
      T* to = dst + r * D + c;
      if constexpr (VEC * sizeof(T) == 16) {
        *reinterpret_cast<uint4*>(to) =
            __ldg(reinterpret_cast<const uint4*>(from));
      } else if constexpr (VEC * sizeof(T) == 8) {
        *reinterpret_cast<uint2*>(to) =
            __ldg(reinterpret_cast<const uint2*>(from));
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) to[e] = from[e];
      }
    }
  }
}
