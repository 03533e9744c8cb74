// Device-side twins of kernels/cache_layout.py, shared by the ConSmax
// kernels and the softmax baseline: the one mask (kv_mask, causal or not),
// the fill-bounding skip predicate (shard_live) and the ConSmax weights
// (consmax_weight), the quantized cache's dequant (dequant_block), plus
// small vector load helpers. Keep each formula identical to its Python
// twin: the plain versions the kernels are tested against are built from
// those.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

// cache_layout.kv_mask: query at absolute position qpos sees key row kpos
// iff kpos < kv_len, (causal) qpos >= kpos and (window > 0)
// qpos - kpos < window. The serving kernels are always causal; the
// full-sequence kernels count query and key positions from 0, so their
// causal mask is top-left aligned.
__device__ __forceinline__ bool kv_mask(int qpos, int kpos, int kv_len,
                                        int window, bool causal = true) {
  bool m = kpos < kv_len;
  if (causal) m = m && (qpos >= kpos);
  if (window > 0) m = m && (qpos - kpos < window);
  return m;
}

// cache_layout.shard_live: rows [start, start + size) can contribute for a
// query in [qpos_lo, qpos_hi].
__device__ __forceinline__ bool shard_live(int start, int size, int kv_len,
                                           int qpos_hi, int qpos_lo,
                                           int window) {
  bool live = (start < kv_len) && (start <= qpos_hi);
  if (window > 0) live = live && (start + size > qpos_lo - window + 1);
  return live;
}

// The merged constant of Eq. 3, C = exp(-beta) / gamma: computed once per
// query head by the caller, outside the KV loop.
__device__ __forceinline__ float consmax_c(float beta, float gamma) {
  return expf(-beta) / gamma;
}

// Optional tanh softcap, then cache_layout.consmax_weights: merged
// c * exp(s) with c = consmax_c(beta, gamma) (Eq. 3), else
// exp(s - beta) / gamma (Eq. 2). The form is fixed at compile time, so
// neither the other form nor a per-score exp(-beta) / gamma stays in the
// tile loop. Only called for unmasked entries.
template <bool kMerged>
__device__ __forceinline__ float consmax_weight(float s, float beta,
                                                float gamma, float c,
                                                float softcap) {
  if (softcap > 0.f) s = softcap * tanhf(s / softcap);
  return kMerged ? c * expf(s) : expf(s - beta) / gamma;
}

// Where a slot's logical cache row lives: the one thing the contiguous and
// the paged kernels do differently. row(b, r, &i) sets i to the index of the
// (hkv * dk)-element row that holds logical row r of slot b, and returns
// false when no row backs it (an unmapped page), which a kernel must treat
// as exact zeros without loading anything. The tile walk, the shard split
// and the numerics are the same for both, and tiles and shards stay aligned
// to logical row positions: a paged kernel gives the contiguous kernel's
// bits whenever the pages hold the same rows, for any page size.
//
// ContigRows: a (b, L, hkv, dk) cache; row r of slot b is row b * L + r.
struct ContigRows {
  int L;
  __device__ __forceinline__ bool row(int b, int r, size_t* i) const {
    *i = static_cast<size_t>(b) * L + r;
    return true;
  }
};

// PagedRows: a (P, ps, hkv, dk) page pool and a (b, npg) int32 table; row r
// of slot b is row table[b, r / ps] * ps + r % ps, and a -1 entry maps
// nothing. The column is clamped into [0, npg) so a read can never leave
// the slot's table row, even for r past its last column.
struct PagedRows {
  const int* table;
  int npg, ps;
  __device__ __forceinline__ bool row(int b, int r, size_t* i) const {
    const int col = min(r / ps, npg - 1);
    const int page = __ldg(table + static_cast<size_t>(b) * npg + col);
    *i = static_cast<size_t>(page) * ps + r % ps;
    return page >= 0;
  }
};

// One aligned access of NBYTES bytes.
template <int NBYTES> struct RawVec;
template <> struct RawVec<1> { using T = uint8_t; };
template <> struct RawVec<2> { using T = unsigned short; };
template <> struct RawVec<4> { using T = unsigned int; };
template <> struct RawVec<8> { using T = uint2; };
template <> struct RawVec<16> { using T = uint4; };

// N contiguous bf16 values as one aligned access, widened to fp32.
template <int N>
__device__ __forceinline__ void load_bf16(const __nv_bfloat16* p, float* out) {
  using V = typename RawVec<2 * N>::T;
  V raw = *reinterpret_cast<const V*>(p);
  const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
  for (int i = 0; i < N; ++i) out[i] = __bfloat162float(e[i]);
}

// The K/V element types a cache is stored in (cache_layout.KV_DTYPES):
// bf16 as is; int8 and fp8_e4m3 codes with one fp32 scale per row and KV
// head. KVType<T>::kScaled says whether a read multiplies by the scale.
enum KVCode { kKVBF16 = 0, kKVInt8 = 1, kKVFP8 = 2 };  // the ops' kv_type
template <class T> struct KVType { static constexpr bool kScaled = true; };
template <> struct KVType<__nv_bfloat16> {
  static constexpr bool kScaled = false;
};

__device__ __forceinline__ float code_value(int8_t x) {
  return static_cast<float>(x);
}
__device__ __forceinline__ float code_value(__nv_fp8_e4m3 x) {
  return static_cast<float>(x);
}

// cache_layout.dequant_block for one code: the fp32 product code * scale
// (__fmul_rn: never contracted into a later FMA), rounded to bf16 — the
// compute dtype the cache is read in. So a kernel on a quantized cache
// computes exactly what it computes on the dequantized bf16 cache.
__device__ __forceinline__ __nv_bfloat16 dequant(float code, float scale) {
  return __float2bfloat16_rn(__fmul_rn(code, scale));
}

// N contiguous K/V elements of type T as one aligned access, dequantized
// with ``scale`` (ignored for bf16, which is read as stored) and widened to
// fp32: the same values load_bf16 reads from the dequantized cache.
template <class T, int N>
__device__ __forceinline__ void load_kv(const T* p, float scale, float* out) {
  if constexpr (!KVType<T>::kScaled) {
    load_bf16<N>(p, out);
  } else {
    using V = typename RawVec<N>::T;  // one byte per code
    V raw = *reinterpret_cast<const V*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < N; ++i)
      out[i] = __bfloat162float(dequant(code_value(e[i]), scale));
  }
}

// 16 codes (one 16-byte access) dequantized to 16 bf16 values, as two
// 16-byte words for a shared-memory tile row.
template <class T>
__device__ __forceinline__ void dequant16(const T* p, float scale,
                                          uint4* lo, uint4* hi) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const T* e = reinterpret_cast<const T*>(&raw);
  uint32_t w[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    __nv_bfloat162 t;
    t.x = dequant(code_value(e[2 * i]), scale);
    t.y = dequant(code_value(e[2 * i + 1]), scale);
    w[i] = *reinterpret_cast<const uint32_t*>(&t);
  }
  *lo = make_uint4(w[0], w[1], w[2], w[3]);
  *hi = make_uint4(w[4], w[5], w[6], w[7]);
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
