// Device-side twins of kernels/cache_layout.py, shared by the ConSmax
// kernels and the softmax baseline: the one mask (kv_mask, causal or not),
// the fill-bounding skip predicate (live_shards), the ConSmax weights
// (consmax_weight) and the quantized cache's dequant (dequant_block). Keep
// each formula identical to its Python twin: the plain versions the kernels
// are tested against are built from those.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
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

// A kernel counts its own launches: thread 0 of block (0, 0, 0) adds one to
// the wrapper's device counter (null: not counted), so a launch a CUDA graph
// replays counts as one made eagerly (kernels/_build.py launch_counter).
__device__ __forceinline__ void count_launch(unsigned long long* launches) {
  if (launches && threadIdx.x == 0 && blockIdx.x == 0 && blockIdx.y == 0 &&
      blockIdx.z == 0)
    atomicAdd(launches, 1ULL);
}

// cache_layout.shard_live for a decode step (the query at row n - 1 of a
// slot with n valid rows), over the shards of bk rows: the live shards are
// one run [s0, s1) of the ns shards (shard_live is monotonic in the shard
// start); every shard when fill_bound is off.
__device__ __forceinline__ void live_shards(int n, int bk, int ns, int window,
                                            int fill_bound, int* s0,
                                            int* s1) {
  *s0 = 0;
  *s1 = ns;
  if (!fill_bound) return;
  *s1 = n > 0 ? min(ns, (n - 1) / bk + 1) : 0;
  if (window > 0) *s0 = max(0, (n - window) / bk);
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
// cache_row(b) is the row of the cache that query row b reads: b itself,
// except for a contiguous cache given a slot operand.
//
// ContigRows: a (B, L, hkv, dk) cache; row r of slot s is row s * L + r.
// With `slot` (b,) int32 on the device, query row b reads cache slot
// slot[b] (the engine's static prefill step: one request's chunk against
// the whole slot pool, its slot a value, not an address); without, slot b.
struct ContigRows {
  int L;
  const int* slot = nullptr;
  __device__ __forceinline__ int cache_row(int b) const {
    return slot ? __ldg(slot + b) : b;
  }
  __device__ __forceinline__ bool row(int s, int r, size_t* i) const {
    *i = static_cast<size_t>(s) * L + r;
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
  __device__ __forceinline__ int cache_row(int b) const { return b; }
  __device__ __forceinline__ bool row(int b, int r, size_t* i) const {
    const int col = min(r / ps, npg - 1);
    const int page = __ldg(table + static_cast<size_t>(b) * npg + col);
    *i = static_cast<size_t>(page) * ps + r % ps;
    return page >= 0;
  }
};

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
// computes exactly what it computes on the dequantized bf16 cache (a pair
// rounded by one __floats2bfloat162_rn gets the same two values).
__device__ __forceinline__ __nv_bfloat16 dequant(float code, float scale) {
  return __float2bfloat16_rn(__fmul_rn(code, scale));
}

// The four codes of a 32-bit word as fp32 values, exactly (code_value's
// values) on the ALU and FMA pipes: int8 by placing each byte, offset by
// 128, in the mantissa of 2^23 (one PRMT) and subtracting 2^23 + 128;
// fp8_e4m3 two at a time through the e4m3x2 -> f16x2 conversion (every
// e4m3 value is an f16 value).
template <class T> __device__ void code_values4(uint32_t w, float* out);
template <>
__device__ __forceinline__ void code_values4<int8_t>(uint32_t w,
                                                     float* out) {
  const uint32_t u = w ^ 0x80808080u;  // code + 128 in each byte
#pragma unroll
  for (int i = 0; i < 4; ++i)
    out[i] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + i)) -
             8388736.f;
}
template <>
__device__ __forceinline__ void code_values4<__nv_fp8_e4m3>(uint32_t w,
                                                            float* out) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(
        static_cast<__nv_fp8x2_storage_t>(w >> (16 * i)), __NV_E4M3);
    const float2 f = __half22float2(*reinterpret_cast<const __half2*>(&h));
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// 16 codes (one 16-byte access) dequantized to 16 bf16 values, as two
// 16-byte words for a shared-memory tile row. Two routes to the same bits
// (dequant's product, rounded once to bf16): code by code through the
// conversion unit (I2F / F2F, a quarter of the FMA rate), which the prefill
// mainloop's producer takes so that it leaves the FMA pipe to the
// consumers' epilogue; or, kAlu, code_values4 and one cvt.rn.bf16x2 per
// pair on the ALU and FMA pipes, which the decode kernel takes, since all
// its warps wait for the dequantized tile.
template <class T, bool kAlu = false>
__device__ __forceinline__ void dequant16(const T* p, float scale,
                                          uint4* lo, uint4* hi) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  uint32_t w[8];
  if constexpr (kAlu) {
    const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float c[4];
      code_values4<T>(words[i], c);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const __nv_bfloat162 t = __floats2bfloat162_rn(
            __fmul_rn(c[2 * j], scale), __fmul_rn(c[2 * j + 1], scale));
        w[2 * i + j] = *reinterpret_cast<const uint32_t*>(&t);
      }
    }
  } else {
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      __nv_bfloat162 t;
      t.x = dequant(code_value(e[2 * i]), scale);
      t.y = dequant(code_value(e[2 * i + 1]), scale);
      w[i] = *reinterpret_cast<const uint32_t*>(&t);
    }
  }
  *lo = make_uint4(w[0], w[1], w[2], w[3]);
  *hi = make_uint4(w[4], w[5], w[6], w[7]);
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
