// Device-side twins of kernels/cache_layout.py, shared by the ConSmax
// kernels and the softmax baseline: the one mask (kv_mask, causal or not),
// the fill-bounding skip predicate (shard_live) and the ConSmax weights
// (consmax_weight), plus small bf16 load helpers. Keep each formula
// identical to its Python twin: the plain versions the kernels are tested
// against are built from those.
#pragma once

#include <cuda_bf16.h>
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

// N contiguous bf16 values as one aligned access, widened to fp32.
template <int N> struct BF16Vec;
template <> struct BF16Vec<1> { using T = unsigned short; };
template <> struct BF16Vec<2> { using T = unsigned int; };
template <> struct BF16Vec<4> { using T = uint2; };
template <> struct BF16Vec<8> { using T = uint4; };

template <int N>
__device__ __forceinline__ void load_bf16(const __nv_bfloat16* p, float* out) {
  typename BF16Vec<N>::T raw =
      *reinterpret_cast<const typename BF16Vec<N>::T*>(p);
  const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
  for (int i = 0; i < N; ++i) out[i] = __bfloat162float(e[i]);
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
