// Full-sequence online-softmax attention for Hopper (sm_90a), CUDA C++:
// the baseline the paper compares ConSmax against.
//
// Replaces the TPU kernel softmax_attention (_kernel) of
// src/repro/kernels/softmax_attn/kernel.py. The same mainloop as
// consmax_attn.cu and consmax_prefill.cu (attn_mainloop.cuh: a producer
// warpgroup's cp.async copies into a ring of shared-memory stages, two
// consumer warpgroups of 64 folded query rows each at head_dim <= 128 (one
// at 256), wgmma for S = Q K^T and O += P V); the difference is exactly the
// synchronization ConSmax removes. Per row, on the score accumulator in
// registers (in base 2: exp(x) = 2^(x log2 e)):
//   s = q . k * scale;  s = softcap * tanh(s / softcap) (optional)
//   s = NEG_INF (-1e30) where kv_mask(qpos, kpos, skv, window, causal) is
//     false
//   m_new = max(m, max_j s_j);  alpha = exp(m - m_new)
//   e_j = exp(s_j - m_new), 0 where masked
//   l = l * alpha + sum_j e_j              (fp32 e)
//   acc = acc * alpha + sum_j bf16(e_j) v_j
// and at the end o = acc / max(l, 1e-30), written as bf16. Each thread
// keeps m for its two rows (reduced over the 4 threads of a quad that hold
// a row's columns) and a partial l over its own columns, summed over the
// quad once at the end.
//
// A tile no row of the CTA can see is skipped: for every row it would give
// alpha = 1 and e = 0, so skipping is exact. CTAs of the last rows, which
// see the most tiles under causal masking, are issued first.
//
// Bound on an H100 SXM: as consmax_attn.cu (4 * d * H flops per visible
// pair, on the tensor cores through wgmma); the extra work per tile is one
// row max (two shuffles), one exp per row, one rescale of the accumulator
// and, once, the divide.
//
// fp32 q / k / v take softmax_attn_f32_launch instead: attn_f32.cuh's
// kernel, both products in 3xTF32 on the tensor cores (mma.sync) and fp32
// exp, within the reference's fp32 tolerance.
#include "attn_f32.cuh"
#include "attn_mainloop.cuh"

namespace {

template <int DK>
int launch(const void* q, const void* k, const void* v, void* out, int b,
           int sq, int skv, int H, int hkv, int causal, int window,
           float softcap, float scale, void* stream, void* launches) {
  const WalkArgs<__nv_bfloat16, ContigRows> a{
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), nullptr, nullptr,
      ContigRows{skv}, nullptr, nullptr, nullptr, nullptr,
      static_cast<__nv_bfloat16*>(out), sq, H, hkv, skv, causal, window,
      /*fill_bound=*/1, /*reverse=*/1, softcap, scale, /*shard_rows=*/skv,
      /*ns=*/1, nullptr, nullptr, static_cast<unsigned long long*>(launches)};
  return static_cast<int>(launch_walk<DK, kFormSoftmax>(
      a, b, static_cast<cudaStream_t>(stream)));
}

}  // namespace

// q (b, sq, H, dk) bf16; k, v (b, skv, hkv, dk) bf16; out (b, sq, H, dk)
// bf16; launches a uint64 device counter the kernel adds one to (null:
// not counted). dk in {32, 64, 96, 128, 256}; H % hkv == 0.
extern "C" int softmax_attn_launch(const void* q, const void* k,
                                   const void* v, void* out, int b, int sq,
                                   int skv, int H, int hkv, int dk,
                                   int causal, int window, float softcap,
                                   float scale, void* stream,
                                   void* launches) {
  switch (dk) {
    case 32:
      return launch<32>(q, k, v, out, b, sq, skv, H, hkv, causal, window,
                        softcap, scale, stream, launches);
    case 64:
      return launch<64>(q, k, v, out, b, sq, skv, H, hkv, causal, window,
                        softcap, scale, stream, launches);
    case 96:
      return launch<96>(q, k, v, out, b, sq, skv, H, hkv, causal, window,
                        softcap, scale, stream, launches);
    case 128:
      return launch<128>(q, k, v, out, b, sq, skv, H, hkv, causal, window,
                         softcap, scale, stream, launches);
    case 256:
      return launch<256>(q, k, v, out, b, sq, skv, H, hkv, causal, window,
                         softcap, scale, stream, launches);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The same on fp32 operands (attn_f32.cuh): q (b, sq, H, dk), k, v
// (b, skv, hkv, dk), out (b, sq, H, dk) fp32; launches as above.
extern "C" int softmax_attn_f32_launch(const void* q, const void* k,
                                       const void* v, void* out, int b,
                                       int sq, int skv, int H, int hkv,
                                       int dk, int causal, int window,
                                       float softcap, float scale,
                                       void* stream, void* launches) {
  const F32Args a{static_cast<const float*>(q), static_cast<const float*>(k),
                  static_cast<const float*>(v), nullptr, nullptr,
                  static_cast<float*>(out), sq, skv, H, hkv, causal, window,
                  softcap, scale, static_cast<unsigned long long*>(launches)};
  return launch_f32<kF32Softmax>(a, b, dk, stream);
}
