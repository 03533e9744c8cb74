// Full-sequence ConSmax attention for Hopper (sm_90a), CUDA C++.
//
// Replaces the TPU kernel consmax_attention (_kernel) of
// src/repro/kernels/consmax_attn/kernel.py: the paper's sync-free
// attention. For queries at positions 0..sq-1 (top-left aligned under
// causal masking, also when skv > sq) against keys 0..skv-1:
//   s = q . k * scale;  s = softcap * tanh(s / softcap) (optional)
//   p = exp(s - beta) / gamma  |  C * exp(s), C = exp(-beta) / gamma (merged)
//   p = 0 where kv_mask(qpos, kpos, skv, window, causal) is false
//   o = sum_j bf16(p_j) v_j,  fp32 accumulator, written as bf16
// The KV walk carries the fp32 accumulator and nothing else: no running
// max, no denominator, no rescale.
//
// q, k and v are read in the model layout (b, s, h, d) as stored, at row
// stride h * d; the reference's swapaxes to (b, h, s, d) is a layout
// adapter and is not done here.
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s): 4 * d * H flops
// per visible (query, key) pair; causal qwen2-1.5b at b = 2, s = 4096 is
// ~1.03e11 flops (~104 us) against ~40 MB of q/k/v/out (~12 us): compute-
// bound, so both products run on the tensor cores through wgmma.
//
// Design: consmax_prefill.cu's kernel with index 0 and the whole sequence
// as the chunk, through the same mainloop (attn_mainloop.cuh: a producer
// warpgroup's cp.async copies into a ring of shared-memory stages, the
// consumer warpgroups' wgmma products, the ConSmax epilogue on the
// accumulator):
// * GQA folded position-major (row r = pos * g + head-in-group): a CTA's
//   rows share one KV head; query head ih reads KV head ih / g.
// * At head_dim <= 128 a CTA holds two consumer warpgroups, 128 folded rows:
//   each K/V tile copied into shared memory serves both, which halves the
//   copies' traffic (at qwen2-1.5b b 2 x s 4096 the 64-row design moved
//   ~1.6 GB of K/V tiles from L2 for 8 MB of K/V), and one warpgroup's
//   per-score work overlaps the other's products. 768 CTAs at that shape.
// * One CTA per (128 or 64 folded rows, kv head, batch row) walks the KV
//   tiles its rows can see, in order (causal and window reach; a skipped
//   tile would add exact zeros), adding each tile's P V into registers.
// * The form (Eq. 2 or 3) is a template parameter and each row's merged
//   constant C is computed once (consmax_c / consmax_weight<kMerged>, as in
//   the serving kernels).
// * CTAs are issued heaviest first: under causal masking the last rows see
//   the most tiles, so they start while the card is still filling.
// With index 0, lengths sq and the same rows it gives consmax_prefill's
// bits: the tiles, their order and the arithmetic are the same code.
//
// fp32 q / k / v take consmax_attn_f32_launch instead: the plain SIMT kernel
// of attn_f32.cuh (fp32 products and exp, the reference's fp32 tolerance).
#include "attn_f32.cuh"
#include "attn_mainloop.cuh"

namespace {

template <int DK>
int launch(const void* q, const void* k, const void* v, const void* beta,
           const void* gamma, void* out, int b, int sq, int skv, int H,
           int hkv, int causal, int window, float softcap, float scale,
           int merged, void* stream) {
  const WalkArgs<__nv_bfloat16, ContigRows> a{
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), nullptr, nullptr,
      ContigRows{skv}, nullptr, nullptr, static_cast<const float*>(beta),
      static_cast<const float*>(gamma), static_cast<__nv_bfloat16*>(out), sq,
      H, hkv, skv, causal, window, /*fill_bound=*/1, /*reverse=*/1, softcap,
      scale};
  auto st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(merged ? launch_walk<DK, kFormEq3, true>(a, b, st)
                                 : launch_walk<DK, kFormEq2, true>(a, b, st));
}

}  // namespace

// q (b, sq, H, dk) bf16; k, v (b, skv, hkv, dk) bf16; beta, gamma (H,)
// fp32; out (b, sq, H, dk) bf16. dk in {32, 64, 96, 128, 256}; H % hkv == 0.
extern "C" int consmax_attn_launch(const void* q, const void* k,
                                   const void* v, const void* beta,
                                   const void* gamma, void* out, int b,
                                   int sq, int skv, int H, int hkv, int dk,
                                   int causal, int window, float softcap,
                                   float scale, int merged, void* stream) {
  switch (dk) {
    case 32:
      return launch<32>(q, k, v, beta, gamma, out, b, sq, skv, H, hkv,
                        causal, window, softcap, scale, merged, stream);
    case 64:
      return launch<64>(q, k, v, beta, gamma, out, b, sq, skv, H, hkv,
                        causal, window, softcap, scale, merged, stream);
    case 96:
      return launch<96>(q, k, v, beta, gamma, out, b, sq, skv, H, hkv,
                        causal, window, softcap, scale, merged, stream);
    case 128:
      return launch<128>(q, k, v, beta, gamma, out, b, sq, skv, H, hkv,
                         causal, window, softcap, scale, merged, stream);
    case 256:
      return launch<256>(q, k, v, beta, gamma, out, b, sq, skv, H, hkv,
                         causal, window, softcap, scale, merged, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The same on fp32 operands (attn_f32.cuh): q (b, sq, H, dk), k, v
// (b, skv, hkv, dk), out (b, sq, H, dk) fp32; beta, gamma (H,) fp32.
extern "C" int consmax_attn_f32_launch(const void* q, const void* k,
                                       const void* v, const void* beta,
                                       const void* gamma, void* out, int b,
                                       int sq, int skv, int H, int hkv,
                                       int dk, int causal, int window,
                                       float softcap, float scale,
                                       int merged, void* stream) {
  const F32Args a{static_cast<const float*>(q), static_cast<const float*>(k),
                  static_cast<const float*>(v),
                  static_cast<const float*>(beta),
                  static_cast<const float*>(gamma), static_cast<float*>(out),
                  sq, skv, H, hkv, causal, window, softcap, scale};
  return merged ? launch_f32<kF32Eq3>(a, b, dk, stream)
                : launch_f32<kF32Eq2>(a, b, dk, stream);
}
