// ConSmax append-at-index prefill for Hopper (sm_90a), CUDA C++.
//
// Replaces the TPU kernels of src/repro/kernels/consmax_prefill/kernel.py:
// consmax_prefill (_kernel) and consmax_prefill_paged (_paged_kernel).
//
// A (b, c) chunk of pre-scaled queries at per-slot cache positions
// index + [0, c) attends the cache rows below index + lengths (the chunk's
// own K/V were written there first), causally and optionally within a
// sliding window:
//   s = q . k * scale;  s = softcap * tanh(s / softcap) (optional)
//   p = C * exp(s), C = exp(-beta) / gamma (merged)  |  exp(s - beta) / gamma
//   p = 0 where kv_mask(qpos, kpos, index + lengths, window) is false
//   o = sum_j p_j v_j
// The cache is read in its stored layout and the ragged edge is masked
// here: no transposed or padded copy. The contiguous (b, L, hkv, dk) cache
// and the paged (P, ps, hkv, dk) pool + (b, npg) table run one kernel that
// differs only in the row address (ContigRows / PagedRows in
// consmax_common.cuh): the paged kernel walks the same 64-row tiles, not
// the TPU's sequential page axis, and gives the contiguous
// kernel's bits when the pages hold the same rows. A row of an unmapped
// (-1) page is loaded as zeros, never read: zero K and V rows add exact
// zeros, as the reference's block_valid mask does. The cache holds bf16, or
// int8 / fp8_e4m3 codes with one fp32 scale per (row, KV head); the
// mainloop's producer dequantizes them into the bf16 shared-memory tile, so
// a quantized cache gives the bits of the bf16 kernel on its dequantized
// values (the TPU kernels' per-block dequant_block).
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s): at c = 512 a
// chunk does ~4 * c * H * fill * dk flops per layer (12.9 GFLOP ~ 13 us for
// qwen2-1.5b at fill 4096) against ~2 * fill * hkv * dk * 2 bytes of K/V
// (4 MB ~ 1.3 us): compute-bound, so the products run on the tensor cores
// through wgmma, the only instruction that reaches their full rate.
//
// Design against that bound: the Hopper mainloop of attn_mainloop.cuh
// (shared with consmax_attn.cu and softmax_attn.cu), with the ConSmax
// epilogue. Per CTA: 64 folded query rows of one KV head (GQA folded
// position-major, row r = pos * g + head-in-group, as the TPU kernel does,
// so one K/V tile in shared memory serves g query heads); a producer
// warpgroup keeps cp.async copies of the next KV tiles in flight into a ring
// of 3 stages (2 at head_dim 256 with codes) of dynamic shared memory while
// the consumer warpgroup runs S = Q K^T and O += P V through wgmma. ConSmax
// needs no running max and no rescale, so the fp32 accumulator just adds
// each tile's P V: a fixed combine order, no partials, no atomics. The form
// (Eq. 2 or 3) is a template parameter and each row's merged constant C is
// computed once before the walk, so merged ConSmax has one exp per score.
// Fill bounding without a host sync: the CTA reads index/lengths on the
// device and walks only the tiles its rows can see.
//
// Filling the card: at the engine's chunk (b 1, c 512, qwen2-1.5b: g 6, 2
// KV heads) the grid is 512 * 6 / 64 = 48 row tiles x 2 KV heads = 96 CTAs
// of 256 threads on 132 SMs, one wave; each walks up to 64 + 8 KV tiles at
// fill 4096. The design keeps every CTA's walk whole (no KV split): a split
// would add an fp32 partials buffer and a second pass per launch, and the
// walk is short enough that 96 CTAs finish in one wave. It keeps one
// consumer warpgroup per CTA: two (128 rows sharing each copied tile, as the
// full-sequence kernels run) would halve the CTAs to 48, and measured
// slower at this shape (PERF.md). Each tile then costs the consumer its two
// products and the epilogue back to back; a KV split over fixed logical
// shards, or overlapping one tile's epilogue with the next tile's S, is the
// next step if the chunk kernel sets TTFT once the host bound is gone.
#include "attn_mainloop.cuh"

namespace {

template <int DK, class TKV, class Rows>
cudaError_t launch(const WalkArgs<TKV, Rows>& a, int b, int merged,
                   cudaStream_t st) {
  return merged ? launch_walk<DK, kFormEq3>(a, b, st)
                : launch_walk<DK, kFormEq2>(a, b, st);
}

// The head_dim and K/V element type a launch was built for.
template <class TKV, class Rows>
int launch_dk(int dk, const WalkArgs<TKV, Rows>& a, int b, int merged,
              cudaStream_t st) {
  switch (dk) {
    case 32:
      return launch<32>(a, b, merged, st);
    case 64:
      return launch<64>(a, b, merged, st);
    case 96:
      return launch<96>(a, b, merged, st);
    case 128:
      return launch<128>(a, b, merged, st);
    case 256:
      return launch<256>(a, b, merged, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <class TKV, class Rows>
int launch_typed(int dk, const void* q, const void* k, const void* v,
                 const void* k_scale, const void* v_scale, Rows rows_of,
                 const void* index, const void* lengths, const void* beta,
                 const void* gamma, void* out, int b, int c, int H, int hkv,
                 int L, int window, float softcap, float scale, int merged,
                 int fill_bound, void* stream) {
  const WalkArgs<TKV, Rows> a{
      static_cast<const __nv_bfloat16*>(q), static_cast<const TKV*>(k),
      static_cast<const TKV*>(v), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), rows_of,
      static_cast<const int*>(index), static_cast<const int*>(lengths),
      static_cast<const float*>(beta), static_cast<const float*>(gamma),
      static_cast<__nv_bfloat16*>(out), c, H, hkv, L, /*causal=*/1, window,
      fill_bound, /*reverse=*/0, softcap, scale};
  return launch_dk(dk, a, b, merged, static_cast<cudaStream_t>(stream));
}

template <class Rows>
int launch_kv(int kv_type, int dk, const void* q, const void* k,
              const void* v, const void* k_scale, const void* v_scale,
              Rows rows_of, const void* index, const void* lengths,
              const void* beta, const void* gamma, void* out, int b, int c,
              int H, int hkv, int L, int window, float softcap, float scale,
              int merged, int fill_bound, void* stream) {
  if (kv_type != kKVBF16 && (!k_scale || !v_scale))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (kv_type) {
    case kKVBF16:
      return launch_typed<__nv_bfloat16>(
          dk, q, k, v, k_scale, v_scale, rows_of, index, lengths, beta,
          gamma, out, b, c, H, hkv, L, window, softcap, scale, merged,
          fill_bound, stream);
    case kKVInt8:
      return launch_typed<int8_t>(dk, q, k, v, k_scale, v_scale, rows_of,
                                  index, lengths, beta, gamma, out, b, c, H,
                                  hkv, L, window, softcap, scale, merged,
                                  fill_bound, stream);
    case kKVFP8:
      return launch_typed<__nv_fp8_e4m3>(
          dk, q, k, v, k_scale, v_scale, rows_of, index, lengths, beta,
          gamma, out, b, c, H, hkv, L, window, softcap, scale, merged,
          fill_bound, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q (b, c, H, dk) bf16; k, v (b, L, hkv, dk) of kv_type (KVCode: bf16,
// int8, fp8_e4m3); k_scale, v_scale (b, L, hkv) fp32 for int8 / fp8 (null
// for bf16); index, lengths (b,) int32; beta, gamma (H,) fp32; out
// (b, c, H, dk) bf16. dk in {32, 64, 96, 128, 256}.
extern "C" int consmax_prefill_launch(const void* q, const void* k,
                                      const void* v, const void* k_scale,
                                      const void* v_scale, const void* index,
                                      const void* lengths, const void* beta,
                                      const void* gamma, void* out, int b,
                                      int c, int H, int hkv, int L, int dk,
                                      int window, float softcap, float scale,
                                      int merged, int fill_bound, int kv_type,
                                      void* stream) {
  return launch_kv(kv_type, dk, q, k, v, k_scale, v_scale, ContigRows{L},
                   index, lengths, beta, gamma, out, b, c, H, hkv, L, window,
                   softcap, scale, merged, fill_bound, stream);
}

// The paged twin: kp, vp (P, ps, hkv, dk) pools of kv_type; k_scale,
// v_scale (P, ps, hkv) fp32 scale pools (null for bf16), read at the same
// row index as the data; table (b, npg) int32 (-1 = unmapped); the slot's
// logical capacity is npg * ps rows, so a chunk running past it reads no
// row there (its column is clamped as well).
extern "C" int consmax_prefill_paged_launch(
    const void* q, const void* kp, const void* vp, const void* k_scale,
    const void* v_scale, const void* table, const void* index,
    const void* lengths, const void* beta, const void* gamma, void* out,
    int b, int c, int H, int hkv, int npg, int ps, int dk, int window,
    float softcap, float scale, int merged, int fill_bound, int kv_type,
    void* stream) {
  const PagedRows rows_of{static_cast<const int*>(table), npg, ps};
  return launch_kv(kv_type, dk, q, kp, vp, k_scale, v_scale, rows_of, index,
                   lengths, beta, gamma, out, b, c, H, hkv, npg * ps, window,
                   softcap, scale, merged, fill_bound, stream);
}
