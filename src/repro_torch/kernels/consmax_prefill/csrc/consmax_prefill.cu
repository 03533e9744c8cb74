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
// consmax_common.cuh): the paged kernel walks the same 64-row tiles in
// registers, not the TPU's sequential page axis, and gives the contiguous
// kernel's bits when the pages hold the same rows. A row of an unmapped
// (-1) page is loaded as zeros, never read: zero K and V rows add exact
// zeros, as the reference's block_valid mask does. The cache holds bf16, or
// int8 / fp8_e4m3 codes with one fp32 scale per (row, KV head); the tile
// load dequantizes them into the bf16 shared-memory tile (mma_tiles.cuh
// load_kv_tile), so a quantized cache gives the bits of the bf16 kernel on
// its dequantized values (the TPU kernels' per-block dequant_block).
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s): at c = 512 a
// chunk does ~4 * c * H * fill * dk flops per layer (12.9 GFLOP ~ 13 us for
// qwen2-1.5b at fill 4096) against ~2 * fill * hkv * dk * 2 bytes of K/V
// (4 MB ~ 1.3 us): compute-bound, so the products run on tensor cores.
//
// Design against that bound:
// * GQA folded position-major, as the TPU kernel does: folded row
//   r = pos * g + head-in-group, so one block's 64 rows share one KV head
//   and each K/V tile in shared memory serves g query heads.
// * One block per (64 folded rows, kv head, slot) loops over 64-row KV
//   tiles itself. ConSmax needs no running max and no rescale, so the fp32
//   accumulator just adds each tile's p.V: the combine order is fixed, no
//   partial buffers, no atomics, the same result on every run.
// * Tensor cores through mma.sync m16n8k16 (bf16 in, fp32 accumulate):
//   each of the 4 warps owns 16 rows; S = Q K^T and O += P V per tile, with
//   the score accumulator re-packed in registers as the A operand of P V
//   (P rounded to bf16, as the TPU kernel's p.astype(v.dtype)). These tile
//   steps live in mma_tiles.cuh, shared with consmax_attn.cu and
//   softmax_attn.cu.
// * The form (Eq. 2 or 3) is a template parameter chosen at launch, and
//   each row's merged constant C is computed once before the KV walk
//   (consmax_c): the tile loop holds one exp per score for merged ConSmax.
// * Fill bounding without a host sync: the block reads index/lengths on the
//   device and walks only the tiles its rows can see (below the slot's fill,
//   at or before its last row's position, inside the window of its first);
//   a dead tile would add exact zeros.
// What it leaves for later: wgmma + TMA, cp.async double buffering and a
// warp-specialized pipeline; the simple version stalls on its tile loads.
#include "mma_tiles.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRowsPerBlock = 16 * kWarps;  // folded query rows per block

template <int DK, bool kMerged, class TKV, class Rows>
__global__ void __launch_bounds__(kThreads)
    prefill_kernel(const __nv_bfloat16* __restrict__ q,  // (b, c, H, DK)
                   const TKV* __restrict__ k,            // rows of hkv * DK
                   const TKV* __restrict__ v,
                   const float* __restrict__ k_scale,    // rows of hkv
                   const float* __restrict__ v_scale,    // (null for bf16)
                   const Rows rows_of,                   // logical -> row
                   const int* __restrict__ index,        // (b,)
                   const int* __restrict__ lengths,      // (b,)
                   const float* __restrict__ beta,       // (H,)
                   const float* __restrict__ gamma,
                   __nv_bfloat16* __restrict__ out,      // (b, c, H, DK)
                   int c, int H, int hkv, int L, int window, float softcap,
                   float scale, int fill_bound) {
  using T = Tile<DK>;
  __shared__ __align__(16) __nv_bfloat16 k_s[T::BN * T::SROW];
  __shared__ __align__(16) __nv_bfloat16 v_s[T::BN * T::SROW];

  const int h = blockIdx.y, b = blockIdx.z;
  const int g = H / hkv;
  const int rows_total = c * g;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane >> 2, tig = lane & 3;
  const int idx = index[b];
  const int kvl = idx + lengths[b];
  const int r0 = blockIdx.x * kRowsPerBlock;

  // the KV tiles this block's rows can see (never past the cache's last
  // row, even if index + lengths runs over it)
  int kv_begin = 0, kv_end = L;
  if (fill_bound) {
    const int pos_lo = r0 / g;
    const int pos_hi = min(c - 1, (r0 + kRowsPerBlock - 1) / g);
    kv_end = min(L, min(kvl, idx + pos_hi + 1));
    if (window > 0) kv_begin = max(0, idx + pos_lo - window + 1);
  }
  kv_begin = (kv_begin / T::BN) * T::BN;

  // this thread's two accumulator rows: gid and gid + 8 of its warp's 16
  // (pad rows of the chunk included: the caller discards them, as with the
  // reference; rows past the folded chunk are not rows at all)
  bool rvalid[2];
  int qpos[2];
  float bet[2], gam[2], cm[2];
  const __nv_bfloat16* qrow[2];
  __nv_bfloat16* orow[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + warp * 16 + gid + 8 * i;
    rvalid[i] = r < rows_total;
    const int pos = rvalid[i] ? r / g : 0;
    const int head = h * g + (rvalid[i] ? r % g : 0);
    qpos[i] = idx + pos;
    bet[i] = beta[head];
    gam[i] = gamma[head];
    cm[i] = consmax_c(bet[i], gam[i]);
    const size_t at = ((static_cast<size_t>(b) * c + pos) * H + head) * DK;
    qrow[i] = rvalid[i] ? q + at : nullptr;
    orow[i] = rvalid[i] ? out + at : nullptr;
  }

  // Q as mma A fragments, kept in registers for the whole KV walk
  uint32_t qa[T::KS][4];
  load_q_frags<DK>(qa, qrow, tig);

  float o[T::DT][4];
#pragma unroll
  for (int dt = 0; dt < T::DT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dt][e] = 0.f;

  const size_t row_stride = static_cast<size_t>(hkv) * DK;
  const TKV* kh = k + static_cast<size_t>(h) * DK;
  const TKV* vh = v + static_cast<size_t>(h) * DK;

  for (int j0 = kv_begin; j0 < kv_end; j0 += T::BN) {
    __syncthreads();  // the previous tile is consumed
    load_kv_tile<DK, kThreads>(k_s, v_s, kh, vh, k_scale + h, v_scale + h,
                               hkv, row_stride, rows_of, b, j0, kv_end);
    __syncthreads();

    float s[T::NT][4];
    qk_tile<DK>(s, qa, k_s, gid, tig);
    // weights, masked
#pragma unroll
    for (int nt = 0; nt < T::NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const int kpos = j0 + nt * 8 + tig * 2 + (e & 1);
        s[nt][e] = rvalid[i] && kv_mask(qpos[i], kpos, kvl, window)
                       ? consmax_weight<kMerged>(s[nt][e] * scale, bet[i],
                                                 gam[i], cm[i], softcap)
                       : 0.f;
      }
    }
    pv_tile<DK>(o, s, v_s, gid, tig);
  }
  store_rows<DK>(orow, o, tig);
}

template <int DK, class TKV, class Rows>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* k_scale, const float* v_scale, Rows rows_of,
                   const int* index, const int* lengths, const float* beta,
                   const float* gamma, void* out, int b, int c, int H,
                   int hkv, int L, int window, float softcap, float scale,
                   int merged, int fill_bound, cudaStream_t stream) {
  const int g = H / hkv;
  dim3 grid((c * g + kRowsPerBlock - 1) / kRowsPerBlock, hkv, b);
  auto kernel = merged ? prefill_kernel<DK, true, TKV, Rows>
                       : prefill_kernel<DK, false, TKV, Rows>;
  kernel<<<grid, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const TKV*>(k),
      static_cast<const TKV*>(v), k_scale, v_scale, rows_of, index, lengths,
      beta, gamma, static_cast<__nv_bfloat16*>(out), c, H, hkv, L, window, softcap,
      scale, fill_bound);
  return cudaGetLastError();
}

// The head_dim and K/V element type a launch was built for.
template <class TKV, class Rows>
int launch_dk(int dk, const void* q, const void* k, const void* v,
              const float* ks, const float* vs, Rows rows_of, const int* ix,
              const int* len, const float* bt, const float* gm, void* out,
              int b, int c, int H, int hkv, int L, int window, float softcap,
              float scale, int merged, int fill_bound, cudaStream_t st) {
  switch (dk) {
    case 32:
      return launch<32, TKV>(q, k, v, ks, vs, rows_of, ix, len, bt, gm, out,
                             b, c, H, hkv, L, window, softcap, scale, merged,
                             fill_bound, st);
    case 64:
      return launch<64, TKV>(q, k, v, ks, vs, rows_of, ix, len, bt, gm, out,
                             b, c, H, hkv, L, window, softcap, scale, merged,
                             fill_bound, st);
    case 128:
      return launch<128, TKV>(q, k, v, ks, vs, rows_of, ix, len, bt, gm, out,
                              b, c, H, hkv, L, window, softcap, scale, merged,
                              fill_bound, st);
    case 256:
      return launch<256, TKV>(q, k, v, ks, vs, rows_of, ix, len, bt, gm, out,
                              b, c, H, hkv, L, window, softcap, scale, merged,
                              fill_bound, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <class Rows>
int launch_kv(int kv_type, int dk, const void* q, const void* k,
              const void* v, const void* k_scale, const void* v_scale,
              Rows rows_of, const void* index, const void* lengths,
              const void* beta, const void* gamma, void* out, int b, int c,
              int H, int hkv, int L, int window, float softcap, float scale,
              int merged, int fill_bound, void* stream) {
  auto* ks = static_cast<const float*>(k_scale);
  auto* vs = static_cast<const float*>(v_scale);
  auto* ix = static_cast<const int*>(index);
  auto* len = static_cast<const int*>(lengths);
  auto* bt = static_cast<const float*>(beta);
  auto* gm = static_cast<const float*>(gamma);
  auto st = static_cast<cudaStream_t>(stream);
  if (kv_type != kKVBF16 && (!ks || !vs))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (kv_type) {
    case kKVBF16:
      return launch_dk<__nv_bfloat16>(dk, q, k, v, ks, vs, rows_of, ix, len,
                                      bt, gm, out, b, c, H, hkv, L, window,
                                      softcap, scale, merged, fill_bound, st);
    case kKVInt8:
      return launch_dk<int8_t>(dk, q, k, v, ks, vs, rows_of, ix, len, bt, gm,
                               out, b, c, H, hkv, L, window, softcap, scale,
                               merged, fill_bound, st);
    case kKVFP8:
      return launch_dk<__nv_fp8_e4m3>(dk, q, k, v, ks, vs, rows_of, ix, len,
                                      bt, gm, out, b, c, H, hkv, L, window,
                                      softcap, scale, merged, fill_bound, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q (b, c, H, dk) bf16; k, v (b, L, hkv, dk) of kv_type (KVCode: bf16,
// int8, fp8_e4m3); k_scale, v_scale (b, L, hkv) fp32 for int8 / fp8 (null
// for bf16); index, lengths (b,) int32; beta, gamma (H,) fp32; out
// (b, c, H, dk) bf16. dk in {32, 64, 128, 256}.
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
