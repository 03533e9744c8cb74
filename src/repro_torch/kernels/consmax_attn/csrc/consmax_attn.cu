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
// bound, so both products run on tensor cores.
//
// Design: the prefill kernel's (consmax_prefill.cu) tile walk with index 0
// and the whole sequence as the chunk, through the same tile steps
// (mma_tiles.cuh):
// * GQA folded position-major (row r = pos * g + head-in-group): a block's
//   64 rows share one KV head; query head ih reads KV head ih / g.
// * One block per (64 folded rows, kv head, batch row) walks the KV tiles
//   its rows can see, in order (causal and window reach; a skipped tile
//   would add exact zeros), adding each tile's P V into registers.
// * mma.sync m16n8k16 bf16 -> fp32 for S = Q K^T and O += P V, P rounded to
//   bf16 first (the TPU kernel's p.astype(v.dtype)).
// * The form (Eq. 2 or 3) is a template parameter and each row's merged
//   constant C is computed once (consmax_c / consmax_weight<kMerged>, as
//   in the serving kernels): with the form chosen at run time, an exp and
//   an IEEE division per score stayed in the tile loop, and merged ConSmax
//   ran slower than the softmax kernel (measured in PERF.md).
// * Blocks are issued heaviest first: under causal masking the last rows
//   see the most tiles, so they start while the card is still filling.
// With index 0, lengths sq and the same rows it gives consmax_prefill's
// bits: the tiles, their order and the arithmetic are the same.
// What it leaves for later: wgmma + TMA, cp.async double buffering and a
// warp-specialized pipeline; the simple version stalls on its tile loads.
#include "mma_tiles.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRowsPerBlock = 16 * kWarps;  // folded query rows per block

template <int DK, bool kMerged>
__global__ void __launch_bounds__(kThreads)
    consmax_attn_kernel(const __nv_bfloat16* __restrict__ q,  // (b,sq,H,DK)
                        const __nv_bfloat16* __restrict__ k,  // (b,skv,hkv,DK)
                        const __nv_bfloat16* __restrict__ v,
                        const float* __restrict__ beta,       // (H,)
                        const float* __restrict__ gamma,
                        __nv_bfloat16* __restrict__ out,      // (b,sq,H,DK)
                        int sq, int skv, int H, int hkv, int causal,
                        int window, float softcap, float scale) {
  using T = Tile<DK>;
  __shared__ __align__(16) __nv_bfloat16 k_s[T::BN * T::SROW];
  __shared__ __align__(16) __nv_bfloat16 v_s[T::BN * T::SROW];

  const int h = blockIdx.y, b = blockIdx.z;
  const int g = H / hkv;
  const int rows_total = sq * g;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane >> 2, tig = lane & 3;
  const int r0 = (gridDim.x - 1 - blockIdx.x) * kRowsPerBlock;

  // the KV tiles this block's rows can see
  const int pos_lo = r0 / g;
  const int pos_hi = min(sq - 1, (r0 + kRowsPerBlock - 1) / g);
  const int kv_end = causal ? min(skv, pos_hi + 1) : skv;
  int kv_begin = window > 0 ? max(0, pos_lo - window + 1) : 0;
  kv_begin = (kv_begin / T::BN) * T::BN;

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
    qpos[i] = pos;
    bet[i] = beta[head];
    gam[i] = gamma[head];
    cm[i] = consmax_c(bet[i], gam[i]);
    const size_t at = ((static_cast<size_t>(b) * sq + pos) * H + head) * DK;
    qrow[i] = rvalid[i] ? q + at : nullptr;
    orow[i] = rvalid[i] ? out + at : nullptr;
  }

  uint32_t qa[T::KS][4];
  load_q_frags<DK>(qa, qrow, tig);

  float o[T::DT][4];
#pragma unroll
  for (int dt = 0; dt < T::DT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dt][e] = 0.f;

  const size_t row_stride = static_cast<size_t>(hkv) * DK;
  const __nv_bfloat16* kh = k + static_cast<size_t>(h) * DK;
  const __nv_bfloat16* vh = v + static_cast<size_t>(h) * DK;

  for (int j0 = kv_begin; j0 < kv_end; j0 += T::BN) {
    __syncthreads();  // the previous tile is consumed
    load_kv_tile<DK, kThreads>(k_s, v_s, kh, vh, row_stride, ContigRows{skv},
                               b, j0, kv_end);
    __syncthreads();

    float s[T::NT][4];
    qk_tile<DK>(s, qa, k_s, gid, tig);
#pragma unroll
    for (int nt = 0; nt < T::NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const int kpos = j0 + nt * 8 + tig * 2 + (e & 1);
        s[nt][e] = rvalid[i] && kv_mask(qpos[i], kpos, skv, window, causal)
                       ? consmax_weight<kMerged>(s[nt][e] * scale, bet[i],
                                                 gam[i], cm[i], softcap)
                       : 0.f;
      }
    }
    pv_tile<DK>(o, s, v_s, gid, tig);
  }
  store_rows<DK>(orow, o, tig);
}

template <int DK>
int launch(const void* q, const void* k, const void* v, const void* beta,
           const void* gamma, void* out, int b, int sq, int skv, int H,
           int hkv, int causal, int window, float softcap, float scale,
           int merged, void* stream) {
  const int g = H / hkv;
  dim3 grid((sq * g + kRowsPerBlock - 1) / kRowsPerBlock, hkv, b);
  auto kernel = merged ? consmax_attn_kernel<DK, true>
                       : consmax_attn_kernel<DK, false>;
  kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(beta),
      static_cast<const float*>(gamma), static_cast<__nv_bfloat16*>(out), sq,
      skv, H, hkv, causal, window, softcap, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (b, sq, H, dk) bf16; k, v (b, skv, hkv, dk) bf16; beta, gamma (H,)
// fp32; out (b, sq, H, dk) bf16. dk in {32, 64, 128, 256}; H % hkv == 0.
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
