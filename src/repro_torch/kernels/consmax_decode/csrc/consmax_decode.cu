// Split-KV ConSmax decode for Hopper (sm_90a), CUDA C++.
//
// Replaces the TPU kernels of src/repro/kernels/consmax_decode/kernel.py:
// consmax_decode (_folded_kernel with fill_bound, _kernel without) and
// consmax_decode_paged (_paged_kernel).
//
// One query token per slot against the KV cache, read in its stored layout
// (no transposed or padded copy): the contiguous (b, L, hkv, dk) cache, or
// a shared (P, ps, hkv, dk) page pool through a (b, npg) page table. The
// two entry points run one kernel; only the row address differs
// (ContigRows / PagedRows in consmax_common.cuh), so the paged kernel walks
// the same decode_kv_block shards as the contiguous one, not the TPU's
// per-page grid, and gives its bits when the pages hold the same rows.
// The cache holds bf16, or int8 / fp8_e4m3 codes with one fp32 scale per
// (row, KV head) in (b, L, hkv) / (P, ps, hkv) scale tensors addressed by
// the same row index; each element is dequantized as it is loaded
// (consmax_common.cuh dequant: code * scale rounded to bf16), so a
// quantized cache gives the bits of the bf16 kernel on its dequantized
// values (the TPU kernels' per-block dequant_block):
//   s = q . k * scale;  s = softcap * tanh(s / softcap) (optional)
//   p = C * exp(s), C = exp(-beta) / gamma (merged)  |  exp(s - beta) / gamma
//   p = 0 where kv_mask(n - 1, kpos, n, window) is false or no row backs
//     kpos (an unmapped page)  (n = index + 1, or index + active when paged)
//   o = sum_j p_j v_j
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16): decode reads every
// live K and V row once and does 4 flops per row element per query head,
// i.e. ~g flops per byte — far below the ~295 flops/byte ridge, so it is
// bandwidth-bound: about b * fill * hkv * dk * 2 bytes * 2 (K and V) per
// layer, 33.5 MB ~ 10 us for b = 8, fill = 4096, qwen2-1.5b (hkv 2, dk 128).
// An int8 / fp8 cache moves dk + 4 bytes per row, KV head and tensor (the
// codes and the scale) instead of 2 * dk: 0.516x at dk 128.
//
// Design against that bound:
// * Split-KV: the grid is (KV shard, kv head, slot), so b * hkv = 16 rows of
//   work still spread over ~ns * 16 blocks and fill the 132 SMs. ConSmax has
//   no running max and no denominator, so shard partials are independent
//   and combine by plain addition: each shard writes a (g, dk) fp32 partial,
//   and a second kernel sums the live shards of each slot in a fixed order
//   (shard 0, 1, ...). No atomics: results are the same on every run.
// * A slot with n = 0 (a free slot at index 0 in a paged decode step) has
//   no live shard: no partial is written, and the combine, which tests the
//   same predicate, writes zeros without reading one.
// * Fill bounding without a host sync: a block reads its slot's length on
//   the device and returns at once when its shard is past the fill or
//   behind the sliding window (cache_layout.shard_live); the combine skips
//   the same shards, so dead shards cost one launch slot and no bytes.
//   Rows past the fill inside a live shard are not read either. A shard is
//   live by the fill alone (the host never reads the table): a live shard
//   whose rows are all unmapped reads nothing and writes a zero partial, as
//   the reference's skip branch does, so the combine stays table-free.
// * GQA folding: the g query heads sharing a KV head are held in registers
//   (chunks of up to 8 heads), so each K/V row is read once for all of them.
// * Loads: a warp reads one K row with 32 lanes x dk/32 contiguous elements
//   (one vector access each); in the p.V pass, threads cover a row in
//   4-element vectors. A quantized row's scale is one fp32 at the same
//   address for every lane of the warp (one broadcast transaction), issued
//   beside the row's codes, not after them. All math is fp32 FMA on CUDA
//   cores: decode does too few flops per byte for tensor cores to matter.
// * The form (Eq. 2 or 3) is a template parameter chosen at launch, and
//   each head's merged constant C is computed once per head chunk
//   (consmax_c), not per score.
// What it leaves for later: cp.async/TMA double buffering of K/V and more
// rows in flight per warp; the simple version is latency-bound well above
// the 10 us figure.
#include "consmax_common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kHeadChunk = 8;  // query heads of one GQA group per pass

template <int DK, bool kMerged, class TKV, class Rows>
__global__ void __launch_bounds__(kThreads)
    decode_partials(const __nv_bfloat16* __restrict__ q,  // (b, H, DK)
                    const TKV* __restrict__ k,            // rows of hkv * DK
                    const TKV* __restrict__ v,
                    const float* __restrict__ k_scale,    // rows of hkv
                    const float* __restrict__ v_scale,    // (null for bf16)
                    const Rows rows_of,                   // logical -> row
                    const int* __restrict__ lengths,      // (b,)
                    const float* __restrict__ beta,       // (H,)
                    const float* __restrict__ gamma,
                    float* __restrict__ partials,  // (b, hkv, ns, g, DK)
                    int H, int hkv, int L, int bk, int ns, int window,
                    float softcap, float scale, int fill_bound) {
  constexpr int kPerLane = DK / 32;        // K elements per lane (score pass)
  constexpr int kQuads = DK / 4;           // 4-element vectors per row
  constexpr int kRowGroups = kThreads / kQuads;  // rows in flight (p.V pass)

  const int shard = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int g = H / hkv;
  const int n = lengths[b];                // valid rows; decode row is n - 1
  const int start = shard * bk;
  if (fill_bound && !shard_live(start, bk, n, n - 1, n - 1, window)) return;

  extern __shared__ float smem[];
  float* p_s = smem;                             // [kHeadChunk][bk]
  float* red_s = smem + kHeadChunk * bk;         // [kRowGroups][kHeadChunk][DK]

  const int rows = min(bk, L - start);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t row_stride = static_cast<size_t>(hkv) * DK;
  const TKV* kh = k + static_cast<size_t>(h) * DK;
  const TKV* vh = v + static_cast<size_t>(h) * DK;
  const float* ksh = k_scale + h;          // row r's scale: ksh[r * hkv]
  const float* vsh = v_scale + h;

  for (int g0 = 0; g0 < g; g0 += kHeadChunk) {
    const int gc = min(kHeadChunk, g - g0);
    // this lane's slice of each query head, and each head's constants
    float qr[kHeadChunk][kPerLane];
    float bet[kHeadChunk], gam[kHeadChunk], cm[kHeadChunk];
#pragma unroll
    for (int gi = 0; gi < kHeadChunk; ++gi) {
      const int head = h * g + g0 + min(gi, gc - 1);
      load_bf16<kPerLane>(q + (static_cast<size_t>(b) * H + head) * DK +
                              lane * kPerLane,
                          qr[gi]);
      bet[gi] = beta[head];
      gam[gi] = gamma[head];
      cm[gi] = consmax_c(bet[gi], gam[gi]);
    }

    // pass 1: one warp per K row -> weights p_s[gi][j]
    for (int j = warp; j < rows; j += kWarps) {
      const int kpos = start + j;
      // warp-uniform; the table is read only for unmasked rows
      size_t row;
      const bool valid =
          kv_mask(n - 1, kpos, n, window) && rows_of.row(b, kpos, &row);
      float dot[kHeadChunk];
      if (valid) {
        float kf[kPerLane];
        const float ksc = KVType<TKV>::kScaled ? ksh[row * hkv] : 0.f;
        load_kv<TKV, kPerLane>(kh + row * row_stride + lane * kPerLane, ksc,
                               kf);
#pragma unroll
        for (int gi = 0; gi < kHeadChunk; ++gi) {
          float t = 0.f;
#pragma unroll
          for (int e = 0; e < kPerLane; ++e) t += qr[gi][e] * kf[e];
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            t += __shfl_xor_sync(0xffffffffu, t, off);
          dot[gi] = t;
        }
      }
      if (lane == 0) {
        for (int gi = 0; gi < gc; ++gi)
          p_s[gi * bk + j] =
              valid ? consmax_weight<kMerged>(dot[gi] * scale, bet[gi],
                                              gam[gi], cm[gi], softcap)
                    : 0.f;
      }
    }
    __syncthreads();

    // pass 2: o[gi][d] = sum_j p[gi][j] v[j][d], rows split over row groups
    const int quad = threadIdx.x % kQuads, rg = threadIdx.x / kQuads;
    float o[kHeadChunk][4];
#pragma unroll
    for (int gi = 0; gi < kHeadChunk; ++gi)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[gi][e] = 0.f;
    for (int j = rg; j < rows; j += kRowGroups) {
      size_t row;
      if (!kv_mask(n - 1, start + j, n, window) ||
          !rows_of.row(b, start + j, &row))
        continue;  // never read
      float vf[4];
      const float vsc = KVType<TKV>::kScaled ? vsh[row * hkv] : 0.f;
      load_kv<TKV, 4>(vh + row * row_stride + quad * 4, vsc, vf);
#pragma unroll
      for (int gi = 0; gi < kHeadChunk; ++gi) {
        const float p = gi < gc ? p_s[gi * bk + j] : 0.f;
#pragma unroll
        for (int e = 0; e < 4; ++e) o[gi][e] += p * vf[e];
      }
    }
    for (int gi = 0; gi < gc; ++gi)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        red_s[(rg * kHeadChunk + gi) * DK + quad * 4 + e] = o[gi][e];
    __syncthreads();
    // fixed-order sum over the row groups -> this shard's partial
    for (int i = threadIdx.x; i < gc * DK; i += kThreads) {
      const int gi = i / DK, d = i % DK;
      float t = 0.f;
      for (int r = 0; r < kRowGroups; ++r)
        t += red_s[(r * kHeadChunk + gi) * DK + d];
      partials[(((static_cast<size_t>(b) * hkv + h) * ns + shard) * g + g0 +
                gi) * DK + d] = t;
    }
    __syncthreads();  // p_s / red_s are reused by the next head chunk
  }
}

// out[b, head, d] = sum over the slot's live shards, in shard order.
__global__ void decode_combine(const float* __restrict__ partials,
                               const int* __restrict__ lengths,
                               __nv_bfloat16* __restrict__ out,  // (b, H, dk)
                               int b_total, int H, int hkv, int dk, int bk,
                               int ns, int window, int fill_bound) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<size_t>(b_total) * H * dk) return;
  const int d = i % dk;
  const int head = (i / dk) % H;
  const int b = i / (static_cast<size_t>(dk) * H);
  const int g = H / hkv, h = head / g, gi = head % g;
  const int n = lengths[b];
  float t = 0.f;
  for (int s = 0; s < ns; ++s) {
    if (fill_bound && !shard_live(s * bk, bk, n, n - 1, n - 1, window))
      continue;  // never written
    t += partials[(((static_cast<size_t>(b) * hkv + h) * ns + s) * g + gi) *
                      dk + d];
  }
  out[i] = __float2bfloat16(t);
}

template <int DK, class TKV, class Rows>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* k_scale, const float* v_scale, Rows rows_of,
                   const int* lengths, const float* beta, const float* gamma,
                   float* partials, void* out, int b, int H, int hkv, int L,
                   int bk, int window, float softcap, float scale, int merged,
                   int fill_bound, cudaStream_t stream) {
  const int ns = (L + bk - 1) / bk;
  const size_t smem =
      (kHeadChunk * static_cast<size_t>(bk) + kThreads * 4 * kHeadChunk) *
      sizeof(float);
  dim3 grid(ns, hkv, b);
  auto kernel = merged ? decode_partials<DK, true, TKV, Rows>
                       : decode_partials<DK, false, TKV, Rows>;
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const TKV*>(k),
      static_cast<const TKV*>(v), k_scale, v_scale, rows_of, lengths, beta,
      gamma, partials, H, hkv, L, bk, ns, window, softcap, scale, fill_bound);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t total = static_cast<size_t>(b) * H * DK;
  const int threads = 256;
  decode_combine<<<(total + threads - 1) / threads, threads, 0, stream>>>(
      partials, lengths, static_cast<__nv_bfloat16*>(out), b, H, hkv, DK, bk,
      ns, window, fill_bound);
  return cudaGetLastError();
}

// The head_dim and K/V element type a launch was built for.
template <class TKV, class Rows>
int launch_dk(int dk, const void* q, const void* k, const void* v,
              const float* ks, const float* vs, Rows rows_of,
              const int* len, const float* bt, const float* gm, float* part,
              void* out, int b, int H, int hkv, int L, int bk, int window,
              float softcap, float scale, int merged, int fill_bound,
              cudaStream_t st) {
  switch (dk) {
    case 32:
      return launch<32, TKV>(q, k, v, ks, vs, rows_of, len, bt, gm, part, out,
                             b, H, hkv, L, bk, window, softcap, scale, merged,
                             fill_bound, st);
    case 64:
      return launch<64, TKV>(q, k, v, ks, vs, rows_of, len, bt, gm, part, out,
                             b, H, hkv, L, bk, window, softcap, scale, merged,
                             fill_bound, st);
    case 128:
      return launch<128, TKV>(q, k, v, ks, vs, rows_of, len, bt, gm, part,
                              out, b, H, hkv, L, bk, window, softcap, scale,
                              merged, fill_bound, st);
    case 256:
      return launch<256, TKV>(q, k, v, ks, vs, rows_of, len, bt, gm, part,
                              out, b, H, hkv, L, bk, window, softcap, scale,
                              merged, fill_bound, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <class Rows>
int launch_kv(int kv_type, int dk, const void* q, const void* k,
              const void* v, const void* k_scale, const void* v_scale,
              Rows rows_of, const void* lengths, const void* beta,
              const void* gamma, void* partials, void* out, int b, int H,
              int hkv, int L, int bk, int window, float softcap, float scale,
              int merged, int fill_bound, void* stream) {
  auto* ks = static_cast<const float*>(k_scale);
  auto* vs = static_cast<const float*>(v_scale);
  auto* len = static_cast<const int*>(lengths);
  auto* bt = static_cast<const float*>(beta);
  auto* gm = static_cast<const float*>(gamma);
  auto* part = static_cast<float*>(partials);
  auto st = static_cast<cudaStream_t>(stream);
  if (kv_type != kKVBF16 && (!ks || !vs))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (kv_type) {
    case kKVBF16:
      return launch_dk<__nv_bfloat16>(dk, q, k, v, ks, vs, rows_of, len, bt,
                                      gm, part, out, b, H, hkv, L, bk, window,
                                      softcap, scale, merged, fill_bound, st);
    case kKVInt8:
      return launch_dk<int8_t>(dk, q, k, v, ks, vs, rows_of, len, bt, gm,
                               part, out, b, H, hkv, L, bk, window, softcap,
                               scale, merged, fill_bound, st);
    case kKVFP8:
      return launch_dk<__nv_fp8_e4m3>(dk, q, k, v, ks, vs, rows_of, len, bt,
                                      gm, part, out, b, H, hkv, L, bk, window,
                                      softcap, scale, merged, fill_bound, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q (b, H, dk) bf16; k, v (b, L, hkv, dk) of kv_type (KVCode: bf16, int8,
// fp8_e4m3); k_scale, v_scale (b, L, hkv) fp32 for int8 / fp8 (null for
// bf16); lengths (b,) int32 = valid rows per slot; beta, gamma (H,) fp32;
// partials (b, hkv, ceil(L/bk), g, dk) fp32 scratch; out (b, H, dk) bf16.
// dk in {32, 64, 128, 256}; bk <= 512 (shared memory (8 * bk + 4096) * 4
// bytes stays within the default 48 KB).
extern "C" int consmax_decode_launch(const void* q, const void* k,
                                     const void* v, const void* k_scale,
                                     const void* v_scale, const void* lengths,
                                     const void* beta, const void* gamma,
                                     void* partials, void* out, int b, int H,
                                     int hkv, int L, int dk, int bk,
                                     int window, float softcap, float scale,
                                     int merged, int fill_bound, int kv_type,
                                     void* stream) {
  return launch_kv(kv_type, dk, q, k, v, k_scale, v_scale, ContigRows{L},
                   lengths, beta, gamma, partials, out, b, H, hkv, L, bk,
                   window, softcap, scale, merged, fill_bound, stream);
}

// The paged twin: kp, vp (P, ps, hkv, dk) pools of kv_type; k_scale,
// v_scale (P, ps, hkv) fp32 scale pools (null for bf16), read at the same
// row index as the data; table (b, npg) int32 (-1 = unmapped); lengths (b,)
// int32 = valid logical rows (index + active, 0 allowed); partials
// (b, hkv, ceil(npg * ps / bk), g, dk) fp32 scratch. Any page size: bk
// bounds the shared memory, ps only the address.
extern "C" int consmax_decode_paged_launch(
    const void* q, const void* kp, const void* vp, const void* k_scale,
    const void* v_scale, const void* table, const void* lengths,
    const void* beta, const void* gamma, void* partials, void* out, int b,
    int H, int hkv, int npg, int ps, int dk, int bk, int window,
    float softcap, float scale, int merged, int fill_bound, int kv_type,
    void* stream) {
  const PagedRows rows_of{static_cast<const int*>(table), npg, ps};
  return launch_kv(kv_type, dk, q, kp, vp, k_scale, v_scale, rows_of,
                   lengths, beta, gamma, partials, out, b, H, hkv, npg * ps,
                   bk, window, softcap, scale, merged, fill_bound, stream);
}
