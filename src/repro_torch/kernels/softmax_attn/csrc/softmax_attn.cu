// Full-sequence online-softmax attention for Hopper (sm_90a), CUDA C++:
// the baseline the paper compares ConSmax against.
//
// Replaces the TPU kernel softmax_attention (_kernel) of
// src/repro/kernels/softmax_attn/kernel.py. Same tiling and walk as
// consmax_attn.cu (and the same tile steps, mma_tiles.cuh); the difference
// is exactly the synchronization ConSmax removes. Per row, in registers:
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
// A tile no row of the block can see is skipped: for every row it would
// give alpha = 1 and e = 0, so skipping is exact.
//
// Bound on an H100 SXM: as consmax_attn.cu (4 * d * H flops per visible
// pair, on tensor cores); the extra work per tile is one row max (two
// shuffles), one exp per row, one rescale of the accumulator and, once,
// the divide.
#include "mma_tiles.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRowsPerBlock = 16 * kWarps;  // folded query rows per block
constexpr float kNegInf = -1e30f;           // softmax_attn/kernel.py NEG_INF

template <int DK>
__global__ void __launch_bounds__(kThreads)
    softmax_attn_kernel(const __nv_bfloat16* __restrict__ q,  // (b,sq,H,DK)
                        const __nv_bfloat16* __restrict__ k,  // (b,skv,hkv,DK)
                        const __nv_bfloat16* __restrict__ v,
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

  const int pos_lo = r0 / g;
  const int pos_hi = min(sq - 1, (r0 + kRowsPerBlock - 1) / g);
  const int kv_end = causal ? min(skv, pos_hi + 1) : skv;
  int kv_begin = window > 0 ? max(0, pos_lo - window + 1) : 0;
  kv_begin = (kv_begin / T::BN) * T::BN;

  bool rvalid[2];
  int qpos[2];
  const __nv_bfloat16* qrow[2];
  __nv_bfloat16* orow[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + warp * 16 + gid + 8 * i;
    rvalid[i] = r < rows_total;
    const int pos = rvalid[i] ? r / g : 0;
    const int head = h * g + (rvalid[i] ? r % g : 0);
    qpos[i] = pos;
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
  float m[2] = {kNegInf, kNegInf};  // running max of each row
  float l[2] = {0.f, 0.f};          // this thread's share of the row sum

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
    uint32_t live = 0;  // bit 4 * nt + e: entry visible
    float m_new[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < T::NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const int kpos = j0 + nt * 8 + tig * 2 + (e & 1);
        float x = s[nt][e] * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        if (rvalid[i] && kv_mask(qpos[i], kpos, skv, window, causal)) {
          live |= 1u << (4 * nt + e);
        } else {
          x = kNegInf;
        }
        s[nt][e] = x;
        m_new[i] = fmaxf(m_new[i], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // the row's max over its quad
      m_new[i] = fmaxf(m_new[i], __shfl_xor_sync(0xffffffffu, m_new[i], 1));
      m_new[i] = fmaxf(m_new[i], __shfl_xor_sync(0xffffffffu, m_new[i], 2));
      alpha[i] = expf(m[i] - m_new[i]);
      m[i] = m_new[i];
    }
    float lt[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < T::NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const float x = (live >> (4 * nt + e)) & 1u
                            ? expf(s[nt][e] - m[i]) : 0.f;
        s[nt][e] = x;
        lt[i] += x;
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + lt[i];
#pragma unroll
    for (int dt = 0; dt < T::DT; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[dt][e] *= alpha[e >> 1];
    pv_tile<DK>(o, s, v_s, gid, tig);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {  // the row sum over its quad, then divide
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int dt = 0; dt < T::DT; ++dt) {
      o[dt][2 * i] /= denom;
      o[dt][2 * i + 1] /= denom;
    }
  }
  store_rows<DK>(orow, o, tig);
}

template <int DK>
int launch(const void* q, const void* k, const void* v, void* out, int b,
           int sq, int skv, int H, int hkv, int causal, int window,
           float softcap, float scale, void* stream) {
  const int g = H / hkv;
  dim3 grid((sq * g + kRowsPerBlock - 1) / kRowsPerBlock, hkv, b);
  softmax_attn_kernel<DK><<<grid, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      sq, skv, H, hkv, causal, window, softcap, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (b, sq, H, dk) bf16; k, v (b, skv, hkv, dk) bf16; out (b, sq, H, dk)
// bf16. dk in {32, 64, 128, 256}; H % hkv == 0.
extern "C" int softmax_attn_launch(const void* q, const void* k,
                                   const void* v, void* out, int b, int sq,
                                   int skv, int H, int hkv, int dk,
                                   int causal, int window, float softcap,
                                   float scale, void* stream) {
  switch (dk) {
    case 32:
      return launch<32>(q, k, v, out, b, sq, skv, H, hkv, causal, window,
                        softcap, scale, stream);
    case 64:
      return launch<64>(q, k, v, out, b, sq, skv, H, hkv, causal, window,
                        softcap, scale, stream);
    case 128:
      return launch<128>(q, k, v, out, b, sq, skv, H, hkv, causal, window,
                         softcap, scale, stream);
    case 256:
      return launch<256>(q, k, v, out, b, sq, skv, H, hkv, causal, window,
                         softcap, scale, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
