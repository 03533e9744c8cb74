// The full-sequence attention kernels on fp32 operands (consmax_attn.cu and
// softmax_attn.cu, each its own entry point): the reference's kernels take
// any float dtype, and its tests hold fp32 to atol 2e-5, which bf16 or TF32
// tensor-core products (~1e-3 relative) cannot meet. So this is a plain
// SIMT kernel: fp32 loads, fp32 FMA, fp32 exp (expf, not the SFU's ex2).
//
// One CTA of 8 warps per (32 query positions, query head, batch row); each
// warp owns 4 query rows, and each lane DK / 32 of a row's columns (lane,
// lane + 32, ...), so q and the output accumulator stay in registers. K/V
// tiles of 16 rows of the head's KV head are staged in shared memory by all
// threads; per key, each row's dot product is a lane-strided partial sum
// reduced by five xor shuffles (the same order on every run), then:
//   ConSmax (Eq. 2 / 3): o += p v with p = consmax_weight(s), 0 if masked;
//   softmax: m' = max(m, s), o = o exp(m - m') + exp(s - m') v, l likewise,
//     masked keys skipped (alpha 1, e 0), and o / max(l, 1e-30) at the end.
// The CTA walks only the keys its rows can see (causal reach, window); a
// skipped key adds exact zeros. Bound at the paper's shape: 4 dk H fp32 FLOP
// per visible pair over 67 TFLOP/s (no tensor cores); this kernel is right
// first, not fast (PERF.md).
#pragma once

#include "consmax_common.cuh"

namespace {

constexpr int kF32Warps = 8;
constexpr int kF32RowsPerWarp = 4;
constexpr int kF32Rows = kF32Warps * kF32RowsPerWarp;  // positions per CTA
constexpr int kF32Keys = 16;                           // KV rows per tile
constexpr int kF32Eq2 = 0, kF32Eq3 = 1, kF32Softmax = 2;

// q, out (b, sq, H, DK) fp32; k, v (b, skv, hkv, DK) fp32; beta, gamma (H,)
// fp32 (null for softmax).
struct F32Args {
  const float* q;
  const float* k;
  const float* v;
  const float* beta;
  const float* gamma;
  float* out;
  int sq, skv, H, hkv, causal, window;
  float softcap, scale;
};

template <int DK, int kForm>
__global__ void __launch_bounds__(32 * kF32Warps)
    attn_f32_kernel(const __grid_constant__ F32Args a) {
  constexpr int E = DK / 32;  // columns per lane
  constexpr int R = kF32RowsPerWarp;
  __shared__ float ks[kF32Keys][DK];
  __shared__ float vs[kF32Keys][DK];
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.H / a.hkv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int p0 = blockIdx.x * kF32Rows;
  const int plast = min(a.sq - 1, p0 + kF32Rows - 1);

  float q[R][E], o[R][E], m[R], l[R];
  int pos[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    pos[i] = p0 + warp * R + i;
    m[i] = -1e30f;  // softmax_attn/ref.py NEG_INF
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      q[i][e] = pos[i] < a.sq
                    ? a.q[((static_cast<size_t>(b) * a.sq + pos[i]) * a.H +
                           h) * DK + lane + 32 * e]
                    : 0.f;
      o[i][e] = 0.f;
    }
  }
  float bet = 0.f, gam = 1.f, cm = 0.f;
  if constexpr (kForm != kF32Softmax) {
    bet = a.beta[h];
    gam = a.gamma[h];
    cm = consmax_c(bet, gam);
  }

  // the keys this CTA's rows can see
  int kv_begin = 0, kv_end = a.skv;
  if (a.causal) kv_end = min(kv_end, plast + 1);
  if (a.window > 0) kv_begin = max(0, p0 - a.window + 1);
  for (int j0 = kv_begin; j0 < kv_end; j0 += kF32Keys) {
    __syncthreads();  // every warp is done with the last tile
    for (int i = threadIdx.x; i < kF32Keys * DK; i += 32 * kF32Warps) {
      const int r = i / DK, d = i % DK;
      const int kpos = j0 + r;
      const size_t at =
          ((static_cast<size_t>(b) * a.skv + kpos) * a.hkv + hk) * DK + d;
      ks[r][d] = kpos < kv_end ? a.k[at] : 0.f;
      vs[r][d] = kpos < kv_end ? a.v[at] : 0.f;
    }
    __syncthreads();
    const int n = min(kF32Keys, kv_end - j0);
    for (int r = 0; r < n; ++r) {
      const int kpos = j0 + r;
      float s[R];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        s[i] = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) s[i] = fmaf(q[i][e], ks[r][lane + 32 * e],
                                                s[i]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
        for (int i = 0; i < R; ++i)
          s[i] += __shfl_xor_sync(0xffffffffu, s[i], off);
      }
#pragma unroll
      for (int i = 0; i < R; ++i) {
        if (pos[i] >= a.sq ||
            !kv_mask(pos[i], kpos, a.skv, a.window, a.causal != 0))
          continue;  // masked: adds nothing (softmax: alpha 1, e 0)
        const float x = s[i] * a.scale;
        if constexpr (kForm == kF32Softmax) {
          const float y = a.softcap > 0.f ? a.softcap * tanhf(x / a.softcap)
                                          : x;
          const float m_new = fmaxf(m[i], y);
          const float alpha = expf(m[i] - m_new);
          const float p = expf(y - m_new);
          l[i] = l[i] * alpha + p;
#pragma unroll
          for (int e = 0; e < E; ++e)
            o[i][e] = fmaf(p, vs[r][lane + 32 * e], o[i][e] * alpha);
          m[i] = m_new;
        } else {
          const float p = consmax_weight<kForm == kF32Eq3>(x, bet, gam, cm,
                                                           a.softcap);
#pragma unroll
          for (int e = 0; e < E; ++e)
            o[i][e] = fmaf(p, vs[r][lane + 32 * e], o[i][e]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    if (pos[i] >= a.sq) continue;
    const float inv = kForm == kF32Softmax ? 1.f / fmaxf(l[i], 1e-30f) : 1.f;
    float* dst =
        a.out + ((static_cast<size_t>(b) * a.sq + pos[i]) * a.H + h) * DK;
#pragma unroll
    for (int e = 0; e < E; ++e)
      dst[lane + 32 * e] = kForm == kF32Softmax ? o[i][e] * inv : o[i][e];
  }
}

template <int kForm>
int launch_f32(const F32Args& a, int b, int dk, void* stream) {
  dim3 grid((a.sq + kF32Rows - 1) / kF32Rows, a.H, b);
  auto st = static_cast<cudaStream_t>(stream);
  switch (dk) {
    case 32: attn_f32_kernel<32, kForm><<<grid, 32 * kF32Warps, 0, st>>>(a);
      break;
    case 64: attn_f32_kernel<64, kForm><<<grid, 32 * kF32Warps, 0, st>>>(a);
      break;
    case 96: attn_f32_kernel<96, kForm><<<grid, 32 * kF32Warps, 0, st>>>(a);
      break;
    case 128: attn_f32_kernel<128, kForm><<<grid, 32 * kF32Warps, 0, st>>>(a);
      break;
    case 256: attn_f32_kernel<256, kForm><<<grid, 32 * kF32Warps, 0, st>>>(a);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
