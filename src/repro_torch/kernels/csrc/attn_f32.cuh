// The full-sequence attention kernels on fp32 operands (consmax_attn.cu and
// softmax_attn.cu, each its own entry point). Replaces, for fp32 q / k / v,
// the TPU kernels consmax_attention and softmax_attention (_kernel in
// src/repro/kernels/consmax_attn/kernel.py and softmax_attn/kernel.py),
// whose tests hold fp32 to atol 2e-5. A bf16 or TF32 tensor-core product
// (~1e-3 relative) misses that; 3xTF32 meets it on the tensor cores: each
// operand x splits into hi = tf32(x) and lo = tf32(x - hi) (cvt.rna, in
// registers at fragment-load time), and a product is lo.hi + hi.lo + hi.hi
// with fp32 accumulators, the two small cross terms first (CUTLASS's
// 3xTF32 order). The lo.lo term (~2^-22 relative) is dropped. The scores'
// exp and tanh are expf / tanhf, as the plain version's.
//
// Bound: 4 dk H FLOP per visible (query, key) pair; at the paper's qwen2
// shape (b 2 x s 4096, 12 / 2 heads, dk 128, causal) 103 GFLOP against
// ~50 MB of q / k / v / out, so compute-bound: 1.54 ms at the 67 TFLOP/s
// fp32 (non-tensor) peak, 0.625 ms for the three TF32 products at 495
// TFLOP/s.
//
// Design:
// * Instruction: mma.sync.m16n8k8.row.col tf32, fp32 accumulators. wgmma
//   takes tf32 only with both operands K-major; V is stored (keys, dk),
//   N-major as the B of P V, so wgmma would need V transposed in shared
//   memory, and its operands would have to be the split hi / lo tiles in
//   shared memory, while mma.sync reads registers, where the split happens.
// * GQA folded position-major, as the bf16 mainloop: folded row r = pos g +
//   head-in-group, so one CTA's rows share one KV head and every K/V tile
//   copied serves all g query heads. A warp owns 16 folded rows; a CTA 8
//   warps (128 rows) and 64-key tiles, at dk 256 4 warps (64 rows) and
//   32-key tiles, for the fp32 accumulator's registers and shared memory.
// * Shared memory (dynamic): the CTA's Q rows once, then a ring of kStages
//   K+V stages (3 where they fit, else 2) filled by every thread's 16-byte
//   cp.async copies; the copy unit arrives on the stage's mbarrier when a
//   thread's copies land, a __syncthreads after each tile frees its stage
//   for the copy issued at the next step. Rows past the walk or past sq g
//   are zero-filled by the copy and never written.
// * Fragments without shuffles: a product's k order is free as long as A
//   and B agree, so S = Q K^T reads Q and K as float4 runs of 16 columns
//   (two k-steps per load) and O += P V takes P straight from S's
//   accumulator layout (thread (g, t) holds keys 2t, 2t+1 of each 8-key
//   step: those are its k = t, t + 4) against V rows 2t, 2t + 1; V is read
//   as float2 across two output n-tiles, so a thread ends with 4
//   consecutive output columns and stores them as one float4. Row strides
//   of dk + 16 (Q, K) and dk + 4 (V) floats make every fragment load free
//   of bank conflicts.
// * The CTA walks only the keys its rows can see (causal reach, window); a
//   skipped key adds exact zeros. A tile every (row, key) pair of the CTA
//   sees skips the mask (both branches give the same values). CTAs of the
//   last rows, which see the most keys under causal masking, start first:
//   the row tile is the slowest-varying index of a 1-D grid, reversed.
// * Per score, on the accumulator in registers: ConSmax (Eq. 2 / 3) p =
//   consmax_weight(s), 0 if masked; softmax m' = max(m, row max of the
//   tile) over the quad of threads that share a row, alpha = exp(m - m'),
//   e = exp(s - m') (0 if masked), l = l alpha + sum e per thread (summed
//   over the quad once at the end), o = o alpha + e V, and o / max(l,
//   1e-30) at the end.
// * Chunked accumulation: the tensor cores' fp32 accumulate aligns the
//   addend to the largest term and truncates, so a long chain of mma.sync
//   on one accumulator drifts toward zero (measured on the H100 at the
//   qwen2 shape: 1.5e-4 from plain, ~2.6e-5 of the output's scale, with
//   every product chained). Each 16-column (S) or 16-key (O) chunk is
//   summed by its six mma.sync into a fresh fragment, then added to the
//   running sum with a round-to-nearest fp32 add. The products of 4 S
//   n-tiles (O: 2 n-tile pairs) are issued together on independent
//   fragments, so each mma.sync's latency hides behind the next; one
//   fragment's six products in a row leave a warp waiting on each.
// * Determinism: no atomics; every sum runs in a fixed order, so a second
//   run gives the same bits.
#pragma once

#include "async_copy.cuh"
#include "consmax_common.cuh"

namespace {

constexpr int kF32Eq2 = 0, kF32Eq3 = 1, kF32Softmax = 2;
constexpr int kF32SmemMax = 232448;  // the opt-in limit of a Hopper block

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
  unsigned long long* launches;  // count_launch's counter (null: none)
};

// The CTA's shape and dynamic shared memory at head_dim DK (twin:
// kernels/launch_plan.py f32_smem_bytes): 128 bytes of mbarriers, the Q
// rows, then kStages stages of K and V rows.
template <int DK>
struct F32Layout {
  static constexpr int kWarps = DK == 256 ? 4 : 8;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kRows = 16 * kWarps;
  static constexpr int kKeys = DK == 256 ? 32 : 64;
  static constexpr int kQK = DK + 16;  // Q / K row stride (floats)
  static constexpr int kV = DK + 4;    // V row stride (floats)
  static constexpr int kQBytes = kRows * kQK * 4;
  static constexpr int kKBytes = kKeys * kQK * 4;
  static constexpr int kStageBytes = kKBytes + kKeys * kV * 4;
  static constexpr int kBase = 128 + kQBytes;
  static constexpr int kStages =
      kBase + 3 * kStageBytes <= kF32SmemMax ? 3 : 2;
  static constexpr int kBytes = kBase + kStages * kStageBytes;
};

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo, both tf32 (x - hi is exact in fp32)
__device__ __forceinline__ void tf32_split(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Copy `rows` rows of DK floats from global (row i at src(i), or zeros
// when !ok(i)) into shared memory at `stride` floats per row, 16 bytes per
// copy, every thread of the CTA taking its share.
template <int DK, int kThreads, class Src>
__device__ __forceinline__ void f32_copy_rows(float* dst, int rows,
                                              int stride, Src src) {
  constexpr int kChunks = DK / 4;
  for (int i = threadIdx.x; i < rows * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i % kChunks;
    const float* p;
    const bool ok = src(r, &p);
    cp_async16(dst + r * stride + 4 * c, ok ? p + 4 * c : p, ok);
  }
}

template <int DK, int kForm>
__global__ void __launch_bounds__(F32Layout<DK>::kThreads)
    attn_f32_kernel(const __grid_constant__ F32Args a) {
  using L = F32Layout<DK>;
  constexpr int NT = L::kKeys / 8;  // S n-tiles per key tile
  constexpr int NO = DK / 16;       // pairs of output n-tiles
  // S n-tiles / output n-tile pairs whose products are issued together:
  // independent accumulators, so one mma.sync's latency hides behind the
  // next (fewer at dk 256, for the accumulator's registers)
  constexpr int JG = DK == 256 ? 2 : 4;
  constexpr int NG = DK == 256 ? 1 : 2;
  extern __shared__ __align__(128) uint8_t smem[];
  count_launch(a.launches);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  float* qs = reinterpret_cast<float*>(smem + 128);
  auto ks = [&](int s) {
    return reinterpret_cast<float*>(smem + L::kBase + s * L::kStageBytes);
  };
  auto vs = [&](int s) {
    return reinterpret_cast<float*>(smem + L::kBase + s * L::kStageBytes +
                                    L::kKBytes);
  };

  const int gq = a.H / a.hkv;
  const int nrows = a.sq * gq;  // folded rows of one (batch row, KV head)
  const int tiles = (nrows + L::kRows - 1) / L::kRows;
  const int groups = gridDim.x / tiles;  // batch rows x KV heads
  const int hk = blockIdx.x % groups % a.hkv;
  const int b = blockIdx.x % groups / a.hkv;
  const int tile = tiles - 1 - blockIdx.x / groups;  // the last rows first
  const int r0 = tile * L::kRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g8 = lane / 4, t4 = lane % 4;

  // the keys this CTA's rows can see
  const int pos_lo = r0 / gq;
  const int pos_hi = min(a.sq - 1, (r0 + L::kRows - 1) / gq);
  int kv_begin = 0, kv_end = a.skv;
  if (a.causal) kv_end = min(kv_end, pos_hi + 1);
  if (a.window > 0) kv_begin = max(0, pos_lo - a.window + 1);
  const int n_tiles =
      kv_end > kv_begin ? (kv_end - kv_begin + L::kKeys - 1) / L::kKeys : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < L::kStages; ++s) mbar_init(&full[s], L::kThreads);
    mbar_init_fence();
  }
  __syncthreads();

  const size_t kv_row0 = static_cast<size_t>(b) * a.skv;
  const int hkv = a.hkv;
  auto kv_rows = [&](const float* base, int j0) {
    return [=](int r, const float** p) {
      const int kpos = j0 + r;
      const bool ok = kpos < kv_end;
      *p = ok ? base + ((kv_row0 + kpos) * hkv + hk) * DK : base;
      return ok;
    };
  };
  auto issue = [&](int t) {
    const int s = t % L::kStages, j0 = kv_begin + t * L::kKeys;
    f32_copy_rows<DK, L::kThreads>(ks(s), L::kKeys, L::kQK,
                                   kv_rows(a.k, j0));
    f32_copy_rows<DK, L::kThreads>(vs(s), L::kKeys, L::kV, kv_rows(a.v, j0));
    cp_async_arrive(&full[s]);
  };
  // Q rows ride with the first stage's copies
  f32_copy_rows<DK, L::kThreads>(qs, L::kRows, L::kQK,
                                 [&](int r, const float** p) {
    const int R = r0 + r;
    const bool ok = R < nrows;
    *p = ok ? a.q + ((static_cast<size_t>(b) * a.sq + R / gq) * a.H +
                     hk * gq + R % gq) * DK
            : a.q;
    return ok;
  });
  if (n_tiles == 0) cp_async_arrive(&full[0]);
  for (int t = 0; t < L::kStages - 1 && t < n_tiles; ++t) issue(t);

  // this thread's two rows: warp rows g8 and g8 + 8
  int pos[2], head[2];
  float bet[2] = {0.f, 0.f}, gam[2] = {1.f, 1.f}, cm[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int R = r0 + warp * 16 + g8 + 8 * i;
    pos[i] = R / gq;
    head[i] = hk * gq + R % gq;
    if constexpr (kForm != kF32Softmax) {
      if (R < nrows) {
        bet[i] = a.beta[head[i]];
        gam[i] = a.gamma[head[i]];
        cm[i] = consmax_c(bet[i], gam[i]);
      }
    }
  }
  float o[NO][2][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][h][e] = 0.f;
  float m[2] = {-1e30f, -1e30f}, l[2] = {0.f, 0.f};  // softmax_attn NEG_INF

  const float* qw = qs + warp * 16 * L::kQK;
  for (int t = 0; t < n_tiles; ++t) {
    if (t + L::kStages - 1 < n_tiles) issue(t + L::kStages - 1);
    const int s = t % L::kStages, j0 = kv_begin + t * L::kKeys;
    mbar_wait(&full[s], (t / L::kStages) & 1);
    const float* kt = ks(s);
    const float* vt = vs(s);

    // S = Q K^T: 16 columns (two k-steps) per float4 run
    float sc[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll 2
    for (int kk = 0; kk < DK / 16; ++kk) {
      const int c0 = kk * 16 + 4 * t4;
      const float4 qa = *reinterpret_cast<const float4*>(qw + g8 * L::kQK +
                                                         c0);
      const float4 qb = *reinterpret_cast<const float4*>(
          qw + (g8 + 8) * L::kQK + c0);
      uint32_t ah[2][4], al[2][4];
      // k-step 0: columns c0, c0 + 1 (k = t, t + 4); k-step 1: c0 + 2, + 3
      tf32_split(qa.x, ah[0][0], al[0][0]);
      tf32_split(qb.x, ah[0][1], al[0][1]);
      tf32_split(qa.y, ah[0][2], al[0][2]);
      tf32_split(qb.y, ah[0][3], al[0][3]);
      tf32_split(qa.z, ah[1][0], al[1][0]);
      tf32_split(qb.z, ah[1][1], al[1][1]);
      tf32_split(qa.w, ah[1][2], al[1][2]);
      tf32_split(qb.w, ah[1][3], al[1][3]);
#pragma unroll
      for (int jg = 0; jg < NT; jg += JG) {
        uint32_t bh[JG][2][2], bl[JG][2][2];
#pragma unroll
        for (int j = 0; j < JG; ++j) {
          const float4 kb = *reinterpret_cast<const float4*>(
              kt + (8 * (jg + j) + g8) * L::kQK + c0);
          tf32_split(kb.x, bh[j][0][0], bl[j][0][0]);
          tf32_split(kb.y, bh[j][0][1], bl[j][0][1]);
          tf32_split(kb.z, bh[j][1][0], bl[j][1][0]);
          tf32_split(kb.w, bh[j][1][1], bl[j][1][1]);
        }
        float part[JG][4] = {};
#pragma unroll
        for (int x = 0; x < 2; ++x) {
#pragma unroll
          for (int j = 0; j < JG; ++j) mma_tf32(part[j], al[x], bh[j][x]);
#pragma unroll
          for (int j = 0; j < JG; ++j) mma_tf32(part[j], ah[x], bl[j][x]);
#pragma unroll
          for (int j = 0; j < JG; ++j) mma_tf32(part[j], ah[x], bh[j][x]);
        }
#pragma unroll
        for (int j = 0; j < JG; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[jg + j][e] += part[j][e];
      }
    }

    // the per-score epilogue; sc[j][2 i + c] is row i, key j0 + 8 j + 2 t4
    // + c
    const bool full_tile =
        j0 + L::kKeys <= a.skv && (!a.causal || j0 + L::kKeys - 1 <= pos_lo) &&
        (a.window <= 0 || pos_hi - j0 < a.window);
    if constexpr (kForm == kF32Softmax) {
      float mx[2] = {-1e30f, -1e30f};
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e / 2, kpos = j0 + 8 * j + 2 * t4 + e % 2;
          float y = sc[j][e] * a.scale;
          if (a.softcap > 0.f) y = a.softcap * tanhf(y / a.softcap);
          if (!full_tile &&
              !kv_mask(pos[i], kpos, a.skv, a.window, a.causal != 0))
            y = -1e30f;
          sc[j][e] = y;
          mx[i] = fmaxf(mx[i], y);
        }
      float alpha[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float m_new = fmaxf(m[i], mx[i]);
        alpha[i] = expf(m[i] - m_new);
        m[i] = m_new;
        l[i] *= alpha[i];
      }
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e / 2, kpos = j0 + 8 * j + 2 * t4 + e % 2;
          const float p =
              full_tile ||
                      kv_mask(pos[i], kpos, a.skv, a.window, a.causal != 0)
                  ? expf(sc[j][e] - m[i])
                  : 0.f;
          sc[j][e] = p;
          l[i] += p;
        }
#pragma unroll
      for (int n = 0; n < NO; ++n)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[n][h][e] *= alpha[e / 2];
    } else {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e / 2, kpos = j0 + 8 * j + 2 * t4 + e % 2;
          sc[j][e] =
              full_tile ||
                      kv_mask(pos[i], kpos, a.skv, a.window, a.causal != 0)
                  ? consmax_weight<kForm == kF32Eq3>(sc[j][e] * a.scale,
                                                     bet[i], gam[i], cm[i],
                                                     a.softcap)
                  : 0.f;
        }
    }

    // O += P V: k-step j is S's n-tile j (k = t4 <-> key 2 t4, k = t4 + 4
    // <-> key 2 t4 + 1), two k-steps per chunk; output n-tiles 2 n and
    // 2 n + 1 read V columns 16 n + 2 g8 and 16 n + 2 g8 + 1 as one float2
#pragma unroll
    for (int jj = 0; jj < NT; jj += 2) {
      uint32_t ph[2][4], pl[2][4];
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        tf32_split(sc[jj + x][0], ph[x][0], pl[x][0]);
        tf32_split(sc[jj + x][2], ph[x][1], pl[x][1]);
        tf32_split(sc[jj + x][1], ph[x][2], pl[x][2]);
        tf32_split(sc[jj + x][3], ph[x][3], pl[x][3]);
      }
      const float* v0 = vt + (8 * jj + 2 * t4) * L::kV + 2 * g8;
#pragma unroll
      for (int ng = 0; ng < NO; ng += NG) {
        uint32_t bh[NG][2][2][2], bl[NG][2][2][2];  // [n][k-step][h][b0/b1]
#pragma unroll
        for (int n = 0; n < NG; ++n)
#pragma unroll
          for (int x = 0; x < 2; ++x) {
            const float* vr = v0 + 8 * x * L::kV + 16 * (ng + n);
            const float2 va = *reinterpret_cast<const float2*>(vr);
            const float2 vb = *reinterpret_cast<const float2*>(vr + L::kV);
            tf32_split(va.x, bh[n][x][0][0], bl[n][x][0][0]);
            tf32_split(vb.x, bh[n][x][0][1], bl[n][x][0][1]);
            tf32_split(va.y, bh[n][x][1][0], bl[n][x][1][0]);
            tf32_split(vb.y, bh[n][x][1][1], bl[n][x][1][1]);
          }
        float part[NG][2][4] = {};
#pragma unroll
        for (int x = 0; x < 2; ++x) {
#pragma unroll
          for (int n = 0; n < NG; ++n)
#pragma unroll
            for (int h = 0; h < 2; ++h)
              mma_tf32(part[n][h], pl[x], bh[n][x][h]);
#pragma unroll
          for (int n = 0; n < NG; ++n)
#pragma unroll
            for (int h = 0; h < 2; ++h)
              mma_tf32(part[n][h], ph[x], bl[n][x][h]);
#pragma unroll
          for (int n = 0; n < NG; ++n)
#pragma unroll
            for (int h = 0; h < 2; ++h)
              mma_tf32(part[n][h], ph[x], bh[n][x][h]);
        }
#pragma unroll
        for (int n = 0; n < NG; ++n)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 4; ++e) o[ng + n][h][e] += part[n][h][e];
      }
    }
    __syncthreads();  // every warp is done with stage s before its refill
  }
  if (n_tiles == 0) mbar_wait(&full[0], 0);  // Q's copies, never read

  // o[n][h][2 i + c] is row i, column 16 n + 4 t4 + 2 c + h
  float inv[2] = {1.f, 1.f};
  if constexpr (kForm == kF32Softmax) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
      inv[i] = 1.f / fmaxf(l[i], 1e-30f);
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (r0 + warp * 16 + g8 + 8 * i >= nrows) continue;
    float* dst = a.out + ((static_cast<size_t>(b) * a.sq + pos[i]) * a.H +
                          head[i]) * DK + 4 * t4;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      float4 w = make_float4(o[n][0][2 * i], o[n][1][2 * i],
                             o[n][0][2 * i + 1], o[n][1][2 * i + 1]);
      if constexpr (kForm == kF32Softmax) {
        w.x *= inv[i];
        w.y *= inv[i];
        w.z *= inv[i];
        w.w *= inv[i];
      }
      *reinterpret_cast<float4*>(dst + 16 * n) = w;
    }
  }
}

// One launch: a 1-D grid of (row tiles x batch rows x KV heads) CTAs, the
// row tile slowest and reversed (the last rows first), F32Layout's threads
// and dynamic shared memory (the attribute is set once per instantiation).
template <int DK, int kForm>
cudaError_t launch_f32_dk(const F32Args& a, int b, cudaStream_t stream) {
  using L = F32Layout<DK>;
  auto kernel = attn_f32_kernel<DK, kForm>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (attr != cudaSuccess) return attr;
  const int tiles = (a.sq * (a.H / a.hkv) + L::kRows - 1) / L::kRows;
  kernel<<<tiles * b * a.hkv, L::kThreads, L::kBytes, stream>>>(a);
  return cudaGetLastError();
}

template <int kForm>
int launch_f32(const F32Args& a, int b, int dk, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  switch (dk) {
    case 32: return static_cast<int>(launch_f32_dk<32, kForm>(a, b, st));
    case 64: return static_cast<int>(launch_f32_dk<64, kForm>(a, b, st));
    case 96: return static_cast<int>(launch_f32_dk<96, kForm>(a, b, st));
    case 128: return static_cast<int>(launch_f32_dk<128, kForm>(a, b, st));
    case 256: return static_cast<int>(launch_f32_dk<256, kForm>(a, b, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// The dynamic shared memory of one CTA of the fp32 kernel at head_dim dk,
// in bytes; 0 for an unknown head_dim.
extern "C" int attn_f32_smem_bytes(int dk) {
  switch (dk) {
    case 32: return F32Layout<32>::kBytes;
    case 64: return F32Layout<64>::kBytes;
    case 96: return F32Layout<96>::kBytes;
    case 128: return F32Layout<128>::kBytes;
    case 256: return F32Layout<256>::kBytes;
    default: return 0;
  }
}
