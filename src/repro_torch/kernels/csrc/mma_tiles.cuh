// Tensor-core tile steps shared by the query-tiled attention kernels
// (consmax_prefill, consmax_attn, softmax_attn): one block of kWarps warps
// holds 16 query rows per warp as mma.sync m16n8k16 A fragments and walks
// KV tiles of Tile<DK>::BN rows through shared memory. Each step below is
// the one arithmetic all three kernels run, in one order, so a row that
// sees the same keys in the same tiles gets the same bits from each of
// them (chip_smoke.py holds consmax_attn to consmax_prefill's bits).
//
// Fragment layout (PTX ISA, mma.m16n8k16 with .bf16): lane = 4 * gid + tig;
// a thread holds rows gid and gid + 8 of its warp's 16, and of every n-tile
// of 8 columns the columns 2 * tig and 2 * tig + 1: accumulator entry e of
// an n-tile is row gid + 8 * (e >> 1), column 2 * tig + (e & 1).
#pragma once

#include "consmax_common.cuh"

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&t);
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  __nv_bfloat162 t;
  t.x = lo;
  t.y = hi;
  return *reinterpret_cast<uint32_t*>(&t);
}

// Tile sizes for head_dim DK: BN KV rows per shared-memory tile (32 at
// DK 256, so two bf16 tiles stay in 48 KB of static shared memory).
template <int DK>
struct Tile {
  static constexpr int BN = DK <= 128 ? 64 : 32;  // KV rows per tile
  static constexpr int KS = DK / 16;              // k-steps of S = Q K^T
  static constexpr int NT = BN / 8;               // n-tiles of S
  static constexpr int DT = DK / 8;               // n-tiles of O
  static constexpr int SROW = DK + 8;             // padded smem row
  static constexpr int CHUNKS = DK / 8;           // 16-byte chunks per row
};

// This thread's two query rows (gid and gid + 8; a null pointer is a pad
// row, loaded as zeros) as A fragments of S = Q K^T.
template <int DK>
__device__ __forceinline__ void load_q_frags(uint32_t (&qa)[DK / 16][4],
                                             const __nv_bfloat16* const* qrow,
                                             int tig) {
#pragma unroll
  for (int ks = 0; ks < DK / 16; ++ks) {
    const int col = ks * 16 + tig * 2;
#pragma unroll
    for (int half = 0; half < 2; ++half) {  // columns col and col + 8
#pragma unroll
      for (int i = 0; i < 2; ++i) {         // rows gid and gid + 8
        qa[ks][2 * half + i] =
            qrow[i] ? *reinterpret_cast<const uint32_t*>(qrow[i] + col +
                                                         8 * half)
                    : 0u;
      }
    }
  }
}

// KV rows [j0, j0 + BN) of slot b into k_s / v_s (BN x SROW each). kh / vh
// point at the KV head's first element; a row's index comes from
// rows_of.row (ContigRows / PagedRows). Rows at or past kv_end, and rows no
// page backs, are zeros and are never read.
template <int DK, int THREADS, class Rows>
__device__ __forceinline__ void load_kv_tile(
    __nv_bfloat16* k_s, __nv_bfloat16* v_s, const __nv_bfloat16* kh,
    const __nv_bfloat16* vh, size_t row_stride, const Rows& rows_of, int b,
    int j0, int kv_end) {
  using T = Tile<DK>;
  for (int i = threadIdx.x; i < T::BN * T::CHUNKS; i += THREADS) {
    const int r = i / T::CHUNKS, ch = i % T::CHUNKS;
    const int kpos = j0 + r;
    uint4 kv4 = make_uint4(0, 0, 0, 0), vv4 = make_uint4(0, 0, 0, 0);
    size_t row;
    if (kpos < kv_end && rows_of.row(b, kpos, &row)) {
      kv4 = *reinterpret_cast<const uint4*>(kh + row * row_stride + ch * 8);
      vv4 = *reinterpret_cast<const uint4*>(vh + row * row_stride + ch * 8);
    }
    *reinterpret_cast<uint4*>(k_s + r * T::SROW + ch * 8) = kv4;
    *reinterpret_cast<uint4*>(v_s + r * T::SROW + ch * 8) = vv4;
  }
}

// The same tile from a cache of K/V element type TKV: bf16 as above
// (scales ignored); int8 / fp8_e4m3 codes read 16 at a time (one 16-byte
// access), dequantized with their row's scale (ksh[row * hkv], vsh[...]:
// the KV head's column of the (rows, hkv) scale tensors) and stored as bf16
// in the same SROW layout. qk_tile / pv_tile then run unchanged, so a
// quantized tile gives the bits of the bf16 tile of the dequantized cache.
// Rows at or past kv_end and rows no page backs are zeros, and neither
// their codes nor their scales are read.
template <int DK, int THREADS, class TKV, class Rows>
__device__ __forceinline__ void load_kv_tile(
    __nv_bfloat16* k_s, __nv_bfloat16* v_s, const TKV* kh, const TKV* vh,
    const float* ksh, const float* vsh, int hkv, size_t row_stride,
    const Rows& rows_of, int b, int j0, int kv_end) {
  if constexpr (!KVType<TKV>::kScaled) {
    load_kv_tile<DK, THREADS>(k_s, v_s, kh, vh, row_stride, rows_of, b, j0,
                              kv_end);
  } else {
    using T = Tile<DK>;
    constexpr int QCH = DK / 16;  // 16-code chunks per row
    for (int i = threadIdx.x; i < T::BN * QCH; i += THREADS) {
      const int r = i / QCH, ch = i % QCH;
      const int kpos = j0 + r;
      const uint4 z = make_uint4(0, 0, 0, 0);
      uint4 klo = z, khi = z, vlo = z, vhi = z;
      size_t row;
      if (kpos < kv_end && rows_of.row(b, kpos, &row)) {
        const float ksc = ksh[row * hkv], vsc = vsh[row * hkv];
        dequant16(kh + row * row_stride + ch * 16, ksc, &klo, &khi);
        dequant16(vh + row * row_stride + ch * 16, vsc, &vlo, &vhi);
      }
      uint4* kd = reinterpret_cast<uint4*>(k_s + r * T::SROW + ch * 16);
      uint4* vd = reinterpret_cast<uint4*>(v_s + r * T::SROW + ch * 16);
      kd[0] = klo;
      kd[1] = khi;
      vd[0] = vlo;
      vd[1] = vhi;
    }
  }
}

// S = Q K^T for this warp's 16 rows x BN tile rows, fp32, k-steps in order.
template <int DK>
__device__ __forceinline__ void qk_tile(float (&s)[Tile<DK>::NT][4],
                                        const uint32_t (&qa)[DK / 16][4],
                                        const __nv_bfloat16* k_s, int gid,
                                        int tig) {
  using T = Tile<DK>;
#pragma unroll
  for (int nt = 0; nt < T::NT; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < T::KS; ++ks) {
      const __nv_bfloat16* kr =
          k_s + (nt * 8 + gid) * T::SROW + ks * 16 + tig * 2;
      mma_bf16(s[nt], qa[ks], *reinterpret_cast<const uint32_t*>(kr),
               *reinterpret_cast<const uint32_t*>(kr + 8));
    }
  }
}

// O += P V: the weights p (the score accumulator's layout) rounded to bf16
// and re-packed in registers as A fragments, as the TPU kernels'
// p.astype(v.dtype); KV k-steps in order.
template <int DK>
__device__ __forceinline__ void pv_tile(float (&o)[DK / 8][4],
                                        const float (&p)[Tile<DK>::NT][4],
                                        const __nv_bfloat16* v_s, int gid,
                                        int tig) {
  using T = Tile<DK>;
#pragma unroll
  for (int kk = 0; kk < T::BN / 16; ++kk) {
    uint32_t pa[4];
    pa[0] = pack_bf16(p[2 * kk][0], p[2 * kk][1]);
    pa[1] = pack_bf16(p[2 * kk][2], p[2 * kk][3]);
    pa[2] = pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]);
    pa[3] = pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3]);
    const __nv_bfloat16* vr = v_s + (kk * 16 + tig * 2) * T::SROW + gid;
#pragma unroll
    for (int dt = 0; dt < T::DT; ++dt) {
      const __nv_bfloat16* vc = vr + dt * 8;
      mma_bf16(o[dt], pa, pack_bf16(vc[0], vc[T::SROW]),
               pack_bf16(vc[8 * T::SROW], vc[9 * T::SROW]));
    }
  }
}

// This thread's two output rows (null = pad row, not stored), bf16.
template <int DK>
__device__ __forceinline__ void store_rows(__nv_bfloat16* const* orow,
                                           const float (&o)[DK / 8][4],
                                           int tig) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!orow[i]) continue;
#pragma unroll
    for (int dt = 0; dt < DK / 8; ++dt) {
      *reinterpret_cast<__nv_bfloat162*>(orow[i] + dt * 8 + tig * 2) =
          __floats2bfloat162_rn(o[dt][2 * i], o[dt][2 * i + 1]);
    }
  }
}
