// The Hopper attention mainloop shared by the query-tiled attention kernels:
// consmax_prefill (contiguous cache and page pool; bf16, int8 or fp8_e4m3
// K/V), consmax_attn and softmax_attn. One CTA owns 64 folded query rows
// (wgmma's M) of one KV head and walks the KV tiles those rows can see, in
// order, through a ring of kStages shared-memory stages; the full-sequence
// kernels put two such consumers (128 rows) on one ring:
//
//   the last warpgroup (producer, 128 threads): step t waits for stage t's `empty`
//     mbarrier and issues cp.async 16-byte copies of tile t's K and V rows
//     (one row address per row: contiguous, or through the page table; rows
//     past the walk's end or on an unmapped page are zero-filled by the copy
//     itself and never read); the copy unit arrives on the stage's `full`
//     mbarrier when they land, so every stage can be in flight. An int8 /
//     fp8 cache is copied the same way into a staging slot of codes and fp32
//     row scales, and one step later the producer waits for them and
//     dequantizes them into the stage's bf16 operand tile through
//     consmax_common.cuh `dequant`, unchanged: a quantized tile holds
//     exactly the bf16 values of the dequantized cache, so everything
//     downstream gives the same bits.
//   each other warpgroup (consumer, 128 threads): loads its Q tile into shared memory
//     once, then per tile waits for `full`, computes S = Q K^T with
//     wgmma.m64n64k16 (A and B from shared memory, both K-major, k-steps in
//     order), applies the mask and the per-score epilogue on the
//     accumulator in registers, rounds P to bf16 in registers (the TPU
//     kernels' p.astype(v.dtype)), adds O += P V with wgmma.m64nDKk16 (A = P
//     from registers, B = the V tile, MN-major), and arrives on `empty`. It
//     waits only for the tile it works on: a consumer that waited for tile
//     t + 1 before releasing tile t would deadlock the two-stage quantized
//     ring, whose producer publishes t + 1 only after it has refilled tile
//     t's stage.
//
// Tiles are summed in order into one fp32 accumulator, with no partial
// buffers and no atomics: every run gives the same bits, and any two
// kernels that walk the same rows through this loop give the same bits
// (paged == contiguous for every page size, since tiles are aligned to
// logical rows; consmax_attn == consmax_prefill at index 0; a quantized
// cache == the bf16 kernel on its dequantized values).
//
// Shared-memory operand layout: every tile (Q, K, V) is stored as 8 x 16-
// byte "core matrices" (8 rows x 8 bf16), each 128 contiguous bytes, the
// core matrix of rows 8 i.. and columns 8 j.. at ((i * DK / 8) + j) * 128
// bytes: wgmma's no-swizzle canonical layout. The one layout serves Q and K
// as K-major operands (leading byte offset 128 between column groups,
// stride byte offset DK * 16 between row groups) and V as the MN-major B of
// P V (128 bytes between column groups, DK * 16 between row groups), for
// every head_dim from 32 to 256 alike, so no swizzle mode has to match a
// row width. A warp's eight consecutive 16-byte copies fill one core
// matrix, so the copies' shared-memory writes do not conflict.
//
// Per-score epilogues (kForm), in base 2 (exp(x) = 2^(x log2 e), one SFU
// instruction): ConSmax Eq. 2 (exp(s - beta) / gamma, the unmerged form
// with its division) or Eq. 3 (C exp(s), C = exp(-beta) / gamma computed
// once per row) add the tile with no rescale; softmax keeps (m, l) per row
// in base 2 (row max over the quad of threads that share a row, alpha
// rescale of O, l summed over the quad once at the end, the final divide),
// with the -1e30 mask value of softmax_attn/kernel.py. A tile that every
// (row, key) pair of the CTA can see skips the mask; the two branches
// compute the same values. The full-sequence kernels run two consumer
// warpgroups per CTA at head_dim <= 128 (128 rows share each copied K/V
// tile, and one warpgroup's epilogue overlaps the other's products); a
// serving chunk keeps one, so the engine's chunk fills more SMs.
//
// Why cp.async and not TMA: a TMA box reads whole rows up to the tensor's
// bounds, so rows past the fill (stale cache rows) and rows of unmapped
// pages would be loaded and would have to be zeroed in shared memory before
// the product (0 * NaN is NaN), a page of 4 rows would need one box per 4
// rows, and every launch on the host-bound engine would encode a tensor
// map. cp.async with a zero source size zero-fills exactly the rows the
// walk must not read, for any page size, at no host cost.
#pragma once

#include "async_copy.cuh"
#include "consmax_common.cuh"
#include "wgmma.cuh"

// Internal linkage: three libraries instantiate the same templates, and a
// function-local static of a template with external linkage (the
// shared-memory attribute below) is one object across every library loaded
// in the process, so a second library would skip setting its own kernel's
// attribute.
namespace {

constexpr int kWalkBN = 64;        // KV rows per tile: the N of S = Q K^T
constexpr int kWalkRows = 64;      // folded query rows per consumer: wgmma's M
constexpr int kFormEq2 = 0;        // ConSmax exp(s - beta) / gamma
constexpr int kFormEq3 = 1;        // ConSmax C * exp(s) (merged)
constexpr int kFormSoftmax = 2;    // online softmax
constexpr float kNegInf = -1e30f;  // softmax_attn/kernel.py NEG_INF
constexpr int kProducerBar = 3;    // named barrier of the producer warpgroup

// ---------------------------------------------------------------- PTX ----
// A barrier over one warpgroup (ids 1, 2: consumers, kProducerBar: producer).
__device__ __forceinline__ void warpgroup_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

constexpr float kLog2e = 1.4426950408889634f;
// 2^x, the SFU's approximation (relative error ~2^-22, far below the bf16
// rounding of the weights); 2^-1e30 = +0.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&t);
}

// Byte offset of 16-byte chunk ch (columns 8 ch .. 8 ch + 7) of row r in a
// tile of `chunks` chunks per row (the core-matrix layout above).
__device__ __forceinline__ uint32_t tile_off(int r, int ch, int chunks) {
  return static_cast<uint32_t>(((r >> 3) * chunks + ch) * 128 + (r & 7) * 16);
}

// wgmma shared-memory matrix descriptor, no swizzle: start address, leading
// and stride byte offsets, each in 16-byte units.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32);
}

// ------------------------------------------------------------- layout ----
// Dynamic shared memory of one CTA: the stages' mbarriers, the kCons Q tiles
// (one per consumer warpgroup), the
// ring of kStages bf16 K/V stages and, for a quantized cache, one staging
// slot of codes and row scales per stage. At head_dim 256 with codes the
// ring keeps two stages, so the CTA fits the 227 KB a block may use.
template <int DK, class TKV, int kCons = 1>
struct WalkLayout {
  static constexpr bool kScaled = KVType<TKV>::kScaled;
  static constexpr int kChunks = DK / 8;          // 16-byte chunks per row
  static constexpr int kStages = (DK == 256 && kScaled) ? 2 : 3;
  static constexpr int kTile = kWalkBN * DK * 2;  // one bf16 K or V tile
  // a staged code row, padded off the 128-byte bank period where it fits
  static constexpr int kCodeRow = DK + (DK < 256 ? 16 : 0);
  static constexpr int kCodeSlot = 2 * kWalkBN * kCodeRow + 2 * kWalkBN * 4;
  static constexpr int kQ = 128;                  // after the mbarriers
  static constexpr int kKV = kQ + kCons * kWalkRows * DK * 2;
  static constexpr int kCodes = kKV + kStages * 2 * kTile;
  static constexpr int kBytes = kCodes + (kScaled ? kStages * kCodeSlot : 0);
  static_assert(2 * kStages * 8 <= kQ, "mbarriers overflow their slot");
  static_assert(kBytes <= 232448, "more than a block's shared memory");
};

// ---------------------------------------------------------- arguments ----
// One launch of the walk. q, out: (b, c, H, DK) bf16 (the chunk of a slot,
// or a whole sequence); k, v: rows of hkv * DK elements of TKV, row i of
// slot b's logical row r given by rows_of; k_scale, v_scale: rows of hkv
// fp32 (null for bf16). index, lengths: (b,) int32 — the chunk sits at
// cache positions index + [0, c) and the slot's keys end at index +
// lengths; null for a whole sequence (index 0, keys end at L). beta, gamma
// (H,) fp32 (unused by softmax). fill_bound walks only the tiles the CTA's
// rows can see (a skipped tile would add exact zeros); reverse issues the
// CTAs of the last rows first (under causal masking they see the most
// tiles).
template <class TKV, class Rows>
struct WalkArgs {
  const __nv_bfloat16* q;
  const TKV* k;
  const TKV* v;
  const float* k_scale;
  const float* v_scale;
  Rows rows_of;
  const int* index;
  const int* lengths;
  const float* beta;
  const float* gamma;
  __nv_bfloat16* out;
  int c, H, hkv, L, causal, window, fill_bound, reverse;
  float softcap, scale;
};

// ------------------------------------------------------------ producer ----
// The copies of tile t by producer thread pt: K and V rows (bf16 into the
// stage's operand tiles; codes into the tile's staging slot), and for codes
// the rows' scales.
template <int DK, int kCons, class TKV, class Rows>
__device__ __forceinline__ void issue_tile(const WalkArgs<TKV, Rows>& a,
                                           uint8_t* smem, int pt, int b,
                                           int h, int t, int j0,
                                           int kv_end) {
  using Lay = WalkLayout<DK, TKV, kCons>;
  constexpr int CH = Lay::kChunks;
  const size_t row_stride = static_cast<size_t>(a.hkv) * DK;
  const TKV* kh = a.k + static_cast<size_t>(h) * DK;
  const TKV* vh = a.v + static_cast<size_t>(h) * DK;
  const int s = t % Lay::kStages;
  if constexpr (!Lay::kScaled) {
    uint8_t* ks = smem + Lay::kKV + s * 2 * Lay::kTile;
    uint8_t* vs = ks + Lay::kTile;
    // chunk i = pt + 128 j: eight consecutive threads fill one core matrix
#pragma unroll
    for (int j = 0; j < kWalkBN * CH / 128; ++j) {
      const int i = pt + 128 * j;
      const int rest = i >> 3, ch = rest % CH;
      const int r = (rest / CH) * 8 + (i & 7);
      const int kpos = j0 + r;
      size_t row = 0;
      const bool ok = kpos < kv_end && a.rows_of.row(b, kpos, &row);
      const size_t at = ok ? row * row_stride + ch * 8 : 0;
      cp_async16(ks + tile_off(r, ch, CH), kh + at, ok);
      cp_async16(vs + tile_off(r, ch, CH), vh + at, ok);
    }
  } else {
    constexpr int QCH = DK / 16;  // 16-code chunks per row
    uint8_t* kc = smem + Lay::kCodes + s * Lay::kCodeSlot;
    uint8_t* vc = kc + kWalkBN * Lay::kCodeRow;
    float* ksc = reinterpret_cast<float*>(vc + kWalkBN * Lay::kCodeRow);
    float* vsc = ksc + kWalkBN;
#pragma unroll
    for (int j = 0; j < kWalkBN * QCH / 128; ++j) {
      const int i = pt + 128 * j;
      const int r = i / QCH, ch = i % QCH;
      const int kpos = j0 + r;
      size_t row = 0;
      const bool ok = kpos < kv_end && a.rows_of.row(b, kpos, &row);
      const size_t at = ok ? row * row_stride + ch * 16 : 0;
      cp_async16(kc + r * Lay::kCodeRow + ch * 16, kh + at, ok);
      cp_async16(vc + r * Lay::kCodeRow + ch * 16, vh + at, ok);
    }
    if (pt < kWalkBN) {
      const int kpos = j0 + pt;
      size_t row = 0;
      const bool ok = kpos < kv_end && a.rows_of.row(b, kpos, &row);
      const size_t at = ok ? row * a.hkv + h : 0;
      cp_async4(ksc + pt, a.k_scale + at, ok);
      cp_async4(vsc + pt, a.v_scale + at, ok);
    }
  }
}

// Codes and scales of tile t (landed in its staging slot) dequantized into
// its stage's bf16 operand tiles. A zero-filled row (codes 0, scale 0)
// becomes +0, as a bf16 zero row.
template <int DK, int kCons, class TKV>
__device__ __forceinline__ void dequant_tile(uint8_t* smem, int pt, int t) {
  using Lay = WalkLayout<DK, TKV, kCons>;
  constexpr int CH = Lay::kChunks;
  constexpr int QCH = DK / 16;
  const int s = t % Lay::kStages;
  const uint8_t* kc = smem + Lay::kCodes + s * Lay::kCodeSlot;
  const uint8_t* vc = kc + kWalkBN * Lay::kCodeRow;
  const float* ksc =
      reinterpret_cast<const float*>(vc + kWalkBN * Lay::kCodeRow);
  const float* vsc = ksc + kWalkBN;
  uint8_t* ks = smem + Lay::kKV + s * 2 * Lay::kTile;
  uint8_t* vs = ks + Lay::kTile;
#pragma unroll
  for (int j = 0; j < kWalkBN * QCH / 128; ++j) {
    const int i = pt + 128 * j;
    const int rest = i >> 3, ch = rest % QCH;
    const int r = (rest / QCH) * 8 + (i & 7);
    uint4 lo, hi;
    dequant16(reinterpret_cast<const TKV*>(kc + r * Lay::kCodeRow + ch * 16),
              ksc[r], &lo, &hi);
    *reinterpret_cast<uint4*>(ks + tile_off(r, 2 * ch, CH)) = lo;
    *reinterpret_cast<uint4*>(ks + tile_off(r, 2 * ch + 1, CH)) = hi;
    dequant16(reinterpret_cast<const TKV*>(vc + r * Lay::kCodeRow + ch * 16),
              vsc[r], &lo, &hi);
    *reinterpret_cast<uint4*>(vs + tile_off(r, 2 * ch, CH)) = lo;
    *reinterpret_cast<uint4*>(vs + tile_off(r, 2 * ch + 1, CH)) = hi;
  }
}

// bf16: step t waits for tile t's stage to be free, issues its copies and
// has the copy unit itself arrive on the stage's `full` barrier when they
// land (cp.async.mbarrier.arrive.noinc), so every stage of the ring can be
// in flight and the producer never waits for its own copies.
// int8 / fp8: step t issues tile t into its staging slot and publishes tile
// t - 1: waits for its own copies of it, dequantizes it into the stage's
// bf16 tile, fences and arrives. The consumer waits only for the tile it
// works on, so neither form waits on a stage the consumer still needs.
template <int DK, int kCons, class TKV, class Rows>
__device__ __forceinline__ void walk_producer(const WalkArgs<TKV, Rows>& a,
                                              uint8_t* smem, int b, int h,
                                              int kv_begin, int kv_end,
                                              int n_tiles) {
  using Lay = WalkLayout<DK, TKV, kCons>;
  const int pt = threadIdx.x - 128 * kCons;
  constexpr int S = Lay::kStages;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + S;
  if constexpr (!Lay::kScaled) {
    for (int t = 0; t < n_tiles; ++t) {
      mbar_wait(&empty[t % S], ((t / S) & 1) ^ 1);
      issue_tile<DK, kCons>(a, smem, pt, b, h, t, kv_begin + t * kWalkBN,
                             kv_end);
      cp_async_arrive(&full[t % S]);
    }
  } else {
    for (int t = 0; t <= n_tiles; ++t) {
      if (t < n_tiles) {
        mbar_wait(&empty[t % S], ((t / S) & 1) ^ 1);
        issue_tile<DK, kCons>(a, smem, pt, b, h, t, kv_begin + t * kWalkBN,
                             kv_end);
        cp_async_commit();
      }
      if (t == 0) continue;
      if (t < n_tiles) {  // tile t - 1 landed (tile t may stay in flight)
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      warpgroup_sync(kProducerBar);  // every producer thread's copies landed
      dequant_tile<DK, kCons, TKV>(smem, pt, t - 1);
      warpgroup_sync(kProducerBar);  // its staging slot may be refilled
      fence_proxy_async();
      mbar_arrive(&full[(t - 1) % S]);
    }
  }
}

// ------------------------------------------------------------ consumer ----
// Consumer warpgroup cw of the CTA, rows r0 .. r0 + 63 (r0 = the CTA's
// first row + 64 cw). It takes every tile of the CTA's walk in order, and
// computes the ones its own rows can see: a tile no row of it can see would
// add exact zeros (softmax: alpha 1 and e 0), so it only releases it.
template <int DK, int kForm, int kCons, class TKV, class Rows>
__device__ __forceinline__ void walk_consumer(const WalkArgs<TKV, Rows>& a,
                                              uint8_t* smem, int cw, int b,
                                              int h, int r0, int idx, int kvl,
                                              int kv_begin, int n_tiles) {
  using Lay = WalkLayout<DK, TKV, kCons>;
  constexpr int CH = Lay::kChunks;
  constexpr int S = Lay::kStages;
  constexpr int NS = kWalkBN / 2;  // score registers per thread
  constexpr int NO = DK / 2;       // output registers per thread
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + S;
  uint8_t* q_s = smem + Lay::kQ + cw * kWalkRows * DK * 2;
  const int g = a.H / a.hkv;
  const int rows_total = a.c * g;
  const int lt = kCons > 1 ? threadIdx.x % 128 : threadIdx.x;  // in the WG
  const int warp = lt / 32, lane = lt % 32;
  const int gid = lane >> 2, tig = lane & 3;

  // the Q tile, once (rows past the folded chunk are zeros)
  for (int i = lt; i < kWalkRows * CH; i += 128) {
    const int rest = i >> 3, ch = rest % CH;
    const int r = (rest / CH) * 8 + (i & 7);
    const int row = r0 + r;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row < rows_total) {
      const int pos = row / g, head = h * g + row % g;
      val = *reinterpret_cast<const uint4*>(
          a.q + ((static_cast<size_t>(b) * a.c + pos) * a.H + head) * DK +
          ch * 8);
    }
    *reinterpret_cast<uint4*>(q_s + tile_off(r, ch, CH)) = val;
  }
  fence_proxy_async();
  warpgroup_sync(1 + cw);

  // this thread's two accumulator rows: 16 warp + gid (+ 8)
  bool rvalid[2];
  int qpos[2];
  float bet[2] = {0.f, 0.f}, gam[2] = {1.f, 1.f}, cm[2] = {0.f, 0.f};
  __nv_bfloat16* orow[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + warp * 16 + gid + 8 * i;
    rvalid[i] = r < rows_total;
    const int pos = rvalid[i] ? r / g : 0;
    const int head = h * g + (rvalid[i] ? r % g : 0);
    qpos[i] = idx + pos;
    if constexpr (kForm != kFormSoftmax) {
      bet[i] = a.beta[head];
      gam[i] = a.gamma[head];
      cm[i] = consmax_c(bet[i], gam[i]);
    }
    orow[i] = rvalid[i] ? a.out + ((static_cast<size_t>(b) * a.c + pos) *
                                       a.H + head) * DK
                        : nullptr;
  }

  float o[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf};  // softmax: running max of each row
  float l[2] = {0.f, 0.f};          // softmax: this thread's share of l

  // the weights' constants, in base 2: exp(x) = ex2(x log2 e)
  const float k2 = a.scale * kLog2e;
  float b2[2] = {0.f, 0.f};  // Eq. 2: -beta log2 e
#pragma unroll
  for (int i = 0; i < 2; ++i) b2[i] = -bet[i] * kLog2e;
  // a tile is interior when every (row, key) pair of the warpgroup is
  // visible: then the epilogue skips the mask (the same values); it is dead
  // when no row of the warpgroup can see a key of it
  const int pos_lo = min(r0, rows_total - 1) / g;
  const int pos_hi = min(a.c - 1, (r0 + kWalkRows - 1) / g);
  const bool rows_full = r0 + kWalkRows <= rows_total;
  int live_end = a.L, live_begin = 0;  // this warpgroup's visible keys
  if (a.fill_bound) {
    live_end = min(a.L, kvl);
    if (a.causal) live_end = min(live_end, idx + pos_hi + 1);
    if (a.window > 0) live_begin = idx + pos_lo - a.window + 1;
  }
  if (r0 >= rows_total) live_end = 0;

  const uint32_t q_addr = smem_u32(q_s);
  const uint32_t kv_addr = smem_u32(smem + Lay::kKV);
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % S;
    const int j0 = kv_begin + t * kWalkBN;
    const uint32_t k_addr = kv_addr + s * 2 * Lay::kTile;
    const uint32_t v_addr = k_addr + Lay::kTile;
    mbar_wait(&full[s], (t / S) & 1);
    if (kCons > 1 && (j0 >= live_end || j0 + kWalkBN <= live_begin)) {
      mbar_arrive(&empty[s]);  // a dead tile for this warpgroup
      continue;
    }
    fence_proxy_async();  // the landed copies, visible to the tensor cores

    // S = Q K^T, k-steps of 16 columns in order
    float sc[NS];
#pragma unroll
    for (int i = 0; i < NS; ++i) sc[i] = 0.f;
    fence_regs<NS>(sc);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < DK / 16; ++ks) {
      Wgmma<kWalkBN>::ss(sc, smem_desc(q_addr + ks * 256, 128, DK * 16),
                         smem_desc(k_addr + ks * 256, 128, DK * 16), ks > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<NS>(sc);

    // the per-score epilogue on the accumulator: register i is row
    // (i >> 1) & 1 of this thread's two, key j0 + 8 (i >> 2) + 2 tig + (i & 1);
    // x = the score times log2 e (softcapped first where asked)
    const bool interior =
        rows_full && j0 + kWalkBN <= kvl &&
        (!a.causal || j0 + kWalkBN - 1 <= idx + pos_lo) &&
        (a.window <= 0 || idx + pos_hi - j0 < a.window);
    auto logit2 = [&](float v) {
      return a.softcap > 0.f
                 ? a.softcap * tanhf(v * a.scale / a.softcap) * kLog2e
                 : v * k2;
    };
    auto visible = [&](int i) {
      const int ri = (i >> 1) & 1;
      return rvalid[ri] &&
             kv_mask(qpos[ri], j0 + (i >> 2) * 8 + tig * 2 + (i & 1), kvl,
                     a.window, a.causal);
    };
    if constexpr (kForm == kFormSoftmax) {
      uint32_t live = 0xffffffffu;  // bit i: entry i visible
      float m_new[2] = {m[0], m[1]};
      if (interior) {
#pragma unroll
        for (int i = 0; i < NS; ++i) {
          sc[i] = logit2(sc[i]);
          m_new[(i >> 1) & 1] = fmaxf(m_new[(i >> 1) & 1], sc[i]);
        }
      } else {
#pragma unroll
        for (int i = 0; i < NS; ++i) {
          if (visible(i)) {
            sc[i] = logit2(sc[i]);
          } else {
            sc[i] = kNegInf;
            live &= ~(1u << i);
          }
          m_new[(i >> 1) & 1] = fmaxf(m_new[(i >> 1) & 1], sc[i]);
        }
      }
      float alpha[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {  // the row's max over its quad
        m_new[i] = fmaxf(m_new[i], __shfl_xor_sync(0xffffffffu, m_new[i], 1));
        m_new[i] = fmaxf(m_new[i], __shfl_xor_sync(0xffffffffu, m_new[i], 2));
        alpha[i] = ex2(m[i] - m_new[i]);
        m[i] = m_new[i];
      }
      float lt[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const int ri = (i >> 1) & 1;
        const float x = (live >> i) & 1u ? ex2(sc[i] - m[ri]) : 0.f;
        sc[i] = x;
        lt[ri] += x;
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + lt[i];
#pragma unroll
      for (int i = 0; i < NO; ++i) o[i] *= alpha[(i >> 1) & 1];
    } else {
      // Eq. 3: C ex2(x); Eq. 2: ex2(x - beta log2 e) / gamma
      auto weight = [&](int i) {
        const int ri = (i >> 1) & 1;
        const float x = logit2(sc[i]);
        return kForm == kFormEq3 ? cm[ri] * ex2(x)
                                 : ex2(x + b2[ri]) / gam[ri];
      };
      if (interior) {
#pragma unroll
        for (int i = 0; i < NS; ++i) sc[i] = weight(i);
      } else {
#pragma unroll
        for (int i = 0; i < NS; ++i) sc[i] = visible(i) ? weight(i) : 0.f;
      }
    }

    // P as bf16 A fragments: k-step kk holds score columns 16 kk .. 16 kk + 15
    uint32_t pa[kWalkBN / 16][4];
#pragma unroll
    for (int kk = 0; kk < kWalkBN / 16; ++kk) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        pa[kk][e] = pack_bf16(sc[8 * kk + 2 * e], sc[8 * kk + 2 * e + 1]);
    }

    // O += P V, k-steps of 16 KV rows in order
    fence_regs<NO>(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kWalkBN / 16; ++kk) {
      Wgmma<DK>::rs(o, pa[kk],
                    smem_desc(v_addr + kk * 2 * DK * 16, DK * 16, 128), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<NO>(o);
    mbar_arrive(&empty[s]);
  }

  if constexpr (kForm == kFormSoftmax) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // the row sum over its quad, then divide
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
      l[i] = fmaxf(l[i], 1e-30f);
    }
#pragma unroll
    for (int i = 0; i < NO; ++i) o[i] /= l[(i >> 1) & 1];
  }
#pragma unroll
  for (int i = 0; i < NO; i += 2) {
    __nv_bfloat16* dst = orow[(i >> 1) & 1];
    if (dst)
      *reinterpret_cast<__nv_bfloat162*>(dst + (i >> 2) * 8 + tig * 2) =
          __floats2bfloat162_rn(o[i], o[i + 1]);
  }
}

// --------------------------------------------------------------- kernel ----
// kCons consumer warpgroups (64 rows each) share every K/V tile of the
// CTA; warpgroup kCons is the producer.
template <int DK, int kForm, class TKV, class Rows, int kCons>
__global__ void __launch_bounds__(128 * (kCons + 1), 1)
    attn_walk_kernel(const __grid_constant__ WalkArgs<TKV, Rows> a) {
  using Lay = WalkLayout<DK, TKV, kCons>;
  constexpr int kCtaRows = kCons * kWalkRows;
  extern __shared__ __align__(128) uint8_t smem[];
  const int h = blockIdx.y, b = blockIdx.z;
  const int g = a.H / a.hkv;
  const int r0 =
      (a.reverse ? gridDim.x - 1 - blockIdx.x : blockIdx.x) * kCtaRows;
  const int idx = a.index ? a.index[b] : 0;
  const int kvl = a.index ? idx + a.lengths[b] : a.L;

  // the KV tiles this CTA's rows can see (never past the cache's last row,
  // even if index + lengths runs over it)
  int kv_begin = 0, kv_end = a.L;
  if (a.fill_bound) {
    const int pos_lo = r0 / g;
    const int pos_hi = min(a.c - 1, (r0 + kCtaRows - 1) / g);
    kv_end = min(a.L, kvl);
    if (a.causal) kv_end = min(kv_end, idx + pos_hi + 1);
    if (a.window > 0) kv_begin = max(0, idx + pos_lo - a.window + 1);
  }
  kv_begin = (kv_begin / kWalkBN) * kWalkBN;
  const int n_tiles =
      kv_end > kv_begin ? (kv_end - kv_begin + kWalkBN - 1) / kWalkBN : 0;

  if (threadIdx.x == 0) {
    uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
    for (int s = 0; s < Lay::kStages; ++s) {
      mbar_init(&bars[s], 128);                          // full: producer
      mbar_init(&bars[Lay::kStages + s], 128 * kCons);   // empty: consumers
    }
    mbar_init_fence();
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;
  if (wg == kCons) {
    walk_producer<DK, kCons>(a, smem, b, h, kv_begin, kv_end, n_tiles);
  } else {
    walk_consumer<DK, kForm, kCons>(a, smem, wg, b, h, r0 + wg * kWalkRows,
                                    idx, kvl, kv_begin, n_tiles);
  }
}

// One launch: grid (ceil(c * g / (64 kCons)), hkv, b), 128 (kCons + 1)
// threads, the layout's dynamic shared memory (the attribute is set once
// per instantiation). kWide: two consumer warpgroups per CTA at head_dim
// <= 128, so each K/V tile copied serves 128 rows: for the full-sequence
// kernels, whose grids hold many waves of CTAs (the copies' traffic halves,
// and one warpgroup's epilogue overlaps the other's products). A serving
// chunk's grid is under one wave at the engine's shape, so it keeps one
// consumer per CTA and twice the CTAs.
template <int DK, int kForm, bool kWide = false, class TKV, class Rows>
cudaError_t launch_walk(const WalkArgs<TKV, Rows>& a, int b,
                        cudaStream_t stream) {
  constexpr int kCons = kWide && DK <= 128 ? 2 : 1;
  using Lay = WalkLayout<DK, TKV, kCons>;
  auto kernel = attn_walk_kernel<DK, kForm, TKV, Rows, kCons>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Lay::kBytes);
  if (attr != cudaSuccess) return attr;
  const int g = a.H / a.hkv;
  dim3 grid((a.c * g + kCons * kWalkRows - 1) / (kCons * kWalkRows), a.hkv,
            b);
  kernel<<<grid, 128 * (kCons + 1), Lay::kBytes, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// The dynamic shared memory of one CTA at head_dim dk for a cache of
// kv_type (KVCode) with `consumers` consumer warpgroups, in bytes; 0 for an
// unknown combination.
extern "C" int attn_walk_smem_bytes(int dk, int kv_type, int consumers) {
  const bool q = kv_type != kKVBF16;
  if (consumers == 2) {
    switch (dk) {
      case 32:
        return q ? WalkLayout<32, int8_t, 2>::kBytes
                 : WalkLayout<32, __nv_bfloat16, 2>::kBytes;
      case 64:
        return q ? WalkLayout<64, int8_t, 2>::kBytes
                 : WalkLayout<64, __nv_bfloat16, 2>::kBytes;
      case 128:
        return q ? WalkLayout<128, int8_t, 2>::kBytes
                 : WalkLayout<128, __nv_bfloat16, 2>::kBytes;
      default:
        return 0;
    }
  }
  if (consumers != 1) return 0;
  switch (dk) {
    case 32:
      return q ? WalkLayout<32, int8_t>::kBytes
               : WalkLayout<32, __nv_bfloat16>::kBytes;
    case 64:
      return q ? WalkLayout<64, int8_t>::kBytes
               : WalkLayout<64, __nv_bfloat16>::kBytes;
    case 128:
      return q ? WalkLayout<128, int8_t>::kBytes
               : WalkLayout<128, __nv_bfloat16>::kBytes;
    case 256:
      return q ? WalkLayout<256, int8_t>::kBytes
               : WalkLayout<256, __nv_bfloat16>::kBytes;
    default:
      return 0;
  }
}
