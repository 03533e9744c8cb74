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
// Tiles are summed in order into one fp32 accumulator: every run gives the
// same bits, and any two kernels that walk the same rows through this loop
// give the same bits (paged == contiguous for every page size, since tiles
// are aligned to logical rows; consmax_attn == consmax_prefill at index 0
// over one shard; a quantized cache == the bf16 kernel on its dequantized
// values).
//
// The KV-shard axis (ConSmax forms only; consmax_prefill's grid): with
// ns > 1 the rows 0 .. L are cut into ns shards of shard_rows logical rows
// (a multiple of kWalkBN, so a shard is whole tiles), and each consumer
// warpgroup walks one (row tile, shard) pair: one per CTA, or, paired
// (kPair, consmax_prefill at head_dim <= 128), two shards of a row tile in
// one CTA, their tiles alternating through the one ring (TileSeq), so two
// independent tile chains share an SM and its fixed costs. A walk is
// clamped to its shard after the fill / causal / window bounds and its
// fp32 accumulator is the shard's partial; a CTA with no live shard
// returns before the ring starts. Every CTA of a (slot, KV head, row tile)
// derives the same live run [s0, s1) from index, lengths, causality and
// the window, so the one holding the last live shards to finish, found by
// an int32 ticket (atomicAdd; no fp32 atomics), sums the partials in shard
// order, whichever CTA it is, writes the bf16 rows and resets the ticket.
// A row tile with no live shard gets zeros from its first CTA. ns = 1 is
// the unsplit walk: no partials, no ticket, the same bits as a launch
// without the axis. ConSmax weights need no running max, so a shard's
// partial is just its share of the sum; softmax's (m, l) would need a
// rescale, so the softmax form keeps ns = 1.
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
constexpr int kConsumersBar = 4;   // named barrier of all consumer warpgroups
constexpr int kLastSlot = 124;     // the combine's flag, after the mbarriers

// ---------------------------------------------------------------- PTX ----
// A barrier over one warpgroup (ids 1, 2: consumers, kProducerBar: producer).
__device__ __forceinline__ void warpgroup_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// A barrier over the kCons consumer warpgroups (the producer's may be gone).
template <int kCons>
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync %0, %1;\n" ::"r"(kConsumersBar), "r"(128 * kCons)
               : "memory");
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
// ring keeps two stages, so the CTA fits the 227 KB a block may use; every
// other head_dim (32, 64, 96, 128) keeps three. Head_dim 96 is 12 core
// matrices per row and O += P V runs wgmma.m64n96k16: no swizzle atom has
// to divide it.
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
  static_assert(2 * kStages * 8 <= kLastSlot && kLastSlot + 4 <= kQ,
                "mbarriers and the combine's flag overflow their slot");
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
// tiles). shard_rows, ns: the KV-shard axis (ns = 1: none); with ns > 1,
// partials (b, hkv, ns, c g, DK) fp32 scratch and tickets (b, hkv, row
// tiles) int32, zero before the launch and left zero after it.
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
  int shard_rows, ns;
  float* partials;
  int* tickets;
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

// The ring order of a CTA's tiles. One walk (n[1] = 0): its tile j at ring
// position j. Two walks (a paired CTA: two consumer warpgroups on two KV
// shards of the same rows): walk c's tile j; the two walks' tiles alternate
// while both have tiles (walk 0 at even positions), then the longer walk's
// rest follows in order.
struct TileSeq {
  int n[2];         // tiles of walk 0 and walk 1
  int begin[2];     // each walk's first KV row (a multiple of kWalkBN)
  int end[2];       // each walk's end: rows at or past it are zero-filled
  __device__ __forceinline__ int total() const { return n[0] + n[1]; }
  __device__ __forceinline__ int pos(int c, int j) const {
    const int m = min(n[0], n[1]);
    return j < m ? 2 * j + c : 2 * m + (j - m);
  }
  __device__ __forceinline__ void owner(int p, int* c, int* j) const {
    const int m = min(n[0], n[1]);
    if (p < 2 * m) {
      *c = p & 1;
      *j = p >> 1;
    } else {
      *c = n[0] > n[1] ? 0 : 1;
      *j = m + (p - 2 * m);
    }
  }
};

// bf16: step t waits for tile t's stage to be free, issues its copies and
// has the copy unit itself arrive on the stage's `full` barrier when they
// land (cp.async.mbarrier.arrive.noinc), so every stage of the ring can be
// in flight and the producer never waits for its own copies.
// int8 / fp8: step t issues tile t into its staging slot and publishes tile
// t - 1: waits for its own copies of it, dequantizes it into the stage's
// bf16 tile, fences and arrives. The consumer waits only for the tile it
// works on, so neither form waits on a stage the consumer still needs.
// Tiles are issued in ring order (TileSeq); a paired CTA's two consumers
// each wait only for their own walk's tiles, which they release in order.
template <int DK, int kCons, class TKV, class Rows>
__device__ __forceinline__ void walk_producer(const WalkArgs<TKV, Rows>& a,
                                              uint8_t* smem, int b, int h,
                                              const TileSeq& seq) {
  using Lay = WalkLayout<DK, TKV, kCons>;
  const int pt = threadIdx.x - 128 * kCons;
  constexpr int S = Lay::kStages;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + S;
  const int n_tiles = seq.total();
  auto issue = [&](int t) {
    int c, j;
    seq.owner(t, &c, &j);
    issue_tile<DK, kCons>(a, smem, pt, b, h, t, seq.begin[c] + j * kWalkBN,
                          seq.end[c]);
  };
  if constexpr (!Lay::kScaled) {
    for (int t = 0; t < n_tiles; ++t) {
      mbar_wait(&empty[t % S], ((t / S) & 1) ^ 1);
      issue(t);
      cp_async_arrive(&full[t % S]);
    }
  } else {
    for (int t = 0; t <= n_tiles; ++t) {
      if (t < n_tiles) {
        mbar_wait(&empty[t % S], ((t / S) & 1) ^ 1);
        issue(t);
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
// first row + 64 cw, or the CTA's rows when paired). It takes every tile of
// its walk (`walk` of seq: 0, or cw when paired) in order, and computes the
// ones its own rows can see: a tile no row of it can see would add exact
// zeros (softmax: alpha 1 and e 0), so it only releases it. With ns > 1 it
// stores its rows as shard `shard`'s fp32 partial, else as the bf16 output.
template <int DK, int kForm, int kCons, bool kPair, class TKV, class Rows>
__device__ __forceinline__ void walk_consumer(const WalkArgs<TKV, Rows>& a,
                                              uint8_t* smem, int cw, int b,
                                              int h, int r0, int idx, int kvl,
                                              const TileSeq& seq, int walk,
                                              int shard) {
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

  // the Q tile, once, every copy in flight at once (rows past the folded
  // chunk are zero-filled): a KV shard's CTA walks few tiles, so this
  // load's latency is paid by every shard
  for (int i = lt; i < kWalkRows * CH; i += 128) {
    const int rest = i >> 3, ch = rest % CH;
    const int r = (rest / CH) * 8 + (i & 7);
    const int row = r0 + r;
    const bool ok = row < rows_total;
    const int pos = ok ? row / g : 0, head = h * g + (ok ? row % g : 0);
    cp_async16(q_s + tile_off(r, ch, CH),
               a.q + ((static_cast<size_t>(b) * a.c + pos) * a.H + head) *
                         DK + ch * 8,
               ok);
  }
  cp_async_commit();
  cp_async_wait<0>();
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
  const int n_tiles = seq.n[walk];
  for (int jt = 0; jt < n_tiles; ++jt) {
    const int t = seq.pos(walk, jt);  // the tile's ring position
    const int s = t % S;
    const int j0 = seq.begin[walk] + jt * kWalkBN;
    const uint32_t k_addr = kv_addr + s * 2 * Lay::kTile;
    const uint32_t v_addr = k_addr + Lay::kTile;
    mbar_wait(&full[s], (t / S) & 1);
    if (kCons > 1 && !kPair &&
        (j0 >= live_end || j0 + kWalkBN <= live_begin)) {
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
  } else {
    if (a.ns > 1) {  // this shard's partial: rows (b, h, shard, r, :)
      float* part = a.partials + ((static_cast<size_t>(b) * a.hkv + h) *
                                      a.ns + shard) * rows_total * DK;
#pragma unroll
      for (int i = 0; i < NO; i += 2) {
        const int r = r0 + warp * 16 + gid + 8 * ((i >> 1) & 1);
        if (r < rows_total)
          *reinterpret_cast<float2*>(part + static_cast<size_t>(r) * DK +
                                     (i >> 2) * 8 + tig * 2) =
              make_float2(o[i], o[i + 1]);
      }
      return;
    }
  }
#pragma unroll
  for (int i = 0; i < NO; i += 2) {
    __nv_bfloat16* dst = orow[(i >> 1) & 1];
    if (dst)
      *reinterpret_cast<__nv_bfloat162*>(dst + (i >> 2) * 8 + tig * 2) =
          __floats2bfloat162_rn(o[i], o[i + 1]);
  }
}

// ------------------------------------------------------------- combine ----
// Output row r of (slot b, KV head h): folded row r is chunk position
// r / g, query head h g + r % g.
template <int DK, class TKV, class Rows>
__device__ __forceinline__ __nv_bfloat16* out_row(const WalkArgs<TKV, Rows>& a,
                                                  int b, int h, int r) {
  const int g = a.H / a.hkv;
  return a.out + ((static_cast<size_t>(b) * a.c + r / g) * a.H + h * g +
                  r % g) * DK;
}

// A row tile with no live shard: its rows are exact zeros (as an unsplit
// walk of no tile leaves them), written by all threads of its first CTA.
template <int DK, int kCtaRows, class TKV, class Rows>
__device__ __forceinline__ void zero_rows(const WalkArgs<TKV, Rows>& a,
                                          int b, int h, int r0) {
  const int rows_total = a.c * (a.H / a.hkv);
  for (int i = threadIdx.x; i < kCtaRows * DK / 8; i += blockDim.x) {
    const int r = r0 + i / (DK / 8);
    if (r < rows_total)
      *reinterpret_cast<uint4*>(out_row<DK>(a, b, h, r) + (i % (DK / 8)) * 8) =
          make_uint4(0, 0, 0, 0);
  }
}

// After the consumers stored their shards' partials (`mine` live shards of
// this CTA: 1, or 2 when paired): the CTA that brings the int32 ticket of
// (b, h, tile) to s1 - s0 (nr row tiles) holds the last live shards of the
// row tile to finish; it sums the live partials in shard order, s0 first,
// and writes the bf16 rows, and resets the ticket, so the buffer is zeros
// for the next launch. Consumer threads only; the CTA's rows are r0 ..
// r0 + kCtaRows - 1.
template <int DK, int kCons, int kCtaRows, class TKV, class Rows>
__device__ __forceinline__ void combine_shards(const WalkArgs<TKV, Rows>& a,
                                               uint8_t* smem, int b, int h,
                                               int tile, int nr, int r0,
                                               int s0, int s1, int mine) {
  constexpr int Q4 = DK / 4;  // float4 per row
  const int rows_total = a.c * (a.H / a.hkv);
  int* last = reinterpret_cast<int*>(smem + kLastSlot);
  __threadfence();  // this CTA's partial, visible to the last CTA
  consumers_sync<kCons>();
  if (threadIdx.x == 0) {
    int* ticket = a.tickets + (static_cast<size_t>(b) * a.hkv + h) * nr + tile;
    const int done = atomicAdd(ticket, mine) + mine == s1 - s0;
    if (done) *ticket = 0;
    *last = done;
  }
  consumers_sync<kCons>();
  if (!*last) return;
  __threadfence();
  const size_t shard_stride = static_cast<size_t>(rows_total) * Q4;
  const float4* p = reinterpret_cast<const float4*>(
      a.partials + (static_cast<size_t>(b) * a.hkv + h) * a.ns * rows_total *
                       DK);
#pragma unroll 2
  for (int i = threadIdx.x; i < kCtaRows * Q4; i += 128 * kCons) {
    const int r = r0 + i / Q4, d4 = i % Q4;
    if (r >= rows_total) continue;
    float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
    for (int sh = s0; sh < s1; ++sh) {  // loads in flight, adds in order
      const float4 x = __ldcg(p + sh * shard_stride + static_cast<size_t>(r) *
                                                          Q4 + d4);
      t.x += x.x;
      t.y += x.y;
      t.z += x.z;
      t.w += x.w;
    }
    __nv_bfloat162* o =
        reinterpret_cast<__nv_bfloat162*>(out_row<DK>(a, b, h, r) + 4 * d4);
    o[0] = __floats2bfloat162_rn(t.x, t.y);
    o[1] = __floats2bfloat162_rn(t.z, t.w);
  }
}

// --------------------------------------------------------------- kernel ----
// kCons consumer warpgroups share every K/V tile of the CTA; warpgroup kCons
// is the producer. Unpaired: 64 rows per consumer, one walk, blockIdx.x =
// row tile * ns + shard (a row tile's shards issued together, so the shards
// past a chunk's fill, which return at once, fall between live ones).
// Paired (kPair, the serving chunk at head_dim <= 128): two consumers on
// the same 64 rows, consumer c walking shard 2 p + c of the CTA's shard
// pair p, blockIdx.x = row tile * ceil(ns / 2) + p: two independent tile
// chains per SM, each giving the same partial as a CTA walking that shard
// alone. At ns = 1 consumer 1 has no walk and consumer 0 walks the whole
// row tile, as an unpaired CTA would, with the same bits.
template <int DK, int kForm, class TKV, class Rows, int kCons, bool kPair>
__global__ void __launch_bounds__(128 * (kCons + 1), 1)
    attn_walk_kernel(const __grid_constant__ WalkArgs<TKV, Rows> a) {
  using Lay = WalkLayout<DK, TKV, kCons>;
  constexpr int kCtaRows = kPair ? kWalkRows : kCons * kWalkRows;
  constexpr int kWalks = kPair ? 2 : 1;
  extern __shared__ __align__(128) uint8_t smem[];
  const int h = blockIdx.y, b = blockIdx.z;
  const int g = a.H / a.hkv;
  const int per_tile = kPair ? (a.ns + 1) / 2 : a.ns;  // CTAs per row tile
  const int nr = gridDim.x / per_tile;
  const int tile = blockIdx.x / per_tile;
  const int shard0 = (blockIdx.x % per_tile) * kWalks;
  const int r0 = (a.reverse ? nr - 1 - tile : tile) * kCtaRows;
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
  auto tiles = [](int lo, int hi) {
    return hi > lo ? (hi - lo + kWalkBN - 1) / kWalkBN : 0;
  };
  TileSeq seq{{tiles(kv_begin, kv_end), 0}, {kv_begin, 0}, {kv_end, 0}};
  // the live shards [s0, s1): those holding a tile of the walk, the same
  // run for every CTA of the row tile; each walk covers its shard's share
  int s0 = 0, s1 = 1, mine = 0;
  if constexpr (kForm != kFormSoftmax) {
    if (a.ns > 1) {
      s0 = kv_begin / a.shard_rows;
      s1 = kv_end > kv_begin ? (kv_end - 1) / a.shard_rows + 1 : s0;
      for (int c = 0; c < kWalks; ++c) {
        const int sh = shard0 + c;
        const bool live = sh >= s0 && sh < s1;
        const int lo = max(kv_begin, sh * a.shard_rows);
        const int hi = min(kv_end, (sh + 1) * a.shard_rows);
        seq.n[c] = live ? tiles(lo, hi) : 0;
        seq.begin[c] = lo;
        seq.end[c] = hi;
        mine += live;
      }
      if (!mine) {
        if (s1 <= s0 && shard0 == 0) zero_rows<DK, kCtaRows>(a, b, h, r0);
        return;
      }
    }
  }

  if (threadIdx.x == 0) {
    uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
    for (int s = 0; s < Lay::kStages; ++s) {
      mbar_init(&bars[s], 128);  // full: producer
      // empty: every consumer, or (paired) the one that owns the tile
      mbar_init(&bars[Lay::kStages + s], kPair ? 128 : 128 * kCons);
    }
    mbar_init_fence();
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;
  if (wg == kCons) {
    walk_producer<DK, kCons>(a, smem, b, h, seq);
    return;
  }
  const int walk = kPair ? wg : 0;
  // a paired consumer without a shard of its own has no rows to write,
  // except walk 0 unsplit, which writes its rows (zeros with no tile)
  if (!kPair || seq.n[walk] > 0 || (a.ns == 1 && walk == 0))
    walk_consumer<DK, kForm, kCons, kPair>(
        a, smem, wg, b, h, r0 + (kPair ? 0 : wg * kWalkRows), idx, kvl, seq,
        walk, shard0 + walk);
  if constexpr (kForm != kFormSoftmax) {
    if (a.ns > 1)
      combine_shards<DK, kCons, kCtaRows>(a, smem, b, h, tile, nr, r0, s0,
                                          s1, mine);
  }
}

template <int DK, int kForm, class TKV, class Rows, int kCons, bool kPair>
cudaError_t launch_grid(const WalkArgs<TKV, Rows>& a, int grid_x, int b,
                        cudaStream_t stream) {
  using Lay = WalkLayout<DK, TKV, kCons>;
  auto kernel = attn_walk_kernel<DK, kForm, TKV, Rows, kCons, kPair>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Lay::kBytes);
  if (attr != cudaSuccess) return attr;
  kernel<<<dim3(grid_x, a.hkv, b), 128 * (kCons + 1), Lay::kBytes, stream>>>(
      a);
  return cudaGetLastError();
}

// One launch: 128 (kCons + 1) threads, the layout's dynamic shared memory
// (the attribute is set once per instantiation). kWide: two consumer
// warpgroups per CTA at head_dim <= 128, so each K/V tile copied serves 128
// rows: for the full-sequence kernels, whose grids hold many waves of CTAs
// (the copies' traffic halves, and one warpgroup's epilogue overlaps the
// other's products); grid (ceil(c g / 128), hkv, b). A serving chunk keeps
// 64 rows per CTA: at head_dim <= 128 paired, grid (ceil(c g / 64) x
// ceil(ns / 2), hkv, b); at head_dim 256 (no registers for a second
// consumer) one shard per CTA, grid (ceil(c g / 64) x ns, hkv, b). The
// shard axis folds into grid.x (y and z stop at 65,535); a split needs a
// ConSmax form, whole-tile shards covering L, and its partials and
// tickets.
template <int DK, int kForm, bool kWide = false, class TKV, class Rows>
cudaError_t launch_walk(const WalkArgs<TKV, Rows>& a, int b,
                        cudaStream_t stream) {
  if (a.ns < 1 ||
      (a.ns > 1 && (kForm == kFormSoftmax || a.shard_rows <= 0 ||
                    a.shard_rows % kWalkBN || a.shard_rows * a.ns < a.L ||
                    !a.partials || !a.tickets)))
    return cudaErrorInvalidValue;
  const int g = a.H / a.hkv;
  constexpr int kCons = kWide && DK <= 128 ? 2 : 1;
  const int nr = (a.c * g + kCons * kWalkRows - 1) / (kCons * kWalkRows);
  if constexpr (!kWide && DK <= 128 && kForm != kFormSoftmax) {
    return launch_grid<DK, kForm, TKV, Rows, 2, true>(
        a, nr * ((a.ns + 1) / 2), b, stream);
  } else {
    return launch_grid<DK, kForm, TKV, Rows, kCons, false>(a, nr * a.ns, b,
                                                           stream);
  }
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
      case 96:
        return q ? WalkLayout<96, int8_t, 2>::kBytes
                 : WalkLayout<96, __nv_bfloat16, 2>::kBytes;
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
    case 96:
      return q ? WalkLayout<96, int8_t>::kBytes
               : WalkLayout<96, __nv_bfloat16>::kBytes;
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
