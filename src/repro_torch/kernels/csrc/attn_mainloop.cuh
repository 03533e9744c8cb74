// The Hopper attention mainloop shared by the query-tiled attention kernels:
// consmax_prefill (contiguous cache and page pool; bf16, int8 or fp8_e4m3
// K/V), consmax_attn and softmax_attn. A consumer warpgroup owns 64 folded
// query rows (wgmma's M) of one KV head and walks the KV tiles those rows
// can see, in order, through a ring of kStages shared-memory stages; at
// head_dim <= 128 a CTA puts two consumers (128 rows) on each tile it
// copies, at 256 one:
//
//   the last warpgroup (producer, 128 threads): step t waits for stage t's
//     `empty` mbarrier and issues cp.async 16-byte copies of tile t's K and
//     V rows (one row address per row: contiguous, or through the page
//     table; rows past the walk's end or on an unmapped page are
//     zero-filled by the copy itself and never read); the copy unit arrives
//     on the stage's `full` mbarrier when they land, so every stage can be
//     in flight. An int8 / fp8 cache is copied the same way into a staging
//     slot of codes and fp32 row scales, and one step later the producer
//     waits for them and dequantizes them into the stage's bf16 operand
//     tile through consmax_common.cuh `dequant`, unchanged: a quantized
//     tile holds exactly the bf16 values of the dequantized cache, so
//     everything downstream gives the same bits.
//   each other warpgroup (consumer, 128 threads): loads its Q tile into
//     shared memory once, then per tile waits for `full`, computes
//     S = Q K^T with wgmma.m64n64k16 (A and B from shared memory, both
//     K-major, k-steps in order), applies the mask and the per-score
//     epilogue on the accumulator in registers, rounds P to bf16 in
//     registers (the TPU kernels' p.astype(v.dtype)), adds O += P V with
//     wgmma.m64nDKk16 (A = P from registers, B = the V tile, MN-major), and
//     arrives on `empty`. At head_dim <= 128 the step is overlapped
//     (FlashAttention-3's order): tile j's S is issued before tile j - 1's
//     P V, and tile j's epilogue runs while that P V does. So a consumer
//     holds tile j - 1 while it waits for tile j, and the producer
//     publishes tile j without waiting for tile j - 1's stage. At 256 the
//     step stays serial: O's 128 registers leave no room for a score tile
//     beside an O in flight (255 registers, slower).
//   registers: with two consumers, setmaxnreg moves them from the producer
//     (kProducerRegs) to the consumers (kConsumerRegs).
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
// (a multiple of kWalkBN, so a shard is whole tiles), and each CTA walks
// one (row tile, shard) pair, clamped to its shard after the fill / causal
// / window bounds; its fp32 accumulator is the shard's partial. Every CTA
// of a (slot, KV head, row tile) derives the same live run [s0, s1) from
// index, lengths, causality and the window; a CTA whose shard is not in it
// returns before the ring starts, and the one holding the last live shard
// to finish, found by an int32 ticket (atomicAdd; no fp32 atomics), sums
// the partials in shard order, whichever CTA it is, writes the bf16 rows
// and resets the ticket. A row tile with no live shard gets zeros from its
// shard-0 CTA. ns = 1 is the unsplit walk: no partials, no ticket, the same
// bits as a launch without the axis. ConSmax weights need no running max,
// so a shard's partial is just its share of the sum; softmax's (m, l) would
// need a rescale, so the softmax form keeps ns = 1.
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
// compute the same values.
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
// Registers per thread of each role with two consumer warpgroups (setmaxnreg;
// 384 threads start at 168, 64,512 in all): the producer only issues
// copies and dequantizes, the consumers hold O, S and P
constexpr int kProducerRegs = 64;
constexpr int kConsumerRegs = 216;
static_assert(kProducerRegs * 128 + kConsumerRegs * 256 <= 168 * 384,
              "the roles' registers exceed the CTA's");

// --------------------------------------------------------- tile clock ----
// Built only by tools/tile_clock.py (nvcc -DATTN_TILE_CLOCK), never by the
// kernels' own build: thread 0 of each consumer warpgroup stamps clock64()
// at the points of every tile step (kClock*) and of its walk (kWalk*, in
// the slot after the last tile) into g_tile_clock, laid out [CTA][consumer
// warpgroup][tile 0 .. cap, walk][point]. Tiles past cap are not stamped.
#ifdef ATTN_TILE_CLOCK
__device__ long long* g_tile_clock;
__device__ int g_tile_clock_cap;
enum {
  kClockFullWait, kClockFullDone, kClockSIssued, kClockSDone, kClockEpiDone,
  kClockPVIssued, kClockPVDone, kClockReleased, kClockPoints
};
enum { kWalkEntry, kWalkLoopStart, kWalkLoopEnd, kWalkStored, kWalkEnd };
// One consumer warpgroup's stamps, the globals read once: p is null on
// every other thread and when the stamps are off.
struct TileClock {
  long long* p = nullptr;
  int cap = 0;
  __device__ __forceinline__ TileClock(int cw, bool consumer) {
    if (!consumer || threadIdx.x % 128 || !g_tile_clock) return;
    cap = g_tile_clock_cap;
    const size_t cta =
        blockIdx.x + gridDim.x * (blockIdx.y + size_t{gridDim.y} * blockIdx.z);
    p = g_tile_clock + (cta * 2 + cw) * (cap + 1) * kClockPoints;
  }
  __device__ __forceinline__ void stamp(int jt, int point) const {
    if (p && jt <= cap) p[jt * kClockPoints + point] = clock64();
  }
};
#define CLOCK_INIT(cw, consumer) const TileClock tile_clock_(cw, consumer)
#define TILE_CLOCK(jt, point) tile_clock_.stamp(jt, point)
#define WALK_CLOCK(point) tile_clock_.stamp(tile_clock_.cap, point)
#else
#define CLOCK_INIT(cw, consumer) ((void)0)
#define TILE_CLOCK(jt, point) ((void)0)
#define WALK_CLOCK(point) ((void)0)
#endif

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

// Move this warpgroup's registers per thread down (the producer) or up
// (the consumers) to n; the CTA's total stays what the launch gave it.
template <int n>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(n));
}
template <int n>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(n));
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
// logical row r of cache slot rows_of.cache_row(b) given by rows_of;
// k_scale, v_scale: rows of hkv
// fp32 (null for bf16). index, lengths: (b,) int32 — the chunk sits at
// cache positions index + [0, c) and the slot's keys end at index +
// lengths; null for a whole sequence (index 0, keys end at L). beta, gamma
// (H,) fp32 (unused by softmax). fill_bound walks only the tiles the CTA's
// rows can see (a skipped tile would add exact zeros); reverse issues the
// CTAs of the last rows first (under causal masking they see the most
// tiles). shard_rows, ns: the KV-shard axis (ns = 1: none); with ns > 1,
// partials (b, hkv, ns, c g, DK) fp32 scratch and tickets (b, hkv, row
// tiles) int32, zero before the launch and left zero after it. launches:
// the wrapper's launch counter (count_launch; null: not counted).
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
  unsigned long long* launches;
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

// A CTA's walk: KV head h of slot b over one row tile (rows r0 ..), its
// tiles n from KV row begin (a multiple of kWalkBN), rows at or past end
// zero-filled. With ns > 1: the row tile's live shards [s0, s1) and the
// CTA's shard, or, for a row tile with no live shard, zero.
struct CtaWalk {
  int b, kvb, h, tile, r0, idx, kvl;  // kvb: the cache row b reads
  int s0, s1, shard;
  bool zero;
  int n, begin, end;
};

// bf16: step t waits for tile t's stage to be free, issues its copies and
// has the copy unit itself arrive on the stage's `full` barrier when they
// land (cp.async.mbarrier.arrive.noinc), so every stage of the ring can be
// in flight and the producer never waits for its own copies.
// int8 / fp8: step t issues tile t into its staging slot and publishes tile
// t - 1: waits for its own copies of it, then for its operand stage to be
// free, dequantizes it into the stage's bf16 tile, fences and arrives.
// Publishing tile t - 1 waits only for tile t - 1 - S's release, never for
// a later tile's stage, so the codes run a tile further ahead, and a
// consumer that holds tile j - 1 while it waits for tile j (the overlapped
// step) is never waited for.
template <int DK, int kCons, class TKV, class Rows>
__device__ __forceinline__ void walk_producer(const WalkArgs<TKV, Rows>& a,
                                              uint8_t* smem,
                                              const CtaWalk& it) {
  using Lay = WalkLayout<DK, TKV, kCons>;
  const int pt = threadIdx.x - 128 * kCons;
  constexpr int S = Lay::kStages;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + S;
  const int n_tiles = it.n;
  auto issue = [&](int t) {
    issue_tile<DK, kCons>(a, smem, pt, it.kvb, it.h, t,
                          it.begin + t * kWalkBN, it.end);
  };
  if constexpr (!Lay::kScaled) {
    for (int t = 0; t < n_tiles; ++t) {
      mbar_wait(&empty[t % S], ((t / S) & 1) ^ 1);
      issue(t);
      cp_async_arrive(&full[t % S]);
    }
  } else {
    for (int t = 0; t <= n_tiles; ++t) {
      // tile t's codes into staging slot t % S, which held tile t - S,
      // dequantized by step t - S + 1 <= t - 1 (S >= 2): no wait
      if (t < n_tiles) {
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
      // tile t - 1's operand stage: free once tile t - 1 - S is released
      mbar_wait(&empty[(t - 1) % S], (((t - 1) / S) & 1) ^ 1);
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
// add exact zeros (softmax: alpha 1 and e 0), so it only releases it. With
// ns > 1 it stores its rows as the CTA's shard's fp32 partial, else as the
// bf16 output.
template <int DK, int kForm, int kCons, class TKV, class Rows>
__device__ __forceinline__ void walk_consumer(const WalkArgs<TKV, Rows>& a,
                                              uint8_t* smem, int cw,
                                              const CtaWalk& it) {
  const int b = it.b, h = it.h, idx = it.idx, kvl = it.kvl;
  const int r0 = it.r0 + cw * kWalkRows;
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
  CLOCK_INIT(cw, true);

  // the Q tile, once, every copy in flight at once (rows past the folded
  // chunk are zero-filled): a KV shard's CTA walks few tiles, so this
  // load's latency is paid by every shard; the rows' weights are read
  // while it lands
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

  cp_async_wait<0>();  // the Q tile landed, visible to the tensor cores
  fence_proxy_async();
  warpgroup_sync(1 + cw);
  const uint32_t q_addr = smem_u32(q_s);
  const uint32_t kv_addr = smem_u32(smem + Lay::kKV);
  const int n_tiles = it.n;
  // the tiles this warpgroup computes, [lo, hi): with two consumers on one
  // tile the tiles before its rows' window and past their reach are dead
  // for it, a prefix and a suffix of the walk
  int lo = 0, hi = n_tiles;
  if constexpr (kCons > 1) {
    while (lo < hi && it.begin + (lo + 1) * kWalkBN <= live_begin) ++lo;
    while (hi > lo && it.begin + (hi - 1) * kWalkBN >= live_end) --hi;
  }
  auto stage = [&](int jt) { return jt % S; };
  auto wait_full = [&](int jt) {
    TILE_CLOCK(jt, kClockFullWait);
    mbar_wait(&full[jt % S], (jt / S) & 1);
    TILE_CLOCK(jt, kClockFullDone);
  };
  WALK_CLOCK(kWalkLoopStart);
  for (int jt = 0; jt < lo; ++jt) {  // dead tiles: released as they land
    wait_full(jt);
    mbar_arrive(&empty[stage(jt)]);
  }

  float sc[NS];                    // S of one tile, then its weights
  uint32_t pa[kWalkBN / 16][4];    // P as bf16 A fragments
  float alpha[2] = {1.f, 1.f};     // softmax: the rescale of O
  // S = Q K^T of tile jt into sc once its stage has landed, k-steps of 16
  // columns in order; committed as one group, not waited for
  auto issue_s = [&](int jt) {
    wait_full(jt);
    fence_proxy_async();  // the landed copies, visible to the tensor cores
    const uint32_t k_addr = kv_addr + stage(jt) * 2 * Lay::kTile;
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
    TILE_CLOCK(jt, kClockSIssued);
  };
  // O += P V of tile jt (P in pa), k-steps of 16 KV rows in order; one group
  auto issue_pv = [&](int jt) {
    const uint32_t v_addr =
        kv_addr + stage(jt) * 2 * Lay::kTile + Lay::kTile;
    fence_regs<NO>(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kWalkBN / 16; ++kk) {
      Wgmma<DK>::rs(o, pa[kk],
                    smem_desc(v_addr + kk * 2 * DK * 16, DK * 16, 128), 1);
    }
    wgmma_commit();
    TILE_CLOCK(jt, kClockPVIssued);
  };
  // after P V of tile jt has landed: its stage goes back to the producer
  auto release = [&](int jt) {
    fence_regs<NO>(o);
    TILE_CLOCK(jt, kClockPVDone);
    mbar_arrive(&empty[stage(jt)]);
    TILE_CLOCK(jt, kClockReleased);
  };
  // the per-score epilogue of tile jt on sc, in place (O untouched: it may
  // be in flight): register i is row (i >> 1) & 1 of this thread's two,
  // key j0 + 8 (i >> 2) + 2 tig + (i & 1); x = the score times log2 e
  // (softcapped first where asked). Softmax also moves m and l on and
  // leaves O's rescale in alpha.
  auto epilogue = [&](int jt) {
    const int j0 = it.begin + jt * kWalkBN;
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
#ifdef ATTN_TILE_CLOCK
    fence_regs<NS>(sc);
#endif
    TILE_CLOCK(jt, kClockEpiDone);
  };
  // once O is not in flight: softmax's rescale, then P as bf16 A fragments
  // (k-step kk holds score columns 16 kk .. 16 kk + 15)
  auto rescale_pack = [&]() {
    if constexpr (kForm == kFormSoftmax) {
#pragma unroll
      for (int i = 0; i < NO; ++i) o[i] *= alpha[(i >> 1) & 1];
    }
#pragma unroll
    for (int kk = 0; kk < kWalkBN / 16; ++kk) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        pa[kk][e] = pack_bf16(sc[8 * kk + 2 * e], sc[8 * kk + 2 * e + 1]);
    }
  };

  // The tile step. Overlapped (head_dim <= 128): tile jt's S is issued
  // before tile jt - 1's P V, so the tensor cores run S_jt then P_{jt-1}
  // V_{jt-1} back to back, and the epilogue of tile jt runs while P_{jt-1}
  // V_{jt-1} does. One score tile and one P in registers (P of jt - 1 is
  // packed before S_jt is issued into sc). The sums keep their order: O =
  // alpha_jt (O + P_{jt-1} V_{jt-1}) + P_jt V_jt, as the serial step adds
  // them. While it waits for tile jt's stage the warpgroup holds tile jt -
  // 1's, which the producer never waits for before publishing tile jt.
  // Serial (head_dim 256, where O takes 128 registers): P V of tile jt - 1
  // lands and its stage is released before tile jt's S is issued.
  constexpr bool kOverlap = DK <= 128;
  for (int jt = lo; jt < hi; ++jt) {
    if (!kOverlap && jt > lo) {
      issue_pv(jt - 1);
      wgmma_wait<0>();
      release(jt - 1);
    }
    issue_s(jt);
    if (kOverlap && jt > lo) {
      issue_pv(jt - 1);
      wgmma_wait<1>();  // S of tile jt landed; P V of jt - 1 runs on
    } else {
      wgmma_wait<0>();
    }
    fence_regs<NS>(sc);
    TILE_CLOCK(jt, kClockSDone);
    epilogue(jt);
    // O not in flight past here on any path (softmax rescales it next; a
    // wait under the release's condition would leave ptxas a path that
    // writes O while its product runs, and it would serialize the wgmmas)
    wgmma_wait<0>();
    fence_regs<NO>(o);
    if (kOverlap && jt > lo) release(jt - 1);
    rescale_pack();
  }
  if (lo < hi) {
    issue_pv(hi - 1);
    wgmma_wait<0>();
    release(hi - 1);
  }
  for (int jt = hi; jt < n_tiles; ++jt) {  // dead tiles past the reach
    wait_full(jt);
    mbar_arrive(&empty[stage(jt)]);
  }
  WALK_CLOCK(kWalkLoopEnd);

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
                                      a.ns + it.shard) * rows_total * DK;
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
// walk of no tile leaves them), written by all threads of its shard-0 CTA.
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

// After the consumers stored their shard's partial: the CTA that brings
// the int32 ticket of (b, h, tile) to s1 - s0 (nr row tiles) holds the last
// live shard of the row tile to finish; it sums the live partials in shard
// order, s0 first, and writes the bf16 rows, and resets the ticket, so the
// buffer is zeros for the next launch. Consumer threads only; the CTA's
// rows are r0 .. r0 + kCtaRows - 1.
template <int DK, int kCons, int kCtaRows, class TKV, class Rows>
__device__ __forceinline__ void combine_shards(const WalkArgs<TKV, Rows>& a,
                                               uint8_t* smem, int b, int h,
                                               int tile, int nr, int r0,
                                               int s0, int s1) {
  constexpr int Q4 = DK / 4;  // float4 per row
  const int rows_total = a.c * (a.H / a.hkv);
  int* last = reinterpret_cast<int*>(smem + kLastSlot);
  __threadfence();  // this CTA's partial, visible to the last CTA
  consumers_sync<kCons>();
  if (threadIdx.x == 0) {
    int* ticket = a.tickets + (static_cast<size_t>(b) * a.hkv + h) * nr + tile;
    const int done = atomicAdd(ticket, 1) + 1 == s1 - s0;
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

// --------------------------------------------------------------- walks ----
__device__ __forceinline__ int tiles_of(int lo, int hi) {
  return hi > lo ? (hi - lo + kWalkBN - 1) / kWalkBN : 0;
}

// The KV rows [lo, hi) that the `rows` rows from r0 of a chunk at index idx
// (keys end at kvl) can see, lo on a tile boundary (empty when they see
// none: a window past the fill); never past the cache's last row, even if
// index + lengths runs over it.
template <class TKV, class Rows>
__device__ __forceinline__ void walk_span(const WalkArgs<TKV, Rows>& a,
                                          int rows, int r0, int idx, int kvl,
                                          int* lo, int* hi) {
  const int g = a.H / a.hkv;
  int kv_begin = 0, kv_end = a.L;
  if (a.fill_bound) {
    const int pos_lo = r0 / g;
    const int pos_hi = min(a.c - 1, (r0 + rows - 1) / g);
    kv_end = min(a.L, kvl);
    if (a.causal) kv_end = min(kv_end, idx + pos_hi + 1);
    if (a.window > 0) kv_begin = max(0, idx + pos_lo - a.window + 1);
  }
  *lo = (kv_begin / kWalkBN) * kWalkBN;
  *hi = kv_end > kv_begin ? kv_end : *lo;
}

// The live shards [s0, s1) of a row tile's span: those holding a tile of
// it, the same run for every CTA of the row tile.
__device__ __forceinline__ void live_run(int lo, int hi, int shard_rows,
                                         int* s0, int* s1) {
  *s0 = lo / shard_rows;
  *s1 = hi > lo ? (hi - 1) / shard_rows + 1 : *s0;
}

// The walk of CTA (x, y, z): row tile x / ns, its shard x mod ns (the
// whole span unsplit), KV head y, slot z; live: the shard holds a tile of
// the row tile's span, or it is shard 0 of a row tile with no live shard
// (whose rows it zeroes).
template <int kCtaRows, class TKV, class Rows>
__device__ __forceinline__ bool cta_walk(const WalkArgs<TKV, Rows>& a,
                                         CtaWalk* it) {
  it->b = blockIdx.z;
  it->kvb = a.rows_of.cache_row(it->b);
  it->h = blockIdx.y;
  it->tile = blockIdx.x / a.ns;
  it->shard = blockIdx.x % a.ns;
  it->idx = a.index ? a.index[it->b] : 0;
  it->kvl = a.index ? it->idx + a.lengths[it->b] : a.L;
  const int nr = gridDim.x / a.ns;
  it->r0 = (a.reverse ? nr - 1 - it->tile : it->tile) * kCtaRows;
  int lo, hi;
  walk_span(a, kCtaRows, it->r0, it->idx, it->kvl, &lo, &hi);
  it->s0 = 0;
  it->s1 = 1;
  it->zero = false;
  if (a.ns > 1) {
    live_run(lo, hi, a.shard_rows, &it->s0, &it->s1);
    it->zero = it->s1 <= it->s0;
    lo = max(lo, it->shard * a.shard_rows);
    hi = it->zero ? lo : min(hi, (it->shard + 1) * a.shard_rows);
  }
  it->n = tiles_of(lo, hi);
  it->begin = lo;
  it->end = hi;
  return a.ns == 1 ||
         (it->zero ? it->shard == 0
                   : it->shard >= it->s0 && it->shard < it->s1);
}

// --------------------------------------------------------------- kernel ----
// kCons consumer warpgroups (two at head_dim <= 128) share every K/V tile
// of the CTA, 64 rows each; warpgroup kCons is the producer. Grid (row
// tiles x ns, hkv, b): a row tile's shards launch together, so the CTAs of
// shards past a chunk's fill, which return at once, fall between live
// ones.
template <int DK, int kForm, class TKV, class Rows, int kCons>
__global__ void __launch_bounds__(128 * (kCons + 1), 1)
    attn_walk_kernel(const __grid_constant__ WalkArgs<TKV, Rows> a) {
  using Lay = WalkLayout<DK, TKV, kCons>;
  constexpr int kCtaRows = kCons * kWalkRows;
  extern __shared__ __align__(128) uint8_t smem[];
  CLOCK_INIT(threadIdx.x / 128, threadIdx.x < 128 * kCons);
  WALK_CLOCK(kWalkEntry);
  count_launch(a.launches);
  CtaWalk it;
  if (!cta_walk<kCtaRows>(a, &it)) return;
  if (it.zero) {
    zero_rows<DK, kCtaRows>(a, it.b, it.h, it.r0);
    return;
  }
  if (threadIdx.x == 0) {
    uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
    for (int s = 0; s < Lay::kStages; ++s) {
      mbar_init(&bars[s], 128);                         // full: producer
      mbar_init(&bars[Lay::kStages + s], 128 * kCons);  // empty: consumers
    }
    mbar_init_fence();
  }
  __syncthreads();
  // the warpgroup, uniform per warp, so each role's setmaxnreg is one branch
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == kCons) {
    if constexpr (kCons > 1) regs_dec<kProducerRegs>();
    walk_producer<DK, kCons>(a, smem, it);
    return;
  }
  if constexpr (kCons > 1) regs_inc<kConsumerRegs>();
  walk_consumer<DK, kForm, kCons>(a, smem, wg, it);
  WALK_CLOCK(kWalkStored);
  if constexpr (kForm != kFormSoftmax) {
    if (a.ns > 1)
      combine_shards<DK, kCons, kCtaRows>(a, smem, it.b, it.h, it.tile,
                                          gridDim.x / a.ns, it.r0, it.s0,
                                          it.s1);
  }
  WALK_CLOCK(kWalkEnd);
}

// One launch: 128 (kCons + 1) threads, the layout's dynamic shared memory
// (the attribute is set once per instantiation). Two consumer warpgroups
// per CTA at head_dim <= 128, so each K/V tile copied serves 128 rows (the
// copies' traffic halves, and one warpgroup's epilogue overlaps the
// other's products); one at head_dim 256 (the registers of two O tiles and
// the shared memory of two Q tiles are not there). Grid (ceil(c g / 64
// kCons) x ns, hkv, b); the shard axis folds into grid.x (y and z stop at
// 65,535). A split needs a ConSmax form, whole-tile shards covering L, and
// its partials and tickets.
template <int DK, int kForm, class TKV, class Rows>
cudaError_t launch_walk(const WalkArgs<TKV, Rows>& a, int b,
                        cudaStream_t stream) {
  if (a.ns < 1 ||
      (a.ns > 1 && (kForm == kFormSoftmax || a.shard_rows <= 0 ||
                    a.shard_rows % kWalkBN || a.shard_rows * a.ns < a.L ||
                    !a.partials || !a.tickets)))
    return cudaErrorInvalidValue;
  constexpr int kCons = DK <= 128 ? 2 : 1;
  using Lay = WalkLayout<DK, TKV, kCons>;
  auto kernel = attn_walk_kernel<DK, kForm, TKV, Rows, kCons>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Lay::kBytes);
  if (attr != cudaSuccess) return attr;
  const int nr =
      (a.c * (a.H / a.hkv) + kCons * kWalkRows - 1) / (kCons * kWalkRows);
  kernel<<<dim3(nr * a.ns, a.hkv, b), 128 * (kCons + 1), Lay::kBytes,
           stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

#ifdef ATTN_TILE_CLOCK
// Where the stamps go (int64 device buffer, zeroed by the caller) and how
// many tiles of a walk are stamped; null turns the stamps off.
extern "C" int attn_tile_clock(void* buf, int cap) {
  cudaError_t e = cudaMemcpyToSymbol(g_tile_clock, &buf, sizeof(buf));
  if (e == cudaSuccess)
    e = cudaMemcpyToSymbol(g_tile_clock_cap, &cap, sizeof(cap));
  return static_cast<int>(e);
}
#endif

// Registers per thread that a walk with `consumers` consumer warpgroups
// gives its producer (producer = 1) or each consumer through setmaxnreg; 0:
// none is set (one consumer: every thread keeps what ptxas gave it).
extern "C" int attn_walk_role_regs(int consumers, int producer) {
  if (consumers != 2) return 0;
  return producer ? kProducerRegs : kConsumerRegs;
}

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
