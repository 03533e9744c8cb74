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
// (ContigRows / PagedRows in consmax_common.cuh, looked up through
// ShardRows below), so the paged kernel walks the same decode_kv_block
// shards and the same tiles as the contiguous one, not the TPU's per-page
// grid, and gives its bits when the pages hold the same rows. The cache
// holds bf16, or int8 / fp8_e4m3 codes with one fp32 scale per (row, KV
// head) in (b, L, hkv) / (P, ps, hkv) scale tensors addressed by the same
// row index:
//   s = q . k * scale;  s = softcap * tanh(s / softcap) (optional)
//   p = C * exp(s), C = exp(-beta) / gamma (merged)  |  exp(s - beta) / gamma
//   p = 0 where kv_mask(n - 1, kpos, n, window) is false or no row backs
//     kpos (an unmapped page)  (n = index + 1, or index + active when paged)
//   o = sum_j bf16(p_j) v_j   (p rounded to the cache's compute dtype, as
//     the TPU kernel's p.astype(v.dtype))
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16): decode reads every
// live K and V row once and does 4 flops per row element per query head,
// i.e. ~g flops per byte, far below the ~295 flops/byte ridge, so it is
// bound by bytes: 2 * dk bytes per row, KV head and tensor at bf16, dk + 4
// (codes and the scale) at int8 / fp8, 0.516x at dk 128. At the timed shape
// (qwen2-1.5b: b 8, L 8192, fills 1 .. 8192 = 24,993 rows, hkv 2, g 6,
// dk 128, bk 256) that is 25.6 MB ~ 7.65 us at bf16 and 3.95 us at int8.
//
// Design against that bound: one CTA of 8 warps per (shard of bk rows, KV
// head, slot), walking its shard in tiles of kRows = 64 logical rows.
// * Bytes in flight. All 256 threads copy a tile's K and V rows together
//   as 16-byte cp.async.cg copies, four threads per row (a quantized row's
//   two fp32 scales as 4-byte copies beside its codes), into a ring of
//   shared-memory stages; cp.async.mbarrier.arrive.noinc has the copy unit
//   arrive on the stage's `full` mbarrier when they land (async_copy.cuh,
//   shared with the prefill mainloop). bf16 at dk 128 keeps 3 stages of
//   32 KB: while tile t is computed, tiles t + 1 and t + 2 are requested,
//   64 KB per CTA; int8 / fp8 keep 4 stages of 16.5 KB, tiles t + 1 .. t + 4
//   requested once tile t is dequantized. At the timed shape 200 of the 512
//   CTAs are live (100 live shards x 2 KV heads), at most two per SM, so an
//   SM with a live CTA has 64-128 KB requested, against the ~18 KB that
//   Little's law asks at 3.35 TB/s and ~0.7 us of latency.
// * One pass per tile, on the tensor cores. The g heads of the GQA group
//   (up to 16: chatglm3's g) are the 16 rows of mma.sync.m16n8k16's A, so
//   each warp scores 8 keys of the tile as S = Q K^T (K from shared memory
//   by ldmatrix; even and odd k-steps in two accumulators, each in order,
//   then added), with no shuffle at all. The epilogue forces masked, past-
//   the-fill and unmapped keys to exact 0, rounds the weights to bf16 (the
//   TPU kernel's p.astype(v.dtype)) and stores them to a double-buffered
//   shared P tile; after one __syncthreads each warp adds its own 16-row
//   slices of O^T += V^T P^T over the tile's 64 keys (V by ldmatrix.trans,
//   P by ldmatrix) into fp32 accumulators no other warp touches. Tensor
//   cores rather than CUDA cores: the FMA form would need ~g * dk * 2
//   instructions' worth of lanes per row, where the mma form issues a few
//   dozen instructions per warp per tile. Why 64 rows and 8 warps: a tile's
//   steps (wait, scores, weights, barrier, copies, p.V) run one after
//   another, so their latency, not the bytes, set the pace of 32-row tiles
//   on 4 warps; 64 rows put twice the rows under one chain, and three
//   64-row stages still fit two CTAs in an SM's 228 KB.
// * Quantized tiles. The codes and scales land in the stage; all threads
//   dequantize them from shared memory into one bf16 K/V tile pair through
//   consmax_common.cuh dequant16 (its ALU route: the exact dequant values,
//   off the quarter-rate conversion unit), and the rest of the pass is the
//   bf16 kernel's, so a quantized cache gives the bits of the bf16 kernel on
//   its dequantized values while moving 0.516x the bytes.
// * Rows never read. A row past the fill, behind the window or on an
//   unmapped (-1) page is zero-filled by its copy (zero source size): never
//   read, and every row of every stage is written for every tile, so no
//   stale stage is ever read (0 * NaN is NaN). Its weight is forced to 0.
// * Paged addressing once per page. A paged CTA reads its shard's table
//   entries once, one per page its visible rows touch, into shared memory
//   (ShardRows); each row's copies take its page from there, so no row
//   waits on a dependent table load. Tiles and shards stay aligned to
//   logical rows, so paged == contiguous bits for every page size, and a
//   tile may span any number of pages.
// * Split-KV with a fixed-order combine, in one launch. The grid is
//   (ceil(L / bk), hkv, b), a function of shapes alone; a CTA reads its
//   slot's length on the device and returns at once when its shard is past
//   the fill or behind the window (live_shards), so the launch needs no host
//   sync and replays in a CUDA graph. A live shard walks only the tiles that
//   hold visible rows and writes a (g, dk) fp32 partial (zeros when none is
//   visible: the combine stays table-free). The last live shard of a
//   (slot, KV head) to finish, found by an integer ticket (atomicAdd on
//   int32; no fp32 atomics), sums the partials in shard order, whichever
//   CTA it is, writes the output and resets the ticket; a slot with no
//   live shard (a free slot, n = 0) gets zeros from its shard-0 CTA. Every
//   sum has one fixed order, so every run gives the same bits.
// * The form (Eq. 2 or 3) is a template parameter, and each head's merged
//   constant C is computed once per head group (consmax_c), not per score.
// * Shared memory (DecodeLayout): mbarriers, two P tiles, the ring, for
//   codes one dequantized bf16 tile pair, and for a paged cache the shard's
//   page entries (bk + 1 ints at most). Rows are padded by 16 bytes so the
//   8 rows of an ldmatrix fall in distinct banks. bf16 at dk 128: 109,184 B
//   (+ 1,028 paged at bk 256); the attribute is set once per instantiation,
//   to the size at kMaxBlock, and the wrapper checks each launch's bytes
//   (consmax_decode_smem_bytes) before it launches.
// What it still leaves (times in PERF.md): each CTA's tile steps still run
// one after another, so the kernel moves its bytes at about half the card's
// rate; int8 / fp8 are held by the dequant pass that every warp waits for,
// not by their bytes; a producer warp issuing the copies (as the prefill
// mainloop's producer warpgroup does) would take both off the chain. Dead
// shards still take a launch slot each, and the last CTA's sum is a short
// serial tail.
#include <type_traits>

#include "async_copy.cuh"
#include "consmax_common.cuh"

// Internal linkage: a function-local static of a template with external
// linkage (the shared-memory attribute set once per instantiation) would be
// one object across every library loaded in the process (see
// attn_mainloop.cuh).
namespace {

constexpr int kThreads = 256;     // 8 warps
constexpr int kRows = 64;         // KV rows per tile: 8 keys per warp
constexpr int kHeads = 16;        // query heads per walk: the M of mma.m16n8k16
constexpr int kMaxBlock = 512;    // the largest bk (ops.MAX_BLOCK)

// Dynamic shared memory of one CTA; byte offsets.
template <int DK, class TKV, bool kPaged>
struct DecodeLayout {
  static constexpr bool kScaled = KVType<TKV>::kScaled;
  static constexpr int kRowB = 2 * DK + 16;        // a bf16 operand row
  static constexpr int kTileB = kRows * kRowB;     // one K or V operand tile
  static constexpr int kStageB =
      kScaled ? 2 * kRows * DK + 2 * kRows * 4 : 2 * kTileB;
  // 3-8 stages: two CTAs per SM at dk <= 128 (each CTA <= 113 KB; at dk 96
  // 4 bf16 stages of 26 KB or 6 of codes, 111 / 108 KB), one at 256
  static constexpr int stages() {
    if (DK == 256) return 3;
    if (DK == 128) return kScaled ? 4 : 3;
    if (DK == 96) return kScaled ? 6 : 4;
    if (DK == 64) return kScaled ? 8 : 5;
    return 8;
  }
  static constexpr int kStages = stages();
  static constexpr int kPRowB = kRows * 2 + 16;    // one head's weights
  static constexpr int kP = 128;                   // after the mbarriers
  static constexpr int kRing = kP + 2 * kHeads * kPRowB;
  static constexpr int kDequant = kRing + kStages * kStageB;
  static constexpr int kPages = kDequant + (kScaled ? 2 * kTileB : 0);
  static_assert(kStages * 8 <= kP, "mbarriers overflow their slot");
  __host__ __device__ static constexpr int bytes(int bk) {
    return kPages + (kPaged ? (bk + 1) * 4 : 0);
  }
  static_assert(bytes(kMaxBlock) <= 232448,
                "more than a block's shared memory");
};

// The row addresses of a shard's visible rows [lo, hi): contiguous rows are
// computed; a paged shard's table entries, one per page those rows touch,
// are read once per CTA into shared memory (the caller synchronizes before
// the first row()), and row() takes the page from there.
template <class Rows> struct ShardRows;
template <> struct ShardRows<ContigRows> {
  size_t base;
  __device__ ShardRows(const ContigRows& r, int b, int, int, int*)
      : base(static_cast<size_t>(b) * r.L) {}
  __device__ __forceinline__ bool row(int kpos, size_t* i) const {
    *i = base + kpos;
    return true;
  }
};
template <> struct ShardRows<PagedRows> {
  const int* pages;
  int c0, ps;
  __device__ ShardRows(const PagedRows& r, int b, int lo, int hi,
                       int* pages_s)
      : pages(pages_s), c0(lo / r.ps), ps(r.ps) {
    const int n = hi > lo ? (hi - 1) / ps - c0 + 1 : 0;
    for (int i = threadIdx.x; i < n; i += kThreads)
      pages_s[i] = __ldg(r.table + static_cast<size_t>(b) * r.npg +
                         min(c0 + i, r.npg - 1));
  }
  __device__ __forceinline__ bool row(int kpos, size_t* i) const {
    const int page = pages[kpos / ps - c0];
    *i = static_cast<size_t>(page) * ps + kpos % ps;
    return page >= 0;
  }
};

// ----------------------------------------------------------------- PTX ----
__device__ __forceinline__ void ldsm_x4(uint32_t* r, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}
// d (16 x 8, fp32) += a (16 x 16, bf16, row-major) b (16 x 8, bf16, col)
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ----------------------------------------------------------- arguments ----
// q (b, H, DK) bf16; k, v rows of hkv * DK elements of TKV and k_scale,
// v_scale rows of hkv fp32 (null for bf16), row i of slot b's logical row r
// given by rows_of; lengths (b,) int32; beta, gamma (H,) fp32; partials
// (b, hkv, ns, g, DK) fp32 scratch; out (b, H, DK) bf16; tickets (b * hkv,)
// int32, zeros (the kernel leaves them zero).
template <class TKV, class Rows>
struct DecodeArgs {
  const __nv_bfloat16* q;
  const TKV* k;
  const TKV* v;
  const float* k_scale;
  const float* v_scale;
  Rows rows_of;
  const int* lengths;
  const float* beta;
  const float* gamma;
  float* partials;
  __nv_bfloat16* out;  // (b, H, DK)
  int* tickets;        // (b * hkv,) zeros; each back to zero after a launch
  int H, hkv, L, bk, ns, window, fill_bound;
  float softcap, scale;
};

template <int DK, bool kMerged, class TKV, class Rows>
__global__ void __launch_bounds__(kThreads, 1)
    decode_partials(const __grid_constant__ DecodeArgs<TKV, Rows> a) {
  using Lay = DecodeLayout<DK, TKV, std::is_same_v<Rows, PagedRows>>;
  constexpr int S = Lay::kStages;
  constexpr bool kScaled = Lay::kScaled;
  constexpr int kMT = DK >= 128 ? DK / 128 : 1;  // O^T's 16-row slices/warp
  static_assert(kRows == 64 && kThreads == 256,
                "8 keys of scores per warp; P fragments of 64 keys");

  const int shard = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int g = a.H / a.hkv;
  const int n = a.lengths[b];              // valid rows; decode row is n - 1
  const int start = shard * a.bk;
  int s0, s1;
  live_shards(n, a.bk, a.ns, a.window, a.fill_bound, &s0, &s1);
  if (shard < s0 || shard >= s1) {
    if (s1 <= s0 && shard == 0) {  // no live shard (a free slot): zeros
      __nv_bfloat16* o = a.out + (static_cast<size_t>(b) * a.H + h * g) * DK;
      for (int i = threadIdx.x; i < g * DK; i += kThreads)
        o[i] = __float2bfloat16(0.f);
    }
    return;
  }
  // the shard's visible rows [lo, hi), walked in tiles aligned to its start
  int lo = start;
  const int hi = min(min(start + a.bk, a.L), n);
  if (a.window > 0) lo = max(lo, n - a.window);
  const int t0 = hi > lo ? (lo - start) / kRows : 0;
  const int n_tiles = hi > lo ? (hi - start + kRows - 1) / kRows - t0 : 0;

  extern __shared__ __align__(128) uint8_t smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gid = lane >> 2, tig = lane & 3;
  if (tid == 0) {
    for (int s = 0; s < S; ++s) mbar_init(&full[s], kThreads);
    mbar_init_fence();
  }
  const ShardRows<Rows> rows(a.rows_of, b, lo, hi,
                             reinterpret_cast<int*>(smem + Lay::kPages));
  __syncthreads();

  const size_t row_stride = static_cast<size_t>(a.hkv) * DK;
  const TKV* kh = a.k + static_cast<size_t>(h) * DK;
  const TKV* vh = a.v + static_cast<size_t>(h) * DK;
  float* part = a.partials + ((static_cast<size_t>(b) * a.hkv + h) * a.ns +
                              shard) * g * DK;

  // tile t of the walk (use u of the ring) into stage u % S: thread tid
  // copies row tid / 4 of both tensors, in 16-byte chunks tid % 4 + 4 j
  auto issue = [&](int t, int u) {
    uint8_t* st = smem + Lay::kRing + (u % S) * Lay::kStageB;
    const int r = tid >> 2, sub = tid & 3;
    const int kpos = start + (t0 + t) * kRows + r;
    size_t row = 0;
    const bool ok = kpos >= lo && kpos < hi && rows.row(kpos, &row);
    if constexpr (!kScaled) {
      const size_t at = ok ? row * row_stride : 0;
#pragma unroll
      for (int j = 0; j < DK / 32; ++j) {
        const int ch = sub + 4 * j;
        cp_async16(st + r * Lay::kRowB + ch * 16, kh + at + ch * 8, ok);
        cp_async16(st + Lay::kTileB + r * Lay::kRowB + ch * 16,
                   vh + at + ch * 8, ok);
      }
    } else {
      uint8_t* kc = st;
      uint8_t* vc = st + kRows * DK;
      float* ksc = reinterpret_cast<float*>(vc + kRows * DK);
      const size_t at = ok ? row * row_stride : 0;
#pragma unroll
      for (int j = 0; j < (DK / 16 + 3) / 4; ++j) {
        const int ch = sub + 4 * j;
        if (ch < DK / 16) {
          cp_async16(kc + r * DK + ch * 16, kh + at + ch * 16, ok);
          cp_async16(vc + r * DK + ch * 16, vh + at + ch * 16, ok);
        }
      }
      const size_t sat = ok ? row * a.hkv + h : 0;
      if (sub == 0) cp_async4(ksc + r, a.k_scale + sat, ok);
      if (sub == 1) cp_async4(ksc + kRows + r, a.v_scale + sat, ok);
    }
    cp_async_arrive(&full[u % S]);
  };

  int ubase = 0;  // uses of the ring by earlier head groups
  for (int g0 = 0; g0 < g; g0 += kHeads) {
    const int gc = min(kHeads, g - g0);
    // this thread's Q fragments (A of S = Q K^T: heads gid and gid + 8 of
    // the group, zero rows past it) and its two heads' constants, loaded
    // before the ring's first copies, which would queue ahead of them
    uint32_t qa[DK / 16][4];
    const __nv_bfloat16* qh =
        a.q + (static_cast<size_t>(b) * a.H + h * g + g0) * DK + 2 * tig;
#pragma unroll
    for (int ks = 0; ks < DK / 16; ++ks) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int head = gid + 8 * (e & 1);
        qa[ks][e] = head < gc ? *reinterpret_cast<const uint32_t*>(
                                    qh + head * DK + 16 * ks + 8 * (e >> 1))
                              : 0u;
      }
    }
    float bet[2], gam[2], cm[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int head = h * g + g0 + min(gid + 8 * i, gc - 1);
      bet[i] = a.beta[head];
      gam[i] = a.gamma[head];
    }
    for (int t = 0; t < min(S, n_tiles); ++t) issue(t, ubase + t);
#pragma unroll
    for (int i = 0; i < 2; ++i) cm[i] = consmax_c(bet[i], gam[i]);

    float o[kMT][2][4];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int i = 0; i < 8; ++i) o[mt][i >> 2][i & 3] = 0.f;

    for (int t = 0; t < n_tiles; ++t) {
      const int u = ubase + t;
      const uint8_t* st = smem + Lay::kRing + (u % S) * Lay::kStageB;
      mbar_wait(&full[u % S], (u / S) & 1);
      const uint8_t* kt = st;  // this tile's bf16 K and V operand tiles
      if constexpr (kScaled) {
        // codes and scales -> the bf16 tile pair, once every warp is done
        // with tile t - 1's
        if (t > 0) __syncthreads();
        uint8_t* dq = smem + Lay::kDequant;
        const float* ksc =
            reinterpret_cast<const float*>(st + 2 * kRows * DK);
        constexpr int QCH = DK / 16;
#pragma unroll
        for (int j = 0; j < 2 * kRows * QCH / kThreads; ++j) {
          const int i = tid + kThreads * j;
          const int tv = i / (kRows * QCH), r = (i / QCH) % kRows,
                    ch = i % QCH;
          uint4 lo16, hi16;
          dequant16<TKV, true>(reinterpret_cast<const TKV*>(
                        st + (tv * kRows + r) * DK + ch * 16),
                    ksc[tv * kRows + r], &lo16, &hi16);
          uint8_t* dst = dq + tv * Lay::kTileB + r * Lay::kRowB + ch * 32;
          *reinterpret_cast<uint4*>(dst) = lo16;
          *reinterpret_cast<uint4*>(dst + 16) = hi16;
        }
        __syncthreads();  // the bf16 tiles are whole; the stage is free
        if (t + S < n_tiles) issue(t + S, u + S);
        kt = dq;
      }
      const uint8_t* vt = kt + Lay::kTileB;

      // S = Q K^T for keys 8 warp .. 8 warp + 7 of the tile: the even and
      // the odd k-steps in two accumulators (two shorter chains), each in
      // order, then added
      float sc[4], sc2[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 4; ++i) sc[i] = 0.f;
      const uint32_t ka = smem_u32(kt) + (8 * warp + (lane & 7)) * Lay::kRowB +
                          (lane >> 3) * 16;
#pragma unroll
      for (int ks = 0; ks < DK / 16; ks += 2) {
        uint32_t kb[4];
        ldsm_x4(kb, ka + ks * 32);
        mma_bf16(sc, qa[ks], kb[0], kb[1]);
        mma_bf16(sc2, qa[ks + 1], kb[2], kb[3]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) sc[i] += sc2[i];
      // the weights: register i is head gid + 8 (i >> 1), key 2 tig + (i & 1)
      const int kpos0 = start + (t0 + t) * kRows + 8 * warp + 2 * tig;
      bool vis[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        size_t row;
        vis[e] = kpos0 + e >= lo && kpos0 + e < hi && rows.row(kpos0 + e, &row);
      }
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int hr = i >> 1;
        p[i] = vis[i & 1] && gid + 8 * hr < gc
                   ? consmax_weight<kMerged>(sc[i] * a.scale, bet[hr],
                                             gam[hr], cm[hr], a.softcap)
                   : 0.f;
      }
      uint8_t* pt = smem + Lay::kP + (u & 1) * kHeads * Lay::kPRowB;
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        __nv_bfloat162 w = __floats2bfloat162_rn(p[2 * hr], p[2 * hr + 1]);
        *reinterpret_cast<__nv_bfloat162*>(
            pt + (gid + 8 * hr) * Lay::kPRowB + (8 * warp + 2 * tig) * 2) = w;
      }
      __syncthreads();  // P is whole; every warp is done with tile t - 1
      if constexpr (!kScaled) {
        if (t >= 1 && t - 1 + S < n_tiles) issue(t - 1 + S, u - 1 + S);
      }

      // O^T += V^T P^T: this warp's 16-row slices of O^T, all 64 keys
      if (warp * kMT * 16 < DK) {
        uint32_t pb[2][8];  // [head octet][8 keys j]: keys 8 j .. 8 j + 7
        const uint32_t pa =
            smem_u32(pt) + (lane & 7) * Lay::kPRowB + (lane >> 3) * 16;
        ldsm_x4(pb[0], pa);
        ldsm_x4(pb[0] + 4, pa + 64);
        if (gc > 8) {
          ldsm_x4(pb[1], pa + 8 * Lay::kPRowB);
          ldsm_x4(pb[1] + 4, pa + 8 * Lay::kPRowB + 64);
        }
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          const int d0 = (warp * kMT + mt) * 16;
#pragma unroll
          for (int kk = 0; kk < kRows / 16; ++kk) {
            uint32_t va[4];
            ldsm_x4_trans(va, smem_u32(vt) +
                                  (16 * kk + (lane & 7) + 8 * (lane >> 4)) *
                                      Lay::kRowB +
                                  (d0 + 8 * ((lane >> 3) & 1)) * 2);
            mma_bf16(o[mt][0], va, pb[0][2 * kk], pb[0][2 * kk + 1]);
            if (gc > 8)
              mma_bf16(o[mt][1], va, pb[1][2 * kk], pb[1][2 * kk + 1]);
          }
        }
      }
    }

    // this shard's partial: o[mt][nt][i] is O[head 8 nt + 2 tig + (i & 1)]
    // [d0 + gid + 8 (i >> 1)]
    if (warp * kMT * 16 < DK) {
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        const int d0 = (warp * kMT + mt) * 16;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int head = 8 * (i >> 2) + 2 * tig + (i & 1);
          const int d = d0 + gid + 8 * ((i >> 1) & 1);
          if (head < gc) part[(g0 + head) * DK + d] = o[mt][i >> 2][i & 3];
        }
      }
    }
    ubase += n_tiles;
    __syncthreads();  // the next head group refills the ring and P tiles
  }

  // The combine: the last live shard of (slot, KV head) to finish, found by
  // an integer ticket, sums the slot's partials in shard order (the same
  // order whichever CTA is last) and writes the output; it resets the
  // ticket, so the buffer is zeros again for the next launch.
  __shared__ int last;
  __threadfence();  // this CTA's partial, visible to the last CTA
  __syncthreads();
  if (tid == 0) {
    int* ticket = a.tickets + static_cast<size_t>(b) * a.hkv + h;
    last = atomicAdd(ticket, 1) == s1 - s0 - 1;
    if (last) *ticket = 0;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  const size_t stride = static_cast<size_t>(g) * DK / 4;  // float4 / shard
  const float4* p = reinterpret_cast<const float4*>(
      a.partials + (static_cast<size_t>(b) * a.hkv + h) * a.ns * g * DK);
  __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(
      a.out + (static_cast<size_t>(b) * a.H + h * g) * DK);
  for (int i = tid; i < g * DK / 4; i += kThreads) {
    float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
    for (int sh = s0; sh < s1; ++sh) {
      const float4 x = __ldcg(p + sh * stride + i);
      t.x += x.x;
      t.y += x.y;
      t.z += x.z;
      t.w += x.w;
    }
    o[2 * i] = __floats2bfloat162_rn(t.x, t.y);
    o[2 * i + 1] = __floats2bfloat162_rn(t.z, t.w);
  }
}

// The shared-memory attribute of one instantiation, set once (to the size
// at kMaxBlock) on its first launch.
template <int DK, bool kMerged, class TKV, class Rows>
cudaError_t smem_attribute() {
  using Lay = DecodeLayout<DK, TKV, std::is_same_v<Rows, PagedRows>>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      decode_partials<DK, kMerged, TKV, Rows>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, Lay::bytes(kMaxBlock));
  return attr;
}

template <int DK, bool kMerged, class TKV, class Rows>
cudaError_t launch(const DecodeArgs<TKV, Rows>& a, int b,
                   cudaStream_t stream) {
  using Lay = DecodeLayout<DK, TKV, std::is_same_v<Rows, PagedRows>>;
  if (a.bk <= 0 || a.bk > kMaxBlock) return cudaErrorInvalidValue;
  const cudaError_t attr = smem_attribute<DK, kMerged, TKV, Rows>();
  if (attr != cudaSuccess) return attr;
  dim3 grid(a.ns, a.hkv, b);
  decode_partials<DK, kMerged, TKV, Rows>
      <<<grid, kThreads, Lay::bytes(a.bk), stream>>>(a);
  return cudaGetLastError();
}

// The head_dim and form a launch was built for.
template <class TKV, class Rows>
int launch_dk(int dk, int merged, const DecodeArgs<TKV, Rows>& a, int b,
              cudaStream_t st) {
  switch (dk * 2 + (merged ? 1 : 0)) {
    case 64: return launch<32, false>(a, b, st);
    case 65: return launch<32, true>(a, b, st);
    case 128: return launch<64, false>(a, b, st);
    case 129: return launch<64, true>(a, b, st);
    case 192: return launch<96, false>(a, b, st);
    case 193: return launch<96, true>(a, b, st);
    case 256: return launch<128, false>(a, b, st);
    case 257: return launch<128, true>(a, b, st);
    case 512: return launch<256, false>(a, b, st);
    case 513: return launch<256, true>(a, b, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <class Rows>
int launch_kv(int kv_type, int dk, const void* q, const void* k,
              const void* v, const void* k_scale, const void* v_scale,
              Rows rows_of, const void* lengths, const void* beta,
              const void* gamma, void* partials, void* out, void* tickets,
              int b, int H, int hkv, int L, int bk, int window,
              float softcap, float scale, int merged, int fill_bound,
              void* stream) {
  auto* ks = static_cast<const float*>(k_scale);
  auto* vs = static_cast<const float*>(v_scale);
  auto st = static_cast<cudaStream_t>(stream);
  if (kv_type != kKVBF16 && (!ks || !vs))
    return static_cast<int>(cudaErrorInvalidValue);
  if (bk <= 0 || !tickets) return static_cast<int>(cudaErrorInvalidValue);
  const int ns = (L + bk - 1) / bk;
  auto args = [&](auto* kv) {
    using TKV = std::remove_const_t<std::remove_pointer_t<decltype(kv)>>;
    return DecodeArgs<TKV, Rows>{
        static_cast<const __nv_bfloat16*>(q), static_cast<const TKV*>(k),
        static_cast<const TKV*>(v), ks, vs, rows_of,
        static_cast<const int*>(lengths), static_cast<const float*>(beta),
        static_cast<const float*>(gamma), static_cast<float*>(partials),
        static_cast<__nv_bfloat16*>(out), static_cast<int*>(tickets), H, hkv,
        L, bk, ns, window, fill_bound, softcap, scale};
  };
  switch (kv_type) {
    case kKVBF16:
      return launch_dk(dk, merged,
                       args(static_cast<const __nv_bfloat16*>(nullptr)), b,
                       st);
    case kKVInt8:
      return launch_dk(dk, merged, args(static_cast<const int8_t*>(nullptr)),
                       b, st);
    case kKVFP8:
      return launch_dk(dk, merged,
                       args(static_cast<const __nv_fp8_e4m3*>(nullptr)), b,
                       st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <class TKV>
int smem_bytes_dk(int dk, int paged, int bk) {
  switch (dk) {
    case 32:
      return paged ? DecodeLayout<32, TKV, true>::bytes(bk)
                   : DecodeLayout<32, TKV, false>::bytes(bk);
    case 64:
      return paged ? DecodeLayout<64, TKV, true>::bytes(bk)
                   : DecodeLayout<64, TKV, false>::bytes(bk);
    case 96:
      return paged ? DecodeLayout<96, TKV, true>::bytes(bk)
                   : DecodeLayout<96, TKV, false>::bytes(bk);
    case 128:
      return paged ? DecodeLayout<128, TKV, true>::bytes(bk)
                   : DecodeLayout<128, TKV, false>::bytes(bk);
    case 256:
      return paged ? DecodeLayout<256, TKV, true>::bytes(bk)
                   : DecodeLayout<256, TKV, false>::bytes(bk);
    default:
      return 0;
  }
}

}  // namespace

// The dynamic shared memory of one decode_partials CTA at head_dim dk for a
// cache of kv_type (KVCode), contiguous (paged 0) or paged, at shard size
// bk, in bytes; 0 for an unknown combination or bk outside [1, kMaxBlock].
extern "C" int consmax_decode_smem_bytes(int dk, int kv_type, int paged,
                                         int bk) {
  if (bk <= 0 || bk > kMaxBlock) return 0;
  return kv_type == kKVBF16 ? smem_bytes_dk<__nv_bfloat16>(dk, paged, bk)
                            : smem_bytes_dk<int8_t>(dk, paged, bk);
}

// q (b, H, dk) bf16; k, v (b, L, hkv, dk) of kv_type (KVCode: bf16, int8,
// fp8_e4m3); k_scale, v_scale (b, L, hkv) fp32 for int8 / fp8 (null for
// bf16); lengths (b,) int32 = valid rows per slot; beta, gamma (H,) fp32;
// partials (b, hkv, ceil(L/bk), g, dk) fp32 scratch; out (b, H, dk) bf16;
// tickets (b * hkv,) int32 zeros, left zero (the last argument, after the
// stream, so the arguments before it keep their places). dk in
// {32, 64, 96, 128, 256}; 0 < bk <= kMaxBlock.
extern "C" int consmax_decode_launch(const void* q, const void* k,
                                     const void* v, const void* k_scale,
                                     const void* v_scale, const void* lengths,
                                     const void* beta, const void* gamma,
                                     void* partials, void* out, int b, int H,
                                     int hkv, int L, int dk, int bk,
                                     int window, float softcap, float scale,
                                     int merged, int fill_bound, int kv_type,
                                     void* stream, void* tickets) {
  return launch_kv(kv_type, dk, q, k, v, k_scale, v_scale, ContigRows{L},
                   lengths, beta, gamma, partials, out, tickets, b, H, hkv,
                   L, bk, window, softcap, scale, merged, fill_bound, stream);
}

// The paged twin: kp, vp (P, ps, hkv, dk) pools of kv_type; k_scale,
// v_scale (P, ps, hkv) fp32 scale pools (null for bf16), read at the same
// row index as the data; table (b, npg) int32 (-1 = unmapped); lengths (b,)
// int32 = valid logical rows (index + active, 0 allowed); partials
// (b, hkv, ceil(npg * ps / bk), g, dk) fp32 scratch; tickets as above.
// Any page size: a paged CTA keeps its shard's page entries (bk + 1 at
// most) in shared memory, and ps only shapes the address.
extern "C" int consmax_decode_paged_launch(
    const void* q, const void* kp, const void* vp, const void* k_scale,
    const void* v_scale, const void* table, const void* lengths,
    const void* beta, const void* gamma, void* partials, void* out, int b,
    int H, int hkv, int npg, int ps, int dk, int bk, int window,
    float softcap, float scale, int merged, int fill_bound, int kv_type,
    void* stream, void* tickets) {
  const PagedRows rows_of{static_cast<const int*>(table), npg, ps};
  return launch_kv(kv_type, dk, q, kp, vp, k_scale, v_scale, rows_of,
                   lengths, beta, gamma, partials, out, tickets, b, H, hkv,
                   npg * ps, bk, window, softcap, scale, merged, fill_bound,
                   stream);
}
