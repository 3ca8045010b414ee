// Full-scan int4-doc MaxSim for Hopper (sm_90a), plain C interface for
// ctypes.
//
// Replaces the TPU kernel hybrid_rag_colbertv2_tpu/ops/maxsim.py:
// _maxsim_int4_group_kernel (called by maxsim_scores_int4_doc). Same
// function:
//
//   score[b, n] = sum_i max_g ( gs[g, n] * max_{j in group g} q[b, i] . e[n, j] )
//
// The index (ops/quant.py::quantize_int4_groups) packs token rows 2s and
// 2s + 1 into the low and high nibbles of stored row s, feature j in
// byte j, values in [-7, 7]; 8 consecutive rows share one fp32 scale
// gs[g, n], stored (L/8, N) with the doc axis minor. Padding rows copy a
// valid row of their group (a fully padded group copies row 0 and takes
// group 0's scale), so every stored row of a chunk may be multiplied, and
// 64-row chunks wholly past a doc's length are skipped; a zero-length doc
// scores exactly 0. Products are bf16 -> fp32 on the tensor cores; maxima
// and sums are fp32, each sum in a fixed order: two launches agree bit for
// bit.
//
// Bound at the main path's shape (B=8, Lq=32, N_pad=1,000,064, L=64,
// D=128, lengths 32..64): the products over the ~48 M valid rows, ~3.15
// TFLOP, take ~3.2 ms at the H100 SXM's 989 TFLOP/s bf16 rate, against
// ~3.1 GB of packed rows, ~0.9 ms at 3.35 TB/s: operations. The design
// keeps the tensor cores fed and takes the rest off their path:
//  * One block per SM over a contiguous doc range, three warpgroups.
//    Two consumer warpgroups hold the query as wgmma A fragments in
//    registers for the whole kernel (2 m-tiles of 64 query columns each
//    at D <= 128, so 256 columns: all 8 queries of the main path) and
//    multiply each 64-row chunk, the B operand, with
//    wgmma.m64n64k16 bf16 -> fp32 from shared memory (128-byte swizzle).
//  * An 8-row int4 group is one 8-column block of the accumulator: each
//    thread takes the max of its two columns, scales it once by the group
//    scale and folds it into a running max (the TPU kernel's order: group
//    max, scale, max over groups; the four threads of a row agree after
//    two shuffles at the doc's end). Each m-tile is its own commit group,
//    so the first m-tile is folded while the second's products run.
//  * The transform warpgroup is four independent warps; warp w owns live
//    chunks w, w + 4, ...: its lane 0 keeps two bulk copies
//    (cp.async.bulk into an mbarrier ring) of its packed chunks in flight,
//    refilling a stage once every lane has read it and fenced the async
//    proxy. The warp unpacks each landed chunk once into the bf16 tile
//    the consumers read (two nibbles per byte permute and bf16x2 FMA),
//    beside the chunk's 8 group scales. A ballot over 32 (doc, chunk)
//    pairs at a time finds the live chunks.
//  * Consumers publish each doc's row maxima to a ring of slots; the
//    transform warps sum each query's maxima there (a fixed split over
//    lanes and an xor tree), so no consumer waits on a serial sum.
//  * mbarriers hand tiles, packed stages and slots between the roles;
//    there is no block-wide barrier after the set-up.
//
// A doc's last chunk is 32 rows where L % 64 == 32: its bulk copy moves 16
// packed rows, and its 4 absent groups take a NaN scale, which the running
// max (fmaxf drops a NaN operand) ignores whatever the tile's stale rows
// hold; no row past the doc is read.
//
// Takes any B (grid.y tiles the queries), L a multiple of 32, D a multiple
// of 16 up to 256 (above 128 one m-tile per warpgroup, 128 columns per
// block), Lq up to 256 (a query wider than the block's columns is scanned
// in column segments, one launch each, each segment's sum added in order)
// and any N.

#include <climits>
#include <cuda_bf16.h>

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int kChunkRows = 64;                   // doc rows per product (wgmma n)
constexpr int kPairRows = kChunkRows / 2;        // packed rows per chunk
constexpr int kGroupRows = 8;                    // ops/quant.py::int4_group_size
constexpr int kGroups = kChunkRows / kGroupRows;  // group scales per chunk
constexpr int kConsumerThreads = 2 * 128;  // two warpgroups: products and maxima
constexpr int kTransformThreads = 128;     // one warpgroup: copies, unpacking, sums
constexpr int kThreads = kConsumerThreads + kTransformThreads;
constexpr int kTransformWarps = kTransformThreads / 32;
constexpr int kPackedPerWarp = 2;  // packed chunks in flight per transform warp
constexpr int kPackedStages = kTransformWarps * kPackedPerWarp;
constexpr int kColSlots = 8;      // docs' row maxima waiting for their sums
constexpr float kNegInf = -1e30f;

template <int KSTEPS>
struct Cfg {
  static constexpr int D = KSTEPS * 16;
  static constexpr int MT = KSTEPS <= 8 ? 2 : 1;  // 64-column m-tiles per warpgroup
  static constexpr int kCols = 2 * MT * 64;        // query columns per block
  static constexpr int kAtoms = (D + 63) / 64;     // 128-byte swizzle atoms per row
  static constexpr int kTileBytes = kAtoms * kChunkRows * 128;
  static constexpr int kPackedBytes = kPairRows * D;
  static constexpr int kVecs = kPairRows * KSTEPS;  // 16-byte packed pieces per chunk
  static constexpr int kVecsPerWarpLane = (kVecs + 31) / 32;
  // unpacked chunks ready for the products. Not a multiple of the four
  // transform warps where they fit, so each warp's chunks rotate over all
  // the stages: at 8 each warp refilled only its own two, and the scan ran
  // slower. At least one per transform warp: a warp waits on a stage's
  // `tile_empty` by parity alone, and all it knows is that the stage of its
  // own previous chunk, four live chunks back, had been released. With
  // fewer stages than warps, the stage may still be two phases behind the
  // one the warp waits for, a phase of the same parity, and the wait passes.
  static constexpr int kTileStages = kAtoms <= 2 ? 10 : kAtoms == 3 ? 5 : 4;
  static constexpr int kPackedOff = kTileStages * kTileBytes;
  static constexpr int kScaleOff = kPackedOff + kPackedStages * kPackedBytes;
  static constexpr int kColOff = kScaleOff + kTileStages * kGroups * 4;
  static constexpr int kDocOff = kColOff + kColSlots * kCols * 4;
  static constexpr int kBarOff = kDocOff + kColSlots * 4 + 8;  // + the published count
  static constexpr int kBytes =
      kBarOff + (kPackedStages + 2 * kTileStages + 2 * kColSlots + 1) * 8 + 1024;  // + alignment
  static_assert(kTileStages >= kTransformWarps, "a stage's phases would alias by parity");
  static_assert(kBarOff % 8 == 0, "mbarriers are 8-byte aligned");
  static_assert(kBytes <= 227 * 1024, "over the H100's shared memory per block");
};
// Warp w sums the docs published to slots w, w + 4, ...: every use of a
// slot by one warp, in order, so its col_full phases cannot alias.
static_assert(kColSlots % kTransformWarps == 0, "a slot summed by two warps");

// 16 packed bytes (features f..f+15) -> the even row's and the odd row's
// 16 bf16 each, as two 16-byte pieces per row. A nibble n holding the
// signed value s becomes n ^ 8 = s + 8; a byte permute sets 0x43 above it,
// the bf16 of 128 + (s + 8), and one bf16x2 FMA subtracts 136: exact.
__device__ __forceinline__ uint32_t debias(uint32_t x) {
  uint32_t r;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(r) : "r"(x), "r"(0x3F803F80u), "r"(0xC308C308u));
  return r;
}

__device__ __forceinline__ void unpack16(uint4 v, uint4 (&lo)[2], uint4 (&hi)[2]) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  uint32_t l[8], h[8];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uint32_t nl = (w[k] & 0x0F0F0F0Fu) ^ 0x08080808u;         // even tokens
    const uint32_t nh = ((w[k] >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u;  // odd tokens
    l[2 * k] = debias(__byte_perm(nl, 0x43434343u, 0x4140));      // features 4k, 4k+1
    l[2 * k + 1] = debias(__byte_perm(nl, 0x43434343u, 0x4342));  // 4k+2, 4k+3
    h[2 * k] = debias(__byte_perm(nh, 0x43434343u, 0x4140));
    h[2 * k + 1] = debias(__byte_perm(nh, 0x43434343u, 0x4342));
  }
  lo[0] = make_uint4(l[0], l[1], l[2], l[3]);
  lo[1] = make_uint4(l[4], l[5], l[6], l[7]);
  hi[0] = make_uint4(h[0], h[1], h[2], h[3]);
  hi[1] = make_uint4(h[4], h[5], h[6], h[7]);
}

// kTail: L % 64 == 32, so a doc's last chunk is 32 rows. Without it every
// chunk is 64 rows at compile time, and the copy and staging code is that
// of whole chunks alone.
template <int KSTEPS, bool kTail>
__global__ void __launch_bounds__(kThreads, 1)
maxsim_int4_kernel(const __nv_bfloat16* __restrict__ q,  // (B*Lq, D)
                   const int8_t* __restrict__ emb,        // (N*L/2, D) packed
                   const float* __restrict__ gscale,      // (L/8, N)
                   const int* __restrict__ lengths,       // (N,)
                   float* __restrict__ out,               // (B, N)
                   int lq, int batch, int n_docs, int doc_len, int docs_per_block,
                   int queries_per_tile, int seg0, int seg_len, int accumulate) {
  using C = Cfg<KSTEPS>;
  constexpr int D = C::D, MT = C::MT;
  extern __shared__ unsigned char smem_raw[];
  // 1024-byte aligned for the swizzled tiles, by an offset from smem_raw so
  // that the compiler keeps shared-memory loads and stores (not generic ones)
  unsigned char* smem = smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u);
  unsigned char* s_tile = smem;                      // [stages][atoms][64][128 B]
  unsigned char* s_packed = smem + C::kPackedOff;    // [stages][32][D] int8
  float* s_scale = reinterpret_cast<float*>(smem + C::kScaleOff);  // [stages][8]
  float* s_col = reinterpret_cast<float*>(smem + C::kColOff);      // [slots][kCols]
  int* s_col_doc = reinterpret_cast<int*>(smem + C::kDocOff);      // [slots]
  uint64_t* packed_full = reinterpret_cast<uint64_t*>(smem + C::kBarOff);
  uint64_t* tile_full = packed_full + kPackedStages;
  uint64_t* tile_empty = tile_full + C::kTileStages;
  uint64_t* col_full = tile_empty + C::kTileStages;
  uint64_t* col_empty = col_full + kColSlots;
  uint64_t* done = col_empty + kColSlots;  // the consumers have published every doc
  int* s_published = s_col_doc + kColSlots;
  if (threadIdx.x == 0) {
    for (int p = 0; p < kPackedStages; ++p) mbar_init(&packed_full[p], 1);
    for (int s = 0; s < C::kTileStages; ++s) {
      mbar_init(&tile_full[s], 32);  // the transform warp's lanes
      mbar_init(&tile_empty[s], kConsumerThreads);
    }
    for (int k = 0; k < kColSlots; ++k) {
      mbar_init(&col_full[k], kConsumerThreads);
      mbar_init(&col_empty[k], 32);
    }
    mbar_init(done, 1);
    fence_mbar_init();
  }
  __syncthreads();

  const int q0 = blockIdx.y * queries_per_tile;
  const int n_queries = min(queries_per_tile, batch - q0);
  const int chunks_per_doc = (doc_len + kChunkRows - 1) / kChunkRows;
  // packed rows of chunk c: kPairRows, or half as many in a doc's last
  // chunk where L % 64 == 32
  auto chunk_pairs = [&](int c) {
    return kTail ? min(kPairRows, (doc_len - c * kChunkRows) / 2) : kPairRows;
  };
  const int d0 = blockIdx.x * docs_per_block;
  const int d1 = min(n_docs, d0 + docs_per_block);
  // the chunks of a doc that can change its score: rows past the length
  // copy valid rows of their group (ops/quant.py), so later chunks are skipped
  auto live_chunks = [&](int len) {
    return min(chunks_per_doc, (len + kChunkRows - 1) / kChunkRows);
  };

  if (threadIdx.x >= kConsumerThreads) {
    // ---- transform warpgroup: four independent warps; warp w copies and
    // unpacks the live chunks w, w + 4, w + 8, ... and sums the published
    // docs w, w + 4, ... (no barrier among the warps) ---------------------
    const int tw = (threadIdx.x - kConsumerThreads) >> 5;
    const int lane = threadIdx.x & 31;

    // Live chunks in order, 32 (doc, chunk) pairs at a time: lane i tests
    // pair base + i (doc = pair / chunks_per_doc) and a ballot gives the
    // window's live pairs, consumed lowest first.
    struct Scan {
      int base;       // the window's first pair
      uint32_t live;  // its live pairs not yet taken
      int doc, chunk;  // the pair taken last
    };
    const int pair_end = d1 * chunks_per_doc;
    auto split = [&](int pr, int& doc, int& chunk) {
      doc = chunks_per_doc == 1 ? pr : pr / chunks_per_doc;
      chunk = pr - doc * chunks_per_doc;
    };
    // zero-length docs in the window get their zero scores from warp doc % 4
    // when `zeros`
    auto load = [&](Scan& c, bool zeros) {
      const int pr = c.base + lane;
      bool live = false;
      if (pr < pair_end) {
        int doc, chunk;
        split(pr, doc, chunk);
        const int len = lengths[doc];
        live = chunk * kChunkRows < len;
        if (zeros && len == 0 && chunk == 0 && !accumulate && (doc & 3) == tw)
          for (int qq = 0; qq < n_queries; ++qq) out[(size_t)(q0 + qq) * n_docs + doc] = 0.f;
      }
      c.live = __ballot_sync(0xffffffffu, live);
    };
    auto start = [&](bool zeros) {
      Scan c{d0 * chunks_per_doc, 0u, 0, 0};
      load(c, zeros);
      return c;
    };
    // -> the next live chunk, if any
    auto next_live = [&](Scan& c, bool zeros) {
      while (c.live == 0) {
        c.base += 32;
        if (c.base >= pair_end) return false;
        load(c, zeros);
      }
      split(c.base + __ffs(c.live) - 1, c.doc, c.chunk);
      c.live &= c.live - 1;
      return true;
    };
    auto skip = [&](Scan& c, int n, bool zeros) {
      bool more = true;
      for (int i = 0; i < n && more; ++i) more = next_live(c, zeros);
      return more;
    };

    // Lane 0 keeps this warp's bulk copies kPackedPerWarp of its chunks
    // ahead; the (doc, chunk) of each copy in flight waits in q_doc/q_chunk,
    // oldest first, for its unpacking.
    Scan cp = start(true);
    bool cp_more = skip(cp, tw + 1, true);
    int issued = 0;
    int q_doc[kPackedPerWarp], q_chunk[kPackedPerWarp];
    auto copy_next = [&](int& doc, int& chunk) {
      if (!cp_more) return;
      const int p = tw * kPackedPerWarp + issued % kPackedPerWarp;
      if (lane == 0) {
        const uint32_t bytes = chunk_pairs(cp.chunk) * D;
        mbar_arrive_expect_tx(&packed_full[p], bytes);
        bulk_copy_g2s(s_packed + p * C::kPackedBytes,
                      emb + ((size_t)cp.doc * doc_len / 2 + (size_t)cp.chunk * kPairRows) * D,
                      bytes, &packed_full[p]);
      }
      doc = cp.doc;
      chunk = cp.chunk;
      ++issued;
      cp_more = skip(cp, kTransformWarps, true);
    };
#pragma unroll
    for (int j = 0; j < kPackedPerWarp; ++j) copy_next(q_doc[j], q_chunk[j]);

    // published docs' sums, in a fixed order: each query's columns split
    // over `lanes` lanes (a power of two), each adding its share in
    // ascending order, then an xor tree
    int lanes = 32;
    while (lanes > 1 && n_queries * lanes > 32) lanes >>= 1;
    const int per_lane = (seg_len + lanes - 1) / lanes;
    const int part = lane & (lanes - 1);
    const int c_lo = min(seg_len, part * per_lane);
    const int c_hi = min(seg_len, c_lo + per_lane);
    int summed = tw;  // the next published doc (publication order) to sum
    auto drain = [&](int upto, bool block) {
      while (summed < upto) {
        const int k = summed % kColSlots;
        const uint32_t parity = (summed / kColSlots) & 1;
        if (!block && !__any_sync(0xffffffffu, mbar_test(&col_full[k], parity))) return;
        mbar_wait(&col_full[k], parity);
        const float* cols = s_col + k * C::kCols;
        const int doc = s_col_doc[k];
        for (int q_base = 0; q_base < n_queries; q_base += 32 / lanes) {
          const int qq = q_base + lane / lanes;
          float v = 0.f;
          if (qq < n_queries)
            for (int i = c_lo; i < c_hi; ++i) v += cols[qq * seg_len + i];
          for (int o = 1; o < lanes; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
          if (qq < n_queries && part == 0) {
            const size_t o = (size_t)(q0 + qq) * n_docs + doc;
            out[o] = accumulate ? v + load_volatile(out + o) : v;
          }
        }
        mbar_arrive(&col_empty[k]);
        summed += kTransformWarps;
      }
    };

    for (int local = 0; local < issued; ++local) {
      // the chunk's 8 group scales ride with its tile; loaded first, stored
      // last. A 32-row chunk's absent groups get NaN: no max takes them.
      const int pairs = chunk_pairs(q_chunk[0]);
      const int vecs = pairs * KSTEPS;  // 16-byte packed pieces of the chunk
      const float scale =
          lane < 2 * pairs / kGroupRows
              ? __ldg(gscale + (size_t)(q_chunk[0] * kGroups + lane) * n_docs + q_doc[0])
              : __int_as_float(0x7fc00000);
      const int seq = local * kTransformWarps + tw;  // live chunk index
      const int p = tw * kPackedPerWarp + local % kPackedPerWarp;
      mbar_wait(&packed_full[p], (local / kPackedPerWarp) & 1);
      uint4 pre[C::kVecsPerWarpLane];
      const uint4* src = reinterpret_cast<const uint4*>(s_packed + p * C::kPackedBytes);
#pragma unroll
      for (int v = 0; v < C::kVecsPerWarpLane; ++v) {
        const int idx = lane + 32 * v;
        if (idx < vecs) pre[v] = src[idx];
      }
      // Stage p is read: refill it. A bulk copy writes through the async
      // proxy, which neither program order nor __syncwarp orders after
      // the warp's plain reads of the stage: each lane's proxy fence
      // follows its reads, and the warp barrier puts every lane's fence
      // before the copy. Without the fence, a copy from L2 overwrote a
      // stage before it was read in most launches on the H100 with this
      // kernel's 202 KB of shared memory, and in up to 1% of them with
      // less (chip_smoke.py's stress phase).
      fence_proxy_async();
      __syncwarp();
#pragma unroll
      for (int j = 0; j + 1 < kPackedPerWarp; ++j) {
        q_doc[j] = q_doc[j + 1];
        q_chunk[j] = q_chunk[j + 1];
      }
      copy_next(q_doc[kPackedPerWarp - 1], q_chunk[kPackedPerWarp - 1]);

      const int s = seq % C::kTileStages;
      mbar_wait(&tile_empty[s], ((seq / C::kTileStages) & 1) ^ 1);
      unsigned char* tile = s_tile + s * C::kTileBytes;
      // -> token-order bf16 rows in the 128-byte-swizzle layout
#pragma unroll
      for (int v = 0; v < C::kVecsPerWarpLane; ++v) {
        const int idx = lane + 32 * v;
        if (idx < vecs) {
          const int pr = idx / KSTEPS;
          const int kv = idx - pr * KSTEPS;  // features 16 kv .. 16 kv + 15
          uint4 lo[2], hi[2];
          unpack16(pre[v], lo, hi);
          unsigned char* atom = tile + (kv >> 2) * (kChunkRows * 128);
          const int piece = (2 * kv) & 7;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            *reinterpret_cast<uint4*>(atom + sw128_offset(2 * pr, piece + e)) = lo[e];
            *reinterpret_cast<uint4*>(atom + sw128_offset(2 * pr + 1, piece + e)) = hi[e];
          }
        }
      }
      if (lane < kGroups) s_scale[s * kGroups + lane] = scale;
      fence_proxy_async();
      mbar_arrive(&tile_full[s]);
      drain(INT_MAX, false);
    }
    // the consumers post how many docs they published once they are done
    while (true) {
      drain(INT_MAX, false);
      if (__any_sync(0xffffffffu, mbar_test(done, 0))) break;
    }
    mbar_wait(done, 0);
    drain(*s_published, true);
  } else {
    // ---- consumer warpgroups: products, group scales, row maxima -------
    const int wg = threadIdx.x >> 7;
    const int warp = (threadIdx.x >> 5) & 3;  // warp in its warpgroup
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const int tile_cols = n_queries * seg_len;  // tile column c: query c / seg_len

    // this thread's query rows (A fragments) for the whole kernel; rows
    // past the tile are zero
    uint32_t a[MT][KSTEPS][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = (wg * MT + mt) * 64 + 16 * warp + g + 8 * h;
        const bool live = c < tile_cols;
        const int qi = live ? c / seg_len : 0;
        const uint32_t* src = reinterpret_cast<const uint32_t*>(
            q + ((size_t)(q0 + qi) * lq + seg0 + (live ? c - qi * seg_len : 0)) * D);
#pragma unroll
        for (int ks = 0; ks < KSTEPS; ++ks) {
          a[mt][ks][h] = live ? src[ks * 8 + t] : 0u;
          a[mt][ks][2 + h] = live ? src[ks * 8 + 4 + t] : 0u;
        }
      }
    }

    float acc[MT][32];
    int seq = 0, published = 0;
    int next_len = lengths[d0];
    for (int doc = d0; doc < d1; ++doc) {
      const int len = next_len;
      if (doc + 1 < d1) next_len = lengths[doc + 1];
      const int n_live = live_chunks(len);
      if (n_live == 0) continue;
      float run[MT][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) run[mt][0] = run[mt][1] = kNegInf;
      for (int chunk = 0; chunk < n_live; ++chunk, ++seq) {
        const int s = seq % C::kTileStages;
        mbar_wait(&tile_full[s], (seq / C::kTileStages) & 1);
        const float4 s_lo = reinterpret_cast<const float4*>(s_scale + s * kGroups)[0];
        const float4 s_hi = reinterpret_cast<const float4*>(s_scale + s * kGroups)[1];
        const float sc[kGroups] = {s_lo.x, s_lo.y, s_lo.z, s_lo.w,
                                   s_hi.x, s_hi.y, s_hi.z, s_hi.w};
        const unsigned char* tile = s_tile + s * C::kTileBytes;
        // one group per m-tile: the first m-tile's maxima are folded while
        // the second's products run
        wgmma_fence();
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
          for (int ks = 0; ks < KSTEPS; ++ks) {
            const uint64_t desc =
                desc_k_sw128(tile + (ks >> 2) * (kChunkRows * 128) + (ks & 3) * 32);
            wgmma_m64n64k16_rs(acc[mt], a[mt][ks], desc, ks > 0);
          }
          wgmma_commit();
        }
        // columns 8j .. 8j + 7 of the chunk are its group j: the max of the
        // thread's two columns, scaled once, folded into the running max
        // (a NaN scale, an absent group's, leaves it as it was)
        auto fold = [&](int mt) {
#pragma unroll
          for (int i = 0; i < 32; ++i) fence_reg(acc[mt][i]);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
#pragma unroll
            for (int j = 0; j < kGroups; ++j) {
              const float m = fmaxf(acc[mt][4 * j + 2 * h], acc[mt][4 * j + 2 * h + 1]);
              run[mt][h] = fmaxf(run[mt][h], m * sc[j]);
            }
          }
        };
        if constexpr (MT == 2) {
          wgmma_wait<1>();
          fold(0);
        }
        wgmma_wait<0>();
        mbar_arrive(&tile_empty[s]);
        if constexpr (MT == 2) {
          fold(1);
        } else {
          fold(0);
        }
      }
      // the row max over the four threads that share a row, published to
      // the transform warpgroup's sums
      const int k = published % kColSlots;
      mbar_wait(&col_empty[k], ((published / kColSlots) & 1) ^ 1);
      float* cols = s_col + k * C::kCols;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float m = run[mt][h];
          m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
          m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
          if (t == 0) cols[(wg * MT + mt) * 64 + 16 * warp + g + 8 * h] = m;
        }
      }
      if (threadIdx.x == 0) s_col_doc[k] = doc;
      mbar_arrive(&col_full[k]);
      ++published;
    }
    if (threadIdx.x == 0) {
      *s_published = published;
      mbar_arrive(done);
    }
  }
}

template <int K>
cudaError_t launch_k(const void* q, const void* emb, const void* gs, const void* lengths,
                     void* out, int batch, int lq, int n_docs, int doc_len, int sms,
                     cudaStream_t stream) {
  using C = Cfg<K>;
  const auto kernel =
      doc_len % kChunkRows ? maxsim_int4_kernel<K, true> : maxsim_int4_kernel<K, false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kBytes);
  if (err != cudaSuccess) return err;
  // whole queries per block where one fits; else one query per block in
  // column segments of at most kCols, one launch each, summed in order
  const int segments = (lq + C::kCols - 1) / C::kCols;
  const int seg_w = (lq + segments - 1) / segments;
  const int qpt = segments == 1 ? C::kCols / lq : 1;
  const int grid_y = (batch + qpt - 1) / qpt;
  int grid_x = sms / grid_y;
  grid_x = grid_x < 1 ? 1 : grid_x > n_docs ? n_docs : grid_x;
  const int dpb = (n_docs + grid_x - 1) / grid_x;  // a contiguous doc range each
  grid_x = (n_docs + dpb - 1) / dpb;
  const dim3 grid(grid_x, grid_y);
  for (int s = 0; s < segments; ++s) {
    const int seg0 = s * seg_w;
    const int seg_len = lq - seg0 < seg_w ? lq - seg0 : seg_w;
    kernel<<<grid, kThreads, C::kBytes, stream>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const int8_t*>(emb),
        static_cast<const float*>(gs), static_cast<const int*>(lengths),
        static_cast<float*>(out), lq, batch, n_docs, doc_len, dpb, qpt, seg0, seg_len, s > 0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

// Launches on `stream`; returns the first nonzero CUDA error (0 on
// success). q: (batch*lq, dim) bf16; emb: (n_docs*doc_len/2, dim) packed
// int8, 16-byte aligned; group_scales: (doc_len/8, n_docs) fp32; lengths:
// (n_docs,) int32; out: (batch, n_docs) fp32.
extern "C" int maxsim_int4_group_launch(const void* q, const void* emb,
                                        const void* group_scales,
                                        const void* lengths, void* out, int batch,
                                        int lq, int dim, int n_docs, int doc_len,
                                        void* stream) {
  if (dim < 16 || dim > 256 || dim % 16 != 0 || doc_len <= 0 ||
      doc_len % 32 != 0 || lq <= 0 || lq > 256 || batch < 0 || n_docs < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0 || n_docs == 0) return 0;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
#define MAXSIM_INT4_CASE(K)                                                           \
  case K:                                                                             \
    err = launch_k<K>(q, emb, group_scales, lengths, out, batch, lq, n_docs, doc_len, \
                      sms, s);                                                        \
    break;
  switch (dim / 16) {
    MAXSIM_INT4_CASE(1)
    MAXSIM_INT4_CASE(2)
    MAXSIM_INT4_CASE(3)
    MAXSIM_INT4_CASE(4)
    MAXSIM_INT4_CASE(5)
    MAXSIM_INT4_CASE(6)
    MAXSIM_INT4_CASE(7)
    MAXSIM_INT4_CASE(8)
    MAXSIM_INT4_CASE(9)
    MAXSIM_INT4_CASE(10)
    MAXSIM_INT4_CASE(11)
    MAXSIM_INT4_CASE(12)
    MAXSIM_INT4_CASE(13)
    MAXSIM_INT4_CASE(14)
    MAXSIM_INT4_CASE(15)
    MAXSIM_INT4_CASE(16)
  }
#undef MAXSIM_INT4_CASE
  return static_cast<int>(err);
}
