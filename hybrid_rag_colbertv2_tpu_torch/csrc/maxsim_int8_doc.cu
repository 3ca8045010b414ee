// Full-scan int8-doc MaxSim for Hopper (sm_90a), plain C interface for
// ctypes.
//
// Replaces the TPU kernel hybrid_rag_colbertv2_tpu/ops/maxsim.py:
// _maxsim_int8_doc_kernel (called by maxsim_scores_int8_doc), together
// with that wrapper's multiply by the per-doc scale. Same function:
//
//   score[b, n] = doc_scale[n] * sum_i max_j q[b, i] . e[n, j]
//
// over all L stored rows j: the layout (ops/quant.py::quantize_int8_docs)
// stores padding rows as copies of the doc's row 0, so there is no mask,
// and a 64-row chunk that starts at or past the doc's length holds only
// copies and is skipped exactly. q is bf16, e int8 (exact in bf16),
// products and sums fp32, each sum in a fixed order and then multiplied by
// the doc scale once, as the plain version does: two launches agree bit
// for bit. A zero-length doc scores exactly 0.
//
// Bound at the main path's shape (B=8, Lq=32, N_pad=100,096, L=128, D=128,
// lengths 64..128): rows past a doc's length are copies, so only the
// ~9.6 M valid rows need products, ~0.63 TFLOP, ~0.64 ms at the H100
// SXM's 989 TFLOP/s bf16 rate, against ~1.23 GB of valid int8 rows,
// ~0.37 ms at 3.35 TB/s: operations. The design is that of maxsim_int8.cu
// with the mask taken out:
//  * One block per SM over a contiguous doc range, three warpgroups. Two
//    consumer warpgroups hold the query as wgmma A fragments in registers
//    for the whole kernel (2 m-tiles of 64 query columns each at D <= 128,
//    so 256 columns: all 8 queries of the main path) and multiply each
//    live 64-row chunk, the B operand, with wgmma.m64n64k16 bf16 -> fp32
//    from a 128-byte-swizzled shared tile.
//  * With the query as A, doc row j of the chunk is accumulator column j:
//    each thread folds its 16 columns into a running max with fmaxf alone
//    (no factor, no mask). Each m-tile is its own commit group, so the
//    first m-tile is folded while the second's products run.
//  * Chunk c of doc n is live iff c * 64 < lengths[n]. The transform
//    warpgroup is four independent warps; warp w owns the live chunks w,
//    w + 4, ... of the block's range, found by a ballot over the lengths of
//    32 (doc, chunk) pairs at a time. Its lane 0 keeps bulk copies
//    (cp.async.bulk into an mbarrier ring) of those chunks' int8 rows in
//    flight, refilling a stage once every lane has read it and fenced the
//    async proxy; a dead chunk is never read. The warp converts the rows to
//    bf16 once per element into the tile (byte permutes build two bf16
//    pairs from each byte's low 7 bits and from its sign, one bf16x2 FMA
//    subtracts them: exact).
//  * Consumers publish each doc's row maxima to a ring of slots, with the
//    doc scale they read a doc ahead beside its length; the transform
//    warps sum each query's maxima there (a fixed split over lanes and an
//    xor tree) and multiply the sum by the scale, so no consumer waits on
//    a serial sum and no scan warp on a device-memory read. A zero-length
//    doc has no live chunk and is never published: the transform warp
//    doc % 4 writes its 0.
//  * mbarriers hand tiles, copied stages and slots between the roles;
//    there is no block-wide barrier after the set-up.
//
// A doc's last chunk is 32 rows where L % 64 == 32: its bulk copy moves 32
// rows, and the warp writes each converted row into both halves of the
// tile, so the other 32 columns are copies of valid rows and leave every
// max as it is; no row past the doc is read.
//
// Takes any B (grid.y tiles the queries), L a multiple of 32, D a multiple
// of 16 up to 256 (above 128 one m-tile per warpgroup, 128 columns per
// block), Lq up to 256 (a query wider than the block's columns is scanned
// in column segments, one launch each, each segment's sum added in order
// and the doc scale multiplied in the last) and any N. Needs emb 16-byte
// aligned.

#include <climits>
#include <cuda_bf16.h>

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int kChunkRows = 64;             // doc rows per product (wgmma n)
constexpr int kHalfRows = kChunkRows / 2;  // a doc's last chunk where L % 64 == 32
constexpr int kConsumerThreads = 2 * 128;  // two warpgroups: products and maxima
constexpr int kTransformThreads = 128;     // one warpgroup: copies, conversion, sums
constexpr int kThreads = kConsumerThreads + kTransformThreads;
constexpr int kTransformWarps = kTransformThreads / 32;
constexpr int kColSlots = 8;  // docs' row maxima waiting for their sums
constexpr float kNegInf = -1e30f;
constexpr int kSmemLimit = 227 * 1024;  // the H100's shared memory per block

template <int KSTEPS>
struct Cfg {
  static constexpr int D = KSTEPS * 16;
  static constexpr int MT = KSTEPS <= 8 ? 2 : 1;  // 64-column m-tiles per warpgroup
  static constexpr int kCols = 2 * MT * 64;        // query columns per block
  static constexpr int kAtoms = (D + 63) / 64;     // 128-byte swizzle atoms per row
  static constexpr int kTileBytes = kAtoms * kChunkRows * 128;
  static constexpr int kRawBytes = kChunkRows * D;  // a copied stage: the chunk's int8 rows
  static constexpr int kRawPerWarp = kAtoms <= 2 ? 2 : 1;  // copies in flight per warp
  static constexpr int kRawStages = kTransformWarps * kRawPerWarp;
  static constexpr int kVecs = kChunkRows * KSTEPS;  // 16-byte int8 pieces per chunk
  static constexpr int kVecsPerLane = kVecs / 32;
  // pieces a lane holds in registers at once: the whole chunk at D <= 128,
  // so its stage is refilled before the conversion; wider rows in passes
  static constexpr int kPasses = (kVecsPerLane + 15) / 16;
  static constexpr int kHeld = kVecsPerLane / kPasses;
  // tile stages: as many as fit, at most 10
  static constexpr int kStageBytes = kTileBytes + 2 * 8;
  static constexpr int kRest = kRawStages * (kRawBytes + 8) + kColSlots * (kCols * 4 + 8 + 2 * 8) +
                               8 + 8 + 1024;  // + the published count, `done`, alignment
  static constexpr int kFit = (kSmemLimit - kRest) / kStageBytes;
  static constexpr int kTileStages = kFit < 10 ? kFit : 10;
  static constexpr int kRawOff = kTileStages * kTileBytes;
  static constexpr int kColOff = kRawOff + kRawStages * kRawBytes;
  static constexpr int kDocOff = kColOff + kColSlots * kCols * 4;
  static constexpr int kScaleOff = kDocOff + kColSlots * 4;
  static constexpr int kBarOff = kScaleOff + kColSlots * 4 + 8;  // + the published count
  static constexpr int kBytes =
      kBarOff + (kRawStages + 2 * kTileStages + 2 * kColSlots + 1) * 8 + 1024;  // + alignment
  static_assert(kPasses * kHeld == kVecsPerLane, "passes split a lane's pieces evenly");
  // a warp waits on a stage's `tile_empty` by parity alone, knowing only
  // that the stage of its own previous chunk, four live chunks back, was
  // released: with fewer stages than warps a phase of the same parity
  // could pass the wait
  static_assert(kTileStages >= kTransformWarps, "a stage's phases would alias by parity");
  static_assert(kBarOff % 8 == 0, "mbarriers are 8-byte aligned");
  static_assert(kBytes <= kSmemLimit, "over the H100's shared memory per block");
};
// Warp w sums the docs published to slots w, w + 4, ...: every use of a
// slot by one warp, in order, so its col_full phases cannot alias.
static_assert(kColSlots % kTransformWarps == 0, "a slot summed by two warps");

template <int KSTEPS>
__global__ void __launch_bounds__(kThreads, 1)
maxsim_int8_doc_kernel(const __nv_bfloat16* __restrict__ q,  // (B*Lq, D)
                       const int8_t* __restrict__ emb,        // (N*L, D)
                       const float* __restrict__ doc_scales,  // (N,)
                       const int* __restrict__ lengths,       // (N,)
                       float* __restrict__ out,               // (B, N)
                       int lq, int batch, int n_docs, int doc_len, int docs_per_block,
                       int queries_per_tile, int seg0, int seg_len, int accumulate,
                       int last_segment) {
  using C = Cfg<KSTEPS>;
  constexpr int D = C::D, MT = C::MT;
  extern __shared__ unsigned char smem_raw[];
  // 1024-byte aligned for the swizzled tiles, by an offset from smem_raw so
  // that the compiler keeps shared-memory loads and stores (not generic ones)
  unsigned char* smem = smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u);
  unsigned char* s_tile = smem;                 // [stages][atoms][64][128 B]
  unsigned char* s_raw = smem + C::kRawOff;     // [raw stages][64][D] int8
  float* s_col = reinterpret_cast<float*>(smem + C::kColOff);          // [slots][kCols]
  int* s_col_doc = reinterpret_cast<int*>(smem + C::kDocOff);          // [slots]
  float* s_col_scale = reinterpret_cast<float*>(smem + C::kScaleOff);  // [slots]
  int* s_published = reinterpret_cast<int*>(s_col_scale + kColSlots);
  uint64_t* raw_full = reinterpret_cast<uint64_t*>(smem + C::kBarOff);
  uint64_t* tile_full = raw_full + C::kRawStages;
  uint64_t* tile_empty = tile_full + C::kTileStages;
  uint64_t* col_full = tile_empty + C::kTileStages;
  uint64_t* col_empty = col_full + kColSlots;
  uint64_t* done = col_empty + kColSlots;  // the consumers have published every doc
  if (threadIdx.x == 0) {
    for (int p = 0; p < C::kRawStages; ++p) mbar_init(&raw_full[p], 1);
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
  // a doc's 64-row chunks, the last one 32 rows where L % 64 == 32
  const int chunks_per_doc = (doc_len + kChunkRows - 1) / kChunkRows;
  const int d0 = blockIdx.x * docs_per_block;
  const int d1 = min(n_docs, d0 + docs_per_block);

  if (threadIdx.x >= kConsumerThreads) {
    // ---- transform warpgroup: four independent warps; warp w copies and
    // converts the live chunks w, w + 4, w + 8, ... of the block's range
    // and sums the published docs w, w + 4, ... (no barrier among the
    // warps) -----------------------------------------------------------
    const int tw = (threadIdx.x - kConsumerThreads) >> 5;
    const int lane = threadIdx.x & 31;

    // Live chunks in order, 32 (doc, chunk) pairs at a time: lane i tests
    // pair base + i (doc = pair / chunks_per_doc) and a ballot gives the
    // window's live pairs, consumed lowest first.
    struct Scan {
      int base;        // the window's first pair
      uint32_t live;   // its live pairs not yet taken
      int doc, chunk;  // the pair taken last
    };
    const int pair_end = d1 * chunks_per_doc;
    auto split = [&](int pr, int& doc, int& chunk) {
      doc = chunks_per_doc == 1 ? pr : pr / chunks_per_doc;
      chunk = pr - doc * chunks_per_doc;
    };
    // a zero-length doc in the window gets its zero scores from warp
    // doc % 4, in the first column segment
    auto load = [&](Scan& c) {
      const int pr = c.base + lane;
      bool live = false;
      if (pr < pair_end) {
        int doc, chunk;
        split(pr, doc, chunk);
        const int len = lengths[doc];
        live = chunk * kChunkRows < len;
        if (len <= 0 && chunk == 0 && !accumulate && (doc & 3) == tw)
          for (int qq = 0; qq < n_queries; ++qq) out[(size_t)(q0 + qq) * n_docs + doc] = 0.f;
      }
      c.live = __ballot_sync(0xffffffffu, live);
    };
    // -> the next live chunk, if any
    auto next_live = [&](Scan& c) {
      while (c.live == 0) {
        c.base += 32;
        if (c.base >= pair_end) return false;
        load(c);
      }
      split(c.base + __ffs(c.live) - 1, c.doc, c.chunk);
      c.live &= c.live - 1;
      return true;
    };
    auto skip = [&](Scan& c, int n) {
      bool more = true;
      for (int i = 0; i < n && more; ++i) more = next_live(c);
      return more;
    };

    // Lane 0 keeps this warp's bulk copies kRawPerWarp of its chunks
    // ahead; the chunk index of each copy in flight waits in q_chunk,
    // oldest first, for its conversion.
    Scan cp{d0 * chunks_per_doc, 0u, 0, 0};
    load(cp);
    bool cp_more = skip(cp, tw + 1);
    int issued = 0;
    int q_chunk[C::kRawPerWarp];
    auto copy_next = [&](int& chunk) {
      if (!cp_more) return;
      const int p = tw * C::kRawPerWarp + issued % C::kRawPerWarp;
      if (lane == 0) {
        const uint32_t bytes = min(kChunkRows, doc_len - cp.chunk * kChunkRows) * D;
        mbar_arrive_expect_tx(&raw_full[p], bytes);
        bulk_copy_g2s(s_raw + p * C::kRawBytes,
                      emb + ((size_t)cp.doc * doc_len + (size_t)cp.chunk * kChunkRows) * D,
                      bytes, &raw_full[p]);
      }
      chunk = cp.chunk;
      ++issued;
      cp_more = skip(cp, kTransformWarps);
    };
#pragma unroll
    for (int j = 0; j < C::kRawPerWarp; ++j) copy_next(q_chunk[j]);

    // published docs' sums, in a fixed order: each query's columns split
    // over `lanes` lanes (a power of two), each adding its share in
    // ascending order, then an xor tree; the last column segment
    // multiplies the whole sum by the doc scale
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
        const float scale = s_col_scale[k];  // 1 but in the last column segment
        for (int q_base = 0; q_base < n_queries; q_base += 32 / lanes) {
          const int qq = q_base + lane / lanes;
          float v = 0.f;
          if (qq < n_queries)
            for (int i = c_lo; i < c_hi; ++i) v += cols[qq * seg_len + i];
          for (int o = 1; o < lanes; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
          if (qq < n_queries && part == 0) {
            const size_t o = (size_t)(q0 + qq) * n_docs + doc;
            out[o] = (accumulate ? v + load_volatile(out + o) : v) * scale;
          }
        }
        mbar_arrive(&col_empty[k]);
        summed += kTransformWarps;
      }
    };

    // the copy after this warp's reads of stage p: each lane's proxy fence
    // orders its plain reads before the async proxy's writes, and the warp
    // barrier puts every lane's fence before lane 0's copy (without it, a
    // refill from L2 may overwrite a stage before it is read)
    auto refill = [&]() {
      fence_proxy_async();
      __syncwarp();
#pragma unroll
      for (int j = 0; j + 1 < C::kRawPerWarp; ++j) q_chunk[j] = q_chunk[j + 1];
      copy_next(q_chunk[C::kRawPerWarp - 1]);
    };

    for (int local = 0; local < issued; ++local) {
      const int rows = min(kChunkRows, doc_len - q_chunk[0] * kChunkRows);
      const int vecs = rows * KSTEPS;  // 16-byte pieces of the chunk
      const int seq = local * kTransformWarps + tw;  // live chunk index in the block
      const int p = tw * C::kRawPerWarp + local % C::kRawPerWarp;
      mbar_wait(&raw_full[p], (local / C::kRawPerWarp) & 1);
      const uint4* src = reinterpret_cast<const uint4*>(s_raw + p * C::kRawBytes);
      uint4 pre[C::kHeld];
      auto load_rows = [&](int pass) {
#pragma unroll
        for (int v = 0; v < C::kHeld; ++v) {
          const int idx = lane + 32 * (pass * C::kHeld + v);
          if (idx < vecs) pre[v] = src[idx];
        }
      };
      load_rows(0);
      if constexpr (C::kPasses == 1) refill();

      const int s = seq % C::kTileStages;
      mbar_wait(&tile_empty[s], ((seq / C::kTileStages) & 1) ^ 1);
      unsigned char* tile = s_tile + s * C::kTileBytes;
      // -> bf16 rows in the 128-byte-swizzle layout; a 32-row chunk's rows
      // go to both halves of the tile (row r + 32 swizzles as row r)
      auto store = [&](int pass) {
#pragma unroll
        for (int v = 0; v < C::kHeld; ++v) {
          const int idx = lane + 32 * (pass * C::kHeld + v);
          if (idx < vecs) {
            const int r = idx / KSTEPS;
            const int kv = idx - r * KSTEPS;  // features 16 kv .. 16 kv + 15
            const uint2 a = s8x4_to_bf16x4(pre[v].x);
            const uint2 b = s8x4_to_bf16x4(pre[v].y);
            const uint2 c = s8x4_to_bf16x4(pre[v].z);
            const uint2 e = s8x4_to_bf16x4(pre[v].w);
            const uint4 lo = make_uint4(a.x, a.y, b.x, b.y), hi = make_uint4(c.x, c.y, e.x, e.y);
            unsigned char* atom = tile + (kv >> 2) * (kChunkRows * 128);
            const int piece = (2 * kv) & 7;
            *reinterpret_cast<uint4*>(atom + sw128_offset(r, piece)) = lo;
            *reinterpret_cast<uint4*>(atom + sw128_offset(r, piece + 1)) = hi;
            if (rows == kHalfRows) {
              *reinterpret_cast<uint4*>(atom + sw128_offset(r + kHalfRows, piece)) = lo;
              *reinterpret_cast<uint4*>(atom + sw128_offset(r + kHalfRows, piece + 1)) = hi;
            }
          }
        }
      };
      store(0);
#pragma unroll
      for (int pass = 1; pass < C::kPasses; ++pass) {
        load_rows(pass);
        store(pass);
      }
      if constexpr (C::kPasses > 1) refill();
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
    // ---- consumer warpgroups: products and row maxima ------------------
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
    float next_scale = doc_scales[d0];
    for (int doc = d0; doc < d1; ++doc) {
      const int len = next_len;
      const float scale = next_scale;
      if (doc + 1 < d1) {
        next_len = lengths[doc + 1];
        next_scale = doc_scales[doc + 1];
      }
      // the chunks that start before the length; the rest hold copies
      const int n_live = len <= 0 ? 0 : min(chunks_per_doc, (len + kChunkRows - 1) / kChunkRows);
      if (n_live == 0) continue;
      float run[MT][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) run[mt][0] = run[mt][1] = kNegInf;
      for (int chunk = 0; chunk < n_live; ++chunk, ++seq) {
        const int s = seq % C::kTileStages;
        mbar_wait(&tile_full[s], (seq / C::kTileStages) & 1);
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
        // column 8j + 2t + e of row h: the max of the thread's 16 columns
        // folded into the running max
        auto fold = [&](int mt) {
#pragma unroll
          for (int i = 0; i < 32; ++i) fence_reg(acc[mt][i]);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float m[8];
#pragma unroll
            for (int j = 0; j < 8; ++j) m[j] = fmaxf(acc[mt][4 * j + 2 * h], acc[mt][4 * j + 2 * h + 1]);
#pragma unroll
            for (int w = 4; w > 0; w >>= 1)
#pragma unroll
              for (int j = 0; j < w; ++j) m[j] = fmaxf(m[j], m[j + w]);
            run[mt][h] = fmaxf(run[mt][h], m[0]);
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
      if (threadIdx.x == 0) {
        s_col_doc[k] = doc;
        s_col_scale[k] = last_segment ? scale : 1.f;
      }
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
cudaError_t launch_k(const void* q, const void* emb, const void* doc_scales,
                     const void* lengths, void* out, int batch, int lq, int n_docs,
                     int doc_len, int sms, cudaStream_t stream) {
  using C = Cfg<K>;
  cudaError_t err = cudaFuncSetAttribute(
      maxsim_int8_doc_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kBytes);
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
    maxsim_int8_doc_kernel<K><<<grid, kThreads, C::kBytes, stream>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const int8_t*>(emb),
        static_cast<const float*>(doc_scales), static_cast<const int*>(lengths),
        static_cast<float*>(out), lq, batch, n_docs, doc_len, dpb, qpt, seg0, seg_len, s > 0,
        s == segments - 1);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

// Launches on `stream`; returns the first nonzero CUDA error (0 on
// success). q: (batch*lq, dim) bf16; emb: (n_docs*doc_len, dim) int8,
// 16-byte aligned; doc_scales: (n_docs,) fp32; lengths: (n_docs,) int32;
// out: (batch, n_docs) fp32.
extern "C" int maxsim_int8_doc_launch(const void* q, const void* emb,
                                      const void* doc_scales, const void* lengths,
                                      void* out, int batch, int lq, int dim,
                                      int n_docs, int doc_len, void* stream) {
  if (dim < 16 || dim > 256 || dim % 16 != 0 || doc_len <= 0 || doc_len % 32 != 0 ||
      lq <= 0 || lq > 256 || batch < 0 || n_docs < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0 || n_docs == 0) return 0;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
#define MAXSIM_INT8_DOC_CASE(K)                                                         \
  case K:                                                                               \
    err = launch_k<K>(q, emb, doc_scales, lengths, out, batch, lq, n_docs, doc_len, sms, \
                      s);                                                               \
    break;
  switch (dim / 16) {
    MAXSIM_INT8_DOC_CASE(1)
    MAXSIM_INT8_DOC_CASE(2)
    MAXSIM_INT8_DOC_CASE(3)
    MAXSIM_INT8_DOC_CASE(4)
    MAXSIM_INT8_DOC_CASE(5)
    MAXSIM_INT8_DOC_CASE(6)
    MAXSIM_INT8_DOC_CASE(7)
    MAXSIM_INT8_DOC_CASE(8)
    MAXSIM_INT8_DOC_CASE(9)
    MAXSIM_INT8_DOC_CASE(10)
    MAXSIM_INT8_DOC_CASE(11)
    MAXSIM_INT8_DOC_CASE(12)
    MAXSIM_INT8_DOC_CASE(13)
    MAXSIM_INT8_DOC_CASE(14)
    MAXSIM_INT8_DOC_CASE(15)
    MAXSIM_INT8_DOC_CASE(16)
  }
#undef MAXSIM_INT8_DOC_CASE
  return static_cast<int>(err);
}
