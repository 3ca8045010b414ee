// Full-scan MaxSim over a bf16 index for Hopper (sm_90a), plain C
// interface for ctypes. The fp32 entry point is maxsim_f32.cu.
//
// Replaces the TPU kernel hybrid_rag_colbertv2_tpu/ops/maxsim.py:
// _maxsim_kernel (called by maxsim_scores) on bf16 rows. Same function:
//
//   score[b, n] = sum_i max_j ( live(e[n, j]) ? q[b, i] . e[n, j] : -1e30 )
//
// over the doc's L stored rows j and the query's Lq rows i. A row is live
// iff some element has a nonzero exponent field (|x| >= 2^-126): the TPU
// kernel's nonzero-L1-norm test under XLA, which counts subnormal values
// as zero. The index builder zeroes padding rows; doc lengths are not
// read, so a nonzero row past a doc's length counts. The query is bf16,
// products and sums are fp32, each sum in a fixed order: two launches
// agree bit for bit. A doc with no live row scores -1e30 * Lq.
//
// Bound at the main path's shape (B=8, Lq=32, N_pad=100,096, L=128,
// D=128): the mask is by content, so every row is read, 3.28 GB, 0.98 ms
// at the H100 SXM's 3.35 TB/s, against ~0.83 TFLOP of products over the
// live 64-row chunks, ~0.84 ms at 989 TFLOP/s: bytes, with the tensor
// work close behind. So each role does one thing and none waits on work
// that is not its own:
//  * One block per SM over a contiguous doc range, three warpgroups. The
//    producer warp's lane 0 keeps TMA tensor copies (cp.async.bulk.tensor,
//    128-byte swizzle) of 64-row chunks in flight into a ring of tiles, as
//    far ahead as the ring allows. The rows land in the layout of the
//    wgmma B operand (atoms of 64 rows x 128 bytes, one per 64 features):
//    no thread loads, converts or stores them.
//  * Two consumer warpgroups hold the query as wgmma A fragments in
//    registers for the whole kernel (2 m-tiles of 64 query columns each
//    at D <= 128, so 256 columns: all 8 queries of the main path) and
//    multiply each chunk with wgmma.m64n64k16 bf16 -> fp32 as soon as it
//    lands, one commit group per m-tile.
//  * The three mask warps (the producer's warpgroup mates; warp w takes
//    chunks w, w + 3, ...) read each landed tile once: 8 lanes OR a row's
//    128 bytes of an atom (free of bank conflicts; the swizzle permutes
//    16-byte pieces only within a row, so the OR needs no unswizzling), a
//    ballot per 4 rows turns the exponent bits into the chunk's 64 row
//    factors, 1 for a live row and NaN for a masked one, and a flag: no
//    row live, some, or all 64. The consumers wait for them only before
//    the fold, so the mask never delays the tensor cores.
//  * With the query as A, doc row j of the chunk is accumulator column j:
//    each consumer thread multiplies its 16 columns by their factors and
//    folds them into a running max that starts at -1e30 (a NaN factor
//    drops out of fmaxf); where all 64 rows are live (at the main shape,
//    every doc's first chunk) the fold skips the multiply. The first
//    m-tile is folded while the second's products run. A chunk with no
//    live row is not folded: the exact skip.
//  * Consumers publish each doc's row maxima to a ring of slots; the mask
//    warps sum each query's maxima there (a fixed split over lanes and an
//    xor tree), so no consumer waits on a serial sum.
//  * mbarriers hand tiles, factors and slots between the roles; a stage
//    goes back to the producer once the consumers and its mask warp are
//    done with it (each mask lane fences the async proxy first). There is
//    no block-wide barrier after the set-up.
//
// The tensor maps are encoded on the host per launch, by
// cuTensorMapEncodeTiled found through the runtime's driver entry point
// (nothing links libcuda): the rows as an (N*L) x D bf16 tensor, boxes of
// 64 features x 64 rows, and of 64 x 32 for a doc's 32-row last chunk
// where L % 64 == 32, whose other 32 columns take NaN factors (no byte
// past the doc is read). Features past D in a box are out of bounds and
// land as zeros; the barrier counts the whole box.
//
// Takes any B (grid.y tiles the queries), L a multiple of 32, D a multiple
// of 16 up to 256 (above 128 one m-tile per warpgroup, 128 columns per
// block), Lq up to 256 (a query wider than the block's columns is scanned
// in column segments, one launch each, each segment's sum added in order)
// and any N. Needs emb 16-byte aligned.

#include <climits>
#include <cuda.h>
#include <cuda_bf16.h>
#include <type_traits>

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int kChunkRows = 64;             // doc rows per product (wgmma n)
constexpr int kAtomBytes = kChunkRows * 128;  // one swizzle atom: 64 rows x 64 features
constexpr int kConsumerThreads = 2 * 128;  // two warpgroups: products and maxima
constexpr int kProducerWarp = kConsumerThreads / 32;
constexpr int kMaskWarps = 3;              // the rest of the producer's warpgroup
constexpr int kThreads = kConsumerThreads + 32 + kMaskWarps * 32;
constexpr int kColSlots = 6;  // docs' row maxima waiting for their sums
constexpr int kNoneLive = 0, kSomeLive = 1, kAllLive = 2;  // a chunk's flag
constexpr float kNegInf = -1e30f;
constexpr int kSmemLimit = 227 * 1024;  // the H100's shared memory per block

template <int KSTEPS>
struct Cfg {
  static constexpr int D = KSTEPS * 16;
  static constexpr int MT = KSTEPS <= 8 ? 2 : 1;  // 64-column m-tiles per warpgroup
  static constexpr int kCols = 2 * MT * 64;        // query columns per block
  static constexpr int kAtoms = (D + 63) / 64;     // 128-byte swizzle atoms per row
  static constexpr int kTileBytes = kAtoms * kAtomBytes;
  // tile stages: as many as fit (13 at D = 128; a cap of 10 read 3-4%
  // slower on the H100)
  static constexpr int kStageBytes = kTileBytes + kChunkRows * 4 + 4 + 3 * 8;
  static constexpr int kRest = kColSlots * (kCols * 4 + 4 + 2 * 8) + 16 + 1024;  // + alignment
  static constexpr int kStages = (kSmemLimit - kRest) / kStageBytes;
  static constexpr int kFactorOff = kStages * kTileBytes;
  static constexpr int kLiveOff = kFactorOff + kStages * kChunkRows * 4;
  static constexpr int kColOff = kLiveOff + (kStages * 4 + 15) / 16 * 16;
  static constexpr int kDocOff = kColOff + kColSlots * kCols * 4;
  static constexpr int kBarOff = kDocOff + kColSlots * 4;
  static constexpr int kBytes =
      kBarOff + (3 * kStages + 2 * kColSlots) * 8 + 1024;  // + alignment
  // every parity-waited ring keeps at least as many stages as waiters
  static_assert(kStages >= kMaskWarps, "a stage's phases would alias by parity");
  static_assert(kBarOff % 8 == 0, "mbarriers are 8-byte aligned");
  static_assert(kBytes <= kSmemLimit, "over the H100's shared memory per block");
};
// Mask warp w sums the docs published to slots w, w + 3, ...: every use of
// a slot by one warp, in order, so its col_full phases cannot alias.
static_assert(kColSlots % kMaskWarps == 0, "a slot summed by two warps");

template <int KSTEPS>
__global__ void __launch_bounds__(kThreads, 1)
maxsim_bf16_kernel(const __grid_constant__ CUtensorMap rows64,  // boxes of 64 rows
                   const __grid_constant__ CUtensorMap rows32,  // boxes of 32 rows
                   const __nv_bfloat16* __restrict__ q,         // (B*Lq, D)
                   float* __restrict__ out,                     // (B, N)
                   int lq, int batch, int n_docs, int doc_len, int docs_per_block,
                   int queries_per_tile, int seg0, int seg_len, int accumulate) {
  using C = Cfg<KSTEPS>;
  constexpr int D = C::D, MT = C::MT;
  extern __shared__ unsigned char smem_raw[];
  // 1024-byte aligned for the swizzled tiles, by an offset from smem_raw so
  // that the compiler keeps shared-memory loads and stores (not generic ones)
  unsigned char* smem = smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u);
  unsigned char* s_tile = smem;                                      // [stages][atoms][64][128 B]
  float* s_factor = reinterpret_cast<float*>(smem + C::kFactorOff);  // [stages][64]
  int* s_live = reinterpret_cast<int*>(smem + C::kLiveOff);          // [stages]: kNoneLive ..
  float* s_col = reinterpret_cast<float*>(smem + C::kColOff);        // [slots][kCols]
  int* s_col_doc = reinterpret_cast<int*>(smem + C::kDocOff);        // [slots]
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::kBarOff);   // the tile landed
  uint64_t* masked = full + C::kStages;   // its factors are written
  uint64_t* empty = masked + C::kStages;  // its consumers and mask warp are done
  uint64_t* col_full = empty + C::kStages;
  uint64_t* col_empty = col_full + kColSlots;
  if (threadIdx.x == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(&full[s], 1);  // the producer's expect_tx
      mbar_init(&masked[s], 32);
      mbar_init(&empty[s], kConsumerThreads + 32);
    }
    for (int k = 0; k < kColSlots; ++k) {
      mbar_init(&col_full[k], kConsumerThreads);
      mbar_init(&col_empty[k], 32);
    }
    fence_mbar_init();
  }
  __syncthreads();

  const int q0 = blockIdx.y * queries_per_tile;
  const int n_queries = min(queries_per_tile, batch - q0);
  // a doc's 64-row chunks, the last one 32 rows where L % 64 == 32
  const int chunks_per_doc = (doc_len + kChunkRows - 1) / kChunkRows;
  auto chunk_rows = [&](int c) { return min(kChunkRows, doc_len - c * kChunkRows); };
  const int d0 = blockIdx.x * docs_per_block;
  const int d1 = min(n_docs, d0 + docs_per_block);
  const int n_chunks = (d1 - d0) * chunks_per_doc;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  if (warp == kProducerWarp) {
    // ---- producer: lane 0 keeps the ring's copies in flight ------------
    if (lane == 0) {
      prefetch_tensormap(&rows64);
      prefetch_tensormap(&rows32);
      int doc = d0, chunk = 0;
      for (int seq = 0; seq < n_chunks; ++seq) {
        const int s = seq % C::kStages;
        mbar_wait(&empty[s], ((seq / C::kStages) & 1) ^ 1);
        const int rows = chunk_rows(chunk);
        const void* map = rows == kChunkRows ? &rows64 : &rows32;
        const int row0 = doc * doc_len + chunk * kChunkRows;
        unsigned char* tile = s_tile + s * C::kTileBytes;
        mbar_arrive_expect_tx(&full[s], rows * 128 * C::kAtoms);
#pragma unroll
        for (int a = 0; a < C::kAtoms; ++a)
          tma_load_2d(tile + a * kAtomBytes, map, a * 64, row0, &full[s]);
        if (++chunk == chunks_per_doc) {
          chunk = 0;
          ++doc;
        }
      }
    }
  } else if (warp > kProducerWarp) {
    // ---- mask warps: warp w reads chunks w, w + 3, ... once each, and
    // sums the published docs w, w + 3, ... (no barrier among the warps) --
    const int mw = warp - kProducerWarp - 1;

    // published docs' sums, in a fixed order: each query's columns split
    // over `lanes` lanes (a power of two), each adding its share in
    // ascending order, then an xor tree
    int lanes = 32;
    while (lanes > 1 && n_queries * lanes > 32) lanes >>= 1;
    const int per_lane = (seg_len + lanes - 1) / lanes;
    const int part = lane & (lanes - 1);
    const int c_lo = min(seg_len, part * per_lane);
    const int c_hi = min(seg_len, c_lo + per_lane);
    int summed = mw;  // the next published doc (publication order) to sum
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
        summed += kMaskWarps;
      }
    };

    const float nan = __int_as_float(0x7fc00000);
    for (int seq = mw; seq < n_chunks; seq += kMaskWarps) {
      const int s = seq % C::kStages;
      const int rows = chunk_rows(seq % chunks_per_doc);
      mbar_wait(&full[s], (seq / C::kStages) & 1);
      // lanes 8r .. 8r + 7 read row 4i + r, 16 bytes each, of every atom
      const unsigned char* src = s_tile + s * C::kTileBytes + (lane >> 3) * 128 + (lane & 7) * 16;
      uint32_t live_lo = 0, live_hi = 0;  // bit r: row r (lo), row 32 + r (hi) is live
#pragma unroll
      for (int i = 0; i < kChunkRows / 4; ++i) {
        uint32_t nz = 0;
        if (4 * i < rows) {
#pragma unroll
          for (int a = 0; a < C::kAtoms; ++a) {
            const uint4 v = *reinterpret_cast<const uint4*>(src + a * kAtomBytes + i * 512);
            nz |= v.x | v.y | v.z | v.w;
          }
        }
        // some bf16 of the row with a nonzero exponent field: bits 0, 8,
        // 16, 24 of x after folding each lane octet of the ballot
        uint32_t x = __ballot_sync(0xffffffffu, (nz & 0x7f807f80u) != 0);
        x |= x >> 4;
        x |= x >> 2;
        x |= x >> 1;
        const uint32_t four = (x & 1u) | ((x >> 7) & 2u) | ((x >> 14) & 4u) | ((x >> 21) & 8u);
        if (i < 8) {
          live_lo |= four << (4 * i);
        } else {
          live_hi |= four << (4 * (i - 8));
        }
      }
      // this lane's reads of the tile before the refill that follows the
      // stage's release (the async proxy's writes)
      fence_proxy_async();
      s_factor[s * kChunkRows + lane] = (live_lo >> lane) & 1u ? 1.f : nan;
      s_factor[s * kChunkRows + lane + 32] = (live_hi >> lane) & 1u ? 1.f : nan;
      if (lane == 0)
        s_live[s] = (live_lo | live_hi) == 0 ? kNoneLive
                    : rows == kChunkRows && (live_lo & live_hi) == ~0u ? kAllLive
                                                                       : kSomeLive;
      mbar_arrive(&masked[s]);
      mbar_arrive(&empty[s]);
      drain(INT_MAX, false);
    }
    // every doc of the range is published once
    drain(d1 - d0, true);
  } else {
    // ---- consumer warpgroups: products, factors, row maxima ------------
    const int wg = threadIdx.x >> 7;
    const int wwarp = warp & 3;  // warp in its warpgroup
    const int g = lane >> 2, t = lane & 3;
    const int tile_cols = n_queries * seg_len;  // tile column c: query c / seg_len

    // this thread's query rows (A fragments) for the whole kernel; rows
    // past the tile are zero
    uint32_t a[MT][KSTEPS][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = (wg * MT + mt) * 64 + 16 * wwarp + g + 8 * h;
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
    int seq = 0;
    for (int doc = d0; doc < d1; ++doc) {
      float run[MT][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) run[mt][0] = run[mt][1] = kNegInf;
      for (int chunk = 0; chunk < chunks_per_doc; ++chunk, ++seq) {
        const int s = seq % C::kStages;
        const uint32_t parity = (seq / C::kStages) & 1;
        mbar_wait(&full[s], parity);
        const unsigned char* tile = s_tile + s * C::kTileBytes;
        // one group per m-tile: the first m-tile's maxima are folded while
        // the second's products run
        wgmma_fence();
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
          for (int ks = 0; ks < KSTEPS; ++ks) {
            const uint64_t desc = desc_k_sw128(tile + (ks >> 2) * kAtomBytes + (ks & 3) * 32);
            wgmma_m64n64k16_rs(acc[mt], a[mt][ks], desc, ks > 0);
          }
          wgmma_commit();
        }
        // the mask, only now: the products did not wait for it
        mbar_wait(&masked[s], parity);
        const int live = s_live[s];
        if (live == kNoneLive) {  // every row masked: no product can change the max
          wgmma_wait<0>();
          mbar_arrive(&empty[s]);
          continue;
        }
        // the factors of the thread's columns 8j + 2t, 8j + 2t + 1
        float2 f[8];
        const float2* fs = reinterpret_cast<const float2*>(s_factor + s * kChunkRows) + t;
#pragma unroll
        for (int j = 0; j < 8; ++j) f[j] = fs[4 * j];
        // column 8j + 2t + e of row h, times its row's factor where some
        // row is masked, the max of the thread's 16 columns folded into
        // the running max (a NaN factor, a masked row's, drops out of
        // every fmaxf)
        auto fold = [&](int mt, auto scaled) {
#pragma unroll
          for (int i = 0; i < 32; ++i) fence_reg(acc[mt][i]);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float m[8];
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              const float x = acc[mt][4 * j + 2 * h], y = acc[mt][4 * j + 2 * h + 1];
              if constexpr (decltype(scaled)::value) {
                m[j] = fmaxf(x * f[j].x, y * f[j].y);
              } else {
                m[j] = fmaxf(x, y);
              }
            }
#pragma unroll
            for (int w = 4; w > 0; w >>= 1)
#pragma unroll
              for (int j = 0; j < w; ++j) m[j] = fmaxf(m[j], m[j + w]);
            run[mt][h] = fmaxf(run[mt][h], m[0]);
          }
        };
        if (live == kAllLive) {  // every factor is 1
          if constexpr (MT == 2) {
            wgmma_wait<1>();
            fold(0, std::false_type());
          }
          wgmma_wait<0>();
          mbar_arrive(&empty[s]);
          fold(MT - 1, std::false_type());
          continue;
        }
        if constexpr (MT == 2) {
          wgmma_wait<1>();
          fold(0, std::true_type());
        }
        wgmma_wait<0>();
        mbar_arrive(&empty[s]);
        fold(MT - 1, std::true_type());
      }
      // the row max over the four threads that share a row, published to
      // the mask warps' sums
      const int published = doc - d0;
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
          if (t == 0) cols[(wg * MT + mt) * 64 + 16 * wwarp + g + 8 * h] = m;
        }
      }
      if (threadIdx.x == 0) s_col_doc[k] = doc;
      mbar_arrive(&col_full[k]);
    }
  }
}

// cuTensorMapEncodeTiled, from the driver through the runtime (CUDA 12.5
// or later)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The rows as a (rows) x dim bf16 tensor, boxes of 64 features x box_rows
// rows in the 128-byte swizzle layout. -> 0 on success, else the driver's
// error (or cudaErrorSymbolNotFound without the entry point)
int encode_rows(CUtensorMap* map, const void* emb, int dim, long long rows, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(dim), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(dim) * 2};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t steps[2] = {1, 1};
  return static_cast<int>(encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(emb),
                                 dims, strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
                                 CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                                 CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE));
}

template <int K>
int launch_k(const void* q, const void* emb, void* out, int batch, int lq, int n_docs,
             int doc_len, int sms, cudaStream_t stream) {
  using C = Cfg<K>;
  CUtensorMap rows64, rows32;
  const long long rows = static_cast<long long>(n_docs) * doc_len;
  int rc = encode_rows(&rows64, emb, K * 16, rows, kChunkRows);
  if (rc == 0) rc = encode_rows(&rows32, emb, K * 16, rows, kChunkRows / 2);
  if (rc != 0) return rc;
  cudaError_t err = cudaFuncSetAttribute(
      maxsim_bf16_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
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
    maxsim_bf16_kernel<K><<<grid, kThreads, C::kBytes, stream>>>(
        rows64, rows32, static_cast<const __nv_bfloat16*>(q), static_cast<float*>(out), lq,
        batch, n_docs, doc_len, dpb, qpt, seg0, seg_len, s > 0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

}  // namespace

// Launches on `stream`; returns the first nonzero error, CUDA's or the
// tensor map encoder's (0 on success). q: (batch*lq, dim) bf16; emb:
// (n_docs*doc_len, dim) bf16, 16-byte aligned; out: (batch, n_docs) fp32.
extern "C" int maxsim_bf16_launch(const void* q, const void* emb, void* out, int batch, int lq,
                                  int dim, int n_docs, int doc_len, void* stream) {
  if (dim < 16 || dim > 256 || dim % 16 != 0 || doc_len <= 0 || doc_len % 32 != 0 ||
      lq <= 0 || lq > 256 || batch < 0 || n_docs < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0 || n_docs == 0) return 0;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc = static_cast<int>(cudaErrorInvalidValue);
#define MAXSIM_BF16_CASE(K)                                                  \
  case K:                                                                    \
    rc = launch_k<K>(q, emb, out, batch, lq, n_docs, doc_len, sms, s);       \
    break;
  switch (dim / 16) {
    MAXSIM_BF16_CASE(1)
    MAXSIM_BF16_CASE(2)
    MAXSIM_BF16_CASE(3)
    MAXSIM_BF16_CASE(4)
    MAXSIM_BF16_CASE(5)
    MAXSIM_BF16_CASE(6)
    MAXSIM_BF16_CASE(7)
    MAXSIM_BF16_CASE(8)
    MAXSIM_BF16_CASE(9)
    MAXSIM_BF16_CASE(10)
    MAXSIM_BF16_CASE(11)
    MAXSIM_BF16_CASE(12)
    MAXSIM_BF16_CASE(13)
    MAXSIM_BF16_CASE(14)
    MAXSIM_BF16_CASE(15)
    MAXSIM_BF16_CASE(16)
  }
#undef MAXSIM_BF16_CASE
  return rc;
}
