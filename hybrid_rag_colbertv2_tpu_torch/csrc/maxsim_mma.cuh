// Body of the port's mma.sync MaxSim scan for Hopper (sm_90a), now the
// bf16 entry point of maxsim.cu alone (the other layouts' scans have wgmma
// kernels of their own on sm90.cuh). It computes
//
//   score[b, n] = sum_i max_j  v(q[b, i] . e[n, j])
//
// over the doc's L token rows j and the query's Lq rows i, where q and e
// are bf16, products and sums are fp32, and v() is the layout's row rule
// (bf16, row mask m_j: v = m_j ? x : -1e30).
//
// Structure (first written for the int8 layout, now scanned by
// maxsim_int8.cu):
//  * A block owns a tile of up to 256 query-token columns (whole queries)
//    and walks docs with a grid stride. Each of its 8 warps owns 32
//    columns and keeps their bf16 query fragments in registers for the
//    whole kernel, so the query is read once per block, not per doc.
//  * A doc's rows move 64 at a time (32 in a doc's last chunk where
//    L % 64 == 32: the layout stages the absent rows as zeros, which the
//    bf16 mask drops, and no row past the doc is read). Each thread loads
//    its share of the next chunk (16-byte loads) into registers while the
//    block computes on the current one; the layout's Stage writes it to
//    shared memory as bf16 (double buffered, rows
//    padded by 16 bytes so ldmatrix reads hit distinct banks), with one
//    fp32 factor per row beside it. One barrier per chunk.
//  * Warps read A fragments with ldmatrix and multiply with mma.sync
//    m16n8k16 bf16 -> fp32, skipping 16-row tiles that cannot change the
//    max (all rows masked). v() is applied to the fp32 accumulators and
//    folded into a running per-column max in registers, so the (rows x
//    columns) similarity block never leaves registers.
//  * After a doc's last chunk, warp shuffles finish the max over rows,
//    and one thread per query sums its Lq column maxima in ascending
//    column order (deferred one chunk, double-buffered, to share the next
//    barrier). Every output is written by one thread, with no atomics:
//    results are deterministic.
//
// Takes any B (grid.y tiles the columns), L a multiple of 32, D a multiple
// of 16 up to 256, Lq up to 256, and any N.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace maxsim {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kColsPerWarp = 32;
constexpr int kNTiles = kColsPerWarp / 8;          // mma n = 8
constexpr int kTileCols = kWarps * kColsPerWarp;   // 256 columns per block
constexpr int kChunkRows = 64;                     // doc rows per step
constexpr int kMTiles = kChunkRows / 16;           // mma m = 16
constexpr float kNegInf = -1e30f;

template <int D>
struct Smem {
  static constexpr int kRowStride = D + 8;  // bf16 elements (+16 bytes)
  static constexpr int kRowsBytes = 2 * kChunkRows * kRowStride * 2;
  static constexpr int kScaleBytes = 2 * kChunkRows * 4;
  static constexpr int kColmaxBytes = 2 * kTileCols * 4;
  static constexpr int kBytes = kRowsBytes + kScaleBytes + kColmaxBytes;
};

// The index operands the layout reads.
struct Operands {
  const void* emb;  // (N*L, D) rows
};

__device__ __forceinline__ void ldmatrix_x4(uint32_t a[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
}

// D(16x8, fp32) += A(16x16, bf16, row) * B(16x8, bf16, col)
__device__ __forceinline__ void mma_bf16_16816(float c[4], const uint32_t a[4],
                                               const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Layout interface:
//   static constexpr bool kRowScale;     // v() reads a per-row factor
//   static constexpr bool kMaskZero;     // a factor of 0 masks the row
//   template <int D> struct Stage {
//     // registers <- the chunk's first `rows` rows (64, or 32 at a doc's
//     // end) from device memory, and zeros for the rest
//     __device__ void fetch(const Operands&, int n_docs, int doc_len,
//                           int doc, int chunk, int rows);
//     // shared memory <- 64 bf16 rows (row stride D + 8) and 64 factors
//     __device__ void store(__nv_bfloat16* rows, float* factors);
//   };
// kTail: L % 64 == 32, so a doc's last chunk is 32 rows. Without it every
// chunk is 64 rows at compile time, and the staging code is that of whole
// chunks alone (a runtime row count there slowed the then mma.sync
// int8-doc scan by a tenth at the main path's shape).
template <class Layout, int KSTEPS, bool kTail>
__global__ void __launch_bounds__(kThreads)
maxsim_mma_kernel(const __nv_bfloat16* __restrict__ q,  // (B*Lq, D)
                  Operands op,
                  float* __restrict__ out,               // (B, N)
                  int n_cols, int lq, int n_docs, int doc_len,
                  int queries_per_tile) {
  constexpr int D = KSTEPS * 16;
  using S = Smem<D>;
  constexpr int kRowStride = S::kRowStride;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* s_rows = reinterpret_cast<__nv_bfloat16*>(smem);
  float* s_scale = reinterpret_cast<float*>(smem + S::kRowsBytes);
  float* s_colmax = reinterpret_cast<float*>(smem + S::kRowsBytes + S::kScaleBytes);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // mma group id: fragment row / column
  const int t = lane & 3;   // thread in group
  const int q0 = blockIdx.y * queries_per_tile;
  const int col0 = q0 * lq;
  const int tile_cols = min(queries_per_tile * lq, n_cols - col0);
  const int n_queries = tile_cols / lq;
  const bool warp_live = warp * kColsPerWarp < tile_cols;

  // B fragments of this warp's 32 columns over all of D, kept in registers.
  // b[0] = q[col][k0 + 2t .. +1], b[1] = q[col][k0 + 8 + 2t .. +1].
  uint32_t bfrag[kNTiles][KSTEPS][2];
#pragma unroll
  for (int nt = 0; nt < kNTiles; ++nt) {
    const int col = warp * kColsPerWarp + nt * 8 + g;
    const bool live = col < tile_cols;
    const uint32_t* src =
        reinterpret_cast<const uint32_t*>(q + (size_t)(col0 + (live ? col : 0)) * D);
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
      bfrag[nt][ks][0] = live ? src[ks * 8 + t] : 0u;
      bfrag[nt][ks][1] = live ? src[ks * 8 + 4 + t] : 0u;
    }
  }

  // this block's work: its docs (grid stride) x the doc's 64-row chunks,
  // the last one 32 rows where L % 64 == 32
  const int chunks_per_doc = (doc_len + kChunkRows - 1) / kChunkRows;
  const int my_docs = (n_docs - blockIdx.x + gridDim.x - 1) / gridDim.x;
  const int n_items = my_docs * chunks_per_doc;
  auto doc_of = [&](int item) {
    return blockIdx.x + (item / chunks_per_doc) * gridDim.x;
  };
  typename Layout::template Stage<D> stage;
  auto fetch = [&](int item) {
    const int chunk = item % chunks_per_doc;
    stage.fetch(op, n_docs, doc_len, doc_of(item), chunk,
                kTail ? min(kChunkRows, doc_len - chunk * kChunkRows) : kChunkRows);
  };

  // ldmatrix x4 lane address: matrices (rows 0-7 | 8-15) x (cols 0-7 | 8-15)
  const int lm_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int lm_col = (lane >> 4) * 8;

  float cmax[kNTiles][2];
#pragma unroll
  for (int nt = 0; nt < kNTiles; ++nt) cmax[nt][0] = cmax[nt][1] = kNegInf;
  int pend_doc = -1;  // doc whose column maxima wait in s_colmax to be summed
  int pend_buf = 0;

  // one thread per query sums its Lq column maxima in ascending order
  auto write_sum = [&]() {
    if (threadIdx.x < n_queries) {
      const float* cm = s_colmax + pend_buf * kTileCols + threadIdx.x * lq;
      float s = 0.f;
      for (int i = 0; i < lq; ++i) s += cm[i];
      out[(size_t)(q0 + threadIdx.x) * n_docs + pend_doc] = s;
    }
  };

  if (n_items > 0) fetch(0);
  for (int it = 0; it < n_items; ++it) {
    const int buf = it & 1;
    const int doc_seq = it / chunks_per_doc;
    const int doc = doc_of(it);
    const int chunk = it - doc_seq * chunks_per_doc;
    const bool last_chunk = chunk == chunks_per_doc - 1;
    __nv_bfloat16* rows = s_rows + buf * kChunkRows * kRowStride;
    float* sc = s_scale + buf * kChunkRows;

    // buffer buf was last read two chunks ago, before the previous barrier
    stage.store(rows, sc);
    if (it + 1 < n_items) fetch(it + 1);
    __syncthreads();

    if (pend_doc >= 0) {  // the previous doc's per-query sums
      write_sum();
      pend_doc = -1;
    }

    if (warp_live) {
#pragma unroll
      for (int mt = 0; mt < kMTiles; ++mt) {
        // tiles that cannot change the max are skipped (warp-uniform):
        // all 16 rows masked
        if (Layout::kMaskZero &&
            !__any_sync(0xffffffffu, sc[mt * 16 + (lane & 15)] > 0.f))
          continue;
        float acc[kNTiles][4];
#pragma unroll
        for (int nt = 0; nt < kNTiles; ++nt)
          acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
        const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(
            rows + (mt * 16 + lm_row) * kRowStride + lm_col));
#pragma unroll
        for (int ks = 0; ks < KSTEPS; ++ks) {
          uint32_t a[4];
          ldmatrix_x4(a, base + ks * 16 * 2);
#pragma unroll
          for (int nt = 0; nt < kNTiles; ++nt) mma_bf16_16816(acc[nt], a, bfrag[nt][ks]);
        }
        // acc[nt][j] is row g, acc[nt][2 + j] row g + 8; column 2t + j
        const float s_lo = Layout::kRowScale ? sc[mt * 16 + g] : 1.f;
        const float s_hi = Layout::kRowScale ? sc[mt * 16 + g + 8] : 1.f;
#pragma unroll
        for (int nt = 0; nt < kNTiles; ++nt) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            float v_lo = acc[nt][j], v_hi = acc[nt][2 + j];
            if (Layout::kRowScale) {
              v_lo *= s_lo;
              v_hi *= s_hi;
            }
            if (Layout::kMaskZero) {
              v_lo = s_lo > 0.f ? v_lo : kNegInf;
              v_hi = s_hi > 0.f ? v_hi : kNegInf;
            }
            cmax[nt][j] = fmaxf(cmax[nt][j], fmaxf(v_lo, v_hi));
          }
        }
      }
    }

    if (last_chunk) {
      // max over the 8 row groups (lanes that share t), then publish; the
      // sums run after the next barrier
      pend_buf = doc_seq & 1;
#pragma unroll
      for (int nt = 0; nt < kNTiles; ++nt) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float m = cmax[nt][j];
          m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 4));
          m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 8));
          m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 16));
          if (g == 0)
            s_colmax[pend_buf * kTileCols + warp * kColsPerWarp + nt * 8 + 2 * t + j] = m;
          cmax[nt][j] = kNegInf;
        }
      }
      pend_doc = doc;
    }
  }
  __syncthreads();
  if (pend_doc >= 0) write_sum();
}

template <class Layout, int K, bool kTail>
cudaError_t launch_k(dim3 grid, cudaStream_t s, const void* q, Operands op,
                     void* out, int n_cols, int lq, int n_docs, int doc_len,
                     int qpt) {
  constexpr int bytes = Smem<K * 16>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      maxsim_mma_kernel<Layout, K, kTail>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return err;
  maxsim_mma_kernel<Layout, K, kTail><<<grid, kThreads, bytes, s>>>(
      static_cast<const __nv_bfloat16*>(q), op, static_cast<float*>(out),
      n_cols, lq, n_docs, doc_len, qpt);
  return cudaSuccess;
}

// Checks the shape, picks the grid and launches on `stream`; returns the
// launch's cudaGetLastError() (0 on success). q: (batch*lq, dim) bf16;
// out: (batch, n_docs) fp32.
template <class Layout>
int launch_mma(const void* q, Operands op, void* out, int batch, int lq,
               int dim, int n_docs, int doc_len, void* stream) {
  if (dim < 16 || dim > 256 || dim % 16 != 0 || doc_len <= 0 ||
      doc_len % 32 != 0 || lq <= 0 || lq > kTileCols || batch < 0 ||
      n_docs < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0 || n_docs == 0) return 0;
  const int qpt = kTileCols / lq;
  const int n_cols = batch * lq;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int grid_x = n_docs < sms * 8 ? n_docs : sms * 8;
  const dim3 grid(grid_x, (batch + qpt - 1) / qpt);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSuccess;
#define MAXSIM_MMA_CASE(K)                                                    \
  case K:                                                                     \
    err = doc_len % kChunkRows                                                \
              ? launch_k<Layout, K, true>(grid, s, q, op, out, n_cols, lq,    \
                                          n_docs, doc_len, qpt)               \
              : launch_k<Layout, K, false>(grid, s, q, op, out, n_cols, lq,   \
                                           n_docs, doc_len, qpt);             \
    break;
  switch (dim / 16) {
    MAXSIM_MMA_CASE(1)
    MAXSIM_MMA_CASE(2)
    MAXSIM_MMA_CASE(3)
    MAXSIM_MMA_CASE(4)
    MAXSIM_MMA_CASE(5)
    MAXSIM_MMA_CASE(6)
    MAXSIM_MMA_CASE(7)
    MAXSIM_MMA_CASE(8)
    MAXSIM_MMA_CASE(9)
    MAXSIM_MMA_CASE(10)
    MAXSIM_MMA_CASE(11)
    MAXSIM_MMA_CASE(12)
    MAXSIM_MMA_CASE(13)
    MAXSIM_MMA_CASE(14)
    MAXSIM_MMA_CASE(15)
    MAXSIM_MMA_CASE(16)
  }
#undef MAXSIM_MMA_CASE
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace maxsim
