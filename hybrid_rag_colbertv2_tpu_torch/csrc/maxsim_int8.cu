// Full-scan int8 MaxSim for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernel hybrid_rag_colbertv2_tpu/ops/maxsim.py:
// _maxsim_int8_kernel (called by maxsim_scores_int8). Same function:
//
//   score[b, n] = sum_i max_j ( scale[n, j] > 0 ? scale[n, j] * (q[b, i] . e[n, j])
//                                               : -1e30 )
//
// over the doc's L token rows j (a padding row has scale 0, which is the
// mask) and the query's Lq rows i; q is bf16, e is int8 (exact in bf16),
// products and sums in fp32. Zero-length docs score -1e30 * Lq.
//
// Bound at the main path's shape (B=8, Lq=32, N_pad=100,096, L=128, D=128):
// over every padded row, 2*B*Lq*N*L*D = 0.84 TFLOP of bf16 products, 0.85 ms
// at the H100 SXM's 989 TFLOP/s; the int8 rows plus fp32 scales are 1.69 GB,
// 0.51 ms at 3.35 TB/s. Only rows with a nonzero scale need products: with
// the main path's doc lengths (64..128, mean 96) that is ~3/4 of the rows,
// ~0.63 TFLOP, ~0.64 ms. At B*Lq = 256 columns the scan is compute-bound,
// so the design spends its effort on keeping the tensor cores fed:
//
//  * A block owns a tile of up to 256 query-token columns (whole queries)
//    and walks docs with a grid stride. Each of its 8 warps owns 32
//    columns and keeps their bf16 query fragments in registers for the
//    whole kernel, so the query is read once per block, not per doc.
//  * A doc's rows move 64 at a time. Each thread loads its share of the
//    next chunk (16-byte loads) into registers while the block computes
//    on the current one; the int8 -> bf16 conversion happens once per
//    element, when the chunk is written to shared memory (double
//    buffered, rows padded by 16 bytes so ldmatrix reads hit distinct
//    banks), not once per warp. One barrier per chunk.
//  * Warps read A fragments with ldmatrix and multiply with mma.sync
//    m16n8k16 bf16 -> fp32, skipping a 16-row tile whose rows are all
//    masked (a short doc's padding). The per-row scale and mask are
//    applied to the fp32 accumulators and folded into a running
//    per-column max in registers, so the (rows x columns) similarity
//    block never leaves registers.
//  * After a doc's last chunk, warp shuffles finish the max over rows,
//    and one thread per query sums its Lq column maxima in ascending
//    column order (deferred one chunk, double-buffered, to share the next
//    barrier). Every output is written by one thread, with no atomics:
//    results are deterministic.
//  * wgmma, TMA and a deeper pipeline are later work.
//
// Handles any B (grid.y tiles the columns), L a multiple of 64, D a
// multiple of 16 up to 256, Lq up to 256, and any N.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&p);
}

// Four int8 (one 32-bit word, lowest byte first) -> four bf16, exact.
__device__ __forceinline__ uint2 s8x4_to_bf16x4(uint32_t w) {
  const float f0 = static_cast<float>(static_cast<int8_t>(w & 0xff));
  const float f1 = static_cast<float>(static_cast<int8_t>((w >> 8) & 0xff));
  const float f2 = static_cast<float>(static_cast<int8_t>((w >> 16) & 0xff));
  const float f3 = static_cast<float>(static_cast<int8_t>(w >> 24));
  return make_uint2(bf16x2(f0, f1), bf16x2(f2, f3));
}

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

template <int KSTEPS>
__global__ void __launch_bounds__(kThreads)
maxsim_int8_kernel(const __nv_bfloat16* __restrict__ q,  // (B*Lq, D)
                   const int8_t* __restrict__ emb,        // (N*L, D)
                   const float* __restrict__ scales,      // (N*L,)
                   float* __restrict__ out,               // (B, N)
                   int n_cols, int lq, int n_docs, int doc_len,
                   int queries_per_tile) {
  constexpr int D = KSTEPS * 16;
  using S = Smem<D>;
  constexpr int kRowStride = S::kRowStride;
  constexpr int kVecPerRow = D / 16;  // 16-byte int8 vectors per row
  constexpr int kVecPerChunk = kChunkRows * kVecPerRow;
  constexpr int kVecPerThread = (kVecPerChunk + kThreads - 1) / kThreads;
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

  // this block's work: its docs (grid stride) x the doc's 64-row chunks
  const int chunks_per_doc = doc_len / kChunkRows;
  const int my_docs = (n_docs - blockIdx.x + gridDim.x - 1) / gridDim.x;
  const int n_items = my_docs * chunks_per_doc;

  int4 pre[kVecPerThread];  // the next chunk's int8 rows, in flight
  float pre_scale = 0.f;
  auto fetch = [&](int item) {
    const int doc = blockIdx.x + (item / chunks_per_doc) * gridDim.x;
    const size_t row0 = (size_t)doc * doc_len + (item % chunks_per_doc) * kChunkRows;
    const int4* src = reinterpret_cast<const int4*>(emb + row0 * D);
#pragma unroll
    for (int v = 0; v < kVecPerThread; ++v) {
      const int idx = threadIdx.x + v * kThreads;
      if (idx < kVecPerChunk) pre[v] = src[idx];
    }
    if (threadIdx.x < kChunkRows) pre_scale = scales[row0 + threadIdx.x];
  };

  // ldmatrix x4 lane address: matrices (rows 0-7 | 8-15) x (cols 0-7 | 8-15)
  const int lm_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int lm_col = (lane >> 4) * 8;

  float cmax[kNTiles][2];
#pragma unroll
  for (int nt = 0; nt < kNTiles; ++nt) cmax[nt][0] = cmax[nt][1] = kNegInf;
  int pend_doc = -1;  // doc whose column maxima wait in s_colmax to be summed
  int pend_buf = 0;

  if (n_items > 0) fetch(0);
  for (int it = 0; it < n_items; ++it) {
    const int buf = it & 1;
    const int doc_seq = it / chunks_per_doc;
    const int doc = blockIdx.x + doc_seq * gridDim.x;
    const bool last_chunk = it - doc_seq * chunks_per_doc == chunks_per_doc - 1;
    __nv_bfloat16* rows = s_rows + buf * kChunkRows * kRowStride;

    // write the fetched chunk as bf16 (buffer buf was last read two
    // chunks ago, before the previous barrier)
#pragma unroll
    for (int v = 0; v < kVecPerThread; ++v) {
      const int idx = threadIdx.x + v * kThreads;
      if (idx < kVecPerChunk) {
        const int r = idx / kVecPerRow;
        const int c = (idx - r * kVecPerRow) * 16;
        const uint2 a = s8x4_to_bf16x4(static_cast<uint32_t>(pre[v].x));
        const uint2 b = s8x4_to_bf16x4(static_cast<uint32_t>(pre[v].y));
        const uint2 e = s8x4_to_bf16x4(static_cast<uint32_t>(pre[v].z));
        const uint2 f = s8x4_to_bf16x4(static_cast<uint32_t>(pre[v].w));
        uint4* dst = reinterpret_cast<uint4*>(rows + r * kRowStride + c);
        dst[0] = make_uint4(a.x, a.y, b.x, b.y);
        dst[1] = make_uint4(e.x, e.y, f.x, f.y);
      }
    }
    if (threadIdx.x < kChunkRows) s_scale[buf * kChunkRows + threadIdx.x] = pre_scale;
    if (it + 1 < n_items) fetch(it + 1);
    __syncthreads();

    if (pend_doc >= 0) {  // the previous doc's per-query sums
      if (threadIdx.x < n_queries) {
        const float* cm = s_colmax + pend_buf * kTileCols + threadIdx.x * lq;
        float s = 0.f;
        for (int i = 0; i < lq; ++i) s += cm[i];
        out[(size_t)(q0 + threadIdx.x) * n_docs + pend_doc] = s;
      }
      pend_doc = -1;
    }

    if (warp_live) {
      const float* sc = s_scale + buf * kChunkRows;
#pragma unroll
      for (int mt = 0; mt < kMTiles; ++mt) {
        // all 16 rows masked: they would only fold -1e30 into cmax, which
        // starts there, so the tile is skipped (warp-uniform branch)
        if (!__any_sync(0xffffffffu, sc[mt * 16 + (lane & 15)] > 0.f)) continue;
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
        const float s_lo = sc[mt * 16 + g];
        const float s_hi = sc[mt * 16 + g + 8];
#pragma unroll
        for (int nt = 0; nt < kNTiles; ++nt) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const float v_lo = s_lo > 0.f ? acc[nt][j] * s_lo : kNegInf;
            const float v_hi = s_hi > 0.f ? acc[nt][2 + j] * s_hi : kNegInf;
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
  if (pend_doc >= 0 && threadIdx.x < n_queries) {
    const float* cm = s_colmax + pend_buf * kTileCols + threadIdx.x * lq;
    float s = 0.f;
    for (int i = 0; i < lq; ++i) s += cm[i];
    out[(size_t)(q0 + threadIdx.x) * n_docs + pend_doc] = s;
  }
}

template <int K>
cudaError_t launch(dim3 grid, cudaStream_t s, const void* q, const void* emb,
                   const void* scales, void* out, int n_cols, int lq, int n_docs,
                   int doc_len, int qpt) {
  constexpr int bytes = Smem<K * 16>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      maxsim_int8_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  maxsim_int8_kernel<K><<<grid, kThreads, bytes, s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const int8_t*>(emb),
      static_cast<const float*>(scales), static_cast<float*>(out), n_cols, lq,
      n_docs, doc_len, qpt);
  return cudaSuccess;
}

}  // namespace

#define MAXSIM_INT8_CASE(K)                                                    \
  case K:                                                                      \
    err = launch<K>(grid, s, q, emb, scales, out, n_cols, lq, n_docs, doc_len, \
                    qpt);                                                      \
    break;

// Launches on `stream`; returns the launch's cudaGetLastError() (0 on
// success). q: (batch*lq, dim) bf16; emb: (n_docs*doc_len, dim) int8,
// 16-byte aligned; scales: (n_docs*doc_len,) fp32; out: (batch, n_docs) fp32.
extern "C" int maxsim_int8_launch(const void* q, const void* emb, const void* scales,
                                  void* out, int batch, int lq, int dim, int n_docs,
                                  int doc_len, void* stream) {
  if (dim < 16 || dim > 256 || dim % 16 != 0 || doc_len <= 0 ||
      doc_len % kChunkRows != 0 || lq <= 0 || lq > kTileCols || batch < 0 ||
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
  switch (dim / 16) {
    MAXSIM_INT8_CASE(1)
    MAXSIM_INT8_CASE(2)
    MAXSIM_INT8_CASE(3)
    MAXSIM_INT8_CASE(4)
    MAXSIM_INT8_CASE(5)
    MAXSIM_INT8_CASE(6)
    MAXSIM_INT8_CASE(7)
    MAXSIM_INT8_CASE(8)
    MAXSIM_INT8_CASE(9)
    MAXSIM_INT8_CASE(10)
    MAXSIM_INT8_CASE(11)
    MAXSIM_INT8_CASE(12)
    MAXSIM_INT8_CASE(13)
    MAXSIM_INT8_CASE(14)
    MAXSIM_INT8_CASE(15)
    MAXSIM_INT8_CASE(16)
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
