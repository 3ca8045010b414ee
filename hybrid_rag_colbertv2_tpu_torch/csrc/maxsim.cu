// Full-scan MaxSim over an unquantized index for Hopper (sm_90a), plain C
// interface for ctypes: one entry point for bf16 rows, one for fp32 rows.
//
// Replaces the TPU kernel hybrid_rag_colbertv2_tpu/ops/maxsim.py:
// _maxsim_kernel (called by maxsim_scores). Same function:
//
//   score[b, n] = sum_i max_j ( |e[n, j]|_1 > 0 ? q[b, i] . e[n, j] : -1e30 )
//
// over the doc's L stored rows j: the index builder zeroes padding rows,
// so a row whose elements are all +-0 is masked (the TPU kernel's zero-L1-
// norm test; doc lengths are not read). The query is cast to the index
// dtype, products and sums are fp32. Zero-length docs score -1e30 * Lq.
//
// bf16 (maxsim_bf16_launch). Bound at the main path's shape (B=8, Lq=32,
// N_pad=100,096, L=128, D=128): the mask is by content, so every row is
// read, 3.28 GB, ~0.98 ms at the H100 SXM's 3.35 TB/s, against ~0.63 TFLOP
// of products for the valid rows, ~0.64 ms at 989 TFLOP/s: bytes. The
// design is the tensor-core scan of maxsim_mma.cuh: rows are staged with
// 16-byte copies and no conversion, each row's all-zero test is taken
// from the staged words (an OR across the 4 threads that stage the row),
// and 16-row tiles that are wholly masked skip the mma.
//
// fp32 (maxsim_f32_launch). mma.sync takes no fp32 operands and TF32
// would round them, so this is an FFMA kernel on the CUDA cores: ~0.63
// TFLOP for the valid rows at the H100 SXM's 67 TFLOP/s fp32 rate is
// ~9.4 ms, against 6.56 GB of rows, ~2 ms: operations. A block owns 256
// query columns (whole queries) and walks docs with a grid stride; each
// 64-row chunk is multiplied in K-slabs of 16 staged transposed in shared
// memory (double buffered, the next slab prefetched into registers), each
// thread holding an 8 x 8 register tile (4 shared-memory vector loads per
// 64 FFMA). Row masks come from the staged words, column maxima fold in
// registers, and one thread per query sums its Lq maxima in ascending
// column order: no atomics, deterministic.
//
// Both take any B, L a multiple of 64, D a multiple of 16 up to 256, Lq
// up to 256, and any N.

#include "maxsim_mma.cuh"

namespace {

using namespace maxsim;

struct Bf16Rows {
  static constexpr bool kRowScale = true;  // the factor is the row's 0/1 mask
  static constexpr bool kMaskZero = true;
  static constexpr bool kSkipByLength = false;
  static constexpr bool kDocScale = false;

  template <int D>
  struct Stage {
    // 4 threads stage each of the chunk's 64 rows
    static constexpr int kVecPerRow = D / 8;  // 16-byte bf16 vectors per row
    static constexpr int kVecPerThread = (kVecPerRow + 3) / 4;
    uint4 pre[kVecPerThread];  // the chunk's rows, in flight

    __device__ void fetch(const Operands& op, int, int doc_len, int doc, int chunk) {
      const int row = threadIdx.x >> 2;
      const int part = threadIdx.x & 3;
      const uint4* src = reinterpret_cast<const uint4*>(
          static_cast<const __nv_bfloat16*>(op.emb) +
          ((size_t)doc * doc_len + chunk * kChunkRows + row) * D);
#pragma unroll
      for (int v = 0; v < kVecPerThread; ++v) {
        const int j = part + 4 * v;
        if (j < kVecPerRow) pre[v] = src[j];
      }
    }

    __device__ void store(__nv_bfloat16* rows, float* factors) {
      constexpr int kRowStride = Smem<D>::kRowStride;
      const int row = threadIdx.x >> 2;
      const int part = threadIdx.x & 3;
      uint32_t nz = 0;
#pragma unroll
      for (int v = 0; v < kVecPerThread; ++v) {
        const int j = part + 4 * v;
        if (j < kVecPerRow) {
          nz |= (pre[v].x | pre[v].y | pre[v].z | pre[v].w) & 0x7fff7fffu;
          *reinterpret_cast<uint4*>(rows + row * kRowStride + j * 8) = pre[v];
        }
      }
      nz |= __shfl_xor_sync(0xffffffffu, nz, 1);
      nz |= __shfl_xor_sync(0xffffffffu, nz, 2);
      if (part == 0) factors[row] = nz ? 1.f : 0.f;
    }
  };
};

// ---------------------------------------------------------------- fp32 --

constexpr int kK = 16;                 // K-slab depth
constexpr int kAStride = kChunkRows + 4;
constexpr int kBStride = kTileCols + 4;

struct F32Smem {
  float a[2][kK][kAStride];            // rows, transposed: a[k][row]
  float b[2][kK][kBStride];            // query, transposed: b[k][col]
  float red[kWarps][kTileCols];        // per-warp column maxima of a doc
  float col[kTileCols];                // column maxima of a doc
  float flag[2][kChunkRows];           // row masks, by chunk parity
};

__global__ void __launch_bounds__(kThreads, 2)
maxsim_f32_kernel(const float* __restrict__ q,    // (B*Lq, D)
                  const float* __restrict__ emb,  // (N*L, D)
                  float* __restrict__ out,        // (B, N)
                  int dim, int n_cols, int lq, int n_docs, int doc_len,
                  int queries_per_tile) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  F32Smem& sm = *reinterpret_cast<F32Smem*>(smem_raw);
  const int tx = threadIdx.x & 31;  // column group: cols 4tx.., 128 + 4tx..
  const int ty = threadIdx.x >> 5;  // row group (= warp): rows 4ty.., 32 + 4ty..
  const int q0 = blockIdx.y * queries_per_tile;
  const int col0 = q0 * lq;
  const int tile_cols = min(queries_per_tile * lq, n_cols - col0);
  const int n_queries = tile_cols / lq;

  const int n_slabs = dim / kK;
  const int chunks_per_doc = doc_len / kChunkRows;
  const int items_per_doc = chunks_per_doc * n_slabs;
  const int my_docs = (n_docs - blockIdx.x + gridDim.x - 1) / gridDim.x;
  const int n_items = my_docs * items_per_doc;

  // staging: thread -> row (threadIdx.x / 4) x k-quad of the rows' slab,
  // and 4 (col, k-quad) pieces of the query's slab
  const int a_row = threadIdx.x >> 2;
  const int a_k = (threadIdx.x & 3) * 4;
  float4 pa;
  float4 pb[4];
  auto fetch = [&](int item) {
    const int doc = blockIdx.x + (item / items_per_doc) * gridDim.x;
    const int rest = item % items_per_doc;
    const int chunk = rest / n_slabs;
    const int k0 = (rest % n_slabs) * kK;
    pa = *reinterpret_cast<const float4*>(
        emb + ((size_t)doc * doc_len + chunk * kChunkRows + a_row) * dim + k0 + a_k);
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int idx = threadIdx.x + v * kThreads;
      const int c = idx >> 2;
      pb[v] = c < tile_cols
                  ? *reinterpret_cast<const float4*>(
                        q + (size_t)(col0 + c) * dim + k0 + (idx & 3) * 4)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };

  float acc[8][8];
  float cmax[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    cmax[i] = kNegInf;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }
  uint32_t nz = 0;  // this thread's staged bits of its row in the chunk

  if (n_items > 0) fetch(0);
  for (int it = 0; it < n_items; ++it) {
    const int buf = it & 1;
    const int doc_seq = it / items_per_doc;
    const int doc = blockIdx.x + doc_seq * gridDim.x;
    const int rest = it - doc_seq * items_per_doc;
    const int chunk = rest / n_slabs;
    const int slab = rest - chunk * n_slabs;
    const bool last_slab = slab == n_slabs - 1;
    const int fbuf = (doc_seq * chunks_per_doc + chunk) & 1;

    // buffer buf was last read two items ago, before the previous barrier
    sm.a[buf][a_k + 0][a_row] = pa.x;
    sm.a[buf][a_k + 1][a_row] = pa.y;
    sm.a[buf][a_k + 2][a_row] = pa.z;
    sm.a[buf][a_k + 3][a_row] = pa.w;
    nz |= (__float_as_uint(pa.x) | __float_as_uint(pa.y) | __float_as_uint(pa.z) |
           __float_as_uint(pa.w)) & 0x7fffffffu;
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int idx = threadIdx.x + v * kThreads;
      const int c = idx >> 2;
      const int k = (idx & 3) * 4;
      sm.b[buf][k + 0][c] = pb[v].x;
      sm.b[buf][k + 1][c] = pb[v].y;
      sm.b[buf][k + 2][c] = pb[v].z;
      sm.b[buf][k + 3][c] = pb[v].w;
    }
    if (last_slab) {  // the row's mask: OR over the 4 threads staging it
      nz |= __shfl_xor_sync(0xffffffffu, nz, 1);
      nz |= __shfl_xor_sync(0xffffffffu, nz, 2);
      if ((threadIdx.x & 3) == 0) sm.flag[fbuf][a_row] = nz ? 1.f : 0.f;
      nz = 0;
    }
    if (it + 1 < n_items) fetch(it + 1);
    __syncthreads();

#pragma unroll
    for (int k = 0; k < kK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&sm.a[buf][k][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&sm.a[buf][k][32 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&sm.b[buf][k][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&sm.b[buf][k][128 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }

    if (last_slab) {  // fold the chunk into the running column maxima
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = (i < 4 ? 0 : 32) + ty * 4 + (i & 3);
        const bool keep = sm.flag[fbuf][r] > 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          cmax[j] = fmaxf(cmax[j], keep ? acc[i][j] : kNegInf);
          acc[i][j] = 0.f;
        }
      }
      if (chunk == chunks_per_doc - 1) {  // the doc's sums (block-uniform)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          sm.red[ty][(j < 4 ? 0 : 128) + tx * 4 + (j & 3)] = cmax[j];
          cmax[j] = kNegInf;
        }
        __syncthreads();
        float m = sm.red[0][threadIdx.x];
#pragma unroll
        for (int w = 1; w < kWarps; ++w) m = fmaxf(m, sm.red[w][threadIdx.x]);
        sm.col[threadIdx.x] = m;
        __syncthreads();
        if (threadIdx.x < n_queries) {
          const float* cm = sm.col + threadIdx.x * lq;
          float s = 0.f;
          for (int i = 0; i < lq; ++i) s += cm[i];
          out[(size_t)(q0 + threadIdx.x) * n_docs + doc] = s;
        }
      }
    }
  }
}

}  // namespace

// Launches on `stream`; returns the launch's cudaGetLastError() (0 on
// success). q: (batch*lq, dim) bf16; emb: (n_docs*doc_len, dim) bf16,
// 16-byte aligned; out: (batch, n_docs) fp32.
extern "C" int maxsim_bf16_launch(const void* q, const void* emb, void* out,
                                  int batch, int lq, int dim, int n_docs,
                                  int doc_len, void* stream) {
  const Operands op{emb, nullptr, nullptr};
  return launch_mma<Bf16Rows>(q, op, out, batch, lq, dim, n_docs, doc_len, stream);
}

// As maxsim_bf16_launch, with q and emb fp32.
extern "C" int maxsim_f32_launch(const void* q, const void* emb, void* out,
                                 int batch, int lq, int dim, int n_docs,
                                 int doc_len, void* stream) {
  if (dim < 16 || dim > 256 || dim % kK != 0 || doc_len <= 0 ||
      doc_len % kChunkRows != 0 || lq <= 0 || lq > kTileCols || batch < 0 ||
      n_docs < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0 || n_docs == 0) return 0;
  const int qpt = kTileCols / lq;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int grid_x = n_docs < sms * 4 ? n_docs : sms * 4;
  const dim3 grid(grid_x, (batch + qpt - 1) / qpt);
  constexpr int bytes = sizeof(F32Smem);
  cudaError_t err = cudaFuncSetAttribute(
      maxsim_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  maxsim_f32_kernel<<<grid, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(emb),
      static_cast<float*>(out), dim, batch * lq, lq, n_docs, doc_len, qpt);
  return static_cast<int>(cudaGetLastError());
}
