// Full-scan MaxSim over a float32 index for Hopper (sm_90a), plain C
// interface for ctypes.
//
// Replaces the TPU kernel hybrid_rag_colbertv2_tpu/ops/maxsim.py:
// _maxsim_kernel (called by maxsim_scores) on fp32 rows. Same function:
//
//   score[b, n] = sum_i max_j ( |e[n, j]|_1 > 0 ? q[b, i] . e[n, j] : -1e30 )
//
// over the doc's L stored rows j: a row none of whose elements has a
// nonzero exponent field (all +-0 or subnormal) is masked (the TPU
// kernel's zero-L1-norm test under XLA, which counts subnormal values as
// zero). The mask is read from the
// rows, never from doc lengths: a nonzero row past a doc's length counts.
// Products and sums are fp32 FFMA on the CUDA cores: mma.sync and wgmma
// take no fp32 operands and TF32 would round them. Zero-length docs score
// -1e30 * Lq.
//
// Bound at the main path's shape (B=8, Lq=32, N_pad=100,096, L=128,
// D=128): ~0.63 TFLOP for the 9.6 M valid rows at the H100 SXM's 67
// TFLOP/s fp32 rate is ~9.4 ms, against 6.56 GB of rows, ~2 ms:
// operations. So the design keeps the FFMA pipes fed and skips padding:
//  * The block's query columns (256 at D <= 144: all 8 queries) are
//    staged once, transposed as [D][cols], and stay resident in shared
//    memory for the block's life (131 KB at D = 128). One block of 8
//    warps per SM walks docs with a grid stride. Two blocks of 128
//    columns per SM would not fit: each needs the 68 KB row ring beside
//    its 66 KB query.
//  * Rows arrive by cp.async.cg 16-byte copies of whole 64-row chunks
//    (32 rows in a doc's last chunk where L % 64 == 32: no row past the
//    doc is read, and the stage's absent rows count as zero rows),
//    row-major as stored (row stride D + 4 floats, so the 8 rows a warp
//    reads at once hit distinct banks), into a 2-stage ring: the next
//    chunk's copies fly while the block multiplies this one. Two
//    barriers per chunk, none per k-slab: one once the chunk has landed
//    (the other stage is then free for the next copies), one once its row
//    mask is published. A one-barrier variant, each warp testing the rows
//    it had copied itself, ran slower on the H100. The loop's indices
//    advance by addition: no division per chunk.
//  * Once a chunk has landed, 4 threads per row OR its staged words
//    (& 0x7f800000: some exponent bit) and a ballot publishes the
//    chunk's 64-bit row mask.
//    Thread (warp w, lane = 8 lc + lr) owns rows 8 i + lr, i < 8, and
//    columns 32 w + 4 lc + {0..3, 16..19}, an 8 x 8 register tile. Only
//    the 8-row groups up to the chunk's last nonzero row are multiplied
//    (every warp skips the same share; a chunk with no nonzero row is
//    skipped), so the work is the valid rows plus at most 7 per chunk.
//    Zero rows inside that range get -1e30 before the max.
//  * The k-loop loads each row's next 4 elements (one 16-byte vector)
//    and the next k's 8 query values (two vectors) one step ahead: per 4
//    k-steps, G + 8 shared-memory loads feed 32 G FFMA, with 8 warps (2
//    per scheduler) to hide what the prefetch does not.
//  * Column maxima fold in registers; after a doc's last chunk, shuffles
//    finish the max over the 8 lanes that share columns, and one thread
//    per query sums its Lq maxima in ascending column order after the
//    next barrier: no atomics, two launches give bit-equal outputs.
//
// Takes any B, L a multiple of 32, D a multiple of 16 up to 256, Lq up to
// 256, and any N. Where D is large, fewer query columns fit beside the
// ring (64 at D = 256): the launch puts fewer queries in each block, and
// a query wider than that is scanned in column segments, one launch each,
// each segment's sum added to the previous ones' in order by the same
// single thread per (query, doc).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kCols = kWarps * 32;  // query columns a block can hold
constexpr int kChunkRows = 64;      // doc rows per ring stage
constexpr int kPad = 4;             // floats after each staged row
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Four k-steps k..k+3 of the G x 8 tile, with the operands of the next
// four (kn..kn+3) loaded meanwhile: rows into an, the query's next k into
// b0/b1 as each k is consumed.
template <int G>
__device__ __forceinline__ void fma4(float (&acc)[G][8], const float4 (&a)[G],
                                     float4 (&an)[G], float4& b0, float4& b1,
                                     const float* a_ptr, int group_stride,
                                     const float* b_ptr, int q_stride, int k,
                                     int kn) {
#pragma unroll
  for (int i = 0; i < G; ++i) an[i] = lds4(a_ptr + i * group_stride + kn);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const float* bp = b_ptr + (kk < 3 ? k + kk + 1 : kn) * q_stride;
    const float4 c0 = lds4(bp), c1 = lds4(bp + 16);
    const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < G; ++i) {
      const float av = kk == 0 ? a[i].x : kk == 1 ? a[i].y : kk == 2 ? a[i].z : a[i].w;
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av, b[j], acc[i][j]);
    }
    b0 = c0;
    b1 = c1;
  }
}

// The thread's rows 8 i + lr for i < G against its 8 columns over all of
// D, folded into the running column maxima; `rowbits` bit 8 i is row
// 8 i + lr's mask.
template <int G>
__device__ __forceinline__ void scan_groups(const float* a_ptr, int group_stride,
                                            const float* b_ptr, int q_stride,
                                            int dim, uint64_t rowbits,
                                            float (&cmax)[8]) {
  float acc[G][8];
#pragma unroll
  for (int i = 0; i < G; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  float4 a[G], an[G];
#pragma unroll
  for (int i = 0; i < G; ++i) a[i] = lds4(a_ptr + i * group_stride);
  float4 b0 = lds4(b_ptr), b1 = lds4(b_ptr + 16);
  // dim is a multiple of 16: two 4-step halves per trip, a <-> an swapped
#pragma unroll 1
  for (int k = 0; k < dim; k += 8) {
    fma4<G>(acc, a, an, b0, b1, a_ptr, group_stride, b_ptr, q_stride, k, k + 4);
    fma4<G>(acc, an, a, b0, b1, a_ptr, group_stride, b_ptr, q_stride, k + 4,
            min(k + 8, dim - 4));
  }
#pragma unroll
  for (int i = 0; i < G; ++i) {
    const bool keep = (rowbits >> (8 * i)) & 1;
#pragma unroll
    for (int j = 0; j < 8; ++j) cmax[j] = fmaxf(cmax[j], keep ? acc[i][j] : kNegInf);
  }
}

// Shared memory: the row ring, the query tile, the doc's column maxima
// and the chunk's row mask.
__host__ __device__ constexpr int smem_bytes(int dim, int tile_w) {
  return (2 * kChunkRows * (dim + kPad) + dim * tile_w + kCols) * 4 + 8;
}

__global__ void __launch_bounds__(kThreads, 1)
maxsim_f32_kernel(const float* __restrict__ q,    // (B*Lq, D)
                  const float* __restrict__ emb,  // (N*L, D)
                  float* __restrict__ out,        // (B, N)
                  int dim, int lq, int batch, int n_docs, int doc_len,
                  int queries_per_tile, int seg0, int seg_len, int tile_w,
                  int accumulate) {
  extern __shared__ __align__(16) float smem[];
  const int row_stride = dim + kPad;
  const int stage_floats = kChunkRows * row_stride;
  float* s_rows = smem;                          // [2][64][D + 4]
  float* s_q = s_rows + 2 * stage_floats;        // [D][tile_w]
  float* s_col = s_q + dim * tile_w;             // [kCols]
  uint64_t* s_mask = reinterpret_cast<uint64_t*>(s_col + kCols);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int lr = lane & 7;   // rows lr, 8 + lr, ...
  const int lc = lane >> 3;  // columns 32 warp + 4 lc + {0..3, 16..19}
  const int q0 = blockIdx.y * queries_per_tile;
  const int n_queries = min(queries_per_tile, batch - q0);
  const int tile_cols = n_queries * seg_len;  // tile column c: query c / seg_len
  const bool warp_live = warp * 32 < tile_cols;

  // the query tile, transposed, once; columns past tile_cols are zero
  for (int idx = threadIdx.x; idx < dim * tile_w; idx += kThreads) {
    const int k = idx / tile_w;
    const int c = idx - k * tile_w;
    float v = 0.f;
    if (c < tile_cols) {
      const int qi = c / seg_len;
      v = q[((size_t)(q0 + qi) * lq + seg0 + c - qi * seg_len) * dim + k];
    }
    s_q[idx] = v;
  }

  // a chunk is rows * D / 4 16-byte pieces, contiguous in device memory;
  // this thread copies pieces p = threadIdx.x + 256 v, piece p of row r
  // landing at 4 (p + r) in its stage (each row padded by 4 floats)
  const int row_pieces = dim / 4;
  const int r_step = kThreads / row_pieces;
  const int p_step = kThreads - r_step * row_pieces;
  const int r_first = threadIdx.x / row_pieces;
  const int p_first = threadIdx.x - r_first * row_pieces;
  auto copy_chunk = [&](const float* src, float* stage, int rows) {
    const int pieces = rows * row_pieces;
    int r = r_first, pr = p_first;
    for (int p = threadIdx.x; p < pieces; p += kThreads) {
      cp_async16(stage + 4 * (p + r), src + 4 * p);
      r += r_step;
      pr += p_step;
      if (pr >= row_pieces) {
        pr -= row_pieces;
        ++r;
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  // one thread per query sums the doc's column maxima in ascending order
  auto write_sum = [&](int doc) {
    if (threadIdx.x < n_queries) {
      const float* cm = s_col + threadIdx.x * seg_len;
      float s = 0.f;
      for (int i = 0; i < seg_len; ++i) s += cm[i];
      float* o = out + (size_t)(q0 + threadIdx.x) * n_docs + doc;
      *o = accumulate ? *o + s : s;
    }
  };

  // a doc's 64-row chunks, the last one 32 rows where L % 64 == 32
  const int chunks_per_doc = (doc_len + kChunkRows - 1) / kChunkRows;
  auto chunk_rows = [&](int c) { return min(kChunkRows, doc_len - c * kChunkRows); };
  const int chunk_floats = kChunkRows * dim;
  const float* a_lane = s_rows + lr * row_stride;
  const float* b_lane = s_q + warp * 32 + lc * 4;
  float cmax[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) cmax[j] = kNegInf;

  int doc = blockIdx.x;  // the launch gives every block at least one doc
  int chunk = 0;
  int buf = 0;
  int pend_doc = -1;     // doc whose column maxima wait in s_col
  const float* src = emb + (size_t)doc * doc_len * dim;
  copy_chunk(src, s_rows, chunk_rows(0));
  while (doc < n_docs) {
    int next_doc = doc, next_chunk = chunk + 1;
    const float* next_src = src + chunk_floats;
    if (next_chunk == chunks_per_doc) {
      next_chunk = 0;
      next_doc += gridDim.x;
      next_src = emb + (size_t)next_doc * doc_len * dim;
    }
    asm volatile("cp.async.wait_all;\n" ::);
    // this chunk has landed everywhere; the other stage and s_mask are free
    __syncthreads();
    if (pend_doc >= 0) {
      write_sum(pend_doc);
      pend_doc = -1;
    }
    if (next_doc < n_docs)
      copy_chunk(next_src, s_rows + (buf ^ 1) * stage_floats, chunk_rows(next_chunk));

    // row mask: 4 threads per row OR the row's staged words
    const float* rows = s_rows + buf * stage_floats;
    {
      const int row = threadIdx.x >> 2;
      const uint4* w = reinterpret_cast<const uint4*>(rows + row * row_stride) +
                       (threadIdx.x & 3);
      // the rows a 32-row chunk lacks count as zero rows
      const int pieces = row < chunk_rows(chunk) ? row_pieces : 0;
      uint32_t nz = 0;
      for (int v = 0; v < pieces; v += 4) {
        const uint4 x = w[v];
        nz |= x.x | x.y | x.z | x.w;
      }
      nz &= 0x7f800000u;
      nz |= __shfl_xor_sync(0xffffffffu, nz, 1);
      nz |= __shfl_xor_sync(0xffffffffu, nz, 2);
      const uint32_t votes = __ballot_sync(0xffffffffu, nz != 0);  // bit 4 j: row 8 warp + j
      if (lane == 0) {
        uint32_t byte = 0;
#pragma unroll
        for (int j = 0; j < 8; ++j) byte |= ((votes >> (4 * j)) & 1u) << j;
        reinterpret_cast<unsigned char*>(s_mask)[warp] = static_cast<unsigned char>(byte);
      }
    }
    __syncthreads();

    const uint64_t live = *s_mask;  // bit r: row r of the chunk is nonzero
    if (live != 0 && warp_live) {
      const int groups = (63 - __clzll(static_cast<long long>(live))) / 8 + 1;
      const float* a_ptr = a_lane + buf * stage_floats;
      const int gs = 8 * row_stride;
      const uint64_t bits = live >> lr;
      switch (groups) {
        case 1: scan_groups<1>(a_ptr, gs, b_lane, tile_w, dim, bits, cmax); break;
        case 2: scan_groups<2>(a_ptr, gs, b_lane, tile_w, dim, bits, cmax); break;
        case 3: scan_groups<3>(a_ptr, gs, b_lane, tile_w, dim, bits, cmax); break;
        case 4: scan_groups<4>(a_ptr, gs, b_lane, tile_w, dim, bits, cmax); break;
        case 5: scan_groups<5>(a_ptr, gs, b_lane, tile_w, dim, bits, cmax); break;
        case 6: scan_groups<6>(a_ptr, gs, b_lane, tile_w, dim, bits, cmax); break;
        case 7: scan_groups<7>(a_ptr, gs, b_lane, tile_w, dim, bits, cmax); break;
        default: scan_groups<8>(a_ptr, gs, b_lane, tile_w, dim, bits, cmax); break;
      }
    }

    if (next_chunk == 0) {
      // the doc's maxima over the 8 lanes that share columns; summed
      // after the next barrier
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float m = cmax[j];
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 4));
        if (lr == 0) s_col[warp * 32 + (j < 4 ? 0 : 16) + lc * 4 + (j & 3)] = m;
        cmax[j] = kNegInf;
      }
      pend_doc = doc;
    }
    doc = next_doc;
    chunk = next_chunk;
    src = next_src;
    buf ^= 1;
  }
  __syncthreads();
  if (pend_doc >= 0) write_sum(pend_doc);
}

}  // namespace

// Launches on `stream`; returns the first nonzero CUDA error (0 on
// success). q: (batch*lq, dim) fp32; emb: (n_docs*doc_len, dim) fp32,
// 16-byte aligned; out: (batch, n_docs) fp32.
extern "C" int maxsim_f32_launch(const void* q, const void* emb, void* out,
                                 int batch, int lq, int dim, int n_docs,
                                 int doc_len, void* stream) {
  if (dim < 16 || dim > 256 || dim % 16 != 0 || doc_len <= 0 ||
      doc_len % 32 != 0 || lq <= 0 || lq > kCols || batch < 0 ||
      n_docs < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0 || n_docs == 0) return 0;
  int dev = 0, sms = 0, smem_max = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  // the widest query tile, in whole warps' columns, that fits beside the ring
  int cap = kCols;
  while (cap > 32 && smem_bytes(dim, cap) > smem_max) cap -= 32;
  if (smem_bytes(dim, cap) > smem_max) return static_cast<int>(cudaErrorInvalidValue);
  // whole queries per block where one fits; else one query per block in
  // column segments of at most cap, one launch each
  const int segments = (lq + cap - 1) / cap;
  const int seg_w = (lq + segments - 1) / segments;
  const int qpt = segments == 1 ? cap / lq : 1;
  const int tile_w = (qpt * seg_w + 31) / 32 * 32;
  const int bytes = smem_bytes(dim, tile_w);
  cudaError_t err = cudaFuncSetAttribute(
      maxsim_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, maxsim_f32_kernel,
                                                      kThreads, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid_y = (batch + qpt - 1) / qpt;
  int grid_x = sms * (per_sm > 0 ? per_sm : 1) / grid_y;
  grid_x = grid_x < 1 ? 1 : grid_x > n_docs ? n_docs : grid_x;
  const dim3 grid(grid_x, grid_y);
  for (int s = 0; s < segments; ++s) {
    const int seg0 = s * seg_w;
    const int seg_len = lq - seg0 < seg_w ? lq - seg0 : seg_w;
    maxsim_f32_kernel<<<grid, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(q), static_cast<const float*>(emb),
        static_cast<float*>(out), dim, lq, batch, n_docs, doc_len, qpt, seg0,
        seg_len, tile_w, s > 0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}
