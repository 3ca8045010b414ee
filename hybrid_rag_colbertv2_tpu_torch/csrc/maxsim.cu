// Full-scan MaxSim over a bf16 index for Hopper (sm_90a), plain C
// interface for ctypes. The fp32 entry point is maxsim_f32.cu.
//
// Replaces the TPU kernel hybrid_rag_colbertv2_tpu/ops/maxsim.py:
// _maxsim_kernel (called by maxsim_scores) on bf16 rows. Same function:
//
//   score[b, n] = sum_i max_j ( |e[n, j]|_1 > 0 ? q[b, i] . e[n, j] : -1e30 )
//
// over the doc's L stored rows j: the index builder zeroes padding rows,
// so a row whose elements are all +-0 is masked (the TPU kernel's zero-L1-
// norm test; doc lengths are not read). The query is cast to the index
// dtype, products and sums are fp32. Zero-length docs score -1e30 * Lq.
//
// Bound at the main path's shape (B=8, Lq=32, N_pad=100,096, L=128,
// D=128): the mask is by content, so every row is read, 3.28 GB, ~0.98 ms
// at the H100 SXM's 3.35 TB/s, against ~0.63 TFLOP of products for the
// valid rows, ~0.64 ms at 989 TFLOP/s: bytes. The design is the
// tensor-core scan of maxsim_mma.cuh: rows are staged with 16-byte copies
// and no conversion, each row's all-zero test is taken from the staged
// words (an OR across the 4 threads that stage the row), and 16-row tiles
// that are wholly masked skip the mma.
//
// Takes any B, L a multiple of 32, D a multiple of 16 up to 256, Lq up to
// 256, and any N.

#include "maxsim_mma.cuh"

namespace {

using namespace maxsim;

struct Bf16Rows {
  static constexpr bool kRowScale = true;  // the factor is the row's 0/1 mask
  static constexpr bool kMaskZero = true;

  template <int D>
  struct Stage {
    // 4 threads stage each of the chunk's 64 rows
    static constexpr int kVecPerRow = D / 8;  // 16-byte bf16 vectors per row
    static constexpr int kVecPerThread = (kVecPerRow + 3) / 4;
    uint4 pre[kVecPerThread];  // the chunk's rows, in flight

    // rows past `rows` (the absent half of a doc's last chunk) are staged
    // as zeros, which the mask drops
    __device__ void fetch(const Operands& op, int, int doc_len, int doc, int chunk,
                          int rows) {
      const int row = threadIdx.x >> 2;
      const int part = threadIdx.x & 3;
      const uint4* src = reinterpret_cast<const uint4*>(
          static_cast<const __nv_bfloat16*>(op.emb) +
          ((size_t)doc * doc_len + chunk * kChunkRows + row) * D);
#pragma unroll
      for (int v = 0; v < kVecPerThread; ++v) {
        const int j = part + 4 * v;
        if (j < kVecPerRow) pre[v] = row < rows ? src[j] : make_uint4(0, 0, 0, 0);
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

}  // namespace

// Launches on `stream`; returns the launch's cudaGetLastError() (0 on
// success). q: (batch*lq, dim) bf16; emb: (n_docs*doc_len, dim) bf16,
// 16-byte aligned; out: (batch, n_docs) fp32.
extern "C" int maxsim_bf16_launch(const void* q, const void* emb, void* out,
                                  int batch, int lq, int dim, int n_docs,
                                  int doc_len, void* stream) {
  const Operands op{emb};
  return launch_mma<Bf16Rows>(q, op, out, batch, lq, dim, n_docs, doc_len, stream);
}

