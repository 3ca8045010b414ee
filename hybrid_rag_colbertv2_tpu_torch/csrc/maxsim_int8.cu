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
// so the design (maxsim_mma.cuh) keeps the tensor cores fed: the query
// lives in registers, rows are converted to bf16 once per element while
// staged, and 16-row tiles whose scales are all 0 are skipped. The scale
// and mask apply to the fp32 accumulators before the running max.

#include "maxsim_mma.cuh"

namespace {

using namespace maxsim;

struct Int8Rows {
  static constexpr bool kRowScale = true;
  static constexpr bool kMaskZero = true;
  static constexpr bool kSkipByLength = false;
  static constexpr bool kDocScale = false;

  template <int D>
  struct Stage {
    static constexpr int kVecPerRow = D / 16;  // 16-byte int8 vectors per row
    static constexpr int kVecPerChunk = kChunkRows * kVecPerRow;
    static constexpr int kVecPerThread = (kVecPerChunk + kThreads - 1) / kThreads;
    int4 pre[kVecPerThread];  // the chunk's int8 rows, in flight
    float pre_scale = 0.f;

    __device__ void fetch(const Operands& op, int, int doc_len, int doc, int chunk) {
      const size_t row0 = (size_t)doc * doc_len + chunk * kChunkRows;
      const int4* src = reinterpret_cast<const int4*>(
          static_cast<const int8_t*>(op.emb) + row0 * D);
#pragma unroll
      for (int v = 0; v < kVecPerThread; ++v) {
        const int idx = threadIdx.x + v * kThreads;
        if (idx < kVecPerChunk) pre[v] = src[idx];
      }
      if (threadIdx.x < kChunkRows) pre_scale = op.scales[row0 + threadIdx.x];
    }

    __device__ void store(__nv_bfloat16* rows, float* factors) {
      constexpr int kRowStride = Smem<D>::kRowStride;
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
      if (threadIdx.x < kChunkRows) factors[threadIdx.x] = pre_scale;
    }
  };
};

}  // namespace

// Launches on `stream`; returns the launch's cudaGetLastError() (0 on
// success). q: (batch*lq, dim) bf16; emb: (n_docs*doc_len, dim) int8,
// 16-byte aligned; scales: (n_docs*doc_len,) fp32; out: (batch, n_docs) fp32.
extern "C" int maxsim_int8_launch(const void* q, const void* emb, const void* scales,
                                  void* out, int batch, int lq, int dim, int n_docs,
                                  int doc_len, void* stream) {
  const Operands op{emb, static_cast<const float*>(scales), nullptr};
  return launch_mma<Int8Rows>(q, op, out, batch, lq, dim, n_docs, doc_len, stream);
}
