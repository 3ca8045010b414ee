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
// stores padding rows as copies of the doc's row 0, so there is no mask.
// q is bf16, e int8 (exact in bf16), products and sums fp32. A zero-length
// doc scores exactly 0.
//
// Bound at the main path's shape (B=8, Lq=32, N_pad=100,096, L=128, D=128,
// lengths 64..128): rows past a doc's length are copies, so only the
// ~9.6 M valid rows need products, ~0.63 TFLOP, ~0.64 ms at the H100
// SXM's 989 TFLOP/s bf16 rate, against ~1.23 GB of valid int8 rows,
// ~0.37 ms at 3.35 TB/s: operations. The design (maxsim_mma.cuh) keeps the
// tensor cores fed (query in registers, rows converted once while staged),
// drops the per-row scale and
// mask from the accumulator epilogue (the doc scale multiplies each sum
// once), and skips the loads of 64-row chunks and the products of 16-row
// tiles that lie wholly past the doc's length. Where L % 64 == 32 a
// doc's last chunk is 32 rows; the 32 absent rows lie past every length
// and are skipped.

#include "maxsim_mma.cuh"

namespace {

using namespace maxsim;

struct Int8DocRows {
  static constexpr bool kRowScale = false;
  static constexpr bool kMaskZero = false;
  static constexpr bool kSkipByLength = true;
  static constexpr bool kDocScale = true;

  template <int D>
  struct Stage {
    static constexpr int kVecPerRow = D / 16;  // 16-byte int8 vectors per row
    static constexpr int kVecPerChunk = kChunkRows * kVecPerRow;
    static constexpr int kVecPerThread = (kVecPerChunk + kThreads - 1) / kThreads;
    int4 pre[kVecPerThread];  // the chunk's int8 rows, in flight

    __device__ void fetch(const Operands& op, int, int doc_len, int doc, int chunk,
                          int rows) {
      const size_t row0 = (size_t)doc * doc_len + chunk * kChunkRows;
      const int4* src = reinterpret_cast<const int4*>(
          static_cast<const int8_t*>(op.emb) + row0 * D);
#pragma unroll
      for (int v = 0; v < kVecPerThread; ++v) {
        const int idx = threadIdx.x + v * kThreads;
        if (idx < kVecPerChunk)
          pre[v] = idx < rows * kVecPerRow ? src[idx] : make_int4(0, 0, 0, 0);
      }
    }

    __device__ void store(__nv_bfloat16* rows, float*) {
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
    }
  };
};

}  // namespace

// Launches on `stream`; returns the launch's cudaGetLastError() (0 on
// success). q: (batch*lq, dim) bf16; emb: (n_docs*doc_len, dim) int8,
// 16-byte aligned; doc_scales: (n_docs,) fp32; lengths: (n_docs,) int32;
// out: (batch, n_docs) fp32.
extern "C" int maxsim_int8_doc_launch(const void* q, const void* emb,
                                      const void* doc_scales, const void* lengths,
                                      void* out, int batch, int lq, int dim,
                                      int n_docs, int doc_len, void* stream) {
  const Operands op{emb, static_cast<const float*>(doc_scales),
                    static_cast<const int*>(lengths)};
  return launch_mma<Int8DocRows>(q, op, out, batch, lq, dim, n_docs, doc_len, stream);
}
