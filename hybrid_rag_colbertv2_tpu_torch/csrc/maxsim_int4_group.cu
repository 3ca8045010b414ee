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
// valid row of their group (or the doc's row 0 with group 0's scale), so
// there is no mask; a zero-length doc scores exactly 0. Since gs >= 0 and
// rounding gs * x is monotonic in x, max_j gs[g(j), n] * x_j is the TPU
// kernel's max over groups of scaled group maxima bit for bit, so the
// group scale is applied per row like the int8 kernel's row scale.
//
// Bound at the main path's shape (B=8, Lq=32, N_pad=1,000,064, L=64,
// D=128, lengths 32..64): only the ~48 M valid rows need products,
// ~3.15 TFLOP, ~3.2 ms at the H100 SXM's 989 TFLOP/s bf16 rate, against
// ~3.1 GB of packed valid rows, ~0.9 ms at 3.35 TB/s: operations. The
// design (maxsim_mma.cuh) reads the packed rows (half the bytes of int8),
// unpacks both nibbles by arithmetic shifts once per element while staging
// them in token order as bf16 (exact), so the tensor-core work is the
// int8-doc kernel's, and skips the loads of 64-row chunks and the
// products of 16-row tiles wholly past the doc's length.

#include "maxsim_mma.cuh"

namespace {

using namespace maxsim;

constexpr int kGroupRows = 8;  // ops/quant.py::int4_group_size(L) for L % 64 == 0

// Four packed bytes -> the four low (even-token) or high (odd-token)
// nibbles as bf16, sign-extended by arithmetic shifts.
__device__ __forceinline__ uint2 lo_s4x4_to_bf16x4(uint32_t w) {
  return make_uint2(bf16x2(s4<3>(w), s4<11>(w)), bf16x2(s4<19>(w), s4<27>(w)));
}
__device__ __forceinline__ uint2 hi_s4x4_to_bf16x4(uint32_t w) {
  return make_uint2(bf16x2(s4<7>(w), s4<15>(w)), bf16x2(s4<23>(w), s4<31>(w)));
}

struct Int4GroupRows {
  static constexpr bool kRowScale = true;
  static constexpr bool kMaskZero = false;
  static constexpr bool kSkipByLength = true;
  static constexpr bool kDocScale = false;

  template <int D>
  struct Stage {
    static constexpr int kPairRows = kChunkRows / 2;  // packed rows per chunk
    static constexpr int kVecPerRow = D / 16;         // 16-byte vectors per row
    static constexpr int kVecPerChunk = kPairRows * kVecPerRow;
    static constexpr int kVecPerThread = (kVecPerChunk + kThreads - 1) / kThreads;
    int4 pre[kVecPerThread];  // the chunk's packed rows, in flight
    float pre_scale = 0.f;

    __device__ void fetch(const Operands& op, int n_docs, int doc_len, int doc,
                          int chunk) {
      const size_t prow0 = ((size_t)doc * doc_len + chunk * kChunkRows) / 2;
      const int4* src = reinterpret_cast<const int4*>(
          static_cast<const int8_t*>(op.emb) + prow0 * D);
#pragma unroll
      for (int v = 0; v < kVecPerThread; ++v) {
        const int idx = threadIdx.x + v * kThreads;
        if (idx < kVecPerChunk) pre[v] = src[idx];
      }
      if (threadIdx.x < kChunkRows) {
        const int group = (chunk * kChunkRows + threadIdx.x) / kGroupRows;
        pre_scale = op.scales[(size_t)group * n_docs + doc];
      }
    }

    __device__ void store(__nv_bfloat16* rows, float* factors) {
      constexpr int kRowStride = Smem<D>::kRowStride;
#pragma unroll
      for (int v = 0; v < kVecPerThread; ++v) {
        const int idx = threadIdx.x + v * kThreads;
        if (idx < kVecPerChunk) {
          const int pr = idx / kVecPerRow;
          const int c = (idx - pr * kVecPerRow) * 16;
          const uint32_t w[4] = {static_cast<uint32_t>(pre[v].x),
                                 static_cast<uint32_t>(pre[v].y),
                                 static_cast<uint32_t>(pre[v].z),
                                 static_cast<uint32_t>(pre[v].w)};
          uint2 lo[4], hi[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            lo[k] = lo_s4x4_to_bf16x4(w[k]);
            hi[k] = hi_s4x4_to_bf16x4(w[k]);
          }
          uint4* even = reinterpret_cast<uint4*>(rows + (2 * pr) * kRowStride + c);
          uint4* odd = reinterpret_cast<uint4*>(rows + (2 * pr + 1) * kRowStride + c);
          even[0] = make_uint4(lo[0].x, lo[0].y, lo[1].x, lo[1].y);
          even[1] = make_uint4(lo[2].x, lo[2].y, lo[3].x, lo[3].y);
          odd[0] = make_uint4(hi[0].x, hi[0].y, hi[1].x, hi[1].y);
          odd[1] = make_uint4(hi[2].x, hi[2].y, hi[3].x, hi[3].y);
        }
      }
      if (threadIdx.x < kChunkRows) factors[threadIdx.x] = pre_scale;
    }
  };
};

}  // namespace

// Launches on `stream`; returns the launch's cudaGetLastError() (0 on
// success). q: (batch*lq, dim) bf16; emb: (n_docs*doc_len/2, dim) packed
// int8, 16-byte aligned; group_scales: (doc_len/8, n_docs) fp32; lengths:
// (n_docs,) int32; out: (batch, n_docs) fp32.
extern "C" int maxsim_int4_group_launch(const void* q, const void* emb,
                                        const void* group_scales,
                                        const void* lengths, void* out, int batch,
                                        int lq, int dim, int n_docs, int doc_len,
                                        void* stream) {
  const Operands op{emb, static_cast<const float*>(group_scales),
                    static_cast<const int*>(lengths)};
  return launch_mma<Int4GroupRows>(q, op, out, batch, lq, dim, n_docs, doc_len,
                                   stream);
}
