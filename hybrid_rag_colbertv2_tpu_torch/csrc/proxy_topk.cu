// Stage A of the pruned dense route for Hopper (sm_90a), plain C
// interface for ctypes: the pooled-proxy product over the whole corpus
// and an exact top-C of each query's proxies.
//
// Replaces no Pallas kernel: the JAX package leaves stage A
// (hybrid_rag_colbertv2_tpu/ops/prefilter.py::pooled_proxy_topk, a bf16
// dot and lax.top_k) to XLA. The port's plain version
// (ops/prefilter.py::pooled_proxy_topk_reference) widens the bf16 table to
// fp32, multiplies, masks and sorts the whole (B, N) row. Same function:
//
//   proxy[b, n] = n < n_docs && len[n] > 0 ? sum_d qbar[b, d] pooled[n, d]
//                                          : -1e30
//   cand[b, :]  = the C largest proxy[b, :], largest first, equal values
//                 by ascending n (lax.top_k's order, and the card's stable
//                 descending sort, which counts -0.0 equal to +0.0 and
//                 puts NaN first)
//
// qbar and pooled are bf16, so every product is exact in fp32; the sums
// are fp32 (tensor-core accumulation). Selection is exact: no approximate
// top-k.
//
// Bound: one read of the bf16 table, 2,210,456 x 128 x 2 B = 0.566 GB at
// the colbertv2.msmarco-open cell's shape, 0.17 ms at 3.35 TB/s. At B = 16
// the product is 16 FLOP a byte, near the fp32 FFMA rate's 20, and a
// sort of the (B, N) row reads and writes it several times over, so:
//  * The product runs on the tensor cores (mma.sync m16n8k16, bf16 in,
//    fp32 out): a warp takes 16 docs x 16 queries a step. The dot product
//    runs over d in any order, so the k positions of the mma fragments
//    are permuted to let each lane load 16 contiguous bytes of its two
//    rows (docs g and g + 8) per 32 dims, with no shared memory and no
//    conversion: 4 lanes read 64 contiguous bytes of a row, whole
//    sectors. The query sums, permuted the same way, sit in shared
//    memory. Each warp walks a contiguous run of tiles, loading the next
//    tile while it multiplies this one; 16 warps an SM keep ~128 KB of
//    loads in flight.
//  * The table is read once. The scan writes the masked fp32 proxies
//    (0.14 GB at B = 16, streaming stores), tile-major so that a warp's
//    16 docs x B queries are one contiguous run, and, from registers and
//    shuffles, the maximum of each 16 docs (level 1, (B, N / 16)) and of
//    each 256 (level 2, folded in by atomicMax on order keys): nothing
//    else reads the corpus axis.
//  * Selection goes down the levels instead of sorting N values. Every
//    entry gets a 64-bit key (order-preserving bits of its value, then
//    the complement of its index): keys are distinct, and descending key
//    order is (value descending, index ascending). The top C entries of
//    a level lie among the 16 children of the top C entries of the level
//    above (an entry outside those parents is beaten by the best child
//    of each of C parents ranked above its own), and no child below the
//    C-th parent's value can win (each parent has a child of its own
//    value). So cell 1's top-C is three one-block-per-query rounds of an
//    exact radix select: over the 8,635 level-2 keys, then the kept
//    level-1 children of the 1,024 winners, then the kept proxies of
//    theirs (a few thousand each, in shared memory). A round skips the
//    common high bits of its candidates' keys, then histograms 8-bit
//    digits of the candidates that still match (one histogram a warp)
//    until the bin holding the C-th key is exactly what is left to take.
//    One block per query sorts the C winners (bitonic, the steps within
//    a warp on registers) and writes their indices.
// The levels follow N alone (a corpus of at most 16,384 docs takes one
// round over its proxies), the query tiles B (16 queries a tile; more
// tiles read the table again), the slabs D (any multiple of 8 up to 256,
// read as one or two 128-dim slabs). C may be any value up to N:
// candidates that do not fit shared memory stay in the workspace, and
// more than 16,384 winners are sorted in chunks merged by rank.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kFan = 16;            // entries a level-(l+1) entry covers
constexpr int kScanWarps = 8;
constexpr int kScanThreads = kScanWarps * 32;
constexpr int kChunks = 4;          // 32-dim chunks in a slab of the scan
constexpr int kQueries = 16;        // queries a scan block multiplies
constexpr int kSelThreads = 1024;
constexpr int kSelWarps = kSelThreads / 32;
constexpr int kDigit = 8;
constexpr int kBins = 1 << kDigit;  // a histogram per select warp
constexpr int kStageBatch = 16;     // candidates a thread stages at once
constexpr int kTopCap = 16384;      // the first round's most candidates
constexpr int kSortMax = 16384;     // keys one block sorts

static_assert(kBins <= kSelThreads, "find_bin takes one bin a thread");

__device__ __forceinline__ uint4 ld_stream(const void* p) {
  uint4 v;
  asm("ld.global.nc.L1::no_allocate.L2::256B.v4.u32 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Order-preserving bits of a value: -0.0 as +0.0, every NaN above +inf.
__device__ __forceinline__ uint32_t order_key(float v) {
  uint32_t b = __float_as_uint(v);
  if (v != v) b = 0x7fffffffu;
  if (b == 0x80000000u) b = 0u;
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// Distinct keys from an entry's order key and index; descending key
// order is (value descending, index ascending). A valid key is never 0:
// 0 marks a missing candidate.
__device__ __forceinline__ uint64_t rank_key(uint32_t ok, uint32_t idx) {
  return (static_cast<uint64_t>(ok) << 32) | static_cast<uint32_t>(~idx);
}

__device__ __forceinline__ uint32_t key_index(uint64_t k) {
  return ~static_cast<uint32_t>(k);
}

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

__device__ __forceinline__ uint64_t shr(uint64_t x, int s) {
  return s >= 64 ? 0ull : x >> s;
}

// The larger value in key order (NaN wins; -0.0 and +0.0 tie).
__device__ __forceinline__ float key_max(float a, float b) {
  return (a != a || a > b) ? a : b;
}

// ---------------------------------------------------------------------
// The product: proxies, level-1 and level-2 maxima.
//
// Lane (g = lane / 4, t = lane % 4) of a warp holds rows g and g + 8 of
// a 16-doc tile. For the 32 dims [32 c, 32 c + 32) it loads dims
// 32 c + 8 t .. + 7 of each row as one uint4 {x, y, z, w}; mma step s
// (two per 32 dims) takes {x, y} (s = 0) or {z, w} (s = 1) as its k
// positions {2t, 2t+1} and {2t+8, 2t+9}, and the query operand holds
// dims 32 c + 8 t + 4 s + {0, 1} and {2, 3} at the same positions. A
// tile is read in slabs of 128 dims (one slab for D <= 128, two up to
// 256), each slab's loads issued while the one before is multiplied.
__global__ void __launch_bounds__(kScanThreads, 2)
proxy_scan_kernel(const uint16_t* __restrict__ qbar,     // (B, D) bf16
                  const uint16_t* __restrict__ pooled,   // (N, D) bf16
                  const int* __restrict__ lengths,       // (N,)
                  float* __restrict__ proxy,             // (M1, B, 16)
                  float* __restrict__ lvl1,              // (B, M1)
                  uint32_t* __restrict__ lvl2,           // (B, M2) order keys, zeroed
                  int batch, int dim, int n_pad, int n_docs, int m1, int m2) {
  // every lane's query operand: [slab][chunk][step][n tile][lane]
  __shared__ uint2 s_q[2][kChunks][2][2][32];
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int q0 = blockIdx.y * kQueries;
  const int slabs = (dim + 32 * kChunks - 1) / (32 * kChunks);
  for (int e = threadIdx.x; e < 2 * kChunks * 2 * 2 * 32; e += kScanThreads) {
    const int ln = e & 31, nt = (e >> 5) & 1, st = (e >> 6) & 1, cc = e >> 7;
    const int n = q0 + 8 * nt + (ln >> 2);
    const int d8 = 32 * cc + 8 * (ln & 3);
    uint2 v = make_uint2(0u, 0u);
    if (n < batch && d8 < dim) {
      const uint32_t* p =
          reinterpret_cast<const uint32_t*>(qbar + (size_t)n * dim + d8 + 4 * st);
      v = make_uint2(p[0], p[1]);
    }
    s_q[cc / kChunks][cc % kChunks][st][nt][ln] = v;
  }
  __syncthreads();

  auto load_slab = [&](uint4 (&a)[kChunks][2], int tile, int slab) {
#pragma unroll
    for (int c = 0; c < kChunks; ++c)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = tile * 16 + g + 8 * h;
        const int d = 32 * (kChunks * slab + c) + 8 * t;
        a[c][h] = (r < n_pad && d < dim) ? ld_stream(pooled + (size_t)r * dim + d)
                                         : make_uint4(0u, 0u, 0u, 0u);
      }
  };

  // each warp a contiguous run of tiles, the runs within one tile of
  // each other in length
  const long long warps = (long long)gridDim.x * kScanWarps;
  const long long w = (long long)blockIdx.x * kScanWarps + (threadIdx.x >> 5);
  const int first = static_cast<int>(w * m1 / warps);
  const int last = static_cast<int>((w + 1) * m1 / warps);
  if (first >= last) return;
  // the maximum over this run's tiles of the current group of 16,
  // folded into level 2 when the group or the run ends (a group split
  // between two runs is folded by both)
  float top[2][2];
  auto fold = [&](int group) {
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int q = q0 + 8 * nt + 2 * t + j;
        if (g == 0 && q < batch) atomicMax(lvl2 + (size_t)q * m2 + group, order_key(top[nt][j]));
        top[nt][j] = neg_inf();
      }
  };
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) top[nt][0] = top[nt][1] = neg_inf();
  uint4 a[kChunks][2], an[kChunks][2];
  load_slab(a, first, 0);
  for (int tile = first; tile < last; ++tile) {
    if (tile > first && tile % kFan == 0) fold(tile / kFan - 1);
    float acc[2][4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[nt][j] = 0.f;
    for (int slab = 0; slab < slabs; ++slab) {
      const bool next_tile = slab + 1 == slabs;
      const bool more = !next_tile || tile + 1 < last;
      if (more) load_slab(an, next_tile ? tile + 1 : tile, next_tile ? 0 : slab + 1);
#pragma unroll
      for (int c = 0; c < kChunks; ++c)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const uint2 b0 = s_q[slab][c][0][nt][lane];
          const uint2 b1 = s_q[slab][c][1][nt][lane];
          mma_bf16(acc[nt], a[c][0].x, a[c][1].x, a[c][0].y, a[c][1].y, b0.x, b0.y);
          mma_bf16(acc[nt], a[c][0].z, a[c][1].z, a[c][0].w, a[c][1].w, b1.x, b1.y);
        }
      if (more) {
#pragma unroll
        for (int c = 0; c < kChunks; ++c) {
          a[c][0] = an[c][0];
          a[c][1] = an[c][1];
        }
      }
    }
    const int doc_lo = tile * 16 + g;
    const int doc_hi = doc_lo + 8;
    const bool keep_lo = doc_lo < n_docs && __ldg(lengths + doc_lo) > 0;
    const bool keep_hi = doc_hi < n_docs && __ldg(lengths + doc_hi) > 0;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int q = q0 + 8 * nt + 2 * t + j;
        const float v_lo = keep_lo ? acc[nt][j] : kNegInf;
        const float v_hi = keep_hi ? acc[nt][2 + j] : kNegInf;
        if (q < batch) {
          float* blk = proxy + ((size_t)tile * batch + q) * 16;
          __stcs(blk + g, v_lo);
          __stcs(blk + g + 8, v_hi);
        }
        // docs past N do not exist: they take no part in the maximum
        float m = key_max(doc_lo < n_pad ? v_lo : neg_inf(),
                          doc_hi < n_pad ? v_hi : neg_inf());
        m = key_max(m, __shfl_xor_sync(0xffffffffu, m, 4));
        m = key_max(m, __shfl_xor_sync(0xffffffffu, m, 8));
        m = key_max(m, __shfl_xor_sync(0xffffffffu, m, 16));
        if (g == 0 && q < batch) lvl1[(size_t)q * m1 + tile] = m;
        top[nt][j] = key_max(top[nt][j], m);
      }
  }
  fold((last - 1) / kFan);
}

// ---------------------------------------------------------------------
// One round of the selection: the c_out largest keys among a level's
// candidates, one block per query.
struct Round {
  const float* vals;         // this level's entries, (B, stride) or
                             // (stride / 16, B, 16) where tiled; or
  const uint32_t* okeys;     // their order keys (level 2), (B, stride)
  int stride;
  int tiled;
  int batch;
  int m;                     // entries at this level
  const uint64_t* parents;   // the round above's winners, (B, par_stride); null: all
  int par_stride;
  int count;                 // candidates: m, or 16 per parent
  int c_out;                 // winners
  int filter;                // 1: the parents are the top c_out of their level
  uint64_t* stage;           // (B, stage_stride) keys when not in shared memory
  int stage_stride;
  int in_smem;
  uint64_t* out;             // (B, out_stride) winners' keys, any order
  int out_stride;
};

// The bin, counted from the top, that holds the need-th largest key, and
// the keys in the bins over it: the warps' histograms summed, then a
// scan from the top bin down. Every thread of the block calls it.
__device__ __forceinline__ void find_bin(const uint32_t* whist, uint32_t* hist,
                                         uint32_t need, uint32_t* s_warp,
                                         uint32_t* s_bin, uint32_t* s_above) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  uint32_t h = 0, x = 0;
  if (tid < kBins) {
    const int bin = kBins - 1 - tid;
#pragma unroll 8
    for (int w = 0; w < kSelWarps; ++w) h += whist[w * kBins + bin];
    hist[bin] = h;
    x = h;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) s_warp[warp] = x;
  }
  __syncthreads();
  if (tid < kBins) {
    uint32_t before = 0;
    for (int w = 0; w < warp; ++w) before += s_warp[w];
    const uint32_t incl = x + before;
    if (incl - h < need && need <= incl) {
      *s_bin = kBins - 1 - tid;
      *s_above = incl - h;
    }
  }
}

__global__ void __launch_bounds__(kSelThreads, 1) select_round_kernel(Round r) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* whist = reinterpret_cast<uint32_t*>(smem);  // [warp][bin]
  __shared__ uint32_t hist[kBins];
  __shared__ unsigned long long s_min, s_max;
  __shared__ unsigned long long s_floor;
  __shared__ uint32_t s_valid, s_bin, s_above, s_cnt;
  __shared__ uint32_t s_warp[kBins / 32];
  const int q = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* vals = !r.vals ? nullptr : r.tiled ? r.vals + (size_t)q * 16
                                                 : r.vals + (size_t)q * r.stride;
  const size_t tile_step = r.tiled ? (size_t)r.batch * 16 : 16;
  const uint32_t* okeys = r.okeys ? r.okeys + (size_t)q * r.stride : nullptr;
  // the level's 32-bit words: order keys (level 2) or values
  const uint32_t* words = okeys ? okeys : reinterpret_cast<const uint32_t*>(vals);
  const uint64_t* parents = r.parents ? r.parents + (size_t)q * r.par_stride : nullptr;
  uint64_t* cand = r.in_smem
                       ? reinterpret_cast<uint64_t*>(smem + kSelWarps * kBins * 4)
                       : r.stage + (size_t)q * r.stage_stride;
  uint64_t* out = r.out + (size_t)q * r.out_stride;
  if (tid == 0) {
    s_min = ~0ull;
    s_max = 0ull;
    s_floor = ~0ull;
    s_valid = 0u;
    s_cnt = 0u;
  }
  __syncthreads();

  // with C parents, each a winner with a child of its own value, a child
  // below the smallest parent's value is beaten by C children: dropped
  uint32_t floor_ok = 0;
  if (r.filter) {
    unsigned long long pm = ~0ull;
    for (int i = tid; i < r.count / kFan; i += kSelThreads)
      pm = min(pm, (unsigned long long)parents[i]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) pm = min(pm, __shfl_xor_sync(0xffffffffu, pm, o));
    if (lane == 0) atomicMin(&s_floor, pm);
    __syncthreads();
    floor_ok = static_cast<uint32_t>(s_floor >> 32);
  }

  // stage the kept candidates' keys, packed, kStageBatch a thread at a
  // time (their loads in flight together); their range and count
  unsigned long long lmin = ~0ull, lmax = 0ull;
  for (int b0 = 0; b0 < r.count; b0 += kStageBatch * kSelThreads) {
    // loads without branches, so a batch's loads are in flight together
    uint32_t idx[kStageBatch];
#pragma unroll
    for (int u = 0; u < kStageBatch; ++u) {
      const int i = b0 + u * kSelThreads + tid;
      idx[u] = i < r.count ? static_cast<uint32_t>(i) : 0xffffffffu;
    }
    if (parents) {
#pragma unroll
      for (int u = 0; u < kStageBatch; ++u)
        if (idx[u] != 0xffffffffu)
          idx[u] = key_index(parents[idx[u] / kFan]) * kFan + idx[u] % kFan;
    }
    uint32_t ok[kStageBatch];
#pragma unroll
    for (int u = 0; u < kStageBatch; ++u) {
      const size_t off = (idx[u] / 16) * tile_step + idx[u] % 16;
      ok[u] = idx[u] < static_cast<uint32_t>(r.m) ? __ldg(words + off) : 0u;
    }
    if (!okeys) {
#pragma unroll
      for (int u = 0; u < kStageBatch; ++u)
        if (idx[u] < static_cast<uint32_t>(r.m)) ok[u] = order_key(__uint_as_float(ok[u]));
    }
    // one atomic a warp for the batch
    uint32_t votes[kStageBatch];
    uint32_t kept = 0;
#pragma unroll
    for (int u = 0; u < kStageBatch; ++u) {
      votes[u] = __ballot_sync(0xffffffffu, idx[u] < static_cast<uint32_t>(r.m) &&
                                                ok[u] >= floor_ok);
      kept += __popc(votes[u]);
    }
    uint32_t at = 0;
    if (lane == 0 && kept) at = atomicAdd(&s_valid, kept);
    at = __shfl_sync(0xffffffffu, at, 0);
#pragma unroll
    for (int u = 0; u < kStageBatch; ++u) {
      if ((votes[u] >> lane) & 1u) {
        const uint64_t k = rank_key(ok[u], idx[u]);
        cand[at + __popc(votes[u] & ((1u << lane) - 1u))] = k;
        lmin = min(lmin, (unsigned long long)k);
        lmax = max(lmax, (unsigned long long)k);
      }
      at += __popc(votes[u]);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    lmin = min(lmin, __shfl_xor_sync(0xffffffffu, lmin, o));
    lmax = max(lmax, __shfl_xor_sync(0xffffffffu, lmax, o));
  }
  if (lane == 0) {
    atomicMin(&s_min, lmin);
    atomicMax(&s_max, lmax);
  }
  __syncthreads();
  const int n = static_cast<int>(s_valid);

  // winners: every key k with (k >> pos) >= prefix
  uint32_t need = static_cast<uint32_t>(r.c_out);
  uint64_t prefix;
  int pos;
  if (static_cast<uint32_t>(n) <= need) {
    pos = 0;
    prefix = s_min;
  } else {
    pos = 64 - __clzll(static_cast<long long>(s_min ^ s_max));
    prefix = shr(s_max, pos);
  }
  uint32_t* my_hist = whist + warp * kBins;
  while (pos > 0) {
    const int bits = pos < kDigit ? pos : kDigit;
    const int shift = pos - bits;
    const uint32_t mask = (1u << bits) - 1u;
    for (int j = tid; j < kSelWarps * kBins; j += kSelThreads) whist[j] = 0u;
    __syncthreads();
    // each warp its own histogram, one atomic per bin it touches: the
    // candidates crowd few bins
#pragma unroll 4
    for (int base = 0; base < n; base += kSelThreads) {
      const int i = base + tid;
      const uint64_t k = i < n ? cand[i] : 0ull;
      const bool in = i < n && shr(k, pos) == prefix;
      const uint32_t active = __ballot_sync(0xffffffffu, in);
      if (in) {
        // a warp whose keys share one bin adds once
        const uint32_t bin = static_cast<uint32_t>(k >> shift) & mask;
        const int leader = __ffs(active) - 1;
        const uint32_t same = __ballot_sync(active, bin == __shfl_sync(active, bin, leader));
        if (same != active) atomicAdd(my_hist + bin, 1u);
        else if (lane == leader) atomicAdd(my_hist + bin, __popc(active));
      }
    }
    __syncthreads();
    find_bin(whist, hist, need, s_warp, &s_bin, &s_above);
    __syncthreads();
    const uint32_t b = s_bin;
    need -= s_above;
    const uint32_t in_bin = hist[b];
    prefix = (prefix << bits) | b;
    pos = shift;
    __syncthreads();  // hist and s_bin are read before the next pass writes
    if (in_bin == need) break;
  }

  for (int base = 0; base < n; base += kSelThreads) {
    const int i = base + tid;
    const uint64_t k = i < n ? cand[i] : 0ull;
    const bool win = i < n && shr(k, pos) >= prefix;
    const uint32_t votes = __ballot_sync(0xffffffffu, win);
    uint32_t first = 0;
    if (lane == 0 && votes) first = atomicAdd(&s_cnt, __popc(votes));
    first = __shfl_sync(0xffffffffu, first, 0);
    if (win) out[first + __popc(votes & ((1u << lane) - 1u))] = k;
  }
}

// The steps j = j0, j0 / 2, .. 1 (all under 32) of bitonic merges k0,
// 2 k0, .. k1, on keys in registers: a step's partner is in the warp.
__device__ __forceinline__ void warp_steps(uint64_t* s, int width, int k0, int k1,
                                           int j0) {
  for (int e = threadIdx.x; e < width; e += kSelThreads) {
    uint64_t x = s[e];
    for (int k = k0, j1 = j0; k <= k1; k <<= 1, j1 = k >> 1)
      for (int j = j1; j > 0; j >>= 1) {
        const uint64_t y = __shfl_xor_sync(0xffffffffu, x, j);
        x = (((e & k) == 0) == ((e & j) == 0)) ? max(x, y) : min(x, y);
      }
    s[e] = x;
  }
}

// Sorts chunk blockIdx.x of each query's winners descending, in shared
// memory (bitonic; the steps within a warp on registers): writes the
// indices to ``ids`` (one chunk) or the sorted keys back in place
// (several, merged by merge_rank_kernel).
__global__ void __launch_bounds__(kSelThreads, 1)
sort_chunk_kernel(uint64_t* keys, int stride, int c, int chunk, int* ids) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* s = reinterpret_cast<uint64_t*>(smem);
  const int q = blockIdx.y;
  const int base = blockIdx.x * chunk;
  const int len = min(chunk, c - base);
  int width = 32;  // whole warps
  while (width < len) width <<= 1;
  uint64_t* row = keys + (size_t)q * stride + base;
  for (int i = threadIdx.x; i < width; i += kSelThreads) s[i] = i < len ? row[i] : 0ull;
  __syncthreads();
  warp_steps(s, width, 2, 32, 1);
  __syncthreads();
  for (int k = 64; k <= width; k <<= 1) {
    for (int j = k >> 1; j >= 32; j >>= 1) {
      for (int i = threadIdx.x; i < width; i += kSelThreads) {
        const int o = i ^ j;
        if (o > i) {
          const uint64_t x = s[i], y = s[o];
          if (((i & k) == 0) == (x < y)) {
            s[i] = y;
            s[o] = x;
          }
        }
      }
      __syncthreads();
    }
    warp_steps(s, width, k, k, 16);
    __syncthreads();
  }
  if (ids && chunk >= c) {
    for (int i = threadIdx.x; i < len; i += kSelThreads)
      ids[(size_t)q * c + i] = static_cast<int>(key_index(s[i]));
  } else {
    for (int i = threadIdx.x; i < len; i += kSelThreads) row[i] = s[i];
  }
}

// Each key's place among all of its query's winners: its place in its
// own sorted chunk plus the keys above it in every other chunk.
__global__ void merge_rank_kernel(const uint64_t* keys, int stride, int c, int chunk,
                                  int* ids) {
  const int q = blockIdx.y;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= c) return;
  const uint64_t* row = keys + (size_t)q * stride;
  const uint64_t k = row[i];
  const int own = i / chunk;
  int rank = i - own * chunk;
  for (int j = 0; j * chunk < c; ++j) {
    if (j == own) continue;
    const uint64_t* part = row + (size_t)j * chunk;
    int lo = 0, hi = min(chunk, c - j * chunk);
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (part[mid] > k) lo = mid + 1;
      else hi = mid;
    }
    rank += lo;
  }
  ids[(size_t)q * c + rank] = static_cast<int>(key_index(k));
}

// ---------------------------------------------------------------------
// The levels and the workspace: proxies (B, N) f32 first, then the level
// maxima, two winner buffers and the candidates' staging area.
struct Plan {
  int m[3];
  int top;        // the level of the first round
  int stage_max;  // most candidates of any round
  size_t off[6];  // proxy, lvl1, lvl2, keys0, keys1, stage
  size_t total;
};

size_t align256(size_t x) { return (x + 255) / 256 * 256; }

Plan make_plan(int batch, int n_pad, int c) {
  Plan p;
  p.m[0] = n_pad;
  p.m[1] = (n_pad + kFan - 1) / kFan;
  p.m[2] = (p.m[1] + kFan - 1) / kFan;
  p.top = p.m[0] <= kTopCap ? 0 : p.m[1] <= kTopCap ? 1 : 2;
  p.stage_max = p.m[p.top];
  for (int l = 0; l < p.top; ++l) {
    const int parents = c < p.m[l + 1] ? c : p.m[l + 1];
    if (kFan * parents > p.stage_max) p.stage_max = kFan * parents;
  }
  const size_t b = static_cast<size_t>(batch);
  const size_t bytes[6] = {b * p.m[1] * 16 * 4, b * p.m[1] * 4, b * p.m[2] * 4,
                           b * c * 8,      b * c * 8,      b * p.stage_max * 8};
  size_t at = 0;
  for (int i = 0; i < 6; ++i) {
    p.off[i] = at;
    at += align256(bytes[i]);
  }
  p.total = at;
  return p;
}

}  // namespace

// Bytes of workspace proxy_topk_launch needs for (batch, n_pad, c).
extern "C" size_t proxy_topk_workspace(int batch, int n_pad, int c) {
  if (batch <= 0 || n_pad <= 0 || c <= 0) return 0;
  return make_plan(batch, n_pad, c).total;
}

// Launches on `stream`; returns the first nonzero CUDA error (0 on
// success). qbar: (batch, dim) bf16; pooled: (n_pad, dim) bf16, 16-byte
// aligned; lengths: (n_pad,) int32; workspace: proxy_topk_workspace
// bytes, 256-byte aligned (the proxies at its start, fp32, tile-major:
// (ceil(n_pad / 16), batch, 16), doc 16 i + j of query b at [i][b][j]);
// cand: (batch, c) int32.
extern "C" int proxy_topk_launch(const void* qbar, const void* pooled,
                                 const void* lengths, void* workspace, void* cand,
                                 int batch, int dim, int n_pad, int n_docs, int c,
                                 void* stream_ptr) {
  if (dim < 8 || dim > 256 || dim % 8 != 0 || batch < 0 || n_pad <= 0 ||
      n_docs < 0 || n_docs > n_pad || c <= 0 || c > n_pad)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return 0;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const Plan p = make_plan(batch, n_pad, c);
  unsigned char* ws = static_cast<unsigned char*>(workspace);
  float* level[2] = {reinterpret_cast<float*>(ws + p.off[0]),
                     reinterpret_cast<float*>(ws + p.off[1])};
  uint32_t* lvl2 = reinterpret_cast<uint32_t*>(ws + p.off[2]);
  uint64_t* keys[2] = {reinterpret_cast<uint64_t*>(ws + p.off[3]),
                       reinterpret_cast<uint64_t*>(ws + p.off[4])};
  uint64_t* stage = reinterpret_cast<uint64_t*>(ws + p.off[5]);
  int* ids = static_cast<int*>(cand);

  int dev = 0, sms = 0, smem_max = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);

  cudaError_t err = cudaMemsetAsync(lvl2, 0, sizeof(uint32_t) * batch * p.m[2], stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, proxy_scan_kernel,
                                                      kScanThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid_y = (batch + kQueries - 1) / kQueries;
  int grid_x = sms * (per_sm > 0 ? per_sm : 1) / grid_y;
  const int need_x = (p.m[1] + kScanWarps - 1) / kScanWarps;
  grid_x = grid_x < 1 ? 1 : grid_x > need_x ? need_x : grid_x;
  proxy_scan_kernel<<<dim3(grid_x, grid_y), kScanThreads, 0, stream>>>(
      static_cast<const uint16_t*>(qbar), static_cast<const uint16_t*>(pooled),
      static_cast<const int*>(lengths), level[0], level[1], lvl2, batch, dim, n_pad,
      n_docs, p.m[1], p.m[2]);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  // the rounds, from the top level down to the proxies
  const int hist_bytes = kSelWarps * kBins * 4;
  const int smem_keys = (smem_max - hist_bytes - 2048) / 8;  // 2 KB: static
  int round = 0;
  for (int l = p.top; l >= 0; --l, ++round) {
    Round r;
    r.vals = l < 2 ? level[l] : nullptr;
    r.tiled = l == 0;
    r.batch = batch;
    r.okeys = l == 2 ? lvl2 : nullptr;
    r.stride = p.m[l];
    r.m = p.m[l];
    r.parents = l == p.top ? nullptr : keys[(round - 1) % 2];
    r.par_stride = c;
    const int parents = l == p.top ? 0 : c < p.m[l + 1] ? c : p.m[l + 1];
    r.count = l == p.top ? p.m[l] : kFan * parents;
    r.c_out = c < p.m[l] ? c : p.m[l];
    r.filter = parents == c;
    r.stage = stage;
    r.stage_stride = p.stage_max;
    r.in_smem = r.count <= smem_keys;
    r.out = keys[round % 2];
    r.out_stride = c;
    const int bytes = hist_bytes + (r.in_smem ? r.count * 8 : 0);
    err = cudaFuncSetAttribute(select_round_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    select_round_kernel<<<batch, kSelThreads, bytes, stream>>>(r);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }

  // the winners in order
  uint64_t* win = keys[(round - 1) % 2];
  const int chunk = c <= kSortMax ? c : kSortMax;
  int width = 32;
  while (width < chunk) width <<= 1;
  const int bytes = width * 8;
  err = cudaFuncSetAttribute(sort_chunk_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int chunks = (c + chunk - 1) / chunk;
  sort_chunk_kernel<<<dim3(chunks, batch), kSelThreads, bytes, stream>>>(win, c, c,
                                                                         chunk, ids);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (chunks > 1) {
    merge_rank_kernel<<<dim3((c + 255) / 256, batch), 256, 0, stream>>>(win, c, c,
                                                                        chunk, ids);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}
