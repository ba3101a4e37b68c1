// Fused vector-quantization pass for Hopper (sm_90a): nearest code ids,
// gathered code rows and, optionally, the per-code cluster statistics of
// the EMA codebook update.
//
// Replaces: vae_npvc_tpu/ops/vq_pallas.py:105 `vq_fused` / `_vq_kernel`.
// Contract: dist = ||e||^2 - 2 z.e^T in fp32, argmin with ties to the
// lowest index, z_q = emb[idx] (an exact copy of the code rows, as the TPU
// kernel's one-hot fp32 product is), per-code sums (K, D) and exact counts
// (K,) over the N rows.
//
// Bound on the H100: operations. The products are 2*N*K*D; at K = 512,
// D = 128 that is 256 flops per byte of (N + K)*D*4. They run on the
// tensor cores as 3xTF32 (three TF32 products per fp32 product): bound
// 3*2*N*K*D over 495 TFLOP/s (the 67 TFLOP/s fp32 FMA rate of v1, which
// kept every product in FMA, bounds 2*N*K*D at 2.5x that time).
//
// Design.
//   - Distances as 3xTF32 on mma.sync m16n8k8: each operand x is split
//     into hi = rna_tf32(x), lo = rna_tf32(x - hi); lo*hi, hi*lo, hi*hi are
//     summed, small terms first. ||e||^2 is exact fp32 (sequential FMA over
//     d, v1's order), once per launch in each block for its codes.
//   - Exact fp32 re-scoring of near ties. Each row keeps its best four
//     3xTF32 distances by (dist, index). With S = sum_d |z_d e_d| <=
//     ||z|| * max_k ||e_k||, the split drops at most 3*2^-22 S of a dot
//     product, the tensor cores' fp32 accumulation (3D/8 steps, each within
//     2^-22 of the running magnitude, truncating) at most (3D/8 + 3)*2^-22 S,
//     and v1's sequential FMA dot at most D*2^-24 S from the exact value.
//     The two distances of one code therefore differ by at most
//     2*(5D/8 + 6)*2^-22 S, plus the rounding of e2 - 2 dot (2^-24 of
//     e2 + 2S each). The margin
//         M = 2^-20 * ((D + 8) * ||z|| * max ||e|| + max ||e||^2)
//     covers twice that, so the FMA argmin lies within M of the best 3xTF32
//     distance: a row whose second best is more than M above its best keeps
//     it; one whose fourth is more than M above re-scores the two or three
//     within M in exact fp32 FMA in d order (v1's arithmetic: the rows are
//     copied into the warp's shared memory, one chain a lane); any other
//     re-scores all K (the whole block, a thread two codes, from L2). The
//     ids are v1's (and so the committed JAX fixture's) on every row. The
//     kernel counts the re-scored rows per block, and those re-scored over
//     all K. Random rows re-score ~0.25 %; the smoke's training batches up
//     to ~26 % (its codes crowd together), a codebook whose rows repeat
//     every row near a repeated code.
//   - The codebook is held across a thread-block cluster of 4, 8 or 16
//     blocks (the smallest whose shared memory fits): rank r keeps codes
//     [r*Kr, (r+1)*Kr) in fp32, resident for the life of the block, so no
//     block re-reads the codebook; B fragments are split as they are read.
//     The grid is persistent: cluster c walks the 128-row tiles c, c + G,
//     c + 2G, ... in that order. Each rank loads every tile of its cluster
//     with 16-byte cp.async (4-byte where D or a pointer does not allow it)
//     into one of two buffers, the next tile while the current one merges.
//   - 8 warps: warp w takes rows [16w, 16w + 16) of the tile against all
//     the rank's codes, NT n-tiles of 8 codes a pass (a template argument:
//     NT independent accumulators, whose three products interleave); the
//     best four per row go through the quad's shuffles and are stored
//     straight into the shared memory of the rank that merges the row
//     (distributed shared memory: stores, off the critical path). A
//     cluster barrier; then rank r merges rows [r*128/CR, (r+1)*128/CR) of
//     the tile from its own shared memory: CR threads a row merge the
//     ranks' lists by (dist, index), apply the margin and, where the best
//     stands, write the id; a warp a row re-scores the others. Ids mode is
//     this one launch.
//   - Statistics without atomics, in v1's order: vq_stats, a second
//     launch, adds each code's rows in exactly v1's summation order
//     (16 row segments, 8 row classes a segment, each summed in row
//     order; classes, then segments, added in order), so the sums are v1's
//     bit for bit, and counts them and gathers z_q. A cluster of 8 blocks
//     a code group: each block two segments, rank 0 adds the 16 segment
//     sums in order through distributed shared memory. That order matters
//     beyond rounding: the smoke's 20-step bf16 training run ends on one
//     side or the other of its fixed-batch loss check by the order of
//     these sums alone (v1 with its 16 segment sums added in reverse order
//     fails it), so the statistics keep v1's order and the training
//     trajectory is v1's. The sums in the cluster's shared memory (each
//     rank adding the rows of its codes) were faster but gave another
//     order. Two launches, bit-equal reruns, exact counts, no dependence
//     on the number of clusters the card schedules.
//   - D is zero-padded to a multiple of 8 (the MMA's k step) in shared
//     memory. Rows >= N read as zero and are never written.
//
// C interface (loaded with ctypes): vq_plan gives the launch's cluster size,
// clusters and re-scored counters; vq_fused_launch returns
// cudaGetLastError(). Host-side
// caches are keyed by device (the entry point's `device` argument).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <climits>
#include <initializer_list>
#include <cstdint>
#include <math.h>
#include <mutex>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;   // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 16 * kWarps;   // z rows per tile: 16 a warp
constexpr int kClusterSizes[3] = {4, 8, 16};
constexpr int kBest = 4;             // candidates kept per row

__host__ __device__ constexpr int round_up(int a, int m) {
  return (a + m - 1) / m * m;
}
__host__ __device__ constexpr int padded_dim(int D) { return round_up(D, 8); }
// row stride in elements: conflict-free fragment reads (see below)
__host__ __device__ constexpr int row_stride(int D) {
  return padded_dim(D) + 4;
}
// codes per rank: whole n-tiles of 8
__host__ __device__ constexpr int codes_per_rank(int K, int cr) {
  return round_up((K + cr - 1) / cr, 8);
}

// Shared-memory layout of one block, in bytes from the start.
struct Layout {
  size_t cb, zt, e2, cand, zn, resc, misc, total;
};

__host__ __device__ inline Layout layout(int Kr, int D) {
  const int ld = row_stride(D);
  Layout L;
  size_t o = 0;
  auto take = [&](size_t bytes) {
    const size_t at = o;
    o = round_up((int)(o + bytes), 16);
    return at;
  };
  L.cb = take((size_t)Kr * ld * 4);               // the rank's codes, fp32
  L.zt = take((size_t)2 * kRows * ld * 4);        // two z tiles
  L.e2 = take((size_t)Kr * 4);
  L.cand = take(2 * kRows * kBest * 8);           // ranks' best four, x2
  L.zn = take(kRows * 4);                         // ||z||^2 of the tile
  // each warp's rows of up to kBest - 1 codes being re-scored
  L.resc = take((size_t)kWarps * (kBest - 1) * padded_dim(D) * 4);
  // max ||e||, re-scored rows a warp (two counts), re-scoring modes and
  // candidates of up to kRows/4 rows, the block's re-scoring minimum
  L.misc = take(4 + 8 * kWarps + 4 * kBest * (kRows / 4) + 8 * kWarps);
  L.total = o;
  return L;
}

// ------------------------------------------------------------ async copies
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(s), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// ------------------------------------------------------ tensor-core tiles
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x = hi + lo + O(2^-22 |x|), both TF32 (round to nearest, ties away)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  const float r = __fsub_rn(x, __uint_as_float(hi));
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(r));
}

// ------------------------------------------------------ best four a row
// Order by (dist, index): ties go to the lower index whatever the order
// in which candidates arrive; a NaN distance is never taken.
__device__ __forceinline__ bool before(float da, int ia, float db, int ib) {
  return da < db || (da == db && ia < ib);
}

// A candidate as one 64-bit key: the distance's bits made order-preserving
// as an unsigned integer (-0 taken as +0; NaN above +inf) over the index,
// so that (dist, index) order is one unsigned compare.
__device__ __forceinline__ unsigned long long key_of(float d, int i) {
  const unsigned u = __float_as_uint(__fadd_rn(d, 0.f));
  const unsigned o = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((unsigned long long)o << 32) | (unsigned)i;
}
constexpr unsigned long long kNoKey = ~0ull;

// The best kBest keys, kept sorted by a branchless insertion network.
struct Best {
  unsigned long long k[kBest];
  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int j = 0; j < kBest; ++j) k[j] = kNoKey;
  }
  __device__ __forceinline__ void add(unsigned long long x) {
#pragma unroll
    for (int j = 0; j < kBest - 1; ++j) {
      const unsigned long long a = min(k[j], x);
      x = max(k[j], x);
      k[j] = a;
    }
    k[kBest - 1] = min(k[kBest - 1], x);
  }
  // merge the list of the lane `mask` away (disjoint candidates)
  __device__ __forceinline__ void shfl_merge(int mask) {
    unsigned long long o[kBest];
#pragma unroll
    for (int j = 0; j < kBest; ++j)
      o[j] = __shfl_xor_sync(0xffffffffu, k[j], mask);
#pragma unroll
    for (int j = 0; j < kBest; ++j) add(o[j]);
  }
  __device__ __forceinline__ float dist(int j) const {
    const unsigned o = (unsigned)(k[j] >> 32);
    return __uint_as_float((o & 0x80000000u) ? (o & 0x7fffffffu) : ~o);
  }
  // INT_MAX: no candidate, or a NaN distance
  __device__ __forceinline__ int index(int j) const {
    return k[j] == kNoKey || isnan(dist(j)) ? INT_MAX : (int)(unsigned)k[j];
  }
};

// v1's exact fp32 distance of one code: sequential FMA over d (the loads
// of an unrolled step are independent and go out together)
__device__ __forceinline__ float exact_dist(const float* zrow, const float* e,
                                            int D) {
  float acc = 0.f, s = 0.f;
#pragma unroll 16
  for (int d = 0; d < D; ++d) {
    const float v = e[d];
    acc = fmaf(zrow[d], v, acc);
    s = fmaf(v, v, s);
  }
  return __fsub_rn(s, 2.f * acc);
}

// Rows [0, nrows) x [0, D) of a row-major (., D) matrix from `src` into
// rows [0, rows) of `dst` (row stride ld); rows >= nrows and columns >= D
// zero-filled. All copies are in flight at once.
template <bool VEC>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int nrows, int rows, int D,
                                          int ld) {
  const int Dp = padded_dim(D);
  if (VEC) {
    const int chunks = Dp / 4;
    for (int i = threadIdx.x; i < rows * chunks; i += kThreads) {
      const int r = i / chunks, c = (i - r * chunks) * 4;
      const bool in = r < nrows && c < D;
      cp_async16(dst + r * ld + c, in ? src + (long long)r * D + c : src,
                 in ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < rows * Dp; i += kThreads) {
      const int r = i / Dp, c = i - r * Dp;
      const bool in = r < nrows && c < D;
      cp_async4(dst + r * ld + c, in ? src + (long long)r * D + c : src,
                in ? 4 : 0);
    }
  }
}

// Tile `tile` of z (kRows rows) into `dst`.
template <bool VEC>
__device__ __forceinline__ void load_tile(float* dst, const float* z, int N,
                                          int D, int ld, long long tile) {
  const long long r0 = tile * kRows;
  load_rows<VEC>(dst, z + r0 * D, (int)min((long long)kRows, N - r0), kRows,
                 D, ld);
}

// Built with -DVQ_PHASE_CLOCKS (tools/torch_vq_time.py --phases), the
// kernel adds thread 0's clock64() cycles per phase into
// vq_phase_cycles[block][phase]: 7 the codebook share, 0 the rest of the
// set-up, 1 waiting for a tile, 8 the products (and the tile's norms), 9
// each thread's best four, 2 the quads' merge and the stores to the
// merging ranks, 3 the cluster barrier, 4 the next tile's loads issued, 5
// the merge, 6 the end.
#ifdef VQ_PHASE_CLOCKS
constexpr int kPhases = 12;
__device__ long long vq_phase_cycles[4096][kPhases];
#define PHASE(k)                           \
  do {                                     \
    const long long now_ = clock64();      \
    phase_[k] += now_ - phase_t_;          \
    phase_t_ = now_;                       \
  } while (0)
#else
#define PHASE(k) \
  do {           \
  } while (0)
#endif

template <bool VEC, int NT>
__global__ void __launch_bounds__(kThreads, 1)
vq_cluster(const float* __restrict__ z, const float* __restrict__ emb, int N,
           int K, int D, int Kr, int* __restrict__ idx,
           int* __restrict__ rescored) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int CR = (int)cluster.num_blocks();
  const int cid = blockIdx.x / CR, G = gridDim.x / CR;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int ld = row_stride(D), Dp = padded_dim(D);
  const Layout L = layout(Kr, D);
  float* cb = reinterpret_cast<float*>(smem + L.cb);
  float* zt = reinterpret_cast<float*>(smem + L.zt);
  float* e2s = reinterpret_cast<float*>(smem + L.e2);
  unsigned long long* cand =
      reinterpret_cast<unsigned long long*>(smem + L.cand);
  float* zn2s = reinterpret_cast<float*>(smem + L.zn);
  float* emax_s = reinterpret_cast<float*>(smem + L.misc);
  int* wres = reinterpret_cast<int*>(smem + L.misc + 4);   // 2 x kWarps
  int* rq_mode = wres + 2 * kWarps;
  int* rq_i = rq_mode + kRows / 4;   // (kRows / 4) x (kBest - 1)
  float* resc = reinterpret_cast<float*>(smem + L.resc);
  float* rd_d = reinterpret_cast<float*>(rq_i + (kRows / 4) * (kBest - 1));
  int* rd_i = reinterpret_cast<int*>(rd_d + kWarps);

  const int k0 = rank * Kr;                        // first code of the rank
  const int kvalid = max(0, min(Kr, K - k0));      // codes it owns
  const long long n_tiles = ((long long)N + kRows - 1) / kRows;
  const int my_tiles = (int)max(0LL, (n_tiles - cid + G - 1) / G);
  const int rows_per_rank = kRows / CR;
#ifdef VQ_PHASE_CLOCKS
  long long phase_[kPhases] = {};
  long long phase_t_ = clock64();
#endif

  // the codebook share (fp32, rows past the codebook zero) and the first
  // tile, in flight together; then exact fp32 ||e||^2 (sequential FMA,
  // v1's order)
  for (int c0 = 0; c0 < Kr; c0 += kRows) {
    const int nv = max(0, min(kRows, kvalid - c0));
    load_rows<VEC>(cb + c0 * ld, nv ? emb + (long long)(k0 + c0) * D : emb,
                   nv, min(kRows, Kr - c0), D, ld);
  }
  cp_commit();
  if (my_tiles > 0) load_tile<VEC>(zt, z, N, D, ld, cid);
  cp_commit();
  cp_wait<1>();
  __syncthreads();
  for (int c = tid; c < Kr; c += kThreads) {
    const float* e = cb + c * ld;
    float s = 0.f;
#pragma unroll 16
    for (int d = 0; d < D; ++d) s = fmaf(e[d], e[d], s);
    e2s[c] = c < kvalid ? s : INFINITY;
  }
  PHASE(7);
  if (tid < 2 * kWarps) wres[tid] = 0;
  __syncthreads();
  // max ||e||^2 of the rank's codes, then of the codebook via the cluster
  if (warp == 0) {
    float m = 0.f;
    for (int c = lane; c < kvalid; c += 32) m = fmaxf(m, e2s[c]);
    for (int o = 16; o > 0; o >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    if (lane == 0) *emax_s = m;
  }
  cluster.sync();
  float emax2 = lane < CR ? *cluster.map_shared_rank(emax_s, lane) : 0.f;
  for (int o = 16; o > 0; o >>= 1)
    emax2 = fmaxf(emax2, __shfl_xor_sync(0xffffffffu, emax2, o));
  const float emax = sqrtf(emax2);
  PHASE(0);

  int n_rescored = 0, n_all_codes = 0;
  for (int it = 0; it < my_tiles; ++it) {
    const long long tile = cid + (long long)it * G;
    const int buf = it & 1;
    const float* zs = zt + buf * kRows * ld;
    cp_wait<0>();
    __syncthreads();
    PHASE(1);

    // ---- 3xTF32 distances: warp w's 16 rows against the rank's codes,
    // NT n-tiles of 8 codes a pass; B is split into (hi, lo) as it is read
    Best b_lo, b_hi;   // rows g and g + 8 of the warp's 16
    b_lo.clear();
    b_hi.clear();
    const float* arow = zs + (warp * 16 + g) * ld + t;
    {   // ||z||^2 of rows g, g + 8 for the merge's margin
      float n_lo = 0.f, n_hi = 0.f;
      for (int kk = 0; kk < Dp; kk += 8) {
        n_lo = fmaf(arow[kk], arow[kk], fmaf(arow[kk + 4], arow[kk + 4], n_lo));
        n_hi = fmaf(arow[kk + 8 * ld], arow[kk + 8 * ld],
                    fmaf(arow[kk + 8 * ld + 4], arow[kk + 8 * ld + 4], n_hi));
      }
      for (int o = 1; o < 4; o <<= 1) {
        n_lo += __shfl_xor_sync(0xffffffffu, n_lo, o);
        n_hi += __shfl_xor_sync(0xffffffffu, n_hi, o);
      }
      if (t == 0) {
        zn2s[warp * 16 + g] = n_lo;
        zn2s[warp * 16 + g + 8] = n_hi;
      }
    }
    for (int c0 = 0; c0 < Kr; c0 += NT * 8) {
      float accm[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) accm[j][q] = 0.f;
      const float* brow = cb + (c0 + g) * ld + t;
#pragma unroll 2
      for (int kk = 0; kk < Dp; kk += 8) {
        uint32_t ah[4], al[4];
        split_tf32(arow[kk], ah[0], al[0]);
        split_tf32(arow[kk + 8 * ld], ah[1], al[1]);
        split_tf32(arow[kk + 4], ah[2], al[2]);
        split_tf32(arow[kk + 8 * ld + 4], ah[3], al[3]);
        uint32_t bh0[NT], bl0[NT], bh1[NT], bl1[NT];
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          split_tf32(brow[j * 8 * ld + kk], bh0[j], bl0[j]);
          split_tf32(brow[j * 8 * ld + kk + 4], bh1[j], bl1[j]);
        }
        // 3xTF32, small terms first: lo*hi, hi*lo, hi*hi on every n-tile
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_tf32(accm[j], al, bh0[j], bh1[j]);
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_tf32(accm[j], ah, bl0[j], bl1[j]);
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_tf32(accm[j], ah, bh0[j], bh1[j]);
      }
      PHASE(8);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int c = c0 + j * 8 + 2 * t + q;
          if (c < kvalid) {
            const float e2 = e2s[c];
            b_lo.add(key_of(__fsub_rn(e2, 2.f * accm[j][q]), k0 + c));
            b_hi.add(key_of(__fsub_rn(e2, 2.f * accm[j][2 + q]), k0 + c));
          }
        }
      }
    }
    PHASE(9);
    b_lo.shfl_merge(1);
    b_hi.shfl_merge(1);
    b_lo.shfl_merge(2);
    b_hi.shfl_merge(2);
    // each row's best four go to the rank that merges the row
    if (t == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = warp * 16 + g + 8 * h;
        const int slot =
            ((buf * rows_per_rank + r % rows_per_rank) * CR + rank) * kBest;
        const int dst = r / rows_per_rank;
        unsigned long long* to = cluster.map_shared_rank(cand, dst) + slot;
        const Best& b = h ? b_hi : b_lo;
#pragma unroll
        for (int j = 0; j < kBest; ++j) to[j] = b.k[j];
      }
    }
    PHASE(2);
    cluster.sync();   // every rank's best four of this tile are in place
    PHASE(3);

    // the next tile goes into the buffer just freed
    if (it + 1 < my_tiles)
      load_tile<VEC>(zt + (buf ^ 1) * kRows * ld, z, N, D, ld, tile + G);
    cp_commit();
    PHASE(4);

    // ---- merge of this rank's rows [rank*rpr, (rank+1)*rpr): CR
    // consecutive threads a row merge the ranks' lists and apply the margin;
    // where the best stands they write the id
    bool rescore = false;
    if (tid < kRows) {
      const int rr = tid / CR, src = tid - rr * CR;
      const int rl = rank * rows_per_rank + rr;
      const long long grow = tile * kRows + rl;
      Best b;
      const int slot = ((buf * rows_per_rank + rr) * CR + src) * kBest;
#pragma unroll
      for (int j = 0; j < kBest; ++j) b.k[j] = cand[slot + j];
      for (int o = 1; o < CR; o <<= 1) b.shfl_merge(o);
      const float margin = ldexpf(
          (float)(D + 8) * sqrtf(zn2s[rl]) * emax + emax2, -20);
      // the codes within the margin of the best: 1, the best stands;
      // 2 or 3, re-score them; kBest (the last within it too), every code
      const int i0 = b.index(0);
      int near = 1;
#pragma unroll
      for (int j = 1; j < kBest; ++j)
        if (b.index(j) != INT_MAX && !(b.dist(j) - b.dist(0) > margin))
          near = j + 1;
      if (grow >= N || i0 == INT_MAX) near = 1;
      const int id = i0 == INT_MAX ? 0 : i0;   // 0: NaN input
      if (src == 0) {
        rq_mode[rr] = near;
#pragma unroll
        for (int j = 0; j < kBest - 1; ++j)
          rq_i[rr * (kBest - 1) + j] = j == 0 ? id : b.index(j);
        rescore = near > 1;
      }
      if (near == 1 && src == 0 && grow < N) idx[grow] = id;
    }
    // ---- rows within the margin: exact fp32 (v1's arithmetic). Two or
    // three candidates: a warp a row; kBest (rare): the whole block a row
    if (__syncthreads_or(rescore)) {
      bool full = false;
      for (int rr = warp; rr < rows_per_rank; rr += kWarps) {
        const int near = rq_mode[rr];
        if (near == 1) continue;
        if (near == kBest) {
          full = true;
          continue;
        }
        const int rl = rank * rows_per_rank + rr;
        const int* cands = rq_i + rr * (kBest - 1);
        // the candidates' rows into the warp's scratch (one round trip),
        // then one sequential chain each from shared memory
        float* sc = resc + warp * (kBest - 1) * Dp;
        for (int q = 0; q < near; ++q)
          for (int d = lane; d < D; d += 32)
            sc[q * Dp + d] = __ldg(emb + (long long)cands[q] * D + d);
        __syncwarp();
        float bd = INFINITY;
        int bi = INT_MAX;
        if (lane < near) {
          bi = cands[lane];
          bd = exact_dist(zs + rl * ld, sc + lane * Dp, D);
        }
        __syncwarp();
        for (int o = 16; o > 0; o >>= 1) {
          const float od = __shfl_xor_sync(0xffffffffu, bd, o);
          const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
          if (before(od, oi, bd, bi)) {
            bd = od;
            bi = oi;
          }
        }
        n_rescored += 1;
        if (lane == 0) idx[tile * kRows + rl] = bi == INT_MAX ? cands[0] : bi;
      }
      // every code: a thread a code at a time, a few chains together, the
      // rows read from L2; the block's best by (dist, index)
      if (__syncthreads_or(full))
        for (int rr = 0; rr < rows_per_rank; ++rr) {
          if (rq_mode[rr] != kBest) continue;
          const int rl = rank * rows_per_rank + rr;
          const float* zrow = zs + rl * ld;
          float bd = INFINITY;
          int bi = INT_MAX;
          for (int c0 = tid * 2; c0 < K; c0 += kThreads * 2) {
            const float* e0 = emb + (long long)c0 * D;
            const float* e1 = emb + (long long)min(c0 + 1, K - 1) * D;
            float dot0 = 0.f, sq0 = 0.f, dot1 = 0.f, sq1 = 0.f;
#pragma unroll 16
            for (int d = 0; d < D; ++d) {
              const float zv = zrow[d], v0 = __ldg(e0 + d), v1 = __ldg(e1 + d);
              dot0 = fmaf(zv, v0, dot0);
              sq0 = fmaf(v0, v0, sq0);
              dot1 = fmaf(zv, v1, dot1);
              sq1 = fmaf(v1, v1, sq1);
            }
            const float d0 = __fsub_rn(sq0, 2.f * dot0);
            const float d1 = __fsub_rn(sq1, 2.f * dot1);
            if (before(d0, c0, bd, bi)) {
              bd = d0;
              bi = c0;
            }
            if (c0 + 1 < K && before(d1, c0 + 1, bd, bi)) {
              bd = d1;
              bi = c0 + 1;
            }
          }
          for (int o = 16; o > 0; o >>= 1) {
            const float od = __shfl_xor_sync(0xffffffffu, bd, o);
            const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
            if (before(od, oi, bd, bi)) {
              bd = od;
              bi = oi;
            }
          }
          __syncthreads();   // rd is free
          if (lane == 0) {
            rd_d[warp] = bd;
            rd_i[warp] = bi;
          }
          __syncthreads();
          if (tid == 0) {
            for (int w = 1; w < kWarps; ++w)
              if (before(rd_d[w], rd_i[w], bd, bi)) {
                bd = rd_d[w];
                bi = rd_i[w];
              }
            idx[tile * kRows + rl] =
                bi == INT_MAX ? rq_i[rr * (kBest - 1)] : bi;
            n_rescored += 1;
            n_all_codes += 1;
          }
        }
    }
    PHASE(5);
  }

  // no rank reads or writes this block's shared memory after this
  cluster.sync();
  if (lane == 0) {   // each counted once, on its warp's lane 0
    wres[warp] = n_rescored;
    wres[kWarps + warp] = n_all_codes;
  }
  __syncthreads();
  if (tid < 2) {
    int s = 0;
    for (int w = 0; w < kWarps; ++w) s += wres[tid * kWarps + w];
    rescored[tid * gridDim.x + blockIdx.x] = s;
  }
#ifdef VQ_PHASE_CLOCKS
  PHASE(6);
  if (tid == 0 && blockIdx.x < 4096)
    for (int k = 0; k < kPhases; ++k)
      vq_phase_cycles[blockIdx.x][k] = phase_[k];
#endif
}

// ------------------------------------------------------------ statistics
constexpr int kSegments = 16;       // v1's row segments
constexpr int kStatCodes = kWarps;  // codes a block (a warp each at the end)
constexpr int kPiece = 2048;        // ids staged at a time
constexpr int kStatCluster = 8;     // blocks a cluster, two segments each

// Per-code sums, counts and z_q = emb[idx] over the N rows, in v1's
// summation order, so that the sums are v1's bit for bit: rows fall into
// kSegments segments of ceil(N/16); within a segment, class w holds the
// rows r with (r - segment start) % 8 == w, each class summed in row order
// from 0; a segment's sum is its classes' sums added in class order from
// 0, the total its segments' sums added in segment order from 0. A cluster
// of 8 blocks takes codes [8g, 8g + 8) and columns [32y, 32y + 32); rank r
// sums segments 2r and 2r + 1 (warp w is class w, lane l column 32y + l),
// and rank 0 adds the 16 segment sums in order through distributed shared
// memory. A warp lists its class's matching rows of a staged piece (a
// ballot over 32 ids at a time) and loads their z eight rows at a time.
__global__ void __cluster_dims__(kStatCluster, 1, 1) __launch_bounds__(kThreads)
vq_stats(const float* __restrict__ z, const float* __restrict__ emb,
         const int* __restrict__ idx, int N, int K, int D,
         float* __restrict__ zq, float* __restrict__ bsum,
         float* __restrict__ belem) {
  __shared__ int ids_s[kWarps][kPiece / kWarps];   // a piece, by class
  __shared__ int hits[kWarps][kPiece / kWarps];    // its matching rows
  __shared__ float part[kWarps][kStatCodes][32];
  __shared__ int part_n[kWarps][kStatCodes];
  __shared__ float seg_t[2][kStatCodes][32];       // this block's segments
  __shared__ int seg_n[2][kStatCodes];
  __shared__ float e_s[kStatCodes][32];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int k0 = blockIdx.x / kStatCluster * kStatCodes;
  const int d = blockIdx.y * 32 + lane;
  for (int i = tid; i < kStatCodes * 32; i += kThreads) {
    const int c = i / 32, dd = blockIdx.y * 32 + (i & 31);
    e_s[c][i & 31] = k0 + c < K && dd < D ? emb[(long long)(k0 + c) * D + dd]
                                         : 0.f;
  }
  const long long seg_rows = ((long long)N + kSegments - 1) / kSegments;
  for (int h = 0; h < 2; ++h) {
    const long long rb = (rank * 2 + h) * seg_rows;
    const long long re = min((long long)N, rb + seg_rows);
    float acc[kStatCodes];
    int n[kStatCodes];
#pragma unroll
    for (int q = 0; q < kStatCodes; ++q) {
      acc[q] = 0.f;
      n[q] = 0;
    }
    for (long long p0 = rb; p0 < re; p0 += kPiece) {
      const int np = (int)min((long long)kPiece, re - p0);
      __syncthreads();
      for (int i = tid; i < kPiece; i += kThreads)
        ids_s[i % kWarps][i / kWarps] = i < np ? idx[p0 + i] : -1;
      __syncthreads();
      // the class's rows of this piece whose code is in the block's
      // group, in row order
      int nh = 0;
      for (int j0 = 0; j0 < kPiece / kWarps; j0 += 32) {
        const int c = ids_s[warp][j0 + lane] - k0;
        const bool hit = (unsigned)c < (unsigned)kStatCodes;
        const unsigned m = __ballot_sync(0xffffffffu, hit);
        if (hit) hits[warp][nh + __popc(m & ((1u << lane) - 1))] = j0 + lane;
        nh += __popc(m);
      }
      __syncwarp();
      // their z eight rows at a time, added in row order
      for (int i0 = 0; i0 < nh; i0 += 8) {
        int jj[8];
        float v[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          jj[u] = hits[warp][min(i0 + u, nh - 1)];
          const long long r = p0 + warp + 8LL * jj[u];
          v[u] = i0 + u < nh && d < D ? z[r * D + d] : 0.f;
        }
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          if (i0 + u >= nh) break;
          const int cu = ids_s[warp][jj[u]] - k0;
#pragma unroll
          for (int q = 0; q < kStatCodes; ++q)
            if (q == cu) {
              acc[q] += v[u];
              n[q] += 1;
            }
          const long long r = p0 + warp + 8LL * jj[u];
          if (d < D) zq[r * D + d] = e_s[cu][lane];
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kStatCodes; ++q) {
      part[warp][q][lane] = acc[q];
      if (lane == 0) part_n[warp][q] = n[q];
    }
    __syncthreads();
    float t = 0.f;
    int tn = 0;
    for (int w = 0; w < kWarps; ++w) {
      t += part[w][warp][lane];
      tn += part_n[w][warp];
    }
    seg_t[h][warp][lane] = t;
    if (lane == 0) seg_n[h][warp] = tn;
    __syncthreads();   // part is free for the next segment
  }
  cluster.sync();   // every segment's sums are in place
  if (rank == 0 && k0 + warp < K) {
    float v[kSegments];
    int vn[kSegments];
#pragma unroll
    for (int sg = 0; sg < kSegments; ++sg) {
      v[sg] = cluster.map_shared_rank(&seg_t[sg & 1][warp][lane], sg >> 1)[0];
      vn[sg] = cluster.map_shared_rank(&seg_n[sg & 1][warp], sg >> 1)[0];
    }
    float total = 0.f;
    int count = 0;
#pragma unroll
    for (int sg = 0; sg < kSegments; ++sg) {
      total += v[sg];
      count += vn[sg];
    }
    if (d < D) bsum[(long long)(k0 + warp) * D + d] = total;
    if (blockIdx.y == 0 && lane == 0) belem[k0 + warp] = (float)count;
  }
  cluster.sync();   // rank 0 has read every block's sums
}

// -------------------------------------------------------------------- host
std::mutex host_mutex;  // guards the caches below (ctypes drops the GIL)
constexpr int kCacheSlots = 256;

// n-tiles of 8 codes a warp takes per pass: the most of 8, 4, 2, 1 that
// divides the rank's codes
int pass_tiles(int kr) {
  const int tiles = kr / 8;
  for (const int nt : {8, 4, 2}) if (tiles % nt == 0) return nt;
  return 1;
}

template <bool VEC>
const void* kernel_nt(int nt) {
  switch (nt) {
    case 8: return (const void*)vq_cluster<VEC, 8>;
    case 4: return (const void*)vq_cluster<VEC, 4>;
    case 2: return (const void*)vq_cluster<VEC, 2>;
    default: return (const void*)vq_cluster<VEC, 1>;
  }
}

const void* kernel_of(bool vec, int nt) {
  return vec ? kernel_nt<true>(nt) : kernel_nt<false>(nt);
}

int smem_optin(int dev) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    v = 48 * 1024;
  return v;
}

// Let a kernel take the device's largest dynamic shared memory and
// clusters of 16; once per (device, kernel).
cudaError_t prepare(const void* fn, int dev) {
  std::lock_guard<std::mutex> guard(host_mutex);
  static const void* done[kCacheSlots];
  static int devs[kCacheSlots];
  static int n_done = 0;
  for (int i = 0; i < n_done; ++i)
    if (done[i] == fn && devs[i] == dev) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_optin(dev));
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed,
                             1);
  if (e == cudaSuccess && n_done < kCacheSlots) {
    done[n_done] = fn;
    devs[n_done++] = dev;
  }
  return e;
}

// How a launch runs: clusters of `cr` blocks holding `kr` codes each,
// `nt` n-tiles a pass, at most `max_clusters` resident at once; cr == 0:
// the codebook does not fit.
struct Plan {
  int cr, kr, nt, max_clusters;
  size_t smem;
};

int active_clusters(const void* fn, int cr, size_t smem) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cr);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute a[1];
  a[0].id = cudaLaunchAttributeClusterDimension;
  a[0].val.clusterDim.x = cr;
  a[0].val.clusterDim.y = 1;
  a[0].val.clusterDim.z = 1;
  cfg.attrs = a;
  cfg.numAttrs = 1;
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, fn, &cfg) != cudaSuccess) n = 0;
  cudaGetLastError();  // a refused query is an answer, not a launch error
  return n;
}

// The smallest cluster whose blocks fit; asked once per (device, K, D).
// Both kernels of a plan (16-byte or 4-byte loads) take the same shared
// memory, so the 16-byte one answers for both.
Plan plan_of(int K, int D, int dev) {
  static int keys[kCacheSlots][3];
  static Plan plans[kCacheSlots];
  static int n_seen = 0;
  {
    std::lock_guard<std::mutex> guard(host_mutex);
    for (int i = 0; i < n_seen; ++i)
      if (keys[i][0] == dev && keys[i][1] == K && keys[i][2] == D)
        return plans[i];
  }
  Plan p = {0, 0, 0, 0, 0};
  for (const int cr : kClusterSizes) {
    const int kr = codes_per_rank(K, cr), nt = pass_tiles(kr);
    const size_t smem = layout(kr, D).total;
    if (smem > (size_t)smem_optin(dev)) continue;
    const void* fn = kernel_of(true, nt);
    if (prepare(fn, dev) != cudaSuccess ||
        prepare(kernel_of(false, nt), dev) != cudaSuccess)
      break;
    const int n = active_clusters(fn, cr, smem);
    if (n > 0) {
      p = {cr, kr, nt, n, smem};
      break;
    }
  }
  std::lock_guard<std::mutex> guard(host_mutex);
  if (n_seen < kCacheSlots) {
    keys[n_seen][0] = dev;
    keys[n_seen][1] = K;
    keys[n_seen][2] = D;
    plans[n_seen++] = p;
  }
  return p;
}

int clusters_for(const Plan& p, int N) {
  const long long tiles = ((long long)N + kRows - 1) / kRows;
  return (int)(tiles < p.max_clusters ? tiles : p.max_clusters);
}

}  // namespace

extern "C" {

// out[0] cluster size (0: the codebook does not fit shared memory), out[1]
// clusters, out[2] int32 words of `rescored`: per block, the rows it
// re-scored, then those of them re-scored over every code. Returns a CUDA
// error code.
int vq_plan(int N, int K, int D, int device, int* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Plan p = plan_of(K, D, device);
  const int G = p.cr ? clusters_for(p, N) : 0;
  out[0] = p.cr;
  out[1] = G;
  out[2] = 2 * G * p.cr;
  return (int)cudaGetLastError();
}

// z (N, D), emb (K, D) fp32 contiguous -> idx (N,) int32 and the rows
// re-scored by each block of the ids kernel (`rescored`, sized by vq_plan);
// with bsum non-null (statistics) also zq (N, D), bsum (K, D), belem (K,)
// over the N rows, by a second kernel.
int vq_fused_launch(const float* z, const float* emb, int N, int K, int D,
                    int* idx, float* zq, float* bsum, float* belem,
                    int* rescored, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Plan p = plan_of(K, D, device);
  if (p.cr == 0) return (int)cudaErrorInvalidValue;
  const int G = clusters_for(p, N);
  const bool vec = D % 4 == 0 && reinterpret_cast<uintptr_t>(z) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(emb) % 16 == 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(G * p.cr);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = s;
  cudaLaunchAttribute a[1];
  a[0].id = cudaLaunchAttributeClusterDimension;
  a[0].val.clusterDim.x = p.cr;
  a[0].val.clusterDim.y = 1;
  a[0].val.clusterDim.z = 1;
  cfg.attrs = a;
  cfg.numAttrs = 1;
  int kr = p.kr;
  void* args[] = {&z, &emb, &N, &K, &D, &kr, &idx, &rescored};
  err = cudaLaunchKernelExC(&cfg, kernel_of(vec, p.nt), args);
  if (err != cudaSuccess) return (int)err;
  if (bsum != nullptr)
    vq_stats<<<dim3((K + kStatCodes - 1) / kStatCodes * kStatCluster,
                    (D + 31) / 32),
               kThreads, 0, s>>>(z, emb, idx, N, K, D, zq, bsum, belem);
  return (int)cudaGetLastError();
}

#ifdef VQ_PHASE_CLOCKS
// the phase cycles of the last launch's first n blocks, (n, kPhases)
int vq_phase_clocks(long long* out, int n) {
  return (int)cudaMemcpyFromSymbol(out, vq_phase_cycles,
                                   sizeof(long long) * kPhases * n);
}
#endif

const char* vq_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
