// GroupNorm (+ optional tanh*sigmoid GLU) forward and backward over
// (B, T, C) with per-row valid lengths, for Hopper (sm_90a).
//
// Replaces: vae_npvc_tpu/ops/groupnorm_pallas.py `_call_fwd` / `_fwd_kernel`
// (forward) and `_call_bwd` / `_bwd_kernel` (backward), the TPU kernels that
// hold one (T, C) batch row in VMEM, extended with the masked statistics of
// vae_npvc_tpu/nn/blocks.py `group_norm(..., mask=...)`: only frames
// t < lengths[b] (clamped to [0, T]; count clamped at 1) enter the fp32
// moments, var is clamped at 0, the output is rnd(xhat*scale + bias) times
// the mask (then rnd(tanh(ya))*rnd(sigmoid(yb)) over the channel halves with
// the GLU). The backward rebuilds y in fp32 without rounding it, forms
//   dscale = sum dy*xhat, dbias = sum dy            (fp32, over valid frames)
//   dx = (dxhat - mean(dxhat) - xhat*mean(dxhat*xhat)) * rstd, dxhat = dy*scale
// and writes dx = 0 at t >= lengths[b]. The forward's affine is
// __fmul_rn/__fadd_rn (FMA contraction changes card-only bits). In bf16 the
// GLU's tanh is tanh.approx.f32 and its sigmoid takes __expf; fp32 keeps
// tanhf and expf.
//
// Bound on the H100: bytes. A few flops per element, so the least time is
// one read of x (and of the cotangent g) over the valid frames plus one
// write of the output (or dx) over all frames, at 3.35 TB/s.
//
// Layouts. x and g are (B, T, C) views with either C ("channels-last") or T
// ("channels-first", what F.conv1d(...).transpose(1, 2) hands over) as the
// unit stride, each read in place with its own strides. The output and dx
// are written in x's memory order. Loads and stores are 16-byte vectors
// along the unit axis when pointers, strides and extents allow it, else
// one element at a time (the same kernels with V = 1).
//
// Cluster path: a row crosses device memory once. A thread-block cluster of
// NB = 8 or 16 blocks takes one batch row; block r holds frames
// [r*Tb, (r+1)*Tb) x all C channels (and the cotangent's) in shared memory,
// in x's memory order, loaded once with 16-byte cp.async. The statistics
// are the TPU kernel's two-pass form (`_group_stats`): per-block group
// sums -> cluster.sync -> every block adds the NB partials in rank order
// through distributed shared memory -> mean -> centred sums of squares from
// the resident tile -> cluster.sync -> rstd. The forward then writes its
// slice. The backward, in the same residency, sums dy*xhat and dy per
// channel over its frames (without the GLU in the same pass as the centred
// squares, as g*(x - mean) times rstd), writes them to a (B, NB, C) fp32
// scratch, exchanges the group sums of scale*those through the cluster
// (m1, m2) and writes dx; gn_bwd_param adds the scratch over (batch,
// block) in a fixed order. A block leaves only after a last cluster
// barrier, so none exits while another reads its shared memory. NB is 16
// when B*8 blocks would leave SMs idle (serving's B = 8), else 8; the other
// size is taken when it lets two blocks share an SM (<= kTwoPerSm), or
// when only it holds the row. 256 threads a block; -Xptxas -v: 31-64
// registers in the forward kernels, 56-92 in the backward's (92: bf16 with
// the GLU), no spills, 1.5-2 KB of static shared memory. So the training
// decoder's bf16 forward (64 KB tiles) runs three blocks to an SM and its
// backward (x and g, 104 KB) two. What holds it above the bound on the
// card: the cluster barriers and the work between them
// (tools/torch_gn_time.py --without-barriers times a copy without them).
//
// Streaming path, for rows too long for a cluster (a tile above
// kClusterSmem at NB = 16, e.g. T > 1,600 for a 1024-channel bf16 row in
// the forward): chunks of Tc frames with the same tile code:
// gn_stream_stats (per-chunk count, mean, centred M2) -> fixed-order Chan
// merge in every later block -> gn_fwd_stream_apply; backward
// gn_bwd_stream_partial (per-chunk channel sums and group sums) ->
// gn_bwd_stream_dx -> gn_bwd_param. It reads x three times and g twice.
// The choice is made by shape at launch (gn_plan) and both paths are
// tested; no plain version runs on the card.
//
// Split statistics (sequence-parallel inference, where one row's frames
// lie on several ranks; vae_npvc_tpu/nn/blocks.py `group_norm(seq_axis=)`
// psums the statistics there). The cluster kernels divide by the row's
// own count, so a split row has two entry points of its own, one launch
// each, designed for Hopper as bandwidth-bound passes (no tensor cores, no
// TMA, no shared-memory tile). Bound: bytes, one read of x's valid frames
// for the statistics, one read plus one write of the row for the apply.
// gn_split_stats (gn_split_stats_kernel) writes this rank's per-(row,
// group) (count, mean, centred M2) over its valid frames: a grid of about
// kSplitBlocksPerSm blocks per SM over all (row, group) spans, each block
// streaming its equal share of the group's valid elements read in place
// (channels-first: Cg runs of len contiguous frames) with several 16-byte
// loads in flight a thread; every thread keeps a running triple, the
// block merges its threads' by Chan's formula in a fixed tree, and the
// last block of a (row, group) to finish, chosen by a per-(row, group)
// atomic ticket after a __threadfence, merges the blocks' triples in
// block order and resets its counter (the caller keeps one zeroed counter
// buffer per device and stream). gn_split_apply (gn_split_apply_kernel)
// merges the gathered triples of R ranks in rank order (merge_stats) in
// every block, then streams x to the output element for element: each
// output depends on one input (two with the GLU, channels c and c + C/2),
// so no tile is staged; 16-byte loads in flight, 16-byte stores, about
// kSplitBlocksPerSm blocks per SM. Never E[x^2] - mean^2.
//
// Every sum has a fixed order and no atomic adds a value (the split
// statistics' ticket only picks which block merges), so two runs give the
// same bits.
//
// C interface (loaded with ctypes): gn_forward, gn_backward,
// gn_split_stats and gn_split_apply return cudaGetLastError(); gn_plan
// returns the cluster size a launch takes (0: streaming);
// gn_scratch_floats and gn_split_scratch_floats the fp32 scratch a launch
// needs.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>
#include <mutex>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGroups = 32;
constexpr int kFrameAlign = 8;            // tiles start on multiples of this
constexpr int kClusterSmem = 200 * 1024;  // dynamic smem of a cluster block
constexpr int kTwoPerSm = 108 * 1024;     // two such blocks fit one SM
constexpr int kStreamSmem = 64 * 1024;    // tile budget of a streaming block
constexpr int kStreamMaxFrames = 64;

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// round to the storage type and back: the compute-dtype cast points of the
// reference (nn/blocks.py group_norm casts before the mask and the GLU)
template <typename T> __device__ __forceinline__ float rnd(float v) {
  return to_f<T>(from_f<T>(v));
}

// The GLU's tanh and sigmoid. fp32 takes tanhf and expf; bf16, whose
// result keeps 8 bits, the hardware's tanh.approx.f32 (relative error
// below 2^-10.9) and __expf.
template <typename T> __device__ __forceinline__ float gate_tanh(float y) {
  if constexpr (sizeof(T) == 2) {
    float r;
    asm("tanh.approx.f32 %0, %1;" : "=f"(r) : "f"(y));
    return r;
  } else {
    return tanhf(y);
  }
}

template <typename T> __device__ __forceinline__ float gate_sigmoid(float y) {
  if constexpr (sizeof(T) == 2)
    return __fdividef(1.f, 1.f + __expf(-y));
  else
    return 1.f / (1.f + expf(-y));
}

// V elements of T, 16 bytes when V > 1
template <typename T, int V> struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

template <typename T, int V>
__device__ __forceinline__ Pack<T, V> ld(const T* p) {
  return *reinterpret_cast<const Pack<T, V>*>(p);
}

template <typename T, int V>
__device__ __forceinline__ void st(T* p, const Pack<T, V>& v) {
  *reinterpret_cast<Pack<T, V>*>(p) = v;
}

__device__ __forceinline__ int valid_len(const int* lengths, int b, int T) {
  if (lengths == nullptr) return T;
  return min(max(lengths[b], 0), T);
}

// A (B, T, C) view: element (b, t, c) at b*sb + t*st + c*sc, with sc == 1
// (channels-last) or st == 1 (channels-first, cf).
struct View {
  long long sb, st, sc;
  int cf;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// Per-group block sums: f(g) is this thread's partial of group g; each warp
// adds its lanes by a fixed xor tree, then thread g adds the warps in order.
// out[g] is ready for every thread on return.
template <class F>
__device__ void block_group_sum(F f, int G, float* red, float* out) {
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  for (int g = 0; g < G; ++g) {
    float v = f(g);
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (l == 0) red[w * G + g] = v;
  }
  __syncthreads();
  if (threadIdx.x < G) {
    float t = 0.f;
    for (int i = 0; i < kWarps; ++i) t += red[i * G + threadIdx.x];
    out[threadIdx.x] = t;
  }
  __syncthreads();
}

// ------------------------------------------------------------------ tiles
// A tile holds frames [t0, t0 + Tp) of one batch row, n channels, in x's
// memory order: tile[tl*n + c] (channels-last) or tile[c*Tp + tl]
// (channels-first, Tp the row pitch). Only the nfr frames asked for are
// loaded.

// f(q, r) for this thread's share of i = q*per + r < nq*per, i = tid,
// tid + kThreads, ... in that order, without a division per step.
template <class F>
__device__ __forceinline__ void for_each_qr(int per, int nq, F f) {
  if (per <= 0 || nq <= 0) return;
  int q = threadIdx.x / per, r = threadIdx.x - q * per;
  const int dq = kThreads / per, dr = kThreads - dq * per;
  while (q < nq) {
    f(q, r);
    q += dq;
    r += dr;
    if (r >= per) {
      r -= per;
      ++q;
    }
  }
}

__device__ __forceinline__ int group_of(int c, int Cg, int G) {
  return G == 1 ? 0 : c / Cg;
}

// Issue the copy of frames [t0, t0 + nfr) of `src` row b into the tile
// (cp.async where source and tile share their order: the caller waits with
// cp_async_wait_all and a block barrier).
template <typename T, int V>
__device__ void load_tile(T* tile, bool tile_cf, int Tp, const T* src,
                          const View& v, int b, int t0, int nfr, int n) {
  const T* base = src + b * v.sb + (long long)t0 * v.st;
  if ((bool)v.cf == tile_cf && !tile_cf) {
    for_each_qr(n / V, nfr, [&](int tl, int cv) {
      const T* s = base + tl * v.st + cv * V;
      T* d = tile + tl * n + cv * V;
      if (V > 1) cp_async16(d, s); else *d = *s;
    });
  } else if ((bool)v.cf == tile_cf) {
    for_each_qr((nfr + V - 1) / V, n, [&](int c, int tv) {
      const T* s = base + c * v.sc + tv * V;
      T* d = tile + c * Tp + tv * V;
      if (V > 1) cp_async16(d, s); else *d = *s;
    });
  } else if (!tile_cf) {
    // channels-first source into a channels-last tile: vectors along T,
    // neighbouring threads on neighbouring channels of the tile
    for_each_qr(n, (nfr + V - 1) / V, [&](int tv, int c) {
      const int tl = tv * V;
      const Pack<T, V> p = ld<T, V>(base + c * v.sc + tl);
#pragma unroll
      for (int j = 0; j < V; ++j)
        if (tl + j < nfr) tile[(tl + j) * n + c] = p.v[j];
    });
  } else {
    // channels-last source into a channels-first tile: vectors along C,
    // neighbouring threads on neighbouring frames of the tile
    for_each_qr(nfr, n / V, [&](int cv, int tl) {
      const Pack<T, V> p = ld<T, V>(base + tl * v.st + cv * V);
#pragma unroll
      for (int j = 0; j < V; ++j) tile[(cv * V + j) * Tp + tl] = p.v[j];
    });
  }
}

// This thread's sum of op(x) over group g's channels and the first nv
// frames of the tile.
template <typename T, int V, class Op>
__device__ float group_accum(const T* tile, bool cf, int Tp, int C, int Cg,
                             int nv, int g, Op op) {
  float acc = 0.f;
  if (!cf) {
    for_each_qr(Cg / V, nv, [&](int tl, int cv) {
      const Pack<T, V> p = ld<T, V>(tile + tl * C + g * Cg + cv * V);
#pragma unroll
      for (int j = 0; j < V; ++j) acc += op(to_f<T>(p.v[j]));
    });
  } else {
    for_each_qr((nv + V - 1) / V, Cg, [&](int cl, int tv) {
      const int tl = tv * V;
      const Pack<T, V> p = ld<T, V>(tile + (g * Cg + cl) * Tp + tl);
#pragma unroll
      for (int j = 0; j < V; ++j)
        if (tl + j < nv) acc += op(to_f<T>(p.v[j]));
    });
  }
  return acc;
}

// Group sums of x over the tile's nv valid frames.
template <typename T, int V>
__device__ void tile_sums(const T* tile, bool cf, int Tp, int C, int G,
                          int nv, float* red, float* out) {
  const int Cg = C / G;
  block_group_sum([&](int g) {
    return group_accum<T, V>(tile, cf, Tp, C, Cg, nv, g,
                             [](float x) { return x; });
  }, G, red, out);
}

// Group sums of (x - mean[g])^2 over the tile's nv valid frames.
template <typename T, int V>
__device__ void tile_sq(const T* tile, bool cf, int Tp, int C, int G, int nv,
                        const float* mean, float* red, float* out) {
  const int Cg = C / G;
  block_group_sum([&](int g) {
    const float m = mean[g];
    return group_accum<T, V>(tile, cf, Tp, C, Cg, nv, g, [m](float x) {
      const float d = x - m;
      return d * d;
    });
  }, G, red, out);
}

// V consecutive fp32 parameters from device memory (aligned when V > 1:
// c is a multiple of V)
template <int V>
__device__ __forceinline__ Pack<float, V> ld_param(const float* p, int c) {
  Pack<float, V> r;
  if constexpr (V == 1) {
    r.v[0] = __ldg(p + c);
  } else {
#pragma unroll
    for (int j = 0; j < V; j += 4) {
      const float4 f = __ldg(reinterpret_cast<const float4*>(p + c + j));
      r.v[j] = f.x;
      r.v[j + 1] = f.y;
      r.v[j + 2] = f.z;
      r.v[j + 3] = f.w;
    }
  }
  return r;
}

// the per-channel parameters of V channels (channels-last: c..c+V-1) or
// of one channel (channels-first: all lanes of the vector)
template <int V>
struct Params {
  Pack<float, V> s, b;
  __device__ __forceinline__ void load(const float* scale, const float* bias,
                                       int c, bool cf) {
    if (cf) {
      const float sc = __ldg(scale + c), bi = __ldg(bias + c);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        s.v[j] = sc;
        b.v[j] = bi;
      }
    } else {
      s = ld_param<V>(scale, c);
      b = ld_param<V>(bias, c);
    }
  }
};

// normalized value of one element, then the affine, unrounded
__device__ __forceinline__ float affine(float x, float mean, float rstd,
                                        float sc, float bi, float* xhat) {
  const float xn = __fmul_rn(x - mean, rstd);
  *xhat = xn;
  return __fadd_rn(__fmul_rn(xn, sc), bi);
}

// Write frames [t0, t0 + nfr) of the output row b (Cout channels, in x's
// order, strides o): zero at tile frames >= nv. One vector of V frames of
// a channel pair (channels-first) or V channel pairs of a frame
// (channels-last) per step; a vector's channels share their group.
template <typename T, int V, bool GLU>
__device__ void write_fwd(const T* tile, bool cf, int Tp, int C, int G,
                          int nfr, int nv, const float* s_mean,
                          const float* s_rstd, const float* scale,
                          const float* bias, T* out, const View& o, int b,
                          int t0) {
  const int Cg = C / G, Cout = GLU ? C / 2 : C;
  T* base = out + b * o.sb + (long long)t0 * o.st;
  auto step = [&](int c, int tl) {
    const int ga = group_of(c, Cg, G), gb = group_of(c + Cout, Cg, G);
    const T* pa_at = tile + (cf ? c * Tp + tl : tl * C + c);
    const T* pb_at = tile + (cf ? (c + Cout) * Tp + tl : tl * C + c + Cout);
    T* dst = base + (cf ? c * o.sc + tl : tl * o.st + c);
    Pack<T, V> r;
    if (!cf && tl >= nv) {
#pragma unroll
      for (int j = 0; j < V; ++j) r.v[j] = from_f<T>(0.f);
      st<T, V>(dst, r);
      return;
    }
    const Pack<T, V> pa = ld<T, V>(pa_at);
    Params<V> qa, qb;
    qa.load(scale, bias, c, cf);
    Pack<T, V> pb;
    if (GLU) {
      pb = ld<T, V>(pb_at);
      qb.load(scale, bias, c + Cout, cf);
    }
    const float ma = s_mean[ga], ra = s_rstd[ga];
    const float mb = GLU ? s_mean[gb] : 0.f, rb = GLU ? s_rstd[gb] : 0.f;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      float h, y = 0.f;
      if (!cf || tl + j < nv) {
        y = rnd<T>(affine(to_f<T>(pa.v[j]), ma, ra, qa.s.v[j], qa.b.v[j], &h));
        if (GLU) {
          const float yb = rnd<T>(
              affine(to_f<T>(pb.v[j]), mb, rb, qb.s.v[j], qb.b.v[j], &h));
          y = rnd<T>(gate_tanh<T>(y)) * rnd<T>(gate_sigmoid<T>(yb));
        }
      }
      r.v[j] = from_f<T>(y);
    }
    st<T, V>(dst, r);
  };
  if (cf)
    for_each_qr((nfr + V - 1) / V, Cout,
                [&](int c, int tv) { step(c, tv * V); });
  else
    for_each_qr(Cout / V, nfr, [&](int tl, int cv) { step(cv * V, tl); });
}

// ---------------------------------------------------------------- backward
// One channel's group mean and rstd, scale and bias.
struct ChanPar {
  float m, r, s, b;
};

// dy of the channel pair (a, b = a + Cout) at a valid frame, with xhat of
// both; y is rebuilt in fp32 and not rounded (the TPU kernel's _bwd_kernel).
template <typename T, bool GLU>
__device__ __forceinline__ void dy_pair(float xa, float xb, float go,
                                        const ChanPar& a, const ChanPar& b,
                                        float* ha, float* hb, float* dya,
                                        float* dyb) {
  const float ya = affine(xa, a.m, a.r, a.s, a.b, ha);
  if (GLU) {
    const float yb = affine(xb, b.m, b.r, b.s, b.b, hb);
    const float ta = gate_tanh<T>(ya);
    const float sb = gate_sigmoid<T>(yb);
    *dya = go * sb * (1.f - ta * ta);
    *dyb = go * ta * sb * (1.f - sb);
  } else {
    *hb = 0.f;
    *dya = go;
    *dyb = 0.f;
  }
}

__device__ __forceinline__ ChanPar chan_par(int c, int Cg, int G,
                                           const float* s_mean,
                                           const float* s_rstd,
                                           const float* scale,
                                           const float* bias) {
  const int g = group_of(c, Cg, G);
  return {s_mean[g], s_rstd[g], __ldg(scale + c), __ldg(bias + c)};
}

// What channel_partials adds up per channel pair. Once the statistics are
// known: dy*xhat and dy (and the gate partner's). FUSE (no GLU, only the
// mean known yet): g*(x - mean), g and (x - mean)^2, so one pass over the
// tile gives the variance and, times rstd, the same partials.
template <typename T, bool GLU, bool FUSE>
struct PartAcc {
  float a0 = 0.f, b0 = 0.f, a1 = 0.f, b1 = 0.f;

  __device__ __forceinline__ void add(float xa, float xb, float go,
                                      const ChanPar& ca, const ChanPar& cb) {
    if (FUSE) {
      const float d = xa - ca.m;
      a0 += go * d;
      b0 += go;
      a1 += d * d;
      return;
    }
    float ha, hb, dya, dyb;
    dy_pair<T, GLU>(xa, xb, go, ca, cb, &ha, &hb, &dya, &dyb);
    a0 += dya * ha;
    b0 += dya;
    if (GLU) {
      a1 += dyb * hb;
      b1 += dyb;
    }
  }

  // fixed xor tree over groups of pp neighbouring lanes
  __device__ __forceinline__ void reduce(int pp) {
    for (int o = pp >> 1; o > 0; o >>= 1) {
      a0 += __shfl_xor_sync(0xffffffffu, a0, o);
      b0 += __shfl_xor_sync(0xffffffffu, b0, o);
      if (GLU || FUSE) a1 += __shfl_xor_sync(0xffffffffu, a1, o);
      if (GLU) b1 += __shfl_xor_sync(0xffffffffu, b1, o);
    }
  }

  __device__ __forceinline__ void store(int c, int Cout, float* pg, float* pb,
                                        float* pq) const {
    pg[c] = a0;
    pb[c] = b0;
    if (GLU) {
      pg[c + Cout] = a1;
      pb[c + Cout] = b1;
    }
    if (FUSE) pq[c] = a1;
  }
};

// Per-channel sums (PartAcc) over the tile's nv valid frames into shared
// memory (pg, pb and, with FUSE, pq); ends with a block barrier.
// Channels-last tiles: one thread per channel pair walks the frames.
// Channels-first: a group of pp neighbouring lanes per channel pair, each
// lane on V-frame vectors (the loads of the statistics pass), then a fixed
// xor tree over the group.
template <typename T, int V, bool GLU, bool FUSE>
__device__ void channel_partials(const T* xt, const T* gt, bool cf, int Tp,
                                 int C, int G, int nv, const float* s_mean,
                                 const float* s_rstd, const float* scale,
                                 const float* bias, float* pg, float* pb,
                                 float* pq) {
  static_assert(!(GLU && FUSE), "the GLU's dy needs rstd");
  const int Cg = C / G, Cout = GLU ? C / 2 : C;
  if (!cf) {
    for (int c = threadIdx.x; c < Cout; c += kThreads) {
      const ChanPar ca = chan_par(c, Cg, G, s_mean, s_rstd, scale, bias);
      const ChanPar cb = GLU ? chan_par(c + Cout, Cg, G, s_mean, s_rstd,
                                        scale, bias) : ca;
      PartAcc<T, GLU, FUSE> acc;
      for (int tl = 0; tl < nv; ++tl)
        acc.add(to_f<T>(xt[tl * C + c]),
                GLU ? to_f<T>(xt[tl * C + c + Cout]) : 0.f,
                to_f<T>(gt[tl * Cout + c]), ca, cb);
      acc.store(c, Cout, pg, pb, pq);
    }
  } else {
    const int per = (nv + V - 1) / V;  // vectors of valid frames a channel
    int pp = 1;                        // lanes a channel: a power of two
    while (pp < per && pp < 32) pp <<= 1;
    const int total = Cout * pp;
    const int lane = threadIdx.x & 31;
    for (int base = threadIdx.x - lane; base < total; base += kThreads) {
      const int i = base + lane;
      const int c = min(i / pp, Cout - 1);
      const ChanPar ca = chan_par(c, Cg, G, s_mean, s_rstd, scale, bias);
      const ChanPar cb = GLU ? chan_par(c + Cout, Cg, G, s_mean, s_rstd,
                                        scale, bias) : ca;
      PartAcc<T, GLU, FUSE> acc;
      for (int k = i - (i / pp) * pp; i < total && k < per; k += pp) {
        const int tl = k * V;
        const Pack<T, V> px = ld<T, V>(xt + c * Tp + tl);
        const Pack<T, V> py = GLU ? ld<T, V>(xt + (c + Cout) * Tp + tl) : px;
        const Pack<T, V> pgo = ld<T, V>(gt + c * Tp + tl);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          if (tl + j >= nv) break;
          acc.add(to_f<T>(px.v[j]), to_f<T>(py.v[j]), to_f<T>(pgo.v[j]), ca,
                  cb);
        }
      }
      acc.reduce(pp);
      if (i < total && i % pp == 0) acc.store(c, Cout, pg, pb, pq);
    }
  }
  __syncthreads();
}

// Copy the channel partials to the scratch row and form the group sums of
// scale*pb (-> m1) and scale*pg (-> m2) of this tile.
__device__ void partials_out(const float* pg, const float* pb,
                             const float* scale, int C, int G, float* red,
                             float* rowg, float* rowb, float* m1, float* m2) {
  for (int c = threadIdx.x; c < C; c += kThreads) {
    rowg[c] = pg[c];
    rowb[c] = pb[c];
  }
  const int Cg = C / G;
  block_group_sum([&](int g) {
    float v = 0.f;
    for (int c = g * Cg + threadIdx.x; c < (g + 1) * Cg; c += kThreads)
      v += __ldg(scale + c) * pb[c];
    return v;
  }, G, red, m1);
  block_group_sum([&](int g) {
    float v = 0.f;
    for (int c = g * Cg + threadIdx.x; c < (g + 1) * Cg; c += kThreads)
      v += __ldg(scale + c) * pg[c];
    return v;
  }, G, red, m2);
}

// Write frames [t0, t0 + nfr) of dx row b (C channels, x's order, strides
// o): zero at tile frames >= nv. Vectors as in write_fwd.
template <typename T, int V, bool GLU>
__device__ void write_dx(const T* xt, const T* gt, bool cf, int Tp, int C,
                         int G, int nfr, int nv, const float* s_mean,
                         const float* s_rstd, const float* s_m1,
                         const float* s_m2, const float* scale,
                         const float* bias, T* dx, const View& o, int b,
                         int t0) {
  const int Cg = C / G, Cout = GLU ? C / 2 : C;
  T* base = dx + b * o.sb + (long long)t0 * o.st;
  auto step = [&](int c, int tl) {
    const int ga = group_of(c, Cg, G), gb = group_of(c + Cout, Cg, G);
    T* da = base + (cf ? c * o.sc + tl : tl * o.st + c);
    T* db = base + (cf ? (c + Cout) * o.sc + tl : tl * o.st + c + Cout);
    Pack<T, V> ra, rb;
    if (!cf && tl >= nv) {
#pragma unroll
      for (int j = 0; j < V; ++j) ra.v[j] = from_f<T>(0.f);
      st<T, V>(da, ra);
      if (GLU) st<T, V>(db, ra);
      return;
    }
    const Pack<T, V> pa = ld<T, V>(xt + (cf ? c * Tp + tl : tl * C + c));
    const Pack<T, V> pg = ld<T, V>(gt + (cf ? c * Tp + tl : tl * Cout + c));
    Params<V> qa, qb;
    qa.load(scale, bias, c, cf);
    Pack<T, V> pb;
    if (GLU) {
      pb = ld<T, V>(xt + (cf ? (c + Cout) * Tp + tl : tl * C + c + Cout));
      qb.load(scale, bias, c + Cout, cf);
    }
    const float ma = s_mean[ga], rsa = s_rstd[ga];
    const float m1a = s_m1[ga], m2a = s_m2[ga];
    const float mb = GLU ? s_mean[gb] : 0.f, rsb = GLU ? s_rstd[gb] : 0.f;
    const float m1b = GLU ? s_m1[gb] : 0.f, m2b = GLU ? s_m2[gb] : 0.f;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      float va = 0.f, vb = 0.f;
      if (!cf || tl + j < nv) {
        float ha, hb, dya, dyb;
        dy_pair<T, GLU>(to_f<T>(pa.v[j]), GLU ? to_f<T>(pb.v[j]) : 0.f,
                     to_f<T>(pg.v[j]), {ma, rsa, qa.s.v[j], qa.b.v[j]},
                     {mb, rsb, GLU ? qb.s.v[j] : 0.f, GLU ? qb.b.v[j] : 0.f},
                     &ha, &hb, &dya, &dyb);
        va = (dya * qa.s.v[j] - m1a - ha * m2a) * rsa;
        if (GLU) vb = (dyb * qb.s.v[j] - m1b - hb * m2b) * rsb;
      }
      ra.v[j] = from_f<T>(va);
      if (GLU) rb.v[j] = from_f<T>(vb);
    }
    st<T, V>(da, ra);
    if (GLU) st<T, V>(db, rb);
  };
  if (cf)
    for_each_qr((nfr + V - 1) / V, Cout,
                [&](int c, int tv) { step(c, tv * V); });
  else
    for_each_qr(Cout / V, nfr, [&](int tl, int cv) { step(cv * V, tl); });
}

// ------------------------------------------------------------ cluster path
// Rank-ordered sum over the cluster of the per-block values v[g] (g < G),
// read through distributed shared memory by threads g < G.
__device__ __forceinline__ float cluster_total(cg::cluster_group& cl,
                                               float* v, int g) {
  float t = 0.f;
  for (unsigned q = 0; q < cl.num_blocks(); ++q) t += cl.map_shared_rank(v, q)[g];
  return t;
}

template <typename T, int V, bool GLU>
__global__ void __launch_bounds__(kThreads, 2)
gn_fwd_cluster(const T* __restrict__ x, View xv,
               const float* __restrict__ scale,
               const float* __restrict__ bias,
               const int* __restrict__ lengths, T* __restrict__ out, View ov,
               int T_, int C, int G, int Tb, float eps) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[kWarps * kMaxGroups];
  __shared__ float xs[kMaxGroups], xq[kMaxGroups];
  __shared__ float s_mean[kMaxGroups], s_rstd[kMaxGroups];
  T* tile = reinterpret_cast<T*>(smem);
  cg::cluster_group cl = cg::this_cluster();
  const int r = (int)cl.block_rank(), b = blockIdx.x / (int)cl.num_blocks();
  const int len = valid_len(lengths, b, T_);
  const int t0 = r * Tb;
  const int nfr = max(min(Tb, T_ - t0), 0), nv = max(min(Tb, len - t0), 0);
  const bool cf = xv.cf;
  load_tile<T, V>(tile, cf, Tb, x, xv, b, t0, nv, C);
  cp_async_wait_all();
  __syncthreads();
  const float n = fmaxf((float)len * (float)(C / G), 1.f);
  tile_sums<T, V>(tile, cf, Tb, C, G, nv, red, xs);
  cl.sync();
  if (threadIdx.x < G) s_mean[threadIdx.x] = cluster_total(cl, xs, threadIdx.x) / n;
  __syncthreads();
  tile_sq<T, V>(tile, cf, Tb, C, G, nv, s_mean, red, xq);
  cl.sync();
  if (threadIdx.x < G) {
    const float var = fmaxf(cluster_total(cl, xq, threadIdx.x) / n, 0.f);
    s_rstd[threadIdx.x] = 1.f / sqrtf(var + eps);
  }
  cluster_arrive();  // done reading the other blocks' shared memory
  __syncthreads();
  write_fwd<T, V, GLU>(tile, cf, Tb, C, G, nfr, nv, s_mean, s_rstd, scale,
                       bias, out, ov, b, t0);
  cluster_wait();
}

template <typename T, int V, bool GLU>
__global__ void __launch_bounds__(kThreads, 2)
gn_bwd_cluster(const T* __restrict__ x, View xv,
               const float* __restrict__ scale,
               const float* __restrict__ bias, const T* __restrict__ g,
               View gv, const int* __restrict__ lengths, T* __restrict__ dx,
               View ov, int T_, int C, int G, int Tb, float eps,
               float* __restrict__ pdg, float* __restrict__ pdb) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[kWarps * kMaxGroups];
  __shared__ float xs[kMaxGroups], xq[kMaxGroups], m1s[kMaxGroups],
      m2s[kMaxGroups];
  __shared__ float s_mean[kMaxGroups], s_rstd[kMaxGroups], s_m1[kMaxGroups],
      s_m2[kMaxGroups];
  const int Cout = GLU ? C / 2 : C;
  T* xt = reinterpret_cast<T*>(smem);
  T* gt = xt + (long long)Tb * C;
  float* pg = reinterpret_cast<float*>(gt + (long long)Tb * Cout);
  float* pb = pg + C;
  float* pq = pb + C;
  cg::cluster_group cl = cg::this_cluster();
  const int nb = (int)cl.num_blocks();
  const int r = (int)cl.block_rank(), b = blockIdx.x / nb;
  const int len = valid_len(lengths, b, T_);
  const int t0 = r * Tb;
  const int nfr = max(min(Tb, T_ - t0), 0), nv = max(min(Tb, len - t0), 0);
  const bool cf = xv.cf;
  load_tile<T, V>(xt, cf, Tb, x, xv, b, t0, nv, C);
  load_tile<T, V>(gt, cf, Tb, g, gv, b, t0, nv, Cout);
  cp_async_wait_all();
  __syncthreads();
  const float n = fmaxf((float)len * (float)(C / G), 1.f);
  tile_sums<T, V>(xt, cf, Tb, C, G, nv, red, xs);
  cl.sync();
  if (threadIdx.x < G) s_mean[threadIdx.x] = cluster_total(cl, xs, threadIdx.x) / n;
  __syncthreads();
  const int Cg = C / G;
  if (GLU) {
    tile_sq<T, V>(xt, cf, Tb, C, G, nv, s_mean, red, xq);
  } else {
    // one pass: the centred squares and g*(x - mean), g per channel
    channel_partials<T, V, false, true>(xt, gt, cf, Tb, C, G, nv, s_mean,
                                        s_rstd, scale, bias, pg, pb, pq);
    block_group_sum([&](int g) {
      float v = 0.f;
      for (int c = g * Cg + threadIdx.x; c < (g + 1) * Cg; c += kThreads)
        v += pq[c];
      return v;
    }, G, red, xq);
  }
  cl.sync();
  if (threadIdx.x < G) {
    const float var = fmaxf(cluster_total(cl, xq, threadIdx.x) / n, 0.f);
    s_rstd[threadIdx.x] = 1.f / sqrtf(var + eps);
  }
  __syncthreads();
  if (GLU) {
    channel_partials<T, V, GLU, false>(xt, gt, cf, Tb, C, G, nv, s_mean,
                                       s_rstd, scale, bias, pg, pb, pq);
  } else {
    for (int c = threadIdx.x; c < C; c += kThreads)
      pg[c] *= s_rstd[group_of(c, Cg, G)];  // sum g*xhat = rstd*sum g*(x-m)
    __syncthreads();
  }
  const long long row = (long long)b * nb + r;
  partials_out(pg, pb, scale, C, G, red, pdg + row * C, pdb + row * C, m1s,
               m2s);
  cl.sync();
  if (threadIdx.x < G) {
    s_m1[threadIdx.x] = cluster_total(cl, m1s, threadIdx.x) / n;
    s_m2[threadIdx.x] = cluster_total(cl, m2s, threadIdx.x) / n;
  }
  cluster_arrive();  // done reading the other blocks' shared memory
  __syncthreads();
  write_dx<T, V, GLU>(xt, gt, cf, Tb, C, G, nfr, nv, s_mean, s_rstd, s_m1,
                      s_m2, scale, bias, dx, ov, b, t0);
  cluster_wait();
}

// ---------------------------------------------------------- streaming path
// One block per (chunk of Tc frames, batch row): the chunk's valid count,
// mean and centred sum of squares per group (two passes over the tile).
template <typename T, int V>
__global__ void __launch_bounds__(kThreads, 2)
gn_stream_stats(const T* __restrict__ x, View xv,
                const int* __restrict__ lengths, int T_, int C, int G,
                int Tc, float* __restrict__ part) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[kWarps * kMaxGroups];
  __shared__ float xs[kMaxGroups], xq[kMaxGroups], s_mean[kMaxGroups];
  T* tile = reinterpret_cast<T*>(smem);
  const int chunk = blockIdx.x, b = blockIdx.y, n_chunks = gridDim.x;
  const int t0 = chunk * Tc;
  const int nv = max(min(Tc, valid_len(lengths, b, T_) - t0), 0);
  const bool cf = xv.cf;
  load_tile<T, V>(tile, cf, Tc, x, xv, b, t0, nv, C);
  cp_async_wait_all();
  __syncthreads();
  const float n = (float)nv * (float)(C / G);
  tile_sums<T, V>(tile, cf, Tc, C, G, nv, red, xs);
  if (threadIdx.x < G) s_mean[threadIdx.x] = nv > 0 ? xs[threadIdx.x] / n : 0.f;
  __syncthreads();
  tile_sq<T, V>(tile, cf, Tc, C, G, nv, s_mean, red, xq);
  if (threadIdx.x < G) {
    float* p = part + (((long long)b * G + threadIdx.x) * n_chunks + chunk) * 3;
    p[0] = n;
    p[1] = s_mean[threadIdx.x];
    p[2] = xq[threadIdx.x];
  }
}

// Chan's merge, in order, of n_part (count, mean, centred M2) triples.
__device__ __forceinline__ void chan_merge(const float* __restrict__ p,
                                           int n_part, float* n_out,
                                           float* mean_out, float* m2_out) {
  float n = 0.f, mean = 0.f, m2 = 0.f;
  for (int k = 0; k < n_part; ++k) {
    const float nb = p[3 * k];
    if (nb == 0.f) continue;
    const float nt = n + nb;
    const float delta = p[3 * k + 1] - mean;
    mean += delta * (nb / nt);
    m2 += p[3 * k + 2] + delta * delta * (n * nb / nt);
    n = nt;
  }
  *n_out = n;
  *mean_out = mean;
  *m2_out = m2;
}

// Fixed-order (Chan) merge of one batch row's n_part partial statistics
// into per-group mean and 1/sqrt(var + eps); ends with a block barrier.
__device__ void merge_stats(const float* __restrict__ part, int b, int G,
                            int n_part, float eps, float* s_mean,
                            float* s_rstd) {
  if (threadIdx.x < G) {
    float n, mean, m2;
    chan_merge(part + ((long long)b * G + threadIdx.x) * n_part * 3, n_part,
               &n, &mean, &m2);
    const float var = fmaxf(m2 / fmaxf(n, 1.f), 0.f);
    s_mean[threadIdx.x] = mean;
    s_rstd[threadIdx.x] = 1.f / sqrtf(var + eps);
  }
  __syncthreads();
}

template <typename T, int V, bool GLU>
__global__ void __launch_bounds__(kThreads, 2)
gn_fwd_stream_apply(const T* __restrict__ x, View xv,
                    const float* __restrict__ scale,
                    const float* __restrict__ bias,
                    const int* __restrict__ lengths,
                    const float* __restrict__ part, int n_part,
                    T* __restrict__ out, View ov, int T_, int C, int G,
                    int Tc, float eps) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float s_mean[kMaxGroups], s_rstd[kMaxGroups];
  T* tile = reinterpret_cast<T*>(smem);
  const int chunk = blockIdx.x, b = blockIdx.y;
  const int t0 = chunk * Tc;
  const int nfr = min(Tc, T_ - t0);
  const int nv = max(min(Tc, valid_len(lengths, b, T_) - t0), 0);
  const bool cf = xv.cf;
  load_tile<T, V>(tile, cf, Tc, x, xv, b, t0, nv, C);
  merge_stats(part, b, G, n_part, eps, s_mean, s_rstd);
  cp_async_wait_all();
  __syncthreads();
  write_fwd<T, V, GLU>(tile, cf, Tc, C, G, nfr, nv, s_mean, s_rstd, scale,
                       bias, out, ov, b, t0);
}

// ------------------------------------------------------ split entry points
// 16-byte loads a thread keeps in flight in the split kernels.
constexpr int kSplitUnroll = 4;
// Resident blocks per SM the split kernels' grids aim at; the kernels'
// __launch_bounds__ ask for as many (at most 64 registers a thread, so
// that the GLU applies, which take 72 and 102 registers without the bound,
// keep 4 blocks on an SM).
constexpr int kSplitBlocksPerSm = 4;
// Blocks' triples a thread of the merging block loads (P <= this times
// kThreads).
constexpr int kSplitMergePer = 4;

// A (count, mean, centred M2) triple.
struct Moments {
  float n, mean, m2;
};

// a, then b, by Chan's formula with one division; either may be empty,
// and an empty a gives b's bits.
__device__ __forceinline__ Moments chan(const Moments& a, const Moments& b) {
  if (b.n == 0.f) return a;
  const float nt = a.n + b.n;
  const float wb = b.n / nt;
  const float delta = b.mean - a.mean;
  Moments r;
  r.mean = a.mean + delta * wb;
  r.m2 = a.m2 + (b.m2 + delta * delta * (a.n * wb));
  r.n = nt;
  return r;
}

// Lane 0 gets the merge of the warp's 32 triples in lane order, by a
// fixed-shape tree (pairs of lanes, then pairs of pairs, ...).
__device__ __forceinline__ Moments warp_chan(Moments m) {
  const int l = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    Moments b;
    b.n = __shfl_down_sync(0xffffffffu, m.n, o);
    b.mean = __shfl_down_sync(0xffffffffu, m.mean, o);
    b.m2 = __shfl_down_sync(0xffffffffu, m.m2, o);
    if ((l & (2 * o - 1)) == 0) m = chan(m, b);
  }
  return m;
}

// Thread 0 gets the merge of the block's kThreads triples in thread
// order (warp_chan in each warp, then over the warps); ends with a block
// barrier.
__device__ __forceinline__ Moments block_chan(Moments m, Moments* s_warp) {
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  m = warp_chan(m);
  if (l == 0) s_warp[w] = m;
  __syncthreads();
  if (w == 0)
    m = warp_chan(l < kWarps ? s_warp[l] : Moments{0.f, 0.f, 0.f});
  __syncthreads();
  return m;
}

// One block per (piece p of P, row b, group g). The group's valid elements
// are runs of contiguous elements: channels-first the Cg channels' first
// len frames, channels-last the first len frames' Cg channels. Their V-element vectors, numbered run by run, are cut into P
// equal ranges; a block streams its range, kSplitUnroll 16-byte loads in
// flight a thread and no shared-memory tile. Each thread folds every
// batch of loads (two passes in registers) into its running triple, the
// block merges the threads' triples in thread order and writes one
// triple to blk; the last of the group's P blocks to finish (a
// __threadfence, then a ticket from the group's counter) merges the P
// triples in block order (thread t loads blocks [t*P/kThreads,
// (t+1)*P/kThreads), at most kSplitMergePer, together, then block_chan),
// writes part[b, g] and sets the counter back to 0 for the next launch on
// its stream.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads, kSplitBlocksPerSm)
gn_split_stats_kernel(const T* __restrict__ x, View xv,
                      const int* __restrict__ lengths, int T_, int C, int G,
                      int P, float* __restrict__ blk,
                      unsigned* __restrict__ tickets,
                      float* __restrict__ part) {
  __shared__ Moments s_warp[kWarps];
  __shared__ bool s_last;
  const int bg = blockIdx.x / P, p = blockIdx.x - bg * P;
  const int b = bg / G, g = bg - b * G;
  const int Cg = C / G;
  const int len = valid_len(lengths, b, T_);
  const bool cf = xv.cf;
  const int cols = cf ? len : Cg;
  const int vpr = (cols + V - 1) / V;
  const int n_vec = (cf ? Cg : len) * vpr;
  const int lo = (int)((long long)n_vec * p / P);
  const int hi = (int)((long long)n_vec * (p + 1) / P);
  const T* base = x + b * xv.sb + (long long)g * Cg * xv.sc;
  const long long run = cf ? xv.sc : xv.st;
  Moments acc = {0.f, 0.f, 0.f};
  for (int i0 = lo + threadIdx.x; i0 < hi; i0 += kSplitUnroll * kThreads) {
    Pack<T, V> v[kSplitUnroll];
    int cnt[kSplitUnroll];
#pragma unroll
    for (int u = 0; u < kSplitUnroll; ++u) {
      const int i = i0 + u * kThreads;
      cnt[u] = 0;
      if (i < hi) {
        const int r = i / vpr, cv = i - r * vpr;
        v[u] = ld<T, V>(base + r * run + cv * V);
        cnt[u] = min(V, cols - cv * V);
      }
    }
    float s = 0.f;
    int n = 0;
#pragma unroll
    for (int u = 0; u < kSplitUnroll; ++u) {
#pragma unroll
      for (int j = 0; j < V; ++j)
        if (j < cnt[u]) s += to_f<T>(v[u].v[j]);
      n += cnt[u];
    }
    const float m = s / (float)n;
    float q = 0.f;
#pragma unroll
    for (int u = 0; u < kSplitUnroll; ++u)
#pragma unroll
      for (int j = 0; j < V; ++j)
        if (j < cnt[u]) {
          const float d = to_f<T>(v[u].v[j]) - m;
          q += d * d;
        }
    acc = chan(acc, Moments{(float)n, m, q});
  }
  acc = block_chan(acc, s_warp);
  if (threadIdx.x == 0) {
    float* o = blk + ((long long)bg * P + p) * 3;
    o[0] = acc.n;
    o[1] = acc.mean;
    o[2] = acc.m2;
    __threadfence();
    s_last = atomicAdd(tickets + bg, 1u) == (unsigned)(P - 1);
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const float* q = blk + (long long)bg * P * 3;
  const int k0 = threadIdx.x * P / kThreads;
  const int nk = (threadIdx.x + 1) * P / kThreads - k0;
  Moments got[kSplitMergePer];
#pragma unroll
  for (int j = 0; j < kSplitMergePer; ++j) {
    got[j] = Moments{0.f, 0.f, 0.f};
    if (j < nk) {
      const float* t = q + 3 * (k0 + j);
      got[j] = Moments{__ldcg(t), __ldcg(t + 1), __ldcg(t + 2)};
    }
  }
  Moments m = got[0];
#pragma unroll
  for (int j = 1; j < kSplitMergePer; ++j) m = chan(m, got[j]);
  m = block_chan(m, s_warp);
  if (threadIdx.x == 0) {
    part[3 * bg] = m.n;
    part[3 * bg + 1] = m.mean;
    part[3 * bg + 2] = m.m2;
    tickets[bg] = 0u;
  }
}

// One block per (piece p of P, row b): merges the row's R gathered
// triples per group in rank order (merge_stats), then streams its range
// of the row's output vectors (channels-first: V frames of one output
// channel, channels-last: V channels of one frame), kSplitUnroll of them
// a thread (half as many with the GLU) with their loads (x at channel c
// and, with the GLU, c + C/2) in flight together, and writes each with
// one 16-byte store: the affine, the mask and the GLU of write_fwd,
// element for element. Frames at or past lengths[b] are written as 0
// without a load.
template <typename T, int V, bool GLU>
__global__ void __launch_bounds__(kThreads, kSplitBlocksPerSm)
gn_split_apply_kernel(const T* __restrict__ x, View xv,
                      const float* __restrict__ scale,
                      const float* __restrict__ bias,
                      const int* __restrict__ lengths,
                      const float* __restrict__ part, int R,
                      T* __restrict__ out, View ov, int T_, int C, int G,
                      int P, float eps) {
  __shared__ float s_mean[kMaxGroups], s_rstd[kMaxGroups];
  const int b = blockIdx.x / P, p = blockIdx.x - b * P;
  merge_stats(part, b, G, R, eps, s_mean, s_rstd);
  const int len = valid_len(lengths, b, T_);
  const int Cg = C / G, Cout = GLU ? C / 2 : C;
  const bool cf = xv.cf;
  const int vpr = cf ? (T_ + V - 1) / V : Cout / V;
  const int n_vec = (cf ? Cout : T_) * vpr;
  const int lo = (int)((long long)n_vec * p / P);
  const int hi = (int)((long long)n_vec * (p + 1) / P);
  const T* xb = x + b * xv.sb;
  T* ob = out + b * ov.sb;
  // kSplitUnroll loads in flight a thread: half as many items with the GLU
  constexpr int U = GLU ? (kSplitUnroll + 1) / 2 : kSplitUnroll;
  for (int i0 = lo + threadIdx.x; i0 < hi; i0 += U * kThreads) {
    Pack<T, V> pa[U], pb[U];
    int cs[U], ts[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * kThreads;
      cs[u] = 0;
      ts[u] = T_;   // nothing to write
      if (i < hi) {
        const int r = i / vpr, cv = i - r * vpr;
        cs[u] = cf ? r : cv * V;
        ts[u] = cf ? cv * V : r;
        if (ts[u] < len) {
          const T* at = xb + ts[u] * xv.st + cs[u] * xv.sc;
          pa[u] = ld<T, V>(at);
          if (GLU) pb[u] = ld<T, V>(at + Cout * xv.sc);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int c = cs[u], t = ts[u];
      if (t >= T_) continue;
      Pack<T, V> r;
      if (t >= len) {
#pragma unroll
        for (int j = 0; j < V; ++j) r.v[j] = from_f<T>(0.f);
      } else {
        Params<V> qa, qb;
        qa.load(scale, bias, c, cf);
        if (GLU) qb.load(scale, bias, c + Cout, cf);
        const int ga = group_of(c, Cg, G), gb = group_of(c + Cout, Cg, G);
        const float ma = s_mean[ga], ra = s_rstd[ga];
        const float mb = GLU ? s_mean[gb] : 0.f, rb = GLU ? s_rstd[gb] : 0.f;
#pragma unroll
        for (int j = 0; j < V; ++j) {
          float h, y = 0.f;
          if (!cf || t + j < len) {
            y = rnd<T>(affine(to_f<T>(pa[u].v[j]), ma, ra, qa.s.v[j],
                              qa.b.v[j], &h));
            if (GLU) {
              const float yb = rnd<T>(affine(to_f<T>(pb[u].v[j]), mb, rb,
                                             qb.s.v[j], qb.b.v[j], &h));
              y = rnd<T>(gate_tanh<T>(y)) * rnd<T>(gate_sigmoid<T>(yb));
            }
          }
          r.v[j] = from_f<T>(y);
        }
      }
      st<T, V>(ob + t * ov.st + c * ov.sc, r);
    }
  }
}

// Per-chunk channel partials (scratch rows b*n_chunks + chunk) and the
// chunk's group sums of scale*dbias and scale*dscale partials (gm).
template <typename T, int V, bool GLU>
__global__ void __launch_bounds__(kThreads, 2)
gn_bwd_stream_partial(const T* __restrict__ x, View xv,
                      const float* __restrict__ scale,
                      const float* __restrict__ bias,
                      const T* __restrict__ g, View gv,
                      const int* __restrict__ lengths,
                      const float* __restrict__ part, int T_, int C, int G,
                      int Tc, float eps, float* __restrict__ pdg,
                      float* __restrict__ pdb, float* __restrict__ gm) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[kWarps * kMaxGroups];
  __shared__ float s_mean[kMaxGroups], s_rstd[kMaxGroups], m1s[kMaxGroups],
      m2s[kMaxGroups];
  const int Cout = GLU ? C / 2 : C;
  T* xt = reinterpret_cast<T*>(smem);
  T* gt = xt + (long long)Tc * C;
  float* pg = reinterpret_cast<float*>(gt + (long long)Tc * Cout);
  float* pb = pg + C;
  const int chunk = blockIdx.x, b = blockIdx.y, n_chunks = gridDim.x;
  const int t0 = chunk * Tc;
  const int nv = max(min(Tc, valid_len(lengths, b, T_) - t0), 0);
  const bool cf = xv.cf;
  load_tile<T, V>(xt, cf, Tc, x, xv, b, t0, nv, C);
  load_tile<T, V>(gt, cf, Tc, g, gv, b, t0, nv, Cout);
  merge_stats(part, b, G, n_chunks, eps, s_mean, s_rstd);
  cp_async_wait_all();
  __syncthreads();
  channel_partials<T, V, GLU, false>(xt, gt, cf, Tc, C, G, nv, s_mean,
                                     s_rstd, scale, bias, pg, pb, nullptr);
  const long long row = (long long)b * n_chunks + chunk;
  partials_out(pg, pb, scale, C, G, red, pdg + row * C, pdb + row * C, m1s,
               m2s);
  if (threadIdx.x < G) {
    gm[(row * G + threadIdx.x) * 2] = m1s[threadIdx.x];
    gm[(row * G + threadIdx.x) * 2 + 1] = m2s[threadIdx.x];
  }
}

template <typename T, int V, bool GLU>
__global__ void __launch_bounds__(kThreads, 2)
gn_bwd_stream_dx(const T* __restrict__ x, View xv,
                 const float* __restrict__ scale,
                 const float* __restrict__ bias, const T* __restrict__ g,
                 View gv, const int* __restrict__ lengths,
                 const float* __restrict__ part,
                 const float* __restrict__ gm, T* __restrict__ dx, View ov,
                 int T_, int C, int G, int Tc, float eps) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float s_mean[kMaxGroups], s_rstd[kMaxGroups], s_m1[kMaxGroups],
      s_m2[kMaxGroups];
  const int Cout = GLU ? C / 2 : C;
  T* xt = reinterpret_cast<T*>(smem);
  T* gt = xt + (long long)Tc * C;
  const int chunk = blockIdx.x, b = blockIdx.y, n_chunks = gridDim.x;
  const int t0 = chunk * Tc;
  const int len = valid_len(lengths, b, T_);
  const int nfr = min(Tc, T_ - t0), nv = max(min(Tc, len - t0), 0);
  const bool cf = xv.cf;
  load_tile<T, V>(xt, cf, Tc, x, xv, b, t0, nv, C);
  load_tile<T, V>(gt, cf, Tc, g, gv, b, t0, nv, Cout);
  if (threadIdx.x < G) {
    const float n = fmaxf((float)len * (float)(C / G), 1.f);
    float a = 0.f, c = 0.f;
    for (int k = 0; k < n_chunks; ++k) {
      const float* p = gm + (((long long)b * n_chunks + k) * G + threadIdx.x) * 2;
      a += p[0];
      c += p[1];
    }
    s_m1[threadIdx.x] = a / n;
    s_m2[threadIdx.x] = c / n;
  }
  merge_stats(part, b, G, n_chunks, eps, s_mean, s_rstd);
  cp_async_wait_all();
  __syncthreads();
  write_dx<T, V, GLU>(xt, gt, cf, Tc, C, G, nfr, nv, s_mean, s_rstd, s_m1,
                      s_m2, scale, bias, dx, ov, b, t0);
}

// dscale/dbias: the (rows, C) partials added over rows in a fixed order.
// A block takes 8 channels (one 32-byte sector of a row); its threads are
// 32 row slots x 8 channels, slot k adding rows k, k + 32, ... in order,
// then thread c adds the 32 slots in order.
constexpr int kParamChannels = 8;
constexpr int kParamSlots = kThreads / kParamChannels;

__global__ void __launch_bounds__(kThreads)
gn_bwd_param(const float* __restrict__ pdg, const float* __restrict__ pdb,
             int rows, int C, float* __restrict__ dscale,
             float* __restrict__ dbias) {
  __shared__ float sg[kParamSlots][kParamChannels],
      sb[kParamSlots][kParamChannels];
  const int k = threadIdx.x / kParamChannels;
  const int j = threadIdx.x - k * kParamChannels;
  const int c = blockIdx.x * kParamChannels + j;
  float a = 0.f, d = 0.f;
  if (c < C) {
#pragma unroll 8
    for (int r = k; r < rows; r += kParamSlots) {
      a += pdg[(long long)r * C + c];
      d += pdb[(long long)r * C + c];
    }
  }
  sg[k][j] = a;
  sb[k][j] = d;
  __syncthreads();
  if (threadIdx.x < kParamChannels && c < C) {
    float ta = 0.f, td = 0.f;
    for (int i = 0; i < kParamSlots; ++i) {
      ta += sg[i][threadIdx.x];
      td += sb[i][threadIdx.x];
    }
    dscale[c] = ta;
    dbias[c] = td;
  }
}

// -------------------------------------------------------------------- host
// Host-side caches, each keyed by (device, kernel[, nb]): an attribute set
// or a fit answered on one card says nothing of another. The device is the
// entry point's `device` argument (already made current there).
std::mutex host_mutex;  // guards the caches below (ctypes drops the GIL)
constexpr int kCacheSlots = 256;

// Let a kernel take kClusterSmem of dynamic shared memory and clusters of
// 16; once per (device, kernel).
cudaError_t prepare(const void* fn, int dev) {
  std::lock_guard<std::mutex> guard(host_mutex);
  static const void* done[kCacheSlots];
  static int devs[kCacheSlots];
  static int n_done = 0;
  for (int i = 0; i < n_done; ++i)
    if (done[i] == fn && devs[i] == dev) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kClusterSmem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed,
                             1);
  if (e == cudaSuccess && n_done < kCacheSlots) {
    done[n_done] = fn;
    devs[n_done++] = dev;
  }
  return e;
}

// Whether clusters of nb blocks with kClusterSmem each can be scheduled
// (cudaOccupancyMaxActiveClusters > 0); asked once per (device, kernel,
// nb).
bool cluster_fits(const void* fn, int nb, int dev) {
  static const void* fns[kCacheSlots];
  static int devs[kCacheSlots], nbs[kCacheSlots], ok[kCacheSlots], n_seen = 0;
  {
    std::lock_guard<std::mutex> guard(host_mutex);
    for (int i = 0; i < n_seen; ++i)
      if (fns[i] == fn && devs[i] == dev && nbs[i] == nb) return ok[i];
  }
  int active = 0;
  if (prepare(fn, dev) == cudaSuccess) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(nb);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = kClusterSmem;
    cudaLaunchAttribute a[1];
    a[0].id = cudaLaunchAttributeClusterDimension;
    a[0].val.clusterDim.x = nb;
    a[0].val.clusterDim.y = 1;
    a[0].val.clusterDim.z = 1;
    cfg.attrs = a;
    cfg.numAttrs = 1;
    if (cudaOccupancyMaxActiveClusters(&active, fn, &cfg) != cudaSuccess)
      active = 0;
  }
  cudaGetLastError();  // a refused query is an answer, not a launch error
  std::lock_guard<std::mutex> guard(host_mutex);
  if (n_seen < kCacheSlots) {
    fns[n_seen] = fn;
    devs[n_seen] = dev;
    nbs[n_seen] = nb;
    ok[n_seen++] = active > 0;
  }
  return active > 0;
}

// SM count of a device, read once per device
int num_sms(int dev) {
  constexpr int kMaxDevices = 64;
  static int n[kMaxDevices] = {};
  if (dev < 0 || dev >= kMaxDevices) return 132;
  std::lock_guard<std::mutex> guard(host_mutex);
  if (n[dev] == 0) {
    int v = 132;
    cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev);
    n[dev] = v;
  }
  return n[dev];
}

int round_up(int a, int m) { return (a + m - 1) / m * m; }

// shared memory of the backward's per-channel sums: pg, pb and, without
// the GLU, pq
long long bwd_param_bytes(int C, int glu, int backward) {
  return backward ? (glu ? 2LL : 3LL) * C * sizeof(float) : 0;
}

// Frames of a streaming chunk whose tile (row_bytes a frame, plus extra)
// fits kStreamSmem, a multiple of kFrameAlign up to kStreamMaxFrames; -1
// when not even kFrameAlign frames fit a block.
int stream_frames(long long row_bytes, long long extra) {
  long long fit = (kStreamSmem - extra) / row_bytes / kFrameAlign * kFrameAlign;
  if (fit < kFrameAlign) fit = kFrameAlign;
  const int frames = (int)(fit < kStreamMaxFrames ? fit : kStreamMaxFrames);
  if (frames * row_bytes + extra > kClusterSmem) return -1;
  return frames;
}

// How a launch runs: nb > 0 a cluster of nb blocks per batch row, each
// holding `frames` frames; nb == 0 streaming chunks of `frames` frames;
// nb < 0 a row too wide for either.
struct Plan {
  int nb, frames, rows, dev;
};

template <typename T>
Plan make_plan(int B, int T_, int C, int glu, int backward, int dev) {
  const int Cout = glu ? C / 2 : C;
  const long long row_bytes =
      (long long)(C + (backward ? Cout : 0)) * sizeof(T);
  const long long extra = bwd_param_bytes(C, glu, backward);
  const void* fn = backward
      ? (const void*)gn_bwd_cluster<T, 1, false>
      : (const void*)gn_fwd_cluster<T, 1, false>;
  const int order[2][2] = {{8, 16}, {16, 8}};
  const int* nbs = order[B * 8 < num_sms(dev) ? 1 : 0];
  // the first cluster size whose blocks fit two to an SM, else the first
  // that fits at all
  for (const long long budget : {(long long)kTwoPerSm, (long long)kClusterSmem})
    for (int k = 0; k < 2; ++k) {
      const int nb = nbs[k];
      const int frames = round_up((T_ + nb - 1) / nb, kFrameAlign);
      if (frames * row_bytes + extra <= budget && cluster_fits(fn, nb, dev))
        return {nb, frames, nb, dev};
    }
  const int frames = stream_frames(row_bytes, extra);
  if (frames < 0) return {-1, 0, 0, dev};
  return {0, frames, (T_ + frames - 1) / frames, dev};
}

// scratch floats of a launch: backward (B, rows, C) x 2 partials, then
// (streaming) the chunk statistics and the backward's group sums
template <typename T>
long long scratch_floats(int B, int T_, int C, int G, int glu, int backward,
                         int dev) {
  const Plan p = make_plan<T>(B, T_, C, glu, backward, dev);
  if (p.nb < 0) return -1;
  long long n = backward ? 2LL * B * p.rows * C : 0;
  if (p.nb == 0) n += 3LL * B * G * p.rows + (backward ? 2LL * B * p.rows * G : 0);
  return n;
}

template <typename Kern, typename... Args>
cudaError_t launch_cluster(Kern k, int nb, int B, size_t smem, int dev,
                           cudaStream_t s, Args... args) {
  cudaError_t e = prepare((const void*)k, dev);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * nb);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute a[1];
  a[0].id = cudaLaunchAttributeClusterDimension;
  a[0].val.clusterDim.x = nb;
  a[0].val.clusterDim.y = 1;
  a[0].val.clusterDim.z = 1;
  cfg.attrs = a;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, k, args...);
}

// 16-byte vectors are possible for a view of n channels: aligned pointer,
// strides multiples of V, the unit axis's extent a multiple of V
bool vec_ok(const void* p, const View& v, int T_, int n, int V) {
  if (reinterpret_cast<uintptr_t>(p) % 16 || v.sb % V) return false;
  return v.cf ? (v.sc % V == 0 && T_ % V == 0)
              : (v.st % V == 0 && n % V == 0);
}

template <typename T, int V, bool GLU>
cudaError_t run_fwd(const Plan& p, const T* x, View xv, const float* scale,
                    const float* bias, const int* lengths, T* out, View ov,
                    float* scratch, int B, int T_, int C, int G, float eps,
                    cudaStream_t s) {
  const size_t tile = (size_t)p.frames * C * sizeof(T);
  if (p.nb > 0)
    return launch_cluster(gn_fwd_cluster<T, V, GLU>, p.nb, B, tile, p.dev, s,
                          x, xv, scale, bias, lengths, out, ov, T_, C, G,
                          p.frames, eps);
  cudaError_t e = prepare((const void*)gn_stream_stats<T, V>, p.dev);
  if (e == cudaSuccess)
    e = prepare((const void*)gn_fwd_stream_apply<T, V, GLU>, p.dev);
  if (e != cudaSuccess) return e;
  const dim3 grid(p.rows, B);
  gn_stream_stats<T, V><<<grid, kThreads, tile, s>>>(x, xv, lengths, T_, C, G,
                                                      p.frames, scratch);
  gn_fwd_stream_apply<T, V, GLU><<<grid, kThreads, tile, s>>>(
      x, xv, scale, bias, lengths, scratch, p.rows, out, ov, T_, C, G,
      p.frames, eps);
  return cudaSuccess;
}

template <typename T, int V, bool GLU>
cudaError_t run_bwd(const Plan& p, const T* x, View xv, const float* scale,
                    const float* bias, const T* g, View gv,
                    const int* lengths, T* dx, View ov, float* dscale,
                    float* dbias, float* scratch, int B, int T_, int C, int G,
                    float eps, cudaStream_t s) {
  const int Cout = GLU ? C / 2 : C;
  const size_t smem = (size_t)p.frames * (C + Cout) * sizeof(T)
      + bwd_param_bytes(C, GLU, 1);
  const long long n_part = (long long)B * p.rows * C;
  float* pdg = scratch;
  float* pdb = scratch + n_part;
  cudaError_t e;
  if (p.nb > 0) {
    e = launch_cluster(gn_bwd_cluster<T, V, GLU>, p.nb, B, smem, p.dev, s, x,
                       xv, scale, bias, g, gv, lengths, dx, ov, T_, C, G,
                       p.frames, eps, pdg, pdb);
    if (e != cudaSuccess) return e;
  } else {
    float* part = pdb + n_part;
    float* gm = part + 3LL * B * G * p.rows;
    const size_t tile = (size_t)p.frames * C * sizeof(T);
    const void* fns[3] = {(const void*)gn_stream_stats<T, V>,
                          (const void*)gn_bwd_stream_partial<T, V, GLU>,
                          (const void*)gn_bwd_stream_dx<T, V, GLU>};
    for (const void* fn : fns)
      if ((e = prepare(fn, p.dev)) != cudaSuccess) return e;
    const dim3 grid(p.rows, B);
    gn_stream_stats<T, V><<<grid, kThreads, tile, s>>>(x, xv, lengths, T_, C,
                                                        G, p.frames, part);
    gn_bwd_stream_partial<T, V, GLU><<<grid, kThreads, smem, s>>>(
        x, xv, scale, bias, g, gv, lengths, part, T_, C, G, p.frames, eps,
        pdg, pdb, gm);
    gn_bwd_stream_dx<T, V, GLU><<<grid, kThreads, smem, s>>>(
        x, xv, scale, bias, g, gv, lengths, part, gm, dx, ov, T_, C, G,
        p.frames, eps);
  }
  gn_bwd_param<<<(C + kParamChannels - 1) / kParamChannels, kThreads, 0, s>>>(
      pdg, pdb, B * p.rows, C, dscale, dbias);
  return cudaSuccess;
}

template <typename T>
cudaError_t forward(const void* x, View xv, const float* scale,
                    const float* bias, const int* lengths, void* out,
                    View ov, float* scratch, int B, int T_, int C, int G,
                    int glu, float eps, int dev, cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  const Plan p = make_plan<T>(B, T_, C, glu, 0, dev);
  if (p.nb < 0) return cudaErrorInvalidValue;
  const int Cout = glu ? C / 2 : C;
  const bool vec = vec_ok(x, xv, T_, C, V) && vec_ok(out, ov, T_, Cout, V)
      && (xv.cf || ((C / G) % V == 0 && Cout % V == 0));
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  if (vec && glu)
    return run_fwd<T, V, true>(p, xt, xv, scale, bias, lengths, ot, ov,
                               scratch, B, T_, C, G, eps, s);
  if (vec)
    return run_fwd<T, V, false>(p, xt, xv, scale, bias, lengths, ot, ov,
                                scratch, B, T_, C, G, eps, s);
  if (glu)
    return run_fwd<T, 1, true>(p, xt, xv, scale, bias, lengths, ot, ov,
                               scratch, B, T_, C, G, eps, s);
  return run_fwd<T, 1, false>(p, xt, xv, scale, bias, lengths, ot, ov,
                              scratch, B, T_, C, G, eps, s);
}

template <typename T>
cudaError_t backward(const void* x, View xv, const float* scale,
                     const float* bias, const void* g, View gv,
                     const int* lengths, void* dx, View ov, float* dscale,
                     float* dbias, float* scratch, int B, int T_, int C,
                     int G, int glu, float eps, int dev, cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  const Plan p = make_plan<T>(B, T_, C, glu, 1, dev);
  if (p.nb < 0) return cudaErrorInvalidValue;
  const int Cout = glu ? C / 2 : C;
  const bool vec = vec_ok(x, xv, T_, C, V) && vec_ok(dx, ov, T_, C, V)
      && vec_ok(g, gv, T_, Cout, V)
      && (xv.cf || ((C / G) % V == 0 && Cout % V == 0));
  const T* xt = static_cast<const T*>(x);
  const T* gt = static_cast<const T*>(g);
  T* dt = static_cast<T*>(dx);
  if (vec && glu)
    return run_bwd<T, V, true>(p, xt, xv, scale, bias, gt, gv, lengths, dt,
                               ov, dscale, dbias, scratch, B, T_, C, G, eps, s);
  if (vec)
    return run_bwd<T, V, false>(p, xt, xv, scale, bias, gt, gv, lengths, dt,
                                ov, dscale, dbias, scratch, B, T_, C, G, eps,
                                s);
  if (glu)
    return run_bwd<T, 1, true>(p, xt, xv, scale, bias, gt, gv, lengths, dt,
                               ov, dscale, dbias, scratch, B, T_, C, G, eps, s);
  return run_bwd<T, 1, false>(p, xt, xv, scale, bias, gt, gv, lengths, dt, ov,
                              dscale, dbias, scratch, B, T_, C, G, eps, s);
}

// Blocks per (row, group) of gn_split_stats (per row of gn_split_apply,
// n_rows = B): kSplitBlocksPerSm blocks per SM over the n_rows rows, but
// no fewer than one full round of 16-byte loads (kThreads * kSplitUnroll
// of them) a block over `elems` elements of a row.
int split_blocks(int n_rows, long long elems, int item, int dev) {
  const long long want = ((long long)kSplitBlocksPerSm * num_sms(dev)
                          + n_rows - 1) / n_rows;
  const long long most = elems * item / (16LL * kThreads * kSplitUnroll);
  return (int)std::max(1LL, std::min({want, most,
                                      (long long)kSplitMergePer * kThreads}));
}

// Split statistics (a row whose frames lie on several ranks): one launch
// of gn_split_stats_kernel writes this rank's (B, G, 3) partials.
template <typename T>
cudaError_t split_stats(const void* x, View xv, const int* lengths,
                        float* part, float* blk, unsigned* tickets, int B,
                        int T_, int C, int G, int dev, cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  const int P = split_blocks(B * G, (long long)C / G * T_, sizeof(T), dev);
  const bool vec = vec_ok(x, xv, T_, C, V) && (xv.cf || (C / G) % V == 0);
  const T* xt = static_cast<const T*>(x);
  const dim3 grid(B * G * P);
  if (vec)
    gn_split_stats_kernel<T, V><<<grid, kThreads, 0, s>>>(
        xt, xv, lengths, T_, C, G, P, blk, tickets, part);
  else
    gn_split_stats_kernel<T, 1><<<grid, kThreads, 0, s>>>(
        xt, xv, lengths, T_, C, G, P, blk, tickets, part);
  return cudaSuccess;
}

// Apply with the gathered (B, G, R, 3) partials of R ranks: one launch of
// gn_split_apply_kernel.
template <typename T>
cudaError_t split_apply(const void* x, View xv, const float* scale,
                        const float* bias, const int* lengths,
                        const float* part, int R, void* out, View ov, int B,
                        int T_, int C, int G, int glu, float eps, int dev,
                        cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  const int Cout = glu ? C / 2 : C;
  const bool vec = vec_ok(x, xv, T_, C, V) && vec_ok(out, ov, T_, Cout, V)
      && xv.cf == ov.cf
      && (xv.cf || ((C / G) % V == 0 && Cout % V == 0));
  const int P = split_blocks(B, (long long)C * T_, sizeof(T), dev);
  const dim3 grid(B * P);
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  if (vec && glu)
    gn_split_apply_kernel<T, V, true><<<grid, kThreads, 0, s>>>(
        xt, xv, scale, bias, lengths, part, R, ot, ov, T_, C, G, P, eps);
  else if (vec)
    gn_split_apply_kernel<T, V, false><<<grid, kThreads, 0, s>>>(
        xt, xv, scale, bias, lengths, part, R, ot, ov, T_, C, G, P, eps);
  else if (glu)
    gn_split_apply_kernel<T, 1, true><<<grid, kThreads, 0, s>>>(
        xt, xv, scale, bias, lengths, part, R, ot, ov, T_, C, G, P, eps);
  else
    gn_split_apply_kernel<T, 1, false><<<grid, kThreads, 0, s>>>(
        xt, xv, scale, bias, lengths, part, R, ot, ov, T_, C, G, P, eps);
  return cudaSuccess;
}

View view_of(const long long* strides) {
  // strides (sb, st, sc) in elements; channels-first when C is not the
  // unit stride (the wrapper has checked one of st, sc is 1)
  const bool cf = strides[2] != 1;
  return {strides[0], strides[1], strides[2], cf ? 1 : 0};
}

}  // namespace

extern "C" {

int gn_max_groups() { return kMaxGroups; }

// The cluster size a launch of this shape takes: 8 or 16 (a row held on
// chip), 0 (streaming chunks) or -1 (a row too wide for either).
int gn_plan(int B, int T_, int C, int glu, int is_bf16, int backward,
            int device) {
  if (cudaSetDevice(device) != cudaSuccess) return -1;
  return is_bf16
      ? make_plan<__nv_bfloat16>(B, T_, C, glu, backward, device).nb
      : make_plan<float>(B, T_, C, glu, backward, device).nb;
}

// fp32 scratch floats the caller allocates for one launch (-1: too wide).
long long gn_scratch_floats(int B, int T_, int C, int G, int glu, int is_bf16,
                            int backward, int device) {
  if (cudaSetDevice(device) != cudaSuccess) return -1;
  return is_bf16 ? scratch_floats<__nv_bfloat16>(B, T_, C, G, glu, backward,
                                                device)
                 : scratch_floats<float>(B, T_, C, G, glu, backward, device);
}

// x, out: (B, T, C) / (B, T, C or C/2) fp32 (is_bf16 = 0) or bf16, with
// element strides x_strides / out_strides (sb, st, sc), st or sc equal to
// 1; scale, bias: (C,) fp32; lengths: (B,) int32 or null.
int gn_forward(const void* x, const long long* x_strides, const float* scale,
               const float* bias, const int* lengths, void* out,
               const long long* out_strides, float* scratch, int B, int T_,
               int C, int G, int glu, int is_bf16, float eps, int device,
               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const View xv = view_of(x_strides), ov = view_of(out_strides);
  err = is_bf16 ? forward<__nv_bfloat16>(x, xv, scale, bias, lengths, out, ov,
                                         scratch, B, T_, C, G, glu, eps, device,
                                         s)
                : forward<float>(x, xv, scale, bias, lengths, out, ov,
                                 scratch, B, T_, C, G, glu, eps, device, s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// x, dx: (B, T, C); g: (B, T, C or C/2), all fp32 (is_bf16 = 0) or bf16,
// strides as in gn_forward; scale, bias, dscale, dbias: (C,) fp32;
// lengths: (B,) int32 or null.
int gn_backward(const void* x, const long long* x_strides, const float* scale,
                const float* bias, const void* g, const long long* g_strides,
                const int* lengths, void* dx, const long long* dx_strides,
                float* dscale, float* dbias, float* scratch, int B, int T_,
                int C, int G, int glu, int is_bf16, float eps, int device,
                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const View xv = view_of(x_strides), gv = view_of(g_strides),
             ov = view_of(dx_strides);
  err = is_bf16
      ? backward<__nv_bfloat16>(x, xv, scale, bias, g, gv, lengths, dx, ov,
                                dscale, dbias, scratch, B, T_, C, G, glu, eps,
                                device, s)
      : backward<float>(x, xv, scale, bias, g, gv, lengths, dx, ov, dscale,
                        dbias, scratch, B, T_, C, G, glu, eps, device, s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Split statistics, the entry points of a GroupNorm whose rows are spread
// over ranks (sequence-parallel inference). gn_split_scratch_floats: the
// fp32 scratch of gn_split_stats, 3 floats a block (-1: a row too long
// for 32-bit element indices). gn_split_stats: this rank's per-(row,
// group) (count, mean, centred M2) over its valid frames into part
// (B, G, 3) fp32; tickets: B*G unsigned counters, zero before the launch
// and zero again after it, used by no other stream meanwhile.
// gn_split_apply: normalize x with the gathered partials (B, G, R, 3) of
// R ranks, merged in rank order, then the affine, the mask and the GLU as
// gn_forward.
long long gn_split_scratch_floats(int B, int T_, int C, int G, int is_bf16,
                                  int device) {
  if ((long long)C * T_ >= (1LL << 31)) return -1;
  if (cudaSetDevice(device) != cudaSuccess) return -1;
  const int P = split_blocks(B * G, (long long)C / G * T_, is_bf16 ? 2 : 4,
                             device);
  return 3LL * B * G * P;
}

int gn_split_stats(const void* x, const long long* x_strides,
                   const int* lengths, float* part, float* scratch,
                   unsigned* tickets, int B, int T_, int C, int G,
                   int is_bf16, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const View xv = view_of(x_strides);
  err = is_bf16 ? split_stats<__nv_bfloat16>(x, xv, lengths, part, scratch,
                                             tickets, B, T_, C, G, device, s)
                : split_stats<float>(x, xv, lengths, part, scratch, tickets,
                                     B, T_, C, G, device, s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

int gn_split_apply(const void* x, const long long* x_strides,
                   const float* scale, const float* bias, const int* lengths,
                   const float* part, int R, void* out,
                   const long long* out_strides, int B, int T_, int C, int G,
                   int glu, int is_bf16, float eps, int device,
                   void* stream) {
  if ((long long)C * T_ >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const View xv = view_of(x_strides), ov = view_of(out_strides);
  err = is_bf16 ? split_apply<__nv_bfloat16>(x, xv, scale, bias, lengths,
                                             part, R, out, ov, B, T_, C, G,
                                             glu, eps, device, s)
                : split_apply<float>(x, xv, scale, bias, lengths, part, R,
                                     out, ov, B, T_, C, G, glu, eps, device,
                                     s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

const char* gn_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
