// AdamW's step over a whole parameter tree, for Hopper (sm_90a): the global
// gradient norm in one launch, then the clipped AdamW update and its apply
// in a second.
//
// Replaces no TPU kernel. The reference's optimizer
// (src/repro/optim/optimizers.py: clip_by_global_norm, adamw) is jnp that
// XLA fuses under the train step's jit. Eagerly, PyTorch runs it as about
// ten elementwise ops a leaf over every leaf (about 3,000 launches a step),
// reading and writing each leaf's bytes several times and building a tree
// of bf16 updates. This source is that work in two launches.
//
// What bounds it on this card: bytes. A bf16 parameter needs its gradient
// read (2 bytes), the parameter read and written (2 + 2), and the fp32
// moments read and written (8 + 8): 22 bytes; the norm reads the gradient
// once more (2), so 24 bytes a parameter. For h2o-danube-1.8b's 1.83 B
// parameters that is 43.9 GB, 13.1 ms at 3.35 TB/s. The design:
//
//   * the leaves are cut into chunks of `chunk` elements (a multiple of 8,
//     fixed by the wrapper, not by the card); a table of leaves (pointers,
//     sizes, types, each leaf's first chunk) is copied to the card once a
//     step and read by both launches, since autograd hands out new
//     gradient tensors every step;
//     block b walks chunks b, b + gridDim.x, ..., and finds a chunk's leaf
//     by a binary search over the table's first chunks; the wrapper gives
//     the norm a fixed grid and the update one block a chunk, which the
//     card balances best (tail of one chunk);
//   * a thread takes 8 neighbouring elements at a time: a 16-byte load of
//     each bf16 leaf, two of each fp32 one (every chunk starts 16-byte
//     aligned, since the wrapper takes only 16-byte aligned leaves), and a
//     leaf's last n % 8 elements one each; nothing is read twice within a
//     launch, so loads and stores take the evict-first hints;
//   * the norm pass sums g^2 into one fp64 partial a block, squares and
//     sums in fp64 (a bf16 or fp32 value's square is exact there), in an
//     order fixed by the table and the grid alone; the block with the last
//     ticket folds the partials in block order and writes the norm, the
//     fp64 sum's square root rounded to fp32: the same bits on every run,
//     and one fp32 rounding from the exact norm in practice (an fp32 sum
//     in this order would be as deterministic, but its rounding grows
//     with the terms a thread adds, ~7,000 at danube's size);
//   * the clip's scale is computed by the caller on the card from that
//     norm with PyTorch's own ops, and read here from device memory: the
//     step waits on nothing on the host;
//   * the update pass computes, for each element, exactly what the eager
//     path computes (clip_by_global_norm, adamw's update, the apply in
//     launch/specs.make_train_step), operation by operation in the same
//     order, each rounded once in fp32 (__fmul_rn and the like, so the
//     compiler contracts nothing into an FMA): the clipped gradient
//     rounded to the gradient's type, m and v in place, the bias-corrected
//     step with weight decay on the old parameter, the update rounded to
//     the parameter's type, and p + u rounded to it. PyTorch divides a
//     tensor by a CPU scalar as a product with the scalar's fp32
//     reciprocal (BinaryDivTrueKernel.cu), so m / bc1 and v / bc2 are
//     products with 1 / bc1 and 1 / bc2 here, as the wrapper passes them;
//     no clipped gradient and no update tree is stored.
//
// Parameters and gradients may be bf16 or fp32 each (the type codes of the
// table's rows; a block branches once a chunk); moments are fp32. Every
// entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kVec = 8;   // elements a thread takes at a time

// One row of the wrapper's table: eight int64 words.
struct Leaf {
  const void* g;
  void* p;
  float* m;
  float* v;
  int64_t n;
  int64_t chunk0;   // the leaf's first chunk
  int64_t g_bf16;   // 1: bf16, 0: fp32
  int64_t p_bf16;
};

// AdamW's scalars, each rounded to fp32 as PyTorch rounds a Python scalar
struct Hyper {
  float b1, c1;       // b1, 1 - b1
  float b2, c2;       // b2, 1 - b2
  float ibc1, ibc2;   // 1 / bc1, 1 / bc2 (fp32 reciprocals)
  float eps, wd, neg_lr;
};

using bf16 = __nv_bfloat16;

// 8 elements of type T as floats, and back
template <typename T>
struct Io;

template <>
struct Io<float> {
  static __device__ __forceinline__ void load(const float* p, float (&x)[kVec]) {
    const float4 a = __ldcs(reinterpret_cast<const float4*>(p));
    const float4 b = __ldcs(reinterpret_cast<const float4*>(p) + 1);
    x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
    x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
  }
  static __device__ __forceinline__ void store(float* p, const float (&x)[kVec]) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(x[0], x[1], x[2], x[3]));
    __stcs(reinterpret_cast<float4*>(p) + 1, make_float4(x[4], x[5], x[6], x[7]));
  }
  static __device__ __forceinline__ float one(const float* p) { return __ldcs(p); }
  static __device__ __forceinline__ void put(float* p, float x) { __stcs(p, x); }
  static __device__ __forceinline__ float round(float x) { return x; }
};

template <>
struct Io<bf16> {
  static __device__ __forceinline__ void load(const bf16* p, float (&x)[kVec]) {
    const uint4 raw = __ldcs(reinterpret_cast<const uint4*>(p));
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      x[2 * i] = f.x;
      x[2 * i + 1] = f.y;
    }
  }
  static __device__ __forceinline__ void store(bf16* p, const float (&x)[kVec]) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
    __stcs(reinterpret_cast<uint4*>(p), make_uint4(w[0], w[1], w[2], w[3]));
  }
  static __device__ __forceinline__ float one(const bf16* p) {
    const unsigned short raw = __ldcs(reinterpret_cast<const unsigned short*>(p));
    return __bfloat162float(__ushort_as_bfloat16(raw));
  }
  static __device__ __forceinline__ void put(bf16* p, float x) {
    __stcs(reinterpret_cast<unsigned short*>(p),
           __bfloat16_as_ushort(__float2bfloat16_rn(x)));
  }
  static __device__ __forceinline__ float round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
};

// the leaf holding chunk c: the last row whose first chunk is at most c
__device__ __forceinline__ const Leaf& leaf_of(const Leaf* __restrict__ t,
                                               int nleaves, int64_t c) {
  int lo = 0, hi = nleaves - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (t[mid].chunk0 <= c) lo = mid; else hi = mid - 1;
  }
  return t[lo];
}

// ---------------------------------------------------------------- the norm

template <typename G>
__device__ __forceinline__ double sum_squares(const G* __restrict__ g,
                                              int64_t len, double acc) {
  const int64_t whole = len / kVec * kVec;
  for (int64_t i = static_cast<int64_t>(threadIdx.x) * kVec; i < whole;
       i += kThreads * kVec) {
    float x[kVec];
    Io<G>::load(g + i, x);
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const double d = x[k];
      acc = fma(d, d, acc);
    }
  }
  const int64_t i = whole + threadIdx.x;
  if (i < len) {
    const double d = Io<G>::one(g + i);
    acc = fma(d, d, acc);
  }
  return acc;
}

// the block's sum of one value a thread, in a fixed tree; in thread 0
__device__ __forceinline__ double block_sum(double v) {
  __shared__ double s_warp[kWarps];
#pragma unroll
  for (int lane_mask = 16; lane_mask > 0; lane_mask >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, lane_mask);
  }
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  __syncthreads();   // s_warp is free (an earlier call has read it)
  if (lane == 0) s_warp[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kWarps ? s_warp[lane] : 0.0;
#pragma unroll
    for (int lane_mask = kWarps / 2; lane_mask > 0; lane_mask >>= 1) {
      v += __shfl_xor_sync(0xffffffffu, v, lane_mask);
    }
  }
  return v;
}

__global__ void __launch_bounds__(kThreads)
adamw_norm_pass(const Leaf* __restrict__ table, int nleaves, int64_t nchunks,
                int64_t chunk, double* __restrict__ partial,
                unsigned int* __restrict__ ticket, float* __restrict__ out) {
  __shared__ int s_last;
  double acc = 0.0;
  for (int64_t c = blockIdx.x; c < nchunks; c += gridDim.x) {
    const Leaf& lf = leaf_of(table, nleaves, c);
    const int64_t start = (c - lf.chunk0) * chunk;
    const int64_t len = lf.n - start < chunk ? lf.n - start : chunk;
    if (lf.g_bf16) {
      acc = sum_squares(static_cast<const bf16*>(lf.g) + start, len, acc);
    } else {
      acc = sum_squares(static_cast<const float*>(lf.g) + start, len, acc);
    }
  }
  acc = block_sum(acc);
  if (threadIdx.x == 0) {
    partial[blockIdx.x] = acc;
    __threadfence();   // the partial is visible before the ticket is taken
    s_last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!s_last) return;

  // the last block: every partial, thread t taking blocks t, t + 256, ...
  __threadfence();
  double total = 0.0;
  for (unsigned int j = threadIdx.x; j < gridDim.x; j += kThreads) {
    total += __ldcg(partial + j);
  }
  total = block_sum(total);
  if (threadIdx.x == 0) {
    out[0] = static_cast<float>(sqrt(total));
    *ticket = 0u;   // zeroed for the next launch on this stream
  }
}

// ---------------------------------------------------------------- the update

// one element: the eager path's operations in its order
template <typename G, typename P>
__device__ __forceinline__ void adamw_one(float g, float& m, float& v, float& p,
                                          float scale, const Hyper& h) {
  const float gc = Io<G>::round(__fmul_rn(g, scale));         // the clip
  m = __fadd_rn(__fmul_rn(m, h.b1), __fmul_rn(gc, h.c1));
  v = __fadd_rn(__fmul_rn(v, h.b2), __fmul_rn(__fmul_rn(gc, gc), h.c2));
  float delta = __fmul_rn(m, h.ibc1);
  const float denom = __fadd_rn(__fsqrt_rn(__fmul_rn(v, h.ibc2)), h.eps);
  delta = __fdiv_rn(delta, denom);
  delta = __fadd_rn(delta, __fmul_rn(p, h.wd));
  const float u = Io<P>::round(__fmul_rn(delta, h.neg_lr));   // the update
  p = __fadd_rn(p, u);                                        // the apply
}

template <typename G, typename P>
__device__ __forceinline__ void update_chunk(const G* __restrict__ g,
                                             P* __restrict__ p,
                                             float* __restrict__ m,
                                             float* __restrict__ v,
                                             int64_t len, float scale,
                                             const Hyper& h) {
  const int64_t whole = len / kVec * kVec;
  for (int64_t i = static_cast<int64_t>(threadIdx.x) * kVec; i < whole;
       i += kThreads * kVec) {
    float xg[kVec], xp[kVec], xm[kVec], xv[kVec];
    Io<G>::load(g + i, xg);
    Io<P>::load(p + i, xp);
    Io<float>::load(m + i, xm);
    Io<float>::load(v + i, xv);
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      adamw_one<G, P>(xg[k], xm[k], xv[k], xp[k], scale, h);
    }
    Io<float>::store(m + i, xm);
    Io<float>::store(v + i, xv);
    Io<P>::store(p + i, xp);
  }
  const int64_t i = whole + threadIdx.x;
  if (i < len) {
    float xm = Io<float>::one(m + i), xv = Io<float>::one(v + i);
    float xp = Io<P>::one(p + i);
    adamw_one<G, P>(Io<G>::one(g + i), xm, xv, xp, scale, h);
    Io<float>::put(m + i, xm);
    Io<float>::put(v + i, xv);
    Io<P>::put(p + i, xp);
  }
}

template <typename G, typename P>
__device__ __forceinline__ void update_leaf(const Leaf& lf, int64_t start,
                                            int64_t len, float scale,
                                            const Hyper& h) {
  update_chunk<G, P>(static_cast<const G*>(lf.g) + start,
                     static_cast<P*>(lf.p) + start, lf.m + start,
                     lf.v + start, len, scale, h);
}

__global__ void __launch_bounds__(kThreads)
adamw_update_pass(const Leaf* __restrict__ table, int nleaves, int64_t nchunks,
                  int64_t chunk, const float* __restrict__ scale_ptr, Hyper h) {
  const float scale = __ldg(scale_ptr);
  for (int64_t c = blockIdx.x; c < nchunks; c += gridDim.x) {
    const Leaf& lf = leaf_of(table, nleaves, c);
    const int64_t start = (c - lf.chunk0) * chunk;
    const int64_t len = lf.n - start < chunk ? lf.n - start : chunk;
    if (lf.g_bf16) {
      if (lf.p_bf16) update_leaf<bf16, bf16>(lf, start, len, scale, h);
      else update_leaf<bf16, float>(lf, start, len, scale, h);
    } else {
      if (lf.p_bf16) update_leaf<float, bf16>(lf, start, len, scale, h);
      else update_leaf<float, float>(lf, start, len, scale, h);
    }
  }
}

}  // namespace

// table (nleaves, 8) int64 on the card, as the struct Leaf above: every
// leaf non-empty, 16-byte aligned, its chunk0 the number of chunks of the
// rows before it; nchunks the total. The norm: partial (blocks,) fp64,
// counter a zeroed uint32 that the launch leaves zeroed, out a 0-d fp32.
extern "C" int cobra_adamw_norm(const void* table, int nleaves,
                                long long nchunks, long long chunk, int blocks,
                                void* partial, void* counter, void* out,
                                void* stream) {
  if (nleaves <= 0 || nchunks <= 0 || chunk <= 0 || chunk % kVec != 0 ||
      blocks <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  adamw_norm_pass<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const Leaf*>(table), nleaves, nchunks, chunk,
      static_cast<double*>(partial), static_cast<unsigned int*>(counter),
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// The update: the table's g, p, m and v in place of their leaves; scale a
// 0-d fp32 on the card (the clip's factor); the scalars as Hyper names them.
extern "C" int cobra_adamw_update(const void* table, int nleaves,
                                  long long nchunks, long long chunk,
                                  int blocks, const void* scale, float b1,
                                  float c1, float b2, float c2, float ibc1,
                                  float ibc2, float eps, float wd,
                                  float neg_lr, void* stream) {
  if (nleaves <= 0 || nchunks <= 0 || chunk <= 0 || chunk % kVec != 0 ||
      blocks <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Hyper h{b1, c1, b2, c2, ibc1, ibc2, eps, wd, neg_lr};
  adamw_update_pass<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const Leaf*>(table), nleaves, nchunks, chunk,
      static_cast<const float*>(scale), h);
  return static_cast<int>(cudaGetLastError());
}
