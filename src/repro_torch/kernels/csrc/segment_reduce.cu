// Segment reduction (relational group-by sum / count / min / max), for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/segment_reduce.py:
// segment_reduce (its _kernel). That kernel walked the rows in a sequential
// grid and carried each segment's total in its output block from one grid
// step to the next. Blocks on this card run in no order, so nothing carries
// from block to block: each block folds a row range into a partial, and the
// partials are folded in a fixed order. Every sum is taken in float32 in an
// order fixed by (N, G) alone: no float atomics, no tensor cores (so no
// TF32), and the result does not depend on the run.
//
// What bounds it on this card: bytes. The hot call (the compiled tier's
// accumulator fold) is G = 1 over N = 2.88M rows: it must read 4 bytes of
// value and 4 of segment id per row, about 23 MB, about 7 us at 3.35 TB/s,
// and does one add per row. Keeping 3.35 TB/s busy at about 1 us of memory
// latency needs about 3 MB in flight, so the G = 1 route (fold_stream) is
// built to keep loads in flight and to launch once:
//
//   * block b streams the contiguous rows [b * rpb, (b + 1) * rpb), rpb a
//     multiple of 4 fixed by (N, G) (the wrapper's launch_shape); each
//     thread loads kUnroll 16-byte vectors of values and kUnroll of ids
//     (every one of its vectors at the SF1 shape) before it folds any, with
//     the evict-first hint (__ldcs): nothing rereads them;
//   * thread t folds vectors t, t + 256, ... of its block in registers, a
//     vector's four rows in order, then the rows past the last whole
//     vector (thread 0 of the last block); a warp folds with a
//     __shfl_xor_sync tree, the block its eight warp totals in warp order;
//   * each block writes its partial and takes a ticket on a 4-byte counter
//     after __threadfence(); the block with the last ticket folds every
//     partial in a fixed tree over block order, writes out[0] and puts the
//     counter back to 0, so the next launch on the stream finds it zeroed
//     (one launch per call; the wrapper keeps one counter per stream);
//   * a base that is not 16-byte aligned (a column view) takes the same
//     route with four scalar loads per vector: the same rows in the same
//     order, so the same bits;
//   * the op is a template parameter: a runtime op tested per row cost
//     about 2 us of the 2.88M-row fold (tools/relational_variants.py).
//
// G > 1 takes the tiled route of the first port (fold_row_blocks, then
// fold_partials): block (row block rb, segment tile) stages CHUNK rows at a
// time in shared memory; its 256 threads are (slice s, segment g) pairs,
// tg segments by 256 / tg slices: thread (s, g) folds rows s, s + slices,
// ... of the chunk where the row's segment is g, then the slices combine in
// a fixed tree; a second launch folds partial[g * nrb + 0 .. nrb) into
// out[g]. Its compare work grows as N * G, as it did in the TPU kernel's
// one-hot product.
//
// Empty min/max segments come out as 0, as in the TPU kernel. Segment ids
// outside [0, G) are skipped. Every entry point launches on the caller's
// stream, allocates nothing (the wrapper passes the partial buffer and the
// counter), and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 2048;
constexpr int kUnroll = 8;   // 16-byte vectors of values (and of ids) in flight

enum Op { kSum = 0, kCount = 1, kMin = 2, kMax = 3 };

__device__ __forceinline__ float identity(int op) {
  return op == kMin ? CUDART_INF_F : (op == kMax ? -CUDART_INF_F : 0.0f);
}

__device__ __forceinline__ float combine(int op, float a, float b) {
  if (op == kMin) return b < a ? b : a;
  if (op == kMax) return b > a ? b : a;
  return a + b;
}

// ---------------------------------------------------------------- G = 1

// rows p[0..4), as one 16-byte load or four scalar ones
template <bool kVec>
__device__ __forceinline__ float4 load_vals(const float* p) {
  if constexpr (kVec) {
    return __ldcs(reinterpret_cast<const float4*>(p));
  } else {
    return make_float4(__ldcs(p), __ldcs(p + 1), __ldcs(p + 2), __ldcs(p + 3));
  }
}

template <bool kVec>
__device__ __forceinline__ int4 load_segs(const int32_t* p) {
  if constexpr (kVec) {
    return __ldcs(reinterpret_cast<const int4*>(p));
  } else {
    return make_int4(__ldcs(p), __ldcs(p + 1), __ldcs(p + 2), __ldcs(p + 3));
  }
}

template <int kOp>
__device__ __forceinline__ float fold_row(float acc, float x, int32_t s) {
  return s == 0 ? combine(kOp, acc, kOp == kCount ? 1.0f : x) : acc;
}

// the block's fold of one value per thread, in a fixed tree; the result is
// in thread 0 (every thread of the block must call it)
__device__ __forceinline__ float block_fold(int op, float v) {
  __shared__ float s_warp[kWarps];
#pragma unroll
  for (int lane_mask = 16; lane_mask > 0; lane_mask >>= 1) {
    v = combine(op, v, __shfl_xor_sync(0xffffffffu, v, lane_mask));
  }
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  __syncthreads();   // s_warp is free (an earlier call has read it)
  if (lane == 0) s_warp[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kWarps ? s_warp[lane] : identity(op);
#pragma unroll
    for (int lane_mask = kWarps / 2; lane_mask > 0; lane_mask >>= 1) {
      v = combine(op, v, __shfl_xor_sync(0xffffffffu, v, lane_mask));
    }
  }
  return v;
}

template <bool kVec, int kOp>
__global__ void __launch_bounds__(kThreads)
fold_stream(const float* __restrict__ vals, const int32_t* __restrict__ segs,
            int64_t n, int64_t rows_per_block, float* __restrict__ partial,
            unsigned int* __restrict__ ticket, float* __restrict__ out) {
  constexpr int op = kOp;
  __shared__ int s_last;
  const int tid = threadIdx.x;
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * rows_per_block;
  const int64_t r1 = r0 + rows_per_block < n ? r0 + rows_per_block : n;
  const int64_t nvec = (r1 - r0) / 4;
  const float* bv = vals + r0;
  const int32_t* bs = segs + r0;

  float acc = identity(op);
  for (int64_t v0 = tid; v0 < nvec; v0 += kThreads * kUnroll) {
    float4 x[kUnroll];
    int4 s[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t v = v0 + u * kThreads;
      if (v < nvec) {
        x[u] = load_vals<kVec>(bv + 4 * v);
        s[u] = load_segs<kVec>(bs + 4 * v);
      } else {
        x[u] = make_float4(0.f, 0.f, 0.f, 0.f);
        s[u] = make_int4(-1, -1, -1, -1);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      acc = fold_row<kOp>(acc, x[u].x, s[u].x);
      acc = fold_row<kOp>(acc, x[u].y, s[u].y);
      acc = fold_row<kOp>(acc, x[u].z, s[u].z);
      acc = fold_row<kOp>(acc, x[u].w, s[u].w);
    }
  }
  if (tid == 0) {   // rows past the last whole vector (the last block only)
    for (int64_t r = r0 + 4 * nvec; r < r1; ++r) {
      acc = fold_row<kOp>(acc, __ldcs(vals + r), __ldcs(segs + r));
    }
  }
  acc = block_fold(op, acc);

  if (tid == 0) {
    partial[blockIdx.x] = acc;
    __threadfence();   // the partial is visible before the ticket is taken
    s_last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!s_last) return;

  // the last block: every partial, thread t taking blocks t, t + 256, ...
  __threadfence();
  float total = identity(op);
  for (unsigned int j = tid; j < gridDim.x; j += kThreads) {
    total = combine(op, total, __ldcg(partial + j));
  }
  total = block_fold(op, total);
  if (tid == 0) {
    if ((op == kMin || op == kMax) && !isfinite(total)) total = 0.0f;  // empty
    out[0] = total;
    *ticket = 0u;   // zeroed for the next launch on this stream
  }
}

// ---------------------------------------------------------------- G > 1

__global__ void fold_row_blocks(const float* __restrict__ vals,
                                const int32_t* __restrict__ segs, int64_t n,
                                int32_t num_segments, int32_t tg, int32_t nrb,
                                int64_t rows_per_block, int op,
                                float* __restrict__ partial) {
  __shared__ float s_val[kChunk];
  __shared__ int32_t s_seg[kChunk];
  __shared__ float s_red[kThreads];

  const int tid = threadIdx.x;
  const int rb = static_cast<int>(blockIdx.x % nrb);
  const int tile = static_cast<int>(blockIdx.x / nrb);
  const int gl = tid % tg;
  const int slice = tid / tg;
  const int slices = kThreads / tg;
  const int32_t g = tile * tg + gl;

  const int64_t r0 = static_cast<int64_t>(rb) * rows_per_block;
  const int64_t r1 = r0 + rows_per_block < n ? r0 + rows_per_block : n;
  float acc = identity(op);
  for (int64_t c0 = r0; c0 < r1; c0 += kChunk) {
    const int len = static_cast<int>(r1 - c0 < kChunk ? r1 - c0 : kChunk);
    __syncthreads();  // the previous chunk has been consumed
    for (int j = tid; j < len; j += kThreads) {
      s_val[j] = vals[c0 + j];
      s_seg[j] = segs[c0 + j];
    }
    __syncthreads();
    for (int j = slice; j < len; j += slices) {
      if (s_seg[j] == g) acc = combine(op, acc, op == kCount ? 1.0f : s_val[j]);
    }
  }
  s_red[tid] = acc;
  __syncthreads();
  for (int half = slices / 2; half > 0; half >>= 1) {
    if (slice < half) s_red[tid] = combine(op, s_red[tid], s_red[tid + half * tg]);
    __syncthreads();
  }
  if (slice == 0 && g < num_segments) {
    partial[static_cast<int64_t>(g) * nrb + rb] = s_red[gl];
  }
}

__global__ void fold_partials(const float* __restrict__ partial, int32_t nrb,
                              int op, float* __restrict__ out) {
  __shared__ float s_red[kThreads];
  const int tid = threadIdx.x;
  const int64_t g = blockIdx.x;
  float acc = identity(op);
  for (int j = tid; j < nrb; j += kThreads) {
    acc = combine(op, acc, partial[g * nrb + j]);
  }
  s_red[tid] = acc;
  __syncthreads();
  for (int half = kThreads / 2; half > 0; half >>= 1) {
    if (tid < half) s_red[tid] = combine(op, s_red[tid], s_red[tid + half]);
    __syncthreads();
  }
  if (tid == 0) {
    float v = s_red[0];
    if ((op == kMin || op == kMax) && !isfinite(v)) v = 0.0f;  // empty group
    out[g] = v;
  }
}

}  // namespace

// vals (n,) float32, segs (n,) int32, out (num_segments,) float32.
// num_segments == 1: `blocks` row blocks of rows_per_block rows (a multiple
// of 4) in one launch, partial (blocks,) float32, counter a zeroed uint32
// that the launch leaves zeroed, vec whether vals and segs are both 16-byte
// aligned. num_segments > 1: tg is a power of two dividing 256, `blocks` is
// the number of row blocks nrb, partial (num_segments * nrb,) float32; the
// first launch has nrb * ceil(num_segments / tg) blocks, counter and vec
// are unused.
extern "C" int cobra_segment_reduce(const void* vals, const void* segs,
                                    long long n, int num_segments, int op,
                                    int tg, int blocks,
                                    long long rows_per_block, int vec,
                                    void* partial, void* counter, void* out,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* v = static_cast<const float*>(vals);
  const int32_t* g = static_cast<const int32_t*>(segs);
  float* p = static_cast<float*>(partial);
  float* o = static_cast<float*>(out);
  if (num_segments == 1 && n > 0) {
    unsigned int* t = static_cast<unsigned int*>(counter);
    if (op < kSum || op > kMax) return static_cast<int>(cudaErrorInvalidValue);
    static void (*const kernels[2][4])(const float*, const int32_t*, int64_t,
                                       int64_t, float*, unsigned int*, float*) = {
        {fold_stream<false, kSum>, fold_stream<false, kCount>,
         fold_stream<false, kMin>, fold_stream<false, kMax>},
        {fold_stream<true, kSum>, fold_stream<true, kCount>,
         fold_stream<true, kMin>, fold_stream<true, kMax>}};
    kernels[vec ? 1 : 0][op]<<<blocks, kThreads, 0, s>>>(v, g, n, rows_per_block,
                                                         p, t, o);
  } else if (num_segments > 1 && n > 0) {
    const long long tiles = (num_segments + tg - 1) / tg;
    fold_row_blocks<<<static_cast<unsigned int>(tiles * blocks), kThreads, 0,
                      s>>>(v, g, n, num_segments, tg, blocks, rows_per_block,
                           op, p);
    fold_partials<<<static_cast<unsigned int>(num_segments), kThreads, 0, s>>>(
        p, blocks, op, o);
  }
  return static_cast<int>(cudaGetLastError());
}
