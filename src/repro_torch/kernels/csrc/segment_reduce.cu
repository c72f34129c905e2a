// Segment reduction (relational group-by sum / count / min / max), for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/segment_reduce.py:
// segment_reduce (its _kernel). That kernel walked the rows in a sequential
// grid and carried each segment's total in its output block from one grid
// step to the next. Blocks on this card run in no order, so nothing carries:
//
//   pass 1  block (row block rb, segment tile) folds the rows of its row block
//           into one partial per segment of its tile and writes
//           partial[g * nrb + rb];
//   pass 2  block g folds partial[g * nrb + 0 .. nrb) into out[g].
//
// Inside pass 1 the block stages CHUNK rows at a time in shared memory. Its
// 256 threads are (slice s, segment g) pairs, tg segments by 256 / tg
// slices: thread (s, g) folds rows s, s + slices, s + 2 slices, ... of the
// chunk where the row's segment is g, then the slices combine in a fixed
// tree. Every sum is taken in float32 in an order fixed by (N, G) alone: no
// float atomics, no tensor cores (so no TF32), and the result does not
// depend on the run.
//
// What bounds it on this card: bytes. The hot call (the compiled tier's
// accumulator fold) is G = 1 over N = 2.88M rows: it must read 4 bytes of
// value and 4 of segment id per row, about 23 MB, about 7 us at 3.35 TB/s,
// and does one add per row. The design keeps every load coalesced and every
// thread busy at G = 1 (one segment, 256 slices), and launches up to 1024
// row blocks so the whole card streams the input. For G segments the
// compare work grows as N * G, as it did in the TPU kernel's one-hot
// product; that is fine for the group counts the tests use and is work for
// a later change, not this one.
//
// Empty min/max segments come out as 0, as in the TPU kernel. Segment ids
// outside [0, G) are skipped. Every entry point launches on the caller's
// stream, allocates nothing (the wrapper passes the partial buffer), and
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 2048;

enum Op { kSum = 0, kCount = 1, kMin = 2, kMax = 3 };

__device__ __forceinline__ float identity(int op) {
  return op == kMin ? CUDART_INF_F : (op == kMax ? -CUDART_INF_F : 0.0f);
}

__device__ __forceinline__ float combine(int op, float a, float b) {
  if (op == kMin) return b < a ? b : a;
  if (op == kMax) return b > a ? b : a;
  return a + b;
}

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

// vals (n,) float32, segs (n,) int32, partial (num_segments * nrb,) float32,
// out (num_segments,) float32. tg is a power of two dividing 256; the
// launch has nrb * ceil(num_segments / tg) blocks in pass 1.
extern "C" int cobra_segment_reduce(const void* vals, const void* segs,
                                    long long n, int num_segments, int op,
                                    int tg, int nrb, long long rows_per_block,
                                    void* partial, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (num_segments > 0 && n > 0) {
    const long long tiles = (num_segments + tg - 1) / tg;
    fold_row_blocks<<<static_cast<unsigned int>(tiles * nrb), kThreads, 0, s>>>(
        static_cast<const float*>(vals), static_cast<const int32_t*>(segs), n,
        num_segments, tg, nrb, rows_per_block, op,
        static_cast<float*>(partial));
    fold_partials<<<static_cast<unsigned int>(num_segments), kThreads, 0, s>>>(
        static_cast<const float*>(partial), nrb, op,
        static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
