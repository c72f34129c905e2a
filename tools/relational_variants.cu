// Design variants of the relational kernels, for measurement only: the
// shipped kernels are in src/repro_torch/kernels/csrc/. Each variant
// computes the same function as its kernel (the probe of join_probe.cu,
// the one-segment sum of segment_reduce.cu, the build of join_probe.cu) so
// tools/relational_variants.py can check it and time it beside the others.
// Built by that script with nvcc for sm_90a.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

__device__ __forceinline__ int32_t ld_no_allocate(const int32_t* p) {
  int32_t v;
  asm volatile("ld.global.nc.L1::no_allocate.b32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ int32_t ld_evict_last(const int32_t* p) {
  int32_t v;
  asm volatile("ld.global.nc.L1::evict_last.b32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ int32_t gather(const int32_t* slots, int64_t m, int32_t k) {
  return (k >= 0 && k < m) ? __ldg(slots + k) : -1;
}

// one key per thread; kHint: streaming hints on the key and the result;
// kL1: keys not kept in L1, gathers kept there last
template <bool kHint, bool kL1>
__global__ void probe_one(const int32_t* keys, int64_t n, const int32_t* slots,
                          int64_t m, int32_t* out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int32_t k = kL1 ? ld_no_allocate(keys + i) : (kHint ? __ldcs(keys + i) : keys[i]);
  const int32_t r = kL1 ? ((k >= 0 && k < m) ? ld_evict_last(slots + k) : -1)
                        : gather(slots, m, k);
  if (kHint || kL1) __stcs(out + i, r); else out[i] = r;
}

// kU 16-byte runs of keys per thread, every gather before any store;
// kPersistent: a grid the card holds at once, walking the keys grid-stride,
// after an L2 prefetch of the table
template <int kU, bool kPersistent>
__global__ void __launch_bounds__(256)
probe_runs(const int32_t* keys, int64_t n, const int32_t* slots, int64_t m,
           int32_t* out) {
  if (kPersistent && m <= n) {
    for (int64_t l = blockIdx.x + static_cast<int64_t>(threadIdx.x) * gridDim.x;
         l < (m + 31) / 32; l += static_cast<int64_t>(gridDim.x) * 256) {
      asm volatile("prefetch.global.L2 [%0];" :: "l"(__cvta_generic_to_global(slots + l * 32)));
    }
  }
  const int64_t nvec = n / 4;
  const int64_t stride = kPersistent ? static_cast<int64_t>(gridDim.x) * 256 : 256;
  const int64_t first = kPersistent ? static_cast<int64_t>(blockIdx.x) * 256 + threadIdx.x
                                    : static_cast<int64_t>(blockIdx.x) * 256 * kU + threadIdx.x;
  const int64_t step = kPersistent ? stride * kU : nvec;
  for (int64_t v0 = first; v0 < nvec; v0 += step) {
    int4 k[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int64_t v = v0 + u * stride;
      k[u] = v < nvec ? __ldcs(reinterpret_cast<const int4*>(keys) + v) : make_int4(-1, -1, -1, -1);
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      k[u] = make_int4(gather(slots, m, k[u].x), gather(slots, m, k[u].y),
                       gather(slots, m, k[u].z), gather(slots, m, k[u].w));
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int64_t v = v0 + u * stride;
      if (v < nvec) __stcs(reinterpret_cast<int4*>(out) + v, k[u]);
    }
  }
  if (blockIdx.x == 0 && threadIdx.x < n - 4 * nvec) {
    const int64_t i = 4 * nvec + threadIdx.x;
    out[i] = gather(slots, m, keys[i]);
  }
}

// the first `per` slots staged in shared memory, the rest gathered from
// global memory; 1024-thread persistent blocks, 2 runs of keys a thread
__global__ void __launch_bounds__(1024, 1)
probe_smem(const int32_t* keys, int64_t n, const int32_t* slots, int64_t m,
           int32_t per, int32_t* out) {
  extern __shared__ int4 s_raw[];
  const int32_t* s = reinterpret_cast<const int32_t*>(s_raw);
  constexpr int kU = 2;
  const int64_t nvec = n / 4, stride = static_cast<int64_t>(gridDim.x) * 1024;
  int64_t v0 = static_cast<int64_t>(blockIdx.x) * 1024 + threadIdx.x;
  int4 k[kU];
#pragma unroll
  for (int u = 0; u < kU; ++u) {
    const int64_t v = v0 + u * stride;
    k[u] = v < nvec ? __ldcs(reinterpret_cast<const int4*>(keys) + v) : make_int4(-1, -1, -1, -1);
  }
  for (int i = threadIdx.x; i < per / 4; i += 1024) {
    s_raw[i] = __ldcg(reinterpret_cast<const int4*>(slots) + i);
  }
  __syncthreads();
  for (; v0 < nvec; v0 += stride * kU) {
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      int32_t r[4] = {k[u].x, k[u].y, k[u].z, k[u].w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        r[j] = (r[j] >= 0 && r[j] < per) ? s[r[j]] : gather(slots, m, r[j]);
      }
      k[u] = make_int4(r[0], r[1], r[2], r[3]);
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int64_t v = v0 + u * stride;
      if (v < nvec) __stcs(reinterpret_cast<int4*>(out) + v, k[u]);
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int64_t v = v0 + (u + kU) * stride;
      k[u] = v < nvec ? __ldcs(reinterpret_cast<const int4*>(keys) + v) : make_int4(-1, -1, -1, -1);
    }
  }
  if (blockIdx.x == 0 && threadIdx.x < n - 4 * nvec) {
    const int64_t i = 4 * nvec + threadIdx.x;
    out[i] = gather(slots, m, keys[i]);
  }
}

// the table cut in `per`-slot slices, slice r in the shared memory of the
// cluster's block r, gathered across the cluster
__global__ void __launch_bounds__(1024, 1)
probe_cluster(const int32_t* keys, int64_t n, const int32_t* slots, int32_t m,
              int32_t per, int32_t* out) {
  extern __shared__ int4 s_raw[];
  int32_t* s = reinterpret_cast<int32_t*>(s_raw);
  cg::cluster_group cluster = cg::this_cluster();
  const int32_t lo = static_cast<int32_t>(cluster.block_rank()) * per;
  const int32_t len = m - lo < per ? (m - lo > 0 ? m - lo : 0) : per;
  for (int32_t i = threadIdx.x; i < len; i += 1024) s[i] = __ldcg(slots + lo + i);
  cluster.sync();
  const int64_t stride = static_cast<int64_t>(gridDim.x) * 1024;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * 1024 + threadIdx.x; i < n; i += stride) {
    const int32_t k = __ldcs(keys + i);
    int32_t r = -1;
    if (k >= 0 && k < m) {
      const unsigned int rank = static_cast<unsigned int>(k) / static_cast<unsigned int>(per);
      r = cluster.map_shared_rank(s, rank)[k - static_cast<int32_t>(rank) * per];
    }
    __stcs(out + i, r);
  }
  cluster.sync();
}

int sms() {
  int dev = 0, count = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
  return count;
}

template <typename K>
int resident(K kernel, int threads, size_t smem) {
  int per_sm = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  return sms() * per_sm;
}

// ------------------------------------------------------------ one-segment sum

// the block's sum, in thread 0 (every thread must call it)
template <int kT>
__device__ float block_sum(float v, float* s_warp) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();
  if (threadIdx.x % 32 == 0) s_warp[threadIdx.x / 32] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    v = 0.f;
    for (int w = 0; w < kT / 32; ++w) v += s_warp[w];
  }
  return v;
}

template <int kT, int kU, bool kHint, bool kLastFold>
__global__ void __launch_bounds__(kT)
sum_stream(const float* vals, const int32_t* segs, int64_t n, int64_t rpb,
           float* partial, unsigned int* ticket, float* out) {
  __shared__ int s_last;
  __shared__ float s_warp[kT / 32];
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * rpb;
  const int64_t r1 = r0 + rpb < n ? r0 + rpb : n;
  const int64_t nvec = (r1 - r0) / 4;
  float acc = 0.f;
  for (int64_t v0 = threadIdx.x; v0 < nvec; v0 += kT * kU) {
    float4 x[kU];
    int4 s[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int64_t v = v0 + u * kT;
      const float4* pv = reinterpret_cast<const float4*>(vals + r0) + v;
      const int4* ps = reinterpret_cast<const int4*>(segs + r0) + v;
      x[u] = v < nvec ? (kHint ? __ldcs(pv) : *pv) : make_float4(0.f, 0.f, 0.f, 0.f);
      s[u] = v < nvec ? (kHint ? __ldcs(ps) : *ps) : make_int4(-1, -1, -1, -1);
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      acc += s[u].x == 0 ? x[u].x : 0.f;
      acc += s[u].y == 0 ? x[u].y : 0.f;
      acc += s[u].z == 0 ? x[u].z : 0.f;
      acc += s[u].w == 0 ? x[u].w : 0.f;
    }
  }
  if (threadIdx.x == 0) {
    for (int64_t r = r0 + 4 * nvec; r < r1; ++r) acc += segs[r] == 0 ? vals[r] : 0.f;
  }
  acc = block_sum<kT>(acc, s_warp);
  if (threadIdx.x == 0) {
    partial[blockIdx.x] = acc;
    s_last = 0;
    if (kLastFold) {
      __threadfence();
      s_last = atomicAdd(ticket, 1u) == gridDim.x - 1;
    }
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  float total = 0.f;
  for (unsigned int j = threadIdx.x; j < gridDim.x; j += kT) total += __ldcg(partial + j);
  total = block_sum<kT>(total, s_warp);
  if (threadIdx.x == 0) {
    out[0] = total;
    *ticket = 0u;
  }
}

template <int kT, int kU, bool kHint, bool kLastFold>
void launch_sum(const float* v, const int32_t* s, int64_t n, float* p,
                unsigned int* t, float* o, cudaStream_t st) {
  const int64_t pass = static_cast<int64_t>(kT) * kU * 4;
  int64_t blocks = (n + pass - 1) / pass;
  blocks = blocks > 1024 ? 1024 : (blocks < 1 ? 1 : blocks);
  int64_t rpb = (n + blocks - 1) / blocks;
  rpb = (rpb + 3) / 4 * 4;
  blocks = (n + rpb - 1) / rpb;
  sum_stream<kT, kU, kHint, kLastFold><<<static_cast<unsigned int>(blocks), kT, 0, st>>>(
      v, s, n, rpb, p, t, o);
}

// ------------------------------------------------------------ build: two launches

__global__ void fill_slots(int32_t* slots, int64_t m) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < m) slots[i] = -1;
}

__global__ void scatter_rows(const int32_t* keys, int64_t n, int32_t* slots, int64_t m) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int32_t k = keys[i];
  if (k >= 0 && k < m) atomicMin(reinterpret_cast<unsigned int*>(slots + k), static_cast<unsigned int>(i));
}

}  // namespace

// variant v of the probe; returns the launch's CUDA error (or -1 for an
// unknown variant)
extern "C" int variant_probe(int v, const void* keys_, long long n,
                             const void* slots_, long long m, void* out_,
                             void* stream) {
  const int32_t* keys = static_cast<const int32_t*>(keys_);
  const int32_t* slots = static_cast<const int32_t*>(slots_);
  int32_t* out = static_cast<int32_t*>(out_);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned int one = static_cast<unsigned int>((n + 255) / 256);
  switch (v) {
    case 0:   // one key per thread, no hints (the first port's probe)
      probe_one<false, false><<<one, 256, 0, st>>>(keys, n, slots, m, out);
      break;
    case 1:   // the same with the largest L1 (no shared memory carveout)
      cudaFuncSetAttribute(probe_one<false, false>,
                           cudaFuncAttributePreferredSharedMemoryCarveout, 0);
      probe_one<false, false><<<one, 256, 0, st>>>(keys, n, slots, m, out);
      cudaFuncSetAttribute(probe_one<false, false>,
                           cudaFuncAttributePreferredSharedMemoryCarveout, -1);
      break;
    case 2:   // keys not kept in L1, gathers kept there last
      probe_one<true, true><<<one, 256, 0, st>>>(keys, n, slots, m, out);
      break;
    case 3: {   // 4 runs of 4 keys a thread, persistent, L2 prefetch
      const int64_t need = ((n / 4 + 3) / 4 + 255) / 256;
      const int64_t res = resident(probe_runs<4, true>, 256, 0);
      probe_runs<4, true><<<static_cast<unsigned int>(need < res ? (need > 0 ? need : 1) : res),
                            256, 0, st>>>(keys, n, slots, m, out);
      break;
    }
    case 4: {   // one run of 4 keys a thread, one pass
      const int64_t need = (n / 4 + 255) / 256;
      probe_runs<1, false><<<static_cast<unsigned int>(need > 0 ? need : 1), 256, 0, st>>>(
          keys, n, slots, m, out);
      break;
    }
    case 5: {   // the first 56,000 slots in shared memory
      const int32_t per = static_cast<int32_t>(m < 56000 ? (m / 4) * 4 : 56000);
      cudaFuncSetAttribute(probe_smem, cudaFuncAttributeMaxDynamicSharedMemorySize, per * 4);
      const int64_t need = ((n / 4 + 1) / 2 + 1023) / 1024;
      const int64_t res = resident(probe_smem, 1024, per * 4);
      probe_smem<<<static_cast<unsigned int>(need < res ? (need > 0 ? need : 1) : res), 1024,
                   per * 4, st>>>(keys, n, slots, m, per, out);
      break;
    }
    case 6: {   // the table split over a 2-block cluster's shared memory
      const int32_t per = static_cast<int32_t>((m + 1) / 2 + 3) / 4 * 4;
      if (per * 4 > 227 * 1024) return -1;
      cudaFuncSetAttribute(probe_cluster, cudaFuncAttributeMaxDynamicSharedMemorySize, per * 4);
      cudaLaunchAttribute attr[1];
      attr[0].id = cudaLaunchAttributeClusterDimension;
      attr[0].val.clusterDim.x = 2;
      attr[0].val.clusterDim.y = 1;
      attr[0].val.clusterDim.z = 1;
      cudaLaunchConfig_t cfg = {};
      cfg.gridDim = dim3(static_cast<unsigned int>(sms() / 2 * 2));
      cfg.blockDim = dim3(1024);
      cfg.dynamicSmemBytes = static_cast<size_t>(per) * 4;
      cfg.stream = st;
      cfg.attrs = attr;
      cfg.numAttrs = 1;
      return static_cast<int>(cudaLaunchKernelEx(&cfg, probe_cluster, keys,
                                                 static_cast<int64_t>(n), slots,
                                                 static_cast<int32_t>(m), per, out));
    }
    default:
      return -1;
  }
  return static_cast<int>(cudaGetLastError());
}

// variant v of the one-segment sum (ids == 0 counted); ticket a zeroed uint32
extern "C" int variant_sum(int v, const void* vals_, const void* segs_,
                           long long n, void* partial_, void* ticket_,
                           void* out_, void* stream) {
  const float* vals = static_cast<const float*>(vals_);
  const int32_t* segs = static_cast<const int32_t*>(segs_);
  float* partial = static_cast<float*>(partial_);
  unsigned int* ticket = static_cast<unsigned int*>(ticket_);
  float* out = static_cast<float*>(out_);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (v) {
    case 0: launch_sum<256, 4, true, true>(vals, segs, n, partial, ticket, out, st); break;
    case 1: launch_sum<256, 4, false, true>(vals, segs, n, partial, ticket, out, st); break;
    case 2: launch_sum<256, 8, true, true>(vals, segs, n, partial, ticket, out, st); break;
    case 3: launch_sum<256, 8, true, false>(vals, segs, n, partial, ticket, out, st); break;
    default: return -1;
  }
  return static_cast<int>(cudaGetLastError());
}

// the build as the first port launched it: a fill, then a scatter
extern "C" int variant_build_two_launches(const void* keys, long long n,
                                          void* slots, long long m, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  fill_slots<<<static_cast<unsigned int>((m + 255) / 256), 256, 0, st>>>(
      static_cast<int32_t*>(slots), m);
  scatter_rows<<<static_cast<unsigned int>((n + 255) / 256), 256, 0, st>>>(
      static_cast<const int32_t*>(keys), n, static_cast<int32_t*>(slots), m);
  return static_cast<int>(cudaGetLastError());
}
