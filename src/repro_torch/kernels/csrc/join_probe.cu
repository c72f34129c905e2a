// Direct-address equi-join probe and its slot-table builder, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/join_probe.py:join_probe
// (its _kernel) and the jnp scatter src/repro/kernels/join_probe.py:
// build_direct_table. The build side is a direct-address slot table: slot j
// holds the row index of the build row whose key is j, or -1.
//
// What bounds the probe on this card. By bytes, it reads each int32 key once
// and writes one int32 result: at N = 2.88M probes over M = 100,000 slots
// about 23 MB, 7 us at 3.35 TB/s. What bounds it in fact is the gathers:
// each key reads one 4-byte slot at a random place in the 400 KB table, and
// every gather that misses the SM's L1 (256 KB, less than the table) is a
// 32-byte request to L2. On the H100 the rate of those requests, not the
// bytes or the latency, sets the time: one key per thread, 16-byte runs of
// keys per thread with every gather in flight before any store, persistent
// blocks, an L2 prefetch of the table, a larger L1 carveout, L1 hints on the
// gathers, the first 56,000 slots held in shared memory, and the table
// split across a 2-block cluster's shared memory all measured level or
// slower (`tools/relational_variants.py`, PERF.md), the cluster far slower.
//
// So the probe (probe_slots) keeps the simplest of the fastest: one thread
// per key, consecutive threads on consecutive keys (coalesced 128-byte
// loads and stores), the key read and the result written with the
// streaming hints (__ldcs / __stcs: nothing rereads them, and they need not
// displace the table in L2), the slot gathered through the read-only path
// (__ldg). A key outside [0, M) never touches the table: the bounds check
// gives -1.
//
// The build (build_slots) is one cooperative launch over a grid the card
// holds at once: its blocks fill the slots with -1, meet at a grid barrier,
// then scatter the row ids with an unsigned atomicMin, under which -1
// (0xFFFFFFFF) is the largest value: with duplicate build keys the smallest
// row id wins, which is the first stable match that the numpy twin
// returns, and the table does not depend on the order in which threads
// run. Each thread loads its first key before the fill, so the load's
// latency hides behind the fill and the barrier. The barrier is one word of
// the stream's counters that the wrapper keeps: its low half counts
// arrivals, and the last block to arrive resets it and advances the high
// half, a generation the others wait on. Its bytes (0.8 MB) take well under
// a launch's latency, so its time is the launch's and the barrier's.
//
// Every entry point launches on the caller's stream, allocates nothing, and
// returns the launch's CUDA error so the Python wrapper can raise on a
// refused launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBuildThreads = 1024;   // one element a thread, the grid small:
                                      // few barrier arrivals
constexpr int kMaxDevices = 64;

__global__ void __launch_bounds__(kThreads)
probe_slots(const int32_t* __restrict__ keys, int64_t n,
            const int32_t* __restrict__ slots, int64_t m,
            int32_t* __restrict__ out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  const int32_t k = __ldcs(keys + i);
  __stcs(out + i, (k >= 0 && static_cast<int64_t>(k) < m) ? __ldg(slots + k) : -1);
}

__global__ void __launch_bounds__(kBuildThreads)
build_slots(const int32_t* __restrict__ keys, int64_t n,
            int32_t* __restrict__ slots, int64_t m,
            unsigned int* __restrict__ barrier) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kBuildThreads;
  const int64_t i0 = static_cast<int64_t>(blockIdx.x) * kBuildThreads + threadIdx.x;
  const int32_t first = i0 < n ? keys[i0] : -1;   // in flight across the fill
  for (int64_t i = i0; i < m; i += stride) slots[i] = -1;

  // grid barrier, so every fill is in L2 before any scatter: the low 16
  // bits of the word count arrivals, the high 16 a generation; the last
  // block to arrive puts the count back to 0 and advances the generation in
  // one add, which the others wait for
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned int* word = barrier;
    __threadfence();
    const unsigned int arrived = atomicAdd(barrier, 1u);
    if ((arrived & 0xFFFFu) == gridDim.x - 1) {
      atomicAdd(barrier, 0x10000u - gridDim.x);
    } else {
      while ((*word >> 16) == (arrived >> 16)) __nanosleep(32);
    }
    __threadfence();
  }
  __syncthreads();

  for (int64_t i = i0; i < n; i += stride) {
    const int32_t k = i == i0 ? first : keys[i];
    if (k >= 0 && static_cast<int64_t>(k) < m) {
      atomicMin(reinterpret_cast<unsigned int*>(slots + k),
                static_cast<unsigned int>(i));
    }
  }
}

// blocks of build_slots the card holds at once (SMs x blocks per SM), by
// device: the cooperative launch's largest grid
int resident_build_blocks() {
  static int cache[kMaxDevices];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= kMaxDevices) return 0;
  if (cache[dev] == 0) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, build_slots,
                                                  kBuildThreads, 0);
    cache[dev] = sms * per_sm;
  }
  return cache[dev];
}

}  // namespace

// keys (n,) int32, slots (m,) int32 (written), barrier a uint32 whose low
// 16 bits are 0 (the launch leaves them so).
extern "C" int cobra_build_direct_table(const void* keys, long long n,
                                        void* slots, long long m,
                                        void* barrier, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m <= 0) return static_cast<int>(cudaGetLastError());
  const int resident = resident_build_blocks();
  if (resident <= 0 || resident >= 0x10000) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const long long items = n > m ? n : m;
  const long long need = (items + kBuildThreads - 1) / kBuildThreads;
  const int grid = static_cast<int>(need < resident ? need : resident);
  const int32_t* k = static_cast<const int32_t*>(keys);
  int32_t* sl = static_cast<int32_t*>(slots);
  int64_t n64 = n, m64 = m;
  unsigned int* b = static_cast<unsigned int*>(barrier);
  void* args[] = {&k, &n64, &sl, &m64, &b};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(build_slots), dim3(grid),
      dim3(kBuildThreads), args, 0, s));
}

// keys (n,) int32, slots (m,) int32, out (n,) int32.
extern "C" int cobra_join_probe(const void* keys, long long n,
                                const void* slots, long long m, void* out,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n > 0) {
    probe_slots<<<static_cast<unsigned int>((n + kThreads - 1) / kThreads),
                  kThreads, 0, s>>>(static_cast<const int32_t*>(keys), n,
                                    static_cast<const int32_t*>(slots), m,
                                    static_cast<int32_t*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
