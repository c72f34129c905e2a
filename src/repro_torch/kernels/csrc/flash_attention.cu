// Blocked online-softmax attention (flash attention, forward), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py:
// flash_attention (its _kernel). q (B,H,Tq,hd), k/v (B,KV,Tk,hd), GQA with
// H % KV == 0, causal / sliding-window / chunk-local masks, the query block
// at the tail of the keys (q_offset = Tk - Tq). Running max, sum and
// accumulator are fp32; masked scores are -1e30 with p = 0, and the output
// is acc / max(l, 1e-30), so a row with every key masked gives 0.
//
// What bounds it on this card: operations. The serving path keeps its KV
// cache in fp32 and TF32 would round it, so the products run in fp32 on the
// CUDA cores (67 TFLOP/s), not on the tensor cores. At prefill (Tq = Tk =
// 4,500, window 4,096) a call does about 4e11 flops; at decode (Tq = 1) it
// streams the fp32 cache and is bound by bytes instead.
//
// What the design does about it:
//   * One block per (batch, KV head, query tile). A tile holds up to 64
//     query rows: the heads of one GQA group times consecutive positions
//     (4 heads x 16 positions at prefill, the 4 heads at decode), so every
//     K/V tile is read once for all the heads that share it.
//   * A loop inside the block over 32-key tiles replaces the TPU grid's
//     sequential last dimension. Key tiles wholly outside the causal,
//     window or chunk range of the block's queries are never visited.
//     Each thread issues its K/V loads for a tile in batches of 8 before
//     storing any, so a tile waits for device memory a few times, not once
//     per element (decode streams the cache and is bound by that wait).
//   * Each warp owns 16 query rows with their fp32 state in registers. A
//     lane scores one key of the tile against four rows at a time from
//     shared memory (float4 loads, a padded K row stride so the lanes hit
//     distinct banks), then accumulates p.V with each lane owning 32-dim
//     slices of the head, so stores are coalesced. Head dims up to 96
//     (three slices; the served configurations use 80) are built.
//   * Few blocks (decode: B x KV) would leave most SMs idle, so the wrapper
//     splits the key range over a grid dimension; each split writes fp32
//     partials (acc, m, l) and a second kernel folds them in split order.
//   * Strides are arguments: q may be the (B,T,H,hd) projection and k/v the
//     (B,S,KV,hd) cache, viewed as (B,H,T,hd) without a copy. Ragged Tq and
//     Tk are masked in the kernel; no block-multiple padding is needed.
//
// Every entry point launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError() so the Python wrapper can raise on a refused
// launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 64;                    // query rows per block
constexpr int kRowsPerWarp = kRows / kWarps;  // 16
constexpr int kGroup = 4;                    // rows scored together
constexpr int kKeys = 32;                    // keys per tile, one per lane
constexpr int kLoads = 8;                    // K/V loads in flight per thread
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__host__ __device__ __forceinline__ int floor_div(int a, int b) {
  int q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  float* part_acc;  // (splits, B*H*Tq, hd) when splits > 1
  float* part_ml;   // (splits, B*H*Tq, 2)
  int B, H, KV, Tq, Tk, hd;
  long long sq[4], sk[4], sv[4], so[4];  // element strides (b, head, t, d)
  int causal, window, chunk;             // window / chunk: 0 = none
  float scale;
  int group;      // heads of a GQA group in one block
  int n_hgroups;  // blocks across one GQA group's heads
  int bt;         // query positions per block
  int splits;
};

// Query rows of a block: row i is head (group index i / bt) at position
// t0 + i % bt. Returns false for a row past the tile's end.
struct Row {
  int head, t;
  bool valid;
};

__device__ __forceinline__ Row row_of(const Args& a, int i, int kvh, int hg,
                                      int t0) {
  const int rep = a.H / a.KV;
  const int g = i / a.bt;
  const int hh = hg * a.group + g;
  Row r;
  r.head = kvh * rep + hh;
  r.t = t0 + i % a.bt;
  r.valid = g < a.group && hh < rep && r.t < a.Tq;
  return r;
}

__device__ __forceinline__ bool allowed(const Args& a, int qpos, int kpos) {
  bool ok = true;
  if (a.causal) ok = ok && kpos <= qpos;
  if (a.window > 0) ok = ok && kpos > qpos - a.window;
  if (a.chunk > 0) ok = ok && floor_div(kpos, a.chunk) == floor_div(qpos, a.chunk);
  return ok;
}

template <typename QT, typename KT, int HC>
__global__ void __launch_bounds__(kThreads)
flash_fwd(const Args a) {
  extern __shared__ __align__(16) float smem[];
  const int hdp = (a.hd + 3) & ~3;   // head dim padded to float4
  const int kstride = hdp + 4;       // padded K row: distinct banks per lane
  constexpr int vstride = HC * 32;
  float* q_s = smem;                        // [kRows][hdp], pre-scaled
  float* k_s = q_s + kRows * hdp;           // [kKeys][kstride]
  float* v_s = k_s + kKeys * kstride;       // [kKeys][vstride]
  float* p_s = v_s + kKeys * vstride;       // [kWarps][kKeys][kGroup]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int y = blockIdx.y;
  const int hg = y % a.n_hgroups;
  y /= a.n_hgroups;
  const int kvh = y % a.KV;
  const int b = y / a.KV;
  const int t0 = blockIdx.x * a.bt;
  const int t1 = min(t0 + a.bt, a.Tq);
  const int q_off = a.Tk - a.Tq;

  const QT* q = static_cast<const QT*>(a.q);
  const KT* k = static_cast<const KT*>(a.k);
  const KT* v = static_cast<const KT*>(a.v);

  // the block's query tile, scaled as the TPU kernel does (q * scale)
  for (int e = tid; e < kRows * hdp; e += kThreads) {
    const int i = e / hdp, d = e % hdp;
    const Row r = row_of(a, i, kvh, hg, t0);
    float x = 0.f;
    if (r.valid && d < a.hd) {
      x = to_f32(q[b * a.sq[0] + r.head * a.sq[1] + r.t * a.sq[2] + d * a.sq[3]]) *
          a.scale;
    }
    q_s[e] = x;
  }

  // keys any query of the tile may see
  const int qlo = q_off + t0, qhi = q_off + t1 - 1;
  int kmin = 0, kmax = a.Tk - 1;
  if (a.causal) kmax = min(kmax, qhi);
  if (a.window > 0) kmin = max(kmin, qlo - a.window + 1);
  if (a.chunk > 0) {
    kmin = max(kmin, floor_div(qlo, a.chunk) * a.chunk);
    kmax = min(kmax, floor_div(qhi, a.chunk) * a.chunk + a.chunk - 1);
  }
  int tile_lo = 0, tile_hi = 0;  // [lo, hi) of this split
  if (kmax >= kmin && t1 > t0) {
    const int first = kmin / kKeys, last = kmax / kKeys;
    const int per = (last - first + 1 + a.splits - 1) / a.splits;
    tile_lo = first + blockIdx.z * per;
    tile_hi = min(last + 1, tile_lo + per);
  }

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][HC];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    m[rr] = kNegInf;
    l[rr] = 0.f;
#pragma unroll
    for (int c = 0; c < HC; ++c) acc[rr][c] = 0.f;
  }

  for (int tile = tile_lo; tile < tile_hi; ++tile) {
    const int kbase = tile * kKeys;
    __syncthreads();  // q_s written / the previous tile consumed
    // kLoads elements of K and V per thread and batch, all loads issued
    // before any store, so a batch waits for device memory once
    for (int e0 = tid; e0 < kKeys * vstride; e0 += kLoads * kThreads) {
      float kx[kLoads], vx[kLoads];
#pragma unroll
      for (int i = 0; i < kLoads; ++i) {
        const int e = e0 + i * kThreads;
        const int j = e / vstride, d = e % vstride;
        const int kp = kbase + j;
        kx[i] = vx[i] = 0.f;
        if (kp < a.Tk && d < a.hd) {
          kx[i] = to_f32(k[b * a.sk[0] + kvh * a.sk[1] + kp * a.sk[2] + d * a.sk[3]]);
          vx[i] = to_f32(v[b * a.sv[0] + kvh * a.sv[1] + kp * a.sv[2] + d * a.sv[3]]);
        }
      }
#pragma unroll
      for (int i = 0; i < kLoads; ++i) {
        const int e = e0 + i * kThreads;
        const int j = e / vstride, d = e % vstride;
        if (d < hdp) k_s[j * kstride + d] = kx[i];
        v_s[e] = vx[i];
      }
    }
    __syncthreads();

    const int kp = kbase + lane;
    const bool in_range = kp >= kmin && kp <= kmax;
    const float* krow = k_s + lane * kstride;
    float* pw = p_s + warp * kKeys * kGroup;
#pragma unroll
    for (int g0 = 0; g0 < kRowsPerWarp; g0 += kGroup) {
      Row rows[kGroup];
      bool any = false;
#pragma unroll
      for (int r = 0; r < kGroup; ++r) {
        rows[r] = row_of(a, warp * kRowsPerWarp + g0 + r, kvh, hg, t0);
        any = any || rows[r].valid;
      }
      if (!any) continue;  // the same for the whole warp

      float s[kGroup];
#pragma unroll
      for (int r = 0; r < kGroup; ++r) s[r] = 0.f;
      const float* qg = q_s + (warp * kRowsPerWarp + g0) * hdp;
      for (int d = 0; d < hdp; d += 4) {
        const float4 kk = *reinterpret_cast<const float4*>(krow + d);
#pragma unroll
        for (int r = 0; r < kGroup; ++r) {
          const float4 qq = *reinterpret_cast<const float4*>(qg + r * hdp + d);
          s[r] = fmaf(qq.x, kk.x, s[r]);
          s[r] = fmaf(qq.y, kk.y, s[r]);
          s[r] = fmaf(qq.z, kk.z, s[r]);
          s[r] = fmaf(qq.w, kk.w, s[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < kGroup; ++r) {
        const int rr = g0 + r;
        const bool ok = rows[r].valid && in_range &&
                        allowed(a, q_off + rows[r].t, kp);
        const float sc = ok ? s[r] : kNegInf;
        const float m_new = fmaxf(m[rr], warp_max(sc));
        const float p = ok ? expf(sc - m_new) : 0.f;
        const float alpha = expf(m[rr] - m_new);
        l[rr] = l[rr] * alpha + warp_sum(p);
        m[rr] = m_new;
#pragma unroll
        for (int c = 0; c < HC; ++c) acc[rr][c] *= alpha;
        pw[lane * kGroup + r] = p;
      }
      __syncwarp();
#pragma unroll 4
      for (int j = 0; j < kKeys; ++j) {
        const float4 pp = *reinterpret_cast<const float4*>(pw + j * kGroup);
#pragma unroll
        for (int c = 0; c < HC; ++c) {
          const float vv = v_s[j * vstride + c * 32 + lane];
          acc[g0 + 0][c] = fmaf(pp.x, vv, acc[g0 + 0][c]);
          acc[g0 + 1][c] = fmaf(pp.y, vv, acc[g0 + 1][c]);
          acc[g0 + 2][c] = fmaf(pp.z, vv, acc[g0 + 2][c]);
          acc[g0 + 3][c] = fmaf(pp.w, vv, acc[g0 + 3][c]);
        }
      }
      __syncwarp();
    }
  }

  const long long n_rows = static_cast<long long>(a.B) * a.H * a.Tq;
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const Row r = row_of(a, warp * kRowsPerWarp + rr, kvh, hg, t0);
    if (!r.valid) continue;
    if (a.splits == 1) {
      QT* out = static_cast<QT*>(a.out);
      const float denom = fmaxf(l[rr], 1e-30f);
#pragma unroll
      for (int c = 0; c < HC; ++c) {
        const int d = c * 32 + lane;
        if (d < a.hd) {
          out[b * a.so[0] + r.head * a.so[1] + r.t * a.so[2] + d * a.so[3]] =
              from_f32<QT>(acc[rr][c] / denom);
        }
      }
    } else {
      const long long row =
          (static_cast<long long>(b) * a.H + r.head) * a.Tq + r.t;
      const long long at = static_cast<long long>(blockIdx.z) * n_rows + row;
#pragma unroll
      for (int c = 0; c < HC; ++c) {
        const int d = c * 32 + lane;
        if (d < a.hd) a.part_acc[at * a.hd + d] = acc[rr][c];
      }
      if (lane == 0) {
        a.part_ml[at * 2] = m[rr];
        a.part_ml[at * 2 + 1] = l[rr];
      }
    }
  }
}

// Folds the splits' partials of one query row, in split order.
template <typename QT>
__global__ void flash_combine(const Args a) {
  const long long row = blockIdx.x;
  const int d = threadIdx.x;
  const long long n_rows = static_cast<long long>(a.B) * a.H * a.Tq;
  float mx = kNegInf;
  for (int s = 0; s < a.splits; ++s) mx = fmaxf(mx, a.part_ml[(s * n_rows + row) * 2]);
  float lsum = 0.f, acc = 0.f;
  for (int s = 0; s < a.splits; ++s) {
    const long long at = s * n_rows + row;
    const float w = expf(a.part_ml[at * 2] - mx);
    lsum += a.part_ml[at * 2 + 1] * w;
    if (d < a.hd) acc += a.part_acc[at * a.hd + d] * w;
  }
  if (d < a.hd) {
    const int t = static_cast<int>(row % a.Tq);
    const int head = static_cast<int>((row / a.Tq) % a.H);
    const int b = static_cast<int>(row / (static_cast<long long>(a.Tq) * a.H));
    QT* out = static_cast<QT*>(a.out);
    out[b * a.so[0] + head * a.so[1] + t * a.so[2] + d * a.so[3]] =
        from_f32<QT>(acc / fmaxf(lsum, 1e-30f));
  }
}

size_t smem_bytes(int hd, int hc) {
  const int hdp = (hd + 3) & ~3;
  return sizeof(float) * (static_cast<size_t>(kRows) * hdp +
                          static_cast<size_t>(kKeys) * (hdp + 4) +
                          static_cast<size_t>(kKeys) * hc * 32 +
                          static_cast<size_t>(kWarps) * kKeys * kGroup);
}

template <typename QT, typename KT, int HC>
cudaError_t launch(const Args& a, cudaStream_t s) {
  const size_t smem = smem_bytes(a.hd, HC);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<QT, KT, HC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid((a.Tq + a.bt - 1) / a.bt, a.B * a.KV * a.n_hgroups, a.splits);
  flash_fwd<QT, KT, HC><<<grid, kThreads, smem, s>>>(a);
  if (a.splits > 1) {
    const long long n_rows = static_cast<long long>(a.B) * a.H * a.Tq;
    flash_combine<QT><<<static_cast<unsigned int>(n_rows), HC * 32, 0, s>>>(a);
  }
  return cudaGetLastError();
}

template <typename QT, typename KT>
cudaError_t launch_hd(const Args& a, cudaStream_t s) {
  switch ((a.hd + 31) / 32) {
    case 1: return launch<QT, KT, 1>(a, s);
    case 2: return launch<QT, KT, 2>(a, s);
    case 3: return launch<QT, KT, 3>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. q and out share q_dtype; k and v
// share kv_dtype. The (q, k/v) pairs built are fp32/fp32, bf16/fp32 (the
// serving path: bf16 activations over the fp32 cache) and bf16/bf16.
// Strides are in elements, ordered (batch, head, t, dim).
extern "C" int cobra_flash_attention(
    const void* q, const void* k, const void* v, void* out, void* part_acc,
    void* part_ml, int B, int H, int KV, int Tq, int Tk, int hd,
    const long long* sq, const long long* sk, const long long* sv,
    const long long* so, int causal, int window, int chunk, float scale,
    int group, int n_hgroups, int bt, int splits, int q_dtype, int kv_dtype,
    void* stream) {
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.out = out;
  a.part_acc = static_cast<float*>(part_acc);
  a.part_ml = static_cast<float*>(part_ml);
  a.B = B;
  a.H = H;
  a.KV = KV;
  a.Tq = Tq;
  a.Tk = Tk;
  a.hd = hd;
  for (int i = 0; i < 4; ++i) {
    a.sq[i] = sq[i];
    a.sk[i] = sk[i];
    a.sv[i] = sv[i];
    a.so[i] = so[i];
  }
  a.causal = causal;
  a.window = window;
  a.chunk = chunk;
  a.scale = scale;
  a.group = group;
  a.n_hgroups = n_hgroups;
  a.bt = bt;
  a.splits = splits;
  if (B == 0 || H == 0 || Tq == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (q_dtype == 0 && kv_dtype == 0) {
    err = launch_hd<float, float>(a, s);
  } else if (q_dtype == 1 && kv_dtype == 0) {
    err = launch_hd<__nv_bfloat16, float>(a, s);
  } else if (q_dtype == 1 && kv_dtype == 1) {
    err = launch_hd<__nv_bfloat16, __nv_bfloat16>(a, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
