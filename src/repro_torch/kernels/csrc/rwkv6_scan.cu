// RWKV6 (Finch) WKV scan, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/rwkv6_scan.py:rwkv6_scan
// (its _kernel). Per (batch, head), with K key channels and V value channels:
//     y_t = r_t . S_{t-1} + (sum_k r_t u k_t) v_t
//     S_t = diag(exp w_t) S_{t-1} + k_t (x) v_t          (w_t <= 0)
// It returns y in r's type and the final state in fp32. Unlike the TPU
// kernel it starts from a given state (zeros when none is given), so decode
// can carry the cached state one token at a time, and it takes any T >= 1:
// no chunk multiple.
//
// What bounds it on this card: the recurrence is sequential in t, so each
// (batch, head) is a chain of T dependent state updates; at the serving
// shapes it moves few bytes (prefill: about 460 MB for B = 4, H = 40,
// T = 4,500) and does few operations (about 3 x K x V per token and head),
// so the bound is low and the kernel's time is set by the length of that
// chain, not by the card's memory or arithmetic rates.
//
// What the design does about it:
//   * One warp per (batch, head, 32-wide V tile). Each lane owns one column
//     of the K x V fp32 state and keeps it in registers for the whole
//     sequence: the state never leaves the SM between tokens.
//   * The time loop runs inside the block. Chunks of 32 tokens of r, k and
//     exp(w) are staged in shared memory by coalesced loads (the
//     exponentials computed once per token and channel, not once per lane),
//     and lane t sums token t's bonus sum_k r u k. Every lane then reads
//     them as float4 broadcasts, token after token. (Batching the staging
//     loads 8 per lane made the serving prefill slower, 4.1 -> 7.6 ms, on
//     one H100; see PERF.md.)
//   * Four partial sums per lane break the dependent FMA chain of r . S.
//   * Strides are arguments, so r/k/v/w may be (B,T,H,K) projections viewed
//     as (B,H,T,K) without a copy; y is written through strides as well.
//   * The state is read at the start and written at the end by the lane that
//     owns its column, so the state may be updated in place.
//
// Every entry point launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError() so the Python wrapper can raise on a refused
// launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 32;  // V columns per block, one per lane
constexpr int kChunk = 32;  // tokens staged in shared memory at a time

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

struct Args {
  const void* r;
  const void* k;
  const void* v;
  const float* w;       // log decay, <= 0
  const float* u;       // (H, K) contiguous
  const float* s_in;    // (B, H, K, V) contiguous, or null for zeros
  void* y;
  float* s_out;         // (B, H, K, V) contiguous
  int B, H, T, V;
  long long sr[4], sk[4], sv[4], sw[4], sy[4];  // element strides (b, h, t, d)
};

template <typename T, int K>
__global__ void __launch_bounds__(kLanes)
rwkv6_fwd(const Args a) {
  __shared__ __align__(16) float r_s[kChunk][K];
  __shared__ __align__(16) float k_s[kChunk][K];
  __shared__ __align__(16) float d_s[kChunk][K];  // exp(w)
  __shared__ float rk_s[kChunk][K + 1];           // r u k; padded rows
  __shared__ float v_s[kChunk][kLanes];
  __shared__ float bonus_s[kChunk];

  const int lane = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / a.H, h = bh % a.H;
  const int col = blockIdx.y * kLanes + lane;
  const bool has_col = col < a.V;

  const T* r = static_cast<const T*>(a.r);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  T* y = static_cast<T*>(a.y);
  const long long r0 = b * a.sr[0] + h * a.sr[1];
  const long long k0 = b * a.sk[0] + h * a.sk[1];
  const long long v0 = b * a.sv[0] + h * a.sv[1];
  const long long w0 = b * a.sw[0] + h * a.sw[1];
  const long long y0 = b * a.sy[0] + h * a.sy[1];
  const long long s0 = static_cast<long long>(bh) * K * a.V;

  float S[K];
#pragma unroll
  for (int i = 0; i < K; ++i) {
    S[i] = (a.s_in != nullptr && has_col) ? a.s_in[s0 + i * a.V + col] : 0.f;
  }

  for (int c0 = 0; c0 < a.T; c0 += kChunk) {
    const int n = min(kChunk, a.T - c0);
    __syncwarp();  // the previous chunk consumed
    for (int e = lane; e < n * K; e += kLanes) {
      const int t = e / K, i = e % K;
      const long long tt = c0 + t;
      const float rv = to_f32(r[r0 + tt * a.sr[2] + i * a.sr[3]]);
      const float kv = to_f32(k[k0 + tt * a.sk[2] + i * a.sk[3]]);
      r_s[t][i] = rv;
      k_s[t][i] = kv;
      d_s[t][i] = expf(a.w[w0 + tt * a.sw[2] + i * a.sw[3]]);
      rk_s[t][i] = rv * a.u[h * K + i] * kv;
    }
    for (int t = 0; t < n; ++t) {
      v_s[t][lane] = has_col ? to_f32(v[v0 + (c0 + t) * a.sv[2] + col * a.sv[3]]) : 0.f;
    }
    __syncwarp();
    if (lane < n) {  // lane t sums token t's bonus
      float part = 0.f;
      for (int i = 0; i < K; ++i) part += rk_s[lane][i];
      bonus_s[lane] = part;
    }
    __syncwarp();
    for (int t = 0; t < n; ++t) {
      const float vt = v_s[t][lane];
      float y_0 = 0.f, y_1 = 0.f, y_2 = 0.f, y_3 = 0.f;
#pragma unroll
      for (int i = 0; i < K; i += 4) {
        const float4 rr = *reinterpret_cast<const float4*>(&r_s[t][i]);
        const float4 kk = *reinterpret_cast<const float4*>(&k_s[t][i]);
        const float4 dd = *reinterpret_cast<const float4*>(&d_s[t][i]);
        y_0 = fmaf(rr.x, S[i], y_0);
        y_1 = fmaf(rr.y, S[i + 1], y_1);
        y_2 = fmaf(rr.z, S[i + 2], y_2);
        y_3 = fmaf(rr.w, S[i + 3], y_3);
        S[i] = fmaf(S[i], dd.x, kk.x * vt);
        S[i + 1] = fmaf(S[i + 1], dd.y, kk.y * vt);
        S[i + 2] = fmaf(S[i + 2], dd.z, kk.z * vt);
        S[i + 3] = fmaf(S[i + 3], dd.w, kk.w * vt);
      }
      const float out = (y_0 + y_1) + (y_2 + y_3) + bonus_s[t] * vt;
      if (has_col) y[y0 + (c0 + t) * a.sy[2] + col * a.sy[3]] = from_f32<T>(out);
    }
  }
  if (has_col) {
#pragma unroll
    for (int i = 0; i < K; ++i) a.s_out[s0 + i * a.V + col] = S[i];
  }
}

template <typename T>
cudaError_t launch(const Args& a, int K, cudaStream_t s) {
  dim3 grid(a.B * a.H, (a.V + kLanes - 1) / kLanes);
  switch (K) {
    case 16: rwkv6_fwd<T, 16><<<grid, kLanes, 0, s>>>(a); break;
    case 32: rwkv6_fwd<T, 32><<<grid, kLanes, 0, s>>>(a); break;
    case 64: rwkv6_fwd<T, 64><<<grid, kLanes, 0, s>>>(a); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// dtype code of r, k, v and y: 0 = float32, 1 = bfloat16. K is 16, 32 or 64.
// Strides are in elements, ordered (batch, head, t, channel).
extern "C" int cobra_rwkv6_scan(
    const void* r, const void* k, const void* v, const void* w, const void* u,
    const void* s_in, void* y, void* s_out, int B, int H, int T, int K, int V,
    const long long* sr, const long long* sk, const long long* sv,
    const long long* sw, const long long* sy, int dtype, void* stream) {
  Args a;
  a.r = r;
  a.k = k;
  a.v = v;
  a.w = static_cast<const float*>(w);
  a.u = static_cast<const float*>(u);
  a.s_in = static_cast<const float*>(s_in);
  a.y = y;
  a.s_out = static_cast<float*>(s_out);
  a.B = B;
  a.H = H;
  a.T = T;
  a.V = V;
  for (int i = 0; i < 4; ++i) {
    a.sr[i] = sr[i];
    a.sk[i] = sk[i];
    a.sv[i] = sv[i];
    a.sw[i] = sw[i];
    a.sy[i] = sy[i];
  }
  if (B == 0 || H == 0 || V == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = launch<float>(a, K, s);
  } else if (dtype == 1) {
    err = launch<__nv_bfloat16>(a, K, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
