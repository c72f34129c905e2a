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
// What bounds it on this card: the recurrence is sequential in t. At the
// serving shapes it moves few bytes (prefill: about 460 MB for B = 4,
// H = 40, T = 4,500) and does few operations (about 5 x K x V per token and
// head), so a kernel that walks the whole sequence in one chain per
// (batch, head) is set by the length of that chain and by how few warps
// it gives the card (320 warps of 4,500 dependent steps on 132 SMs), not
// by the card's memory or arithmetic rates.
//
// What the design does about it: the TPU kernel's chunks, recast so that
// every chunk runs at once. The sequence is cut into chunks of kChunkLen
// tokens (nC of them, the last one ragged) and the scan runs in three
// kernels, all fp32 on the CUDA cores, every decay exponent <= 0:
//   A. rwkv6_chunk_state, one block per (batch, head, chunk): the chunk's
//      state from zero, L_c = sum_s (k_s * exp(E_s)) (x) v_s with E_s the
//      sum of w over the chunk's tokens after s (a suffix sum, so the
//      exponents near the chunk's end keep their precision), and its decay
//      D_c = exp(sum of w over the chunk). Each thread holds a 4 x 4 tile
//      of the K x V product in registers. L and D go to scratch that the
//      wrapper allocates, (B, H, nC, K, V) and (B, H, nC, K).
//   B. rwkv6_chunk_carry, one thread per (batch, head, k, v), sequential
//      over the chunks: S_{c+1} = D_c S_c + L_c from the given state. It
//      overwrites L_c with the state entering chunk c and writes the final
//      state. Each thread loads kBatch chunks' L and D before it carries
//      through them, so it waits on device memory once per kBatch chunks,
//      not once per chunk.
//   C. rwkv6_fwd, the token recurrence, one block per (batch, head,
//      chunk): each warp owns 32 value columns, one per lane, and keeps
//      that column of the K x V state in registers from its chunk's
//      entering state; r, k and exp(w) are staged 32 tokens at a time in
//      shared memory (the exponentials computed once per token and channel,
//      shared by the block's warps) and read as float4 broadcasts. The
//      chain per warp drops from T to kChunkLen tokens, and the prefill
//      has about 22,700 warps in place of 320.
// A and C stage whole rows with 16-byte loads where the rows allow it
// (8 bf16 channels a load): staged one element a load, they spend most of
// their time waiting on memory. C keeps the element loads for a short stage
// (decode's one token), where they take one wait for r, k and w together.
// When T <= kChunkLen (decode included) the wrapper launches C alone from
// the given state, and C writes the final state itself.
//
// Strides are arguments, so r/k/v/w may be (B,T,H,K) projections viewed as
// (B,H,T,K) without a copy; y is written through strides as well. The state
// is read before it is written, so it may be updated in place.
//
// Every entry point launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError() so the Python wrapper can raise on a refused
// launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 32;       // V columns per warp, one per lane
constexpr int kStage = 32;       // tokens staged in shared memory at a time (C)
constexpr int kChunkLen = 64;    // tokens per chunk
constexpr int kThreadsA = 256;   // phase A block
constexpr int kThreadsB = 256;   // phase B block
constexpr int kBatch = 8;        // chunks phase B loads ahead

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

// 16 bytes of a row: 4 fp32 or 8 bf16 elements, as floats
template <typename T>
struct Vec {
  static constexpr int N = 16 / sizeof(T);
};

__device__ __forceinline__ void load16(const float* p, float (&x)[4]) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  x[0] = f.x;
  x[1] = f.y;
  x[2] = f.z;
  x[3] = f.w;
}

__device__ __forceinline__ void load16(const __nv_bfloat16* p, float (&x)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __uint_as_float(w[i] << 16);
    x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

template <int N>
__device__ __forceinline__ void store16(float* p, const float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; i += 4) {
    *reinterpret_cast<float4*>(p + i) = make_float4(x[i], x[i + 1], x[i + 2], x[i + 3]);
  }
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
  float* L;             // (B, H, nC, K, V) chunk states (nC > 1)
  float* D;             // (B, H, nC, K) chunk decays (nC > 1)
  int B, H, T, V, nC;
  int vec;              // unit channel strides, 16-byte aligned rows
  long long sr[4], sk[4], sv[4], sw[4], sy[4];  // element strides (b, h, t, d)
};

// V padded to a float4 multiple
__host__ __device__ __forceinline__ int pad4(int x) { return (x + 3) & ~3; }

// Phase A: one block per (batch * head, chunk).
template <typename T, int K>
__global__ void __launch_bounds__(kThreadsA)
rwkv6_chunk_state(const Args a) {
  extern __shared__ __align__(16) float smem[];
  const int V4 = pad4(a.V);
  float* e_s = smem;                         // [kChunkLen][K]: w, then E
  float* k_s = e_s + kChunkLen * K;          // [kChunkLen][K]: k, then k exp(E)
  float* v_s = k_s + kChunkLen * K;          // [kChunkLen][V4]

  const int tid = threadIdx.x;
  const int bh = blockIdx.x, c = blockIdx.y;
  const int b = bh / a.H, h = bh % a.H;
  const int tb = c * kChunkLen;
  const int n = min(kChunkLen, a.T - tb);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const long long k0 = b * a.sk[0] + h * a.sk[1];
  const long long v0 = b * a.sv[0] + h * a.sv[1];
  const long long w0 = b * a.sw[0] + h * a.sw[1];

  if (a.vec) {  // 16-byte loads: whole rows of w, k and v
    constexpr int NR = Vec<T>::N, UR = K / NR, UW = K / 4;
    for (int e = tid; e < n * UW; e += kThreadsA) {
      const int t = e / UW, i0 = (e % UW) * 4;
      *reinterpret_cast<float4*>(e_s + t * K + i0) =
          *reinterpret_cast<const float4*>(a.w + w0 + (tb + t) * a.sw[2] + i0);
    }
    for (int e = tid; e < n * UR; e += kThreadsA) {
      const int t = e / UR, i0 = (e % UR) * NR;
      float kx[NR];
      load16(k + k0 + (tb + t) * a.sk[2] + i0, kx);
      store16(k_s + t * K + i0, kx);
    }
    const int UV = a.V / NR;
    for (int e = tid; e < n * UV; e += kThreadsA) {
      const int t = e / UV, j0 = (e % UV) * NR;
      float vx[NR];
      load16(v + v0 + (tb + t) * a.sv[2] + j0, vx);
#pragma unroll
      for (int jj = 0; jj < NR; ++jj) v_s[t * V4 + j0 + jj] = vx[jj];
    }
    for (int e = tid; e < n * (V4 - a.V); e += kThreadsA) {
      v_s[(e / (V4 - a.V)) * V4 + a.V + e % (V4 - a.V)] = 0.f;
    }
  } else {
    for (int e = tid; e < n * K; e += kThreadsA) {
      const int t = e / K, i = e % K;
      const long long tt = tb + t;
      e_s[e] = a.w[w0 + tt * a.sw[2] + i * a.sw[3]];
      k_s[e] = to_f32(k[k0 + tt * a.sk[2] + i * a.sk[3]]);
    }
    for (int e = tid; e < n * V4; e += kThreadsA) {
      const int t = e / V4, jv = e % V4;
      v_s[e] = jv < a.V ? to_f32(v[v0 + (tb + t) * a.sv[2] + jv * a.sv[3]]) : 0.f;
    }
  }
  __syncthreads();
  if (tid < K) {  // E_t = sum of w over the chunk's tokens after t
    float acc = 0.f;
    for (int t = n - 1; t >= 0; --t) {
      const float w = e_s[t * K + tid];
      e_s[t * K + tid] = acc;
      acc += w;
    }
    a.D[(static_cast<long long>(bh) * a.nC + c) * K + tid] = expf(acc);
  }
  __syncthreads();
  for (int e = tid; e < n * K; e += kThreadsA) k_s[e] *= expf(e_s[e]);
  __syncthreads();

  // L_c[k][v] = sum_t k_s[t][k] v_s[t][v], a 4 x 4 tile per thread
  const int vu = V4 / 4;
  float* L = a.L + (static_cast<long long>(bh) * a.nC + c) * K * a.V;
  for (int unit = tid; unit < (K / 4) * vu; unit += kThreadsA) {
    const int ki = (unit / vu) * 4, vj = (unit % vu) * 4;
    float acc[4][4] = {};
    for (int t = 0; t < n; ++t) {
      const float4 kk = *reinterpret_cast<const float4*>(k_s + t * K + ki);
      const float4 vv = *reinterpret_cast<const float4*>(v_s + t * V4 + vj);
      const float kr[4] = {kk.x, kk.y, kk.z, kk.w};
      const float vr[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
      for (int x = 0; x < 4; ++x) {
#pragma unroll
        for (int z = 0; z < 4; ++z) acc[x][z] = fmaf(kr[x], vr[z], acc[x][z]);
      }
    }
#pragma unroll
    for (int x = 0; x < 4; ++x) {
#pragma unroll
      for (int z = 0; z < 4; ++z) {
        if (vj + z < a.V) L[(ki + x) * a.V + vj + z] = acc[x][z];
      }
    }
  }
}

// Phase B: one thread per (batch * head, k, v) state element. The chunks'
// L and D are loaded kBatch chunks ahead of the carry that consumes them.
template <int K>
__global__ void __launch_bounds__(kThreadsB)
rwkv6_chunk_carry(const Args a) {
  const long long kv = static_cast<long long>(K) * a.V;
  const long long idx = static_cast<long long>(blockIdx.x) * kThreadsB + threadIdx.x;
  if (idx >= static_cast<long long>(a.B) * a.H * kv) return;
  const long long bh = idx / kv, e = idx % kv;
  const int i = static_cast<int>(e / a.V);
  float* __restrict__ Lb = a.L + bh * a.nC * kv + e;
  const float* __restrict__ Db = a.D + bh * a.nC * K + i;
  float S = a.s_in != nullptr ? a.s_in[idx] : 0.f;
  for (int c0 = 0; c0 < a.nC; c0 += kBatch) {
    float l[kBatch], d[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      if (c0 + j < a.nC) {
        l[j] = Lb[(c0 + j) * kv];
        d[j] = Db[(c0 + j) * K];
      }
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      if (c0 + j < a.nC) {
        Lb[(c0 + j) * kv] = S;  // the state entering chunk c0 + j
        S = fmaf(d[j], S, l[j]);
      }
    }
  }
  a.s_out[idx] = S;
}

// Phase C: one block per (batch * head, chunk); warp w owns value columns
// [32 w, 32 w + 32), one per lane.
template <typename T, int K>
__global__ void __launch_bounds__(256)
rwkv6_fwd(const Args a) {
  __shared__ __align__(16) float r_s[kStage][K];
  __shared__ __align__(16) float k_s[kStage][K];
  __shared__ __align__(16) float d_s[kStage][K];  // exp(w)
  __shared__ float rk_s[kStage][K + 1];           // r u k; padded rows
  __shared__ float bonus_s[kStage];
  extern __shared__ float v_dyn[];                // [warps][kStage][kLanes]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthreads = blockDim.x;
  const int bh = blockIdx.x, c = blockIdx.y;
  const int b = bh / a.H, h = bh % a.H;
  const int col = warp * kLanes + lane;
  const bool has_col = col < a.V;
  const int tb = c * kChunkLen;
  const int te = a.nC > 1 ? min(a.T, tb + kChunkLen) : a.T;
  float* v_s = v_dyn + warp * kStage * kLanes;

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
  // the state entering this chunk: phase B's, or the given one
  const float* s_src = a.nC > 1 ? a.L + (static_cast<long long>(bh) * a.nC + c) * K * a.V
                                : (a.s_in != nullptr ? a.s_in + s0 : nullptr);

  float S[K];
#pragma unroll
  for (int i = 0; i < K; ++i) {
    S[i] = (s_src != nullptr && has_col) ? s_src[i * a.V + col] : 0.f;
  }

  for (int c0 = tb; c0 < te; c0 += kStage) {
    const int n = min(kStage, te - c0);
    __syncthreads();  // the previous stage consumed
    if (a.vec && n == kStage) {  // a full stage: 16-byte loads of whole rows
      constexpr int NR = Vec<T>::N, UR = K / NR, UW = K / 4;
      for (int e = tid; e < n * UR; e += nthreads) {
        const int t = e / UR, i0 = (e % UR) * NR;
        const long long tt = c0 + t;
        float rx[NR], kx[NR];
        load16(r + r0 + tt * a.sr[2] + i0, rx);
        load16(k + k0 + tt * a.sk[2] + i0, kx);
        store16(&r_s[t][i0], rx);
        store16(&k_s[t][i0], kx);
#pragma unroll
        for (int j = 0; j < NR; ++j) rk_s[t][i0 + j] = rx[j] * a.u[h * K + i0 + j] * kx[j];
      }
      for (int e = tid; e < n * UW; e += nthreads) {
        const int t = e / UW, i0 = (e % UW) * 4;
        const float4 wx = *reinterpret_cast<const float4*>(a.w + w0 + (c0 + t) * a.sw[2] + i0);
        *reinterpret_cast<float4*>(&d_s[t][i0]) =
            make_float4(expf(wx.x), expf(wx.y), expf(wx.z), expf(wx.w));
      }
      const int UV = a.V / NR;
      for (int e = tid; e < n * UV; e += nthreads) {
        const int t = e / UV, j0 = (e % UV) * NR;
        float vx[NR];
        load16(v + v0 + (c0 + t) * a.sv[2] + j0, vx);
#pragma unroll
        for (int j = 0; j < NR; ++j) {
          const int cj = j0 + j;
          v_dyn[((cj / kLanes) * kStage + t) * kLanes + cj % kLanes] = vx[j];
        }
      }
    } else {
      for (int e = tid; e < n * K; e += nthreads) {
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
        v_s[t * kLanes + lane] =
            has_col ? to_f32(v[v0 + (c0 + t) * a.sv[2] + col * a.sv[3]]) : 0.f;
      }
    }
    __syncthreads();
    if (tid < n) {  // thread t sums token t's bonus
      float part = 0.f;
      for (int i = 0; i < K; ++i) part += rk_s[tid][i];
      bonus_s[tid] = part;
    }
    __syncthreads();
    for (int t = 0; t < n; ++t) {
      const float vt = v_s[t * kLanes + lane];
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
  if (a.nC == 1 && has_col) {  // else phase B wrote the final state
#pragma unroll
    for (int i = 0; i < K; ++i) a.s_out[s0 + i * a.V + col] = S[i];
  }
}

template <typename T, int K>
cudaError_t launch_k(const Args& a, cudaStream_t s) {
  const int bh = a.B * a.H;
  if (a.nC > 1) {
    const size_t smem_a = sizeof(float) * kChunkLen * (2 * K + pad4(a.V));
    cudaError_t err = cudaFuncSetAttribute(rwkv6_chunk_state<T, K>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem_a));
    if (err != cudaSuccess) return err;
    rwkv6_chunk_state<T, K><<<dim3(bh, a.nC), kThreadsA, smem_a, s>>>(a);
    const long long n = static_cast<long long>(bh) * K * a.V;
    rwkv6_chunk_carry<K><<<static_cast<unsigned int>((n + kThreadsB - 1) / kThreadsB),
                           kThreadsB, 0, s>>>(a);
  }
  const int warps = (a.V + kLanes - 1) / kLanes;
  const size_t smem_c = sizeof(float) * warps * kStage * kLanes;
  const size_t smem_static = sizeof(float) * kStage * (4 * K + 2);
  if (smem_static + smem_c > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(rwkv6_fwd<T, K>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem_c));
    if (err != cudaSuccess) return err;
  }
  rwkv6_fwd<T, K><<<dim3(bh, a.nC), warps * kLanes, smem_c, s>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const Args& a, int K, cudaStream_t s) {
  switch (K) {
    case 16: return launch_k<T, 16>(a, s);
    case 32: return launch_k<T, 32>(a, s);
    case 64: return launch_k<T, 64>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype code of r, k, v and y: 0 = float32, 1 = bfloat16. K is 16, 32 or 64,
// V at most 256. Strides are in elements, ordered (batch, head, t, channel).
// vec: r/k/v/w have unit channel strides, 16-byte aligned rows and V a
// multiple of 16 bytes' elements, so rows are read 16 bytes at a time.
// L and D are the scratch of phases A and B, (B, H, nC, K, V) and
// (B, H, nC, K) fp32 with nC = ceil(T / 64) (kChunkLen); unused (may be
// null) when nC is 1.
extern "C" int cobra_rwkv6_scan(
    const void* r, const void* k, const void* v, const void* w, const void* u,
    const void* s_in, void* y, void* s_out, void* L, void* D, int B, int H,
    int T, int K, int V, const long long* sr, const long long* sk,
    const long long* sv, const long long* sw, const long long* sy, int dtype,
    int vec, void* stream) {
  Args a;
  a.r = r;
  a.k = k;
  a.v = v;
  a.w = static_cast<const float*>(w);
  a.u = static_cast<const float*>(u);
  a.s_in = static_cast<const float*>(s_in);
  a.y = y;
  a.s_out = static_cast<float*>(s_out);
  a.L = static_cast<float*>(L);
  a.D = static_cast<float*>(D);
  a.B = B;
  a.H = H;
  a.T = T;
  a.V = V;
  a.nC = T > kChunkLen ? (T + kChunkLen - 1) / kChunkLen : 1;
  a.vec = vec;
  for (int i = 0; i < 4; ++i) {
    a.sr[i] = sr[i];
    a.sk[i] = sk[i];
    a.sv[i] = sv[i];
    a.sw[i] = sw[i];
    a.sy[i] = sy[i];
  }
  if (B == 0 || H == 0 || V == 0) return static_cast<int>(cudaGetLastError());
  if (V > 256 || (a.nC > 1 && (L == nullptr || D == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
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
