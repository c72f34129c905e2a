// RWKV6 (Finch) WKV scan, backward, for Hopper (sm_90a).
//
// The gradient of csrc/rwkv6_scan.cu. The reference package has no TPU
// kernel for it: it trains RWKV6 through the jnp decay_linear_attention
// (src/repro/models/layers.py), which XLA differentiates. Per (batch, head),
// for the forward
//     y_t = r_t . S_{t-1} + (sum_k r_t u k_t) v_t
//     S_t = diag(exp w_t) S_{t-1} + k_t (x) v_t          (w_t <= 0)
// and the cotangents dy_t and G_T = ds_out (zeros when none), with
// G_{t-1} = diag(exp w_t) G_t + r_t (x) dy_t (the cotangent of S_{t-1}):
//     dr_t = S_{t-1} dy_t + (u * k_t)(v_t . dy_t)
//     dk_t = G_t v_t + (u * r_t)(v_t . dy_t)
//     dv_t = G_t^T k_t + (sum_k r_t u k_t) dy_t
//     dw_t = exp(w_t) * sum_v (S_{t-1} * G_t)
//     du   = sum_{b,t} (r_t * k_t)(v_t . dy_t)
//     dstate = G_0
// dr, dk and dv are written in r's type, dw, du and dstate in fp32.
//
// What bounds it on this card: like the forward, the length of its
// dependent chains and the parallelism they leave, not the card's rates.
// At rwkv6-3b's training shape (B 1, H 40, T 2,048, K = V = 64) it moves
// about 137 MB (the inputs once, the forward's chunk states, the
// gradients) and does about 14 operations per token and state element
// (4.8 GFLOP), 0.071 ms at the fp32 rate; a sequential walk over 2,048
// tokens per head would leave 40 chains for 132 SMs.
//
// What the design does about it: the forward's chunks, run backward. The
// sequence is cut into the forward's chunks of kChunkLen tokens; the
// forward's phase B leaves the state entering every chunk (L_c) and every
// chunk's decay (D_c = exp of the chunk's summed w), and the autograd
// Function keeps both. Five kernels, all fp32 on the CUDA cores, every
// decay exponent <= 0:
//   A'. rwkv6_bwd_chunk_adjoint, one block per (batch, head, chunk): the
//       chunk's adjoint from zero, M_c = sum_t (r_t * exp(P_t)) (x) dy_t,
//       P_t the sum of w over the chunk's tokens before t (a prefix sum),
//       a 4 x 4 tile of the K x V product per thread.
//   B'. rwkv6_bwd_chunk_carry, one thread per (batch, head, k, v),
//       backward over the chunks from ds_out: G_exit(c - 1) = D_c G_exit(c)
//       + M_c. It overwrites M_c with G_exit(c), the cotangent of the state
//       leaving chunk c, and writes dstate.
//   C'. rwkv6_bwd_rows, one block per (batch, head, chunk, group of R
//       rows of the state): each lane owns two adjacent elements of a row
//       of the state (a warp 64 columns). The chunk's v and dy are staged
//       in shared memory first, 16 loads in flight a thread, so no token
//       of the recurrence waits on device memory. It runs forward over the
//       chunk from L_c (dr_t's sum over v), keeping S_{t-1} of the last 32
//       tokens in shared memory, then backward from G_exit(c) for dk_t and
//       dw_t; the first 32 tokens' S_{t-1} are computed again from L_c
//       before their backward. So the history takes 32 tokens of shared
//       memory, not 64, and two blocks of 8 warps fit an SM. dw takes the
//       pairwise form, S_{t-1} and G_t at the same t, so no sum of terms
//       that cancel: its error stays relative to each dw_t, however strong
//       the decay. The sums over v of 32 tokens at a time are one
//       reduce-scatter across the warp (31 shuffles for 32 sums, not 5
//       each), then the row's warps in order.
//   C''. rwkv6_bwd_values, one block per (batch, head, chunk): the
//       forward's token recurrence mirrored, each lane owning one column
//       of G in registers and walking the chunk backward from G_exit(c)
//       for dv_t (a sum over k), 32 tokens of r, k, exp(w) and dy staged in
//       shared memory at a time. When T <= kChunkLen it runs from ds_out
//       alone and writes dstate itself.
//   D'. rwkv6_bwd_du: du, the per-chunk sums that C' wrote, added over
//       batch and chunk in order.
// Every sum runs in a fixed order and nothing uses atomics, so two calls
// give the same bits.
//
// Strides are arguments, so r/k/v/w/dy may be (B,T,H,K) projections viewed
// as (B,H,T,K) without a copy, and dr/dk/dv/dw are written through strides
// too. Every entry point launches on the caller's stream, allocates nothing,
// and returns cudaGetLastError() so the Python wrapper can raise on a
// refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 32;       // columns per warp, one per lane
constexpr int kStage = 32;       // tokens per reduce-scatter (C') / stage (C'')
constexpr int kChunkLen = 64;    // tokens per chunk: the forward's
constexpr int kThreadsA = 256;   // phase A' block
constexpr int kThreadsB = 256;   // phase B' block
constexpr int kBatch = 8;        // chunks phase B' loads ahead
constexpr int kMaxWarps = 8;     // phase C' block: at most 8 warps
constexpr int kLoadAhead = 16;   // phase C': staging loads in flight a thread

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
  const float* w;        // log decay, <= 0
  const float* u;        // (H, K) contiguous
  const float* s_in;     // (B, H, K, V) contiguous, or null for zeros
  const void* dy;
  const float* ds_out;   // (B, H, K, V) contiguous, or null for zeros
  const float* L;        // (B, H, nC, K, V) states entering each chunk (nC > 1)
  const float* D;        // (B, H, nC, K) chunk decays (nC > 1)
  float* M;              // (B, H, nC, K, V) scratch: M_c, then G_exit(c)
  float* du_part;        // (B, H, nC, K) scratch: du per chunk
  void* dr;
  void* dk;
  void* dv;
  float* dw;
  float* du;             // (H, K) contiguous
  float* dstate;         // (B, H, K, V) contiguous, or null: not wanted
  int B, H, T, V, nC;
  int rows;              // phase C': state rows per block
  int row_warps;         // phase C': warps per state row, 64 columns each
  int col_warps;         // phase C'': warps, 32 columns each
  // element strides (b, h, t, d)
  long long sr[4], sk[4], sv[4], sw[4], sdy[4], sdr[4], sdk[4], sdv[4], sdw[4];
};

__host__ __device__ __forceinline__ int pad4(int x) { return (x + 3) & ~3; }

__device__ __forceinline__ long long at(const long long (&s)[4], int b, int h,
                                        long long t, int i) {
  return b * s[0] + h * s[1] + t * s[2] + i * s[3];
}

// The chunk's token range: [tb, tb + n).
__device__ __forceinline__ int chunk_len(const Args& a, int c) {
  return a.nC > 1 ? min(kChunkLen, a.T - c * kChunkLen) : a.T;
}

// Phase A': one block per (batch * head, chunk).
template <typename T, int K>
__global__ void __launch_bounds__(kThreadsA)
rwkv6_bwd_chunk_adjoint(const Args a) {
  extern __shared__ __align__(16) float smem[];
  const int V4 = pad4(a.V);
  float* e_s = smem;                         // [kChunkLen][K]: w, then P
  float* r_s = e_s + kChunkLen * K;          // [kChunkLen][K]: r, then r exp(P)
  float* g_s = r_s + kChunkLen * K;          // [kChunkLen][V4]: dy

  const int tid = threadIdx.x;
  const int bh = blockIdx.x, c = blockIdx.y;
  const int b = bh / a.H, h = bh % a.H;
  const int tb = c * kChunkLen;
  const int n = chunk_len(a, c);
  const T* r = static_cast<const T*>(a.r);
  const T* dy = static_cast<const T*>(a.dy);

  for (int e = tid; e < n * K; e += kThreadsA) {
    const int t = e / K, i = e % K;
    e_s[e] = a.w[at(a.sw, b, h, tb + t, i)];
    r_s[e] = to_f32(r[at(a.sr, b, h, tb + t, i)]);
  }
  for (int e = tid; e < n * V4; e += kThreadsA) {
    const int t = e / V4, j = e % V4;
    g_s[e] = j < a.V ? to_f32(dy[at(a.sdy, b, h, tb + t, j)]) : 0.f;
  }
  __syncthreads();
  if (tid < K) {  // P_t = sum of w over the chunk's tokens before t
    float acc = 0.f;
    for (int t = 0; t < n; ++t) {
      const float w = e_s[t * K + tid];
      e_s[t * K + tid] = acc;
      acc += w;
    }
  }
  __syncthreads();
  for (int e = tid; e < n * K; e += kThreadsA) r_s[e] *= expf(e_s[e]);
  __syncthreads();

  // M_c[k][v] = sum_t r_s[t][k] g_s[t][v], a 4 x 4 tile per thread
  const int vu = V4 / 4;
  float* M = a.M + (static_cast<long long>(bh) * a.nC + c) * K * a.V;
  for (int unit = tid; unit < (K / 4) * vu; unit += kThreadsA) {
    const int ki = (unit / vu) * 4, vj = (unit % vu) * 4;
    float acc[4][4] = {};
    for (int t = 0; t < n; ++t) {
      const float4 rr = *reinterpret_cast<const float4*>(r_s + t * K + ki);
      const float4 gg = *reinterpret_cast<const float4*>(g_s + t * V4 + vj);
      const float rx[4] = {rr.x, rr.y, rr.z, rr.w};
      const float gx[4] = {gg.x, gg.y, gg.z, gg.w};
#pragma unroll
      for (int x = 0; x < 4; ++x) {
#pragma unroll
        for (int z = 0; z < 4; ++z) acc[x][z] = fmaf(rx[x], gx[z], acc[x][z]);
      }
    }
#pragma unroll
    for (int x = 0; x < 4; ++x) {
#pragma unroll
      for (int z = 0; z < 4; ++z) {
        if (vj + z < a.V) M[(ki + x) * a.V + vj + z] = acc[x][z];
      }
    }
  }
}

// Phase B': one thread per (batch * head, k, v) state element, backward
// over the chunks; M and D loaded kBatch chunks ahead of the carry.
template <int K>
__global__ void __launch_bounds__(kThreadsB)
rwkv6_bwd_chunk_carry(const Args a) {
  const long long kv = static_cast<long long>(K) * a.V;
  const long long idx = static_cast<long long>(blockIdx.x) * kThreadsB + threadIdx.x;
  if (idx >= static_cast<long long>(a.B) * a.H * kv) return;
  const long long bh = idx / kv, e = idx % kv;
  const int i = static_cast<int>(e / a.V);
  float* __restrict__ Mb = a.M + bh * a.nC * kv + e;
  const float* __restrict__ Db = a.D + bh * a.nC * K + i;
  float G = a.ds_out != nullptr ? a.ds_out[idx] : 0.f;
  for (int c0 = a.nC - 1; c0 >= 0; c0 -= kBatch) {
    float m[kBatch], d[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      if (c0 - j >= 0) {
        m[j] = Mb[(c0 - j) * kv];
        d[j] = Db[(c0 - j) * K];
      }
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      if (c0 - j >= 0) {
        Mb[(c0 - j) * kv] = G;  // the cotangent of the state leaving chunk c0 - j
        G = fmaf(d[j], G, m[j]);
      }
    }
  }
  if (a.dstate != nullptr) a.dstate[idx] = G;
}

// One step of reduce_scatter: the two lanes that differ in bit HALF trade
// halves of x[0, 2 HALF); each keeps the half its bit selects (the upper
// one when set) in x[0, HALF), added to its partner's copy of that half.
template <int HALF>
__device__ __forceinline__ void scatter_step(float (&x)[kStage], int lane) {
  const bool up = (lane & HALF) != 0;
#pragma unroll
  for (int j = 0; j < HALF; ++j) {
    const float send = up ? x[j] : x[j + HALF];
    const float keep = up ? x[j + HALF] : x[j];
    x[j] = keep + __shfl_xor_sync(0xffffffffu, send, HALF);
  }
}

// Reduce-scatter across the warp: returns, in lane j, the sum over all 32
// lanes of their x[j]. 31 shuffles for 32 sums; the order of each sum is
// fixed by the lane numbers alone.
__device__ __forceinline__ float reduce_scatter(float (&x)[kStage], int lane) {
  scatter_step<16>(x, lane);
  scatter_step<8>(x, lane);
  scatter_step<4>(x, lane);
  scatter_step<2>(x, lane);
  scatter_step<1>(x, lane);
  return x[0];
}

// Phase C': one block per (batch * head, chunk, group of a.rows state rows).
// Warp w owns row w / row_warps of the group and its columns
// [64 (w % row_warps), + 64), two adjacent ones per lane.
template <typename T, int K>
__global__ void __launch_bounds__(kMaxWarps * kLanes)
rwkv6_bwd_rows(const Args a) {
  __shared__ float r_s[kChunkLen][kMaxWarps];
  __shared__ float k_s[kChunkLen][kMaxWarps];
  __shared__ float d_s[kChunkLen][kMaxWarps];   // exp(w)
  __shared__ float vd_s[kChunkLen];             // v_t . dy_t
  __shared__ float red_s[2][kMaxWarps][kLanes];
  extern __shared__ __align__(16) float smem_c[];
  const int V2 = (a.V + 1) & ~1;                 // rows of v and dy, padded even
  float2* hist_s = reinterpret_cast<float2*>(smem_c);  // [kStage][threads]: S_{t-1}
  float* v_s = smem_c + 2 * kStage * blockDim.x;       // [kChunkLen][V2]
  float* g_s = v_s + kChunkLen * V2;                   // [kChunkLen][V2]: dy

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthreads = blockDim.x, nwarps = nthreads >> 5;
  const int bh = blockIdx.x, c = blockIdx.y;
  const int b = bh / a.H, h = bh % a.H;
  const int R = a.rows, RW = a.row_warps;
  const int row0 = blockIdx.z * R;
  const int rl = warp / RW, cw = warp % RW;     // row in the group, its warp
  const int row = row0 + rl;
  const int col = cw * 2 * kLanes + 2 * lane;   // the lane's columns: col, col + 1
  const bool has0 = col < a.V, has1 = col + 1 < a.V;
  const int tb = c * kChunkLen;
  const int n = chunk_len(a, c);
  const T* r = static_cast<const T*>(a.r);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dy = static_cast<const T*>(a.dy);

  // the states entering and leaving the chunk, loaded first: their latency
  // hides behind the staging
  const long long s0 = (static_cast<long long>(bh) * a.nC + c) * K * a.V;
  const float* s_src = a.nC > 1 ? a.L + s0
                                : (a.s_in != nullptr ? a.s_in + s0 : nullptr);
  const float* g_src = a.nC > 1 ? a.M + s0
                                : (a.ds_out != nullptr ? a.ds_out + s0 : nullptr);
  float2 S_in = make_float2(0.f, 0.f), G = make_float2(0.f, 0.f);
  if (s_src != nullptr) {
    if (has0) S_in.x = s_src[row * a.V + col];
    if (has1) S_in.y = s_src[row * a.V + col + 1];
  }
  if (g_src != nullptr) {
    if (has0) G.x = g_src[row * a.V + col];
    if (has1) G.y = g_src[row * a.V + col + 1];
  }
  const float uk = a.u[h * K + row];

  // the chunk's inputs into shared memory, kLoadAhead loads in flight a
  // thread, so no token of the recurrence waits on device memory
  for (int e = tid; e < n * R; e += nthreads) {
    const int t = e / R, i = e % R;
    r_s[t][i] = to_f32(r[at(a.sr, b, h, tb + t, row0 + i)]);
    k_s[t][i] = to_f32(k[at(a.sk, b, h, tb + t, row0 + i)]);
    d_s[t][i] = expf(a.w[at(a.sw, b, h, tb + t, row0 + i)]);
  }
  const int nv = n * V2;
  for (int e0 = tid; e0 < nv; e0 += nthreads * kLoadAhead) {
    float x[kLoadAhead], g[kLoadAhead];
#pragma unroll
    for (int q = 0; q < kLoadAhead; ++q) {
      const int e = e0 + q * nthreads;
      const int t = e / V2, j = e - t * V2;
      x[q] = g[q] = 0.f;
      if (e < nv && j < a.V) {
        x[q] = to_f32(v[at(a.sv, b, h, tb + t, j)]);
        g[q] = to_f32(dy[at(a.sdy, b, h, tb + t, j)]);
      }
    }
#pragma unroll
    for (int q = 0; q < kLoadAhead; ++q) {
      const int e = e0 + q * nthreads;
      if (e < nv) {
        v_s[e] = x[q];
        g_s[e] = g[q];
      }
    }
  }
  __syncthreads();
  for (int t = warp; t < n; t += nwarps) {  // v_t . dy_t, one warp a token
    float acc = 0.f;
    for (int j = lane; j < a.V; j += kLanes) {
      acc = fmaf(v_s[t * V2 + j], g_s[t * V2 + j], acc);
    }
#pragma unroll
    for (int o = 16; o >= 1; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (lane == 0) vd_s[t] = acc;
  }
  __syncthreads();
  const int stages = (n + kStage - 1) / kStage;
  const bool live = has0;                        // the lane has a column

  // one stage of the state forward from S: S_{t-1} of its tokens into
  // hist_s when `keep`, S . dy_t (over the lane's columns) into part
  auto forward = [&](float2& S, int st, bool keep, float (&part)[kStage]) {
#pragma unroll
    for (int j = 0; j < kStage; ++j) {
      const int t = st * kStage + j;
      part[j] = 0.f;
      if (t < n) {
        float2 x = make_float2(0.f, 0.f), g = make_float2(0.f, 0.f);
        if (live) {
          x = *reinterpret_cast<const float2*>(v_s + t * V2 + col);
          g = *reinterpret_cast<const float2*>(g_s + t * V2 + col);
        }
        if (keep) hist_s[j * nthreads + tid] = S;
        part[j] = fmaf(S.y, g.y, S.x * g.x);
        const float dt = d_s[t][rl], kt = k_s[t][rl];
        S.x = fmaf(dt, S.x, kt * x.x);
        S.y = fmaf(dt, S.y, kt * x.y);
      }
    }
  };

  // forward: dr, keeping the last stage's S_{t-1} for the backward
  float2 S = S_in;
  for (int st = 0; st < stages; ++st) {
    float part[kStage];
    forward(S, st, st == stages - 1, part);
    red_s[0][warp][lane] = reduce_scatter(part, lane);
    __syncthreads();
    const int t = st * kStage + lane;
    if (cw == 0 && t < n) {
      float acc = 0.f;
      for (int x = 0; x < RW; ++x) acc += red_s[0][rl * RW + x][lane];
      acc = fmaf(uk * k_s[t][rl], vd_s[t], acc);
      static_cast<T*>(a.dr)[at(a.sdr, b, h, tb + t, row)] = from_f32<T>(acc);
    }
    __syncthreads();
  }

  // backward: G_t from G_exit; dk, and dw pairwise with S_{t-1}. The
  // stages before the last take their S_{t-1} again, forward from S_in
  for (int st = stages - 1; st >= 0; --st) {
    if (st < stages - 1) {
      float part[kStage];
      S = S_in;
      for (int s2 = 0; s2 < st; ++s2) forward(S, s2, false, part);
      forward(S, st, true, part);
    }
    float pk[kStage], pw[kStage];
#pragma unroll
    for (int j = kStage - 1; j >= 0; --j) {
      const int t = st * kStage + j;
      pk[j] = 0.f;
      pw[j] = 0.f;
      if (t < n) {
        float2 g = make_float2(0.f, 0.f), x = make_float2(0.f, 0.f);
        if (live) {
          g = *reinterpret_cast<const float2*>(g_s + t * V2 + col);
          x = *reinterpret_cast<const float2*>(v_s + t * V2 + col);
        }
        const float2 hs = hist_s[j * nthreads + tid];
        pk[j] = fmaf(G.y, x.y, G.x * x.x);
        pw[j] = fmaf(hs.y, G.y, hs.x * G.x);
        const float dt = d_s[t][rl], rt = r_s[t][rl];
        G.x = fmaf(dt, G.x, rt * g.x);
        G.y = fmaf(dt, G.y, rt * g.y);
      }
    }
    red_s[0][warp][lane] = reduce_scatter(pk, lane);
    red_s[1][warp][lane] = reduce_scatter(pw, lane);
    __syncthreads();
    const int t = st * kStage + lane;
    if (cw == 0 && t < n) {
      float sk = 0.f, sw = 0.f;
      for (int x = 0; x < RW; ++x) {
        sk += red_s[0][rl * RW + x][lane];
        sw += red_s[1][rl * RW + x][lane];
      }
      sk = fmaf(uk * r_s[t][rl], vd_s[t], sk);
      static_cast<T*>(a.dk)[at(a.sdk, b, h, tb + t, row)] = from_f32<T>(sk);
      a.dw[at(a.sdw, b, h, tb + t, row)] = d_s[t][rl] * sw;
    }
    __syncthreads();
  }
  if (tid < R) {  // du over the chunk's tokens, off the passes' critical path
    float acc = 0.f;
    for (int t = 0; t < n; ++t) acc = fmaf(r_s[t][tid] * k_s[t][tid], vd_s[t], acc);
    a.du_part[(static_cast<long long>(bh) * a.nC + c) * K + row0 + tid] = acc;
  }
}

// Phase C'': one block per (batch * head, chunk); warp w owns the columns
// [32 w, 32 w + 32) of G, one per lane, all K rows in registers.
template <typename T, int K>
__global__ void __launch_bounds__(256)
rwkv6_bwd_values(const Args a) {
  __shared__ __align__(16) float r_s[kStage][K];
  __shared__ __align__(16) float k_s[kStage][K];
  __shared__ __align__(16) float d_s[kStage][K];  // exp(w)
  __shared__ float rk_s[kStage][K + 1];           // r u k; padded rows
  __shared__ float bonus_s[kStage];
  extern __shared__ float g_s[];                  // [kStage][threads]: dy

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthreads = blockDim.x;
  const int bh = blockIdx.x, c = blockIdx.y;
  const int b = bh / a.H, h = bh % a.H;
  const int col = warp * kLanes + lane;
  const bool has_col = col < a.V;
  const int tb = c * kChunkLen;
  const int n = chunk_len(a, c);
  const T* r = static_cast<const T*>(a.r);
  const T* k = static_cast<const T*>(a.k);
  const T* dy = static_cast<const T*>(a.dy);
  T* dv = static_cast<T*>(a.dv);
  const long long s0 = (static_cast<long long>(bh) * a.nC + c) * K * a.V;
  const float* g_src = a.nC > 1 ? a.M + s0
                                : (a.ds_out != nullptr ? a.ds_out + s0 : nullptr);

  float G[K];
#pragma unroll
  for (int i = 0; i < K; ++i) {
    G[i] = (g_src != nullptr && has_col) ? g_src[i * a.V + col] : 0.f;
  }
  const int stages = (n + kStage - 1) / kStage;
  for (int st = stages - 1; st >= 0; --st) {
    const int base = tb + st * kStage;
    const int m = min(kStage, n - st * kStage);
    __syncthreads();  // the previous stage consumed
    for (int e = tid; e < m * K; e += nthreads) {
      const int t = e / K, i = e % K;
      const float rv = to_f32(r[at(a.sr, b, h, base + t, i)]);
      const float kv = to_f32(k[at(a.sk, b, h, base + t, i)]);
      r_s[t][i] = rv;
      k_s[t][i] = kv;
      d_s[t][i] = expf(a.w[at(a.sw, b, h, base + t, i)]);
      rk_s[t][i] = rv * a.u[h * K + i] * kv;
    }
    if (has_col) {  // each lane stages its own column of dy
      const T* gc = dy + at(a.sdy, b, h, base, col);
      for (int t = 0; t < m; ++t) g_s[t * nthreads + col] = to_f32(gc[t * a.sdy[2]]);
    }
    __syncthreads();
    if (tid < m) {  // thread t sums token t's bonus, as the forward does
      float part = 0.f;
      for (int i = 0; i < K; ++i) part += rk_s[tid][i];
      bonus_s[tid] = part;
    }
    __syncthreads();
    for (int t = m - 1; t >= 0; --t) {
      const float g = has_col ? g_s[t * nthreads + col] : 0.f;
      float x0 = 0.f, x1 = 0.f, x2 = 0.f, x3 = 0.f;
#pragma unroll
      for (int i = 0; i < K; i += 4) {
        const float4 rr = *reinterpret_cast<const float4*>(&r_s[t][i]);
        const float4 kk = *reinterpret_cast<const float4*>(&k_s[t][i]);
        const float4 dd = *reinterpret_cast<const float4*>(&d_s[t][i]);
        x0 = fmaf(kk.x, G[i], x0);
        x1 = fmaf(kk.y, G[i + 1], x1);
        x2 = fmaf(kk.z, G[i + 2], x2);
        x3 = fmaf(kk.w, G[i + 3], x3);
        G[i] = fmaf(G[i], dd.x, rr.x * g);
        G[i + 1] = fmaf(G[i + 1], dd.y, rr.y * g);
        G[i + 2] = fmaf(G[i + 2], dd.z, rr.z * g);
        G[i + 3] = fmaf(G[i + 3], dd.w, rr.w * g);
      }
      const float out = (x0 + x1) + (x2 + x3) + bonus_s[t] * g;
      if (has_col) dv[at(a.sdv, b, h, base + t, col)] = from_f32<T>(out);
    }
  }
  if (a.nC == 1 && a.dstate != nullptr && has_col) {  // else phase B' wrote it
#pragma unroll
    for (int i = 0; i < K; ++i) a.dstate[s0 + i * a.V + col] = G[i];
  }
}

// Phase D': one thread per (head, k).
template <int K>
__global__ void __launch_bounds__(256)
rwkv6_bwd_du(const Args a) {
  const int idx = blockIdx.x * 256 + threadIdx.x;
  if (idx >= a.H * K) return;
  const int h = idx / K, i = idx % K;
  float acc = 0.f;
  for (int b = 0; b < a.B; ++b) {
    const float* p = a.du_part + (static_cast<long long>(b) * a.H + h) * a.nC * K + i;
    for (int c = 0; c < a.nC; ++c) acc += p[c * K];
  }
  a.du[idx] = acc;
}

template <typename T, int K>
cudaError_t launch_k(const Args& a, cudaStream_t s) {
  const int bh = a.B * a.H;
  cudaError_t err;
  if (bh > 0) {
    if (a.nC > 1) {
      const size_t smem_a = sizeof(float) * kChunkLen * (2 * K + pad4(a.V));
      err = cudaFuncSetAttribute(rwkv6_bwd_chunk_adjoint<T, K>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem_a));
      if (err != cudaSuccess) return err;
      rwkv6_bwd_chunk_adjoint<T, K><<<dim3(bh, a.nC), kThreadsA, smem_a, s>>>(a);
      const long long n = static_cast<long long>(bh) * K * a.V;
      rwkv6_bwd_chunk_carry<K><<<static_cast<unsigned int>((n + kThreadsB - 1) / kThreadsB),
                                 kThreadsB, 0, s>>>(a);
    }
    const int threads = a.rows * a.row_warps * kLanes;
    const size_t smem_c = sizeof(float) * 2 * (kStage * threads
                                              + kChunkLen * ((a.V + 1) & ~1));
    err = cudaFuncSetAttribute(rwkv6_bwd_rows<T, K>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem_c));
    if (err != cudaSuccess) return err;
    rwkv6_bwd_rows<T, K><<<dim3(bh, a.nC, K / a.rows), threads, smem_c, s>>>(a);
    const int threads_v = a.col_warps * kLanes;
    const size_t smem_v = sizeof(float) * kStage * threads_v;
    const size_t smem_v_static = sizeof(float) * kStage * (4 * K + 2);
    if (smem_v_static + smem_v > 48 * 1024) {
      err = cudaFuncSetAttribute(rwkv6_bwd_values<T, K>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem_v));
      if (err != cudaSuccess) return err;
    }
    rwkv6_bwd_values<T, K><<<dim3(bh, a.nC), threads_v, smem_v, s>>>(a);
  }
  if (a.H > 0) rwkv6_bwd_du<K><<<(a.H * K + 255) / 256, 256, 0, s>>>(a);
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

// dtype code of r, k, v, dy, dr, dk and dv: 0 = float32, 1 = bfloat16. K is
// 16, 32 or 64, V at most 256. Strides are in elements, ordered (batch,
// head, t, channel). L and D are the forward's chunk states and decays,
// (B, H, nC, K, V) and (B, H, nC, K) fp32 with nC = ceil(T / 64)
// (kChunkLen), as cobra_rwkv6_scan leaves them; M (B, H, nC, K, V) is
// scratch. All three are unused (may be null) when nC is 1. du_part is
// scratch of (B, H, nC, K) fp32 (nC = 1 when T <= 64). s_in, ds_out and
// dstate may be null (zeros in; not wanted out).
extern "C" int cobra_rwkv6_scan_bwd(
    const void* r, const void* k, const void* v, const void* w, const void* u,
    const void* s_in, const void* dy, const void* ds_out, const void* L,
    const void* D, void* M, void* du_part, void* dr, void* dk, void* dv,
    void* dw, void* du, void* dstate, int B, int H, int T, int K, int V,
    const long long* sr, const long long* sk, const long long* sv,
    const long long* sw, const long long* sdy, const long long* sdr,
    const long long* sdk, const long long* sdv, const long long* sdw,
    int dtype, void* stream) {
  Args a;
  a.r = r;
  a.k = k;
  a.v = v;
  a.w = static_cast<const float*>(w);
  a.u = static_cast<const float*>(u);
  a.s_in = static_cast<const float*>(s_in);
  a.dy = dy;
  a.ds_out = static_cast<const float*>(ds_out);
  a.L = static_cast<const float*>(L);
  a.D = static_cast<const float*>(D);
  a.M = static_cast<float*>(M);
  a.du_part = static_cast<float*>(du_part);
  a.dr = dr;
  a.dk = dk;
  a.dv = dv;
  a.dw = static_cast<float*>(dw);
  a.du = static_cast<float*>(du);
  a.dstate = static_cast<float*>(dstate);
  a.B = B;
  a.H = H;
  a.T = T;
  a.V = V;
  a.nC = T > kChunkLen ? (T + kChunkLen - 1) / kChunkLen : 1;
  a.col_warps = V > kLanes ? (V + kLanes - 1) / kLanes : 1;
  a.row_warps = V > 2 * kLanes ? (V + 2 * kLanes - 1) / (2 * kLanes) : 1;
  a.rows = kMaxWarps / a.row_warps;
  for (int i = 0; i < 4; ++i) {
    a.sr[i] = sr[i];
    a.sk[i] = sk[i];
    a.sv[i] = sv[i];
    a.sw[i] = sw[i];
    a.sdy[i] = sdy[i];
    a.sdr[i] = sdr[i];
    a.sdk[i] = sdk[i];
    a.sdv[i] = sdv[i];
    a.sdw[i] = sdw[i];
  }
  if (V > 256 || (K != 16 && K != 32 && K != 64) || (K % a.rows) != 0 ||
      du_part == nullptr ||
      (a.nC > 1 && (L == nullptr || D == nullptr || M == nullptr))) {
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
