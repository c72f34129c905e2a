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
// What bounds it on this card. At rwkv6-3b's training shape (B 1, H 40, T
// 2,048, K = V = 64) it moves about 137 MB (the inputs once, the
// forward's chunk states, the gradients: 0.041 ms at 3.35 TB/s). The
// token walk does about 14 operations per token and state element (4.8
// GFLOP, 0.071 ms at the fp32 rate), but its dependent chains, not the
// card's rates, bound it: a sequential walk over 2,048 tokens per head
// would leave 40 chains for 132 SMs. The mma body does the same function
// as chunk products, 3.4 GFLOP on the tensor cores (0.0035 ms at the bf16
// rate) and 1.2 GFLOP on the CUDA cores (0.018 ms), so the bytes bound it;
// what holds it up is latency: 8 warps an SM (its shared memory takes one
// block an SM) run its phases one after another.
//
// What the design does about it: the forward's chunks, run backward. The
// sequence is cut into the forward's chunks of kChunkLen tokens; the
// forward's phase B leaves the state entering every chunk (L_c) and every
// chunk's decay (D_c = exp of the chunk's summed w), and the autograd
// Function keeps both. Two bodies share phases A', B' and D'; the wrapper
// picks one by the rule of rwkv6_scan.scan_bwd_body (body 1, "mma": bf16,
// K 64, V a multiple of 16 up to 128, rows 16-byte aligned; body 0,
// "simt": everything else). Every decay exponent is <= 0:
//   A'. rwkv6_bwd_chunk_adjoint, one block per (batch, head, chunk): the
//       chunk's adjoint from zero, M_c = sum_t (r_t * exp(P_t)) (x) dy_t,
//       P_t the sum of w over the chunk's tokens before t (a prefix sum),
//       a 4 x 4 tile of the K x V product per thread. In the mma body at
//       T <= kChunkLen it also writes the one chunk's decay, which the
//       forward leaves only past one chunk.
//   B'. rwkv6_bwd_chunk_carry, one thread per (batch, head, k, v),
//       backward over the chunks from ds_out: G_exit(c - 1) = D_c G_exit(c)
//       + M_c. It overwrites M_c with G_exit(c), the cotangent of the state
//       leaving chunk c, and writes dstate.
// The simt body (fp32 on the CUDA cores) walks each chunk's tokens:
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
// That token walk is what bounded it: 1.68 ms at the training call, the
// row pass 1.43 ms of it, and 0.76 ms with its loads, shuffles and history
// all cut out. The mma body has no token walk. rwkv6_bwd_chunk_mma, one
// block of 8 warps per (batch, head, chunk), computes the chunk's
// gradients from L_c and G_C = G_exit(c) as matrix products. With A_t the
// sum of w over the chunk's tokens to t, Q = dY V^T and P_ts = sum_k r_tk
// k_sk e^{A_{t-1,k} - A_{s,k}} (s < t, the forward's intra scores):
//     dr_t = e^{A_{t-1}} (L_c dy_t) + sum_{s<t} Q_ts k_s e^{A_{t-1} - A_s}
//     dk_s = e^{A_C - A_s} (G_C v_s) + sum_{t>s} Q_ts r_t e^{A_{t-1} - A_s}
//     dv   = (K e^{A_C - A}) G_C + P^T dY
//     dw_t = sum_{s<t<tau} N_tau,s + sum_{tau>t} a_tau + sum_{s<t} b_s
//            + e^{A_C} L_c . G_C
// (plus the u terms), N_tau,s = Q_tau,s r_tau k_s e^{A_{tau-1} - A_s},
// a_tau = e^{A_{tau-1}} r_tau (L_c dy_tau), b_s = e^{A_C - A_s} k_s (G_C
// v_s). Each term of dw_t is the decay along one path through w_t, and the
// sums only add them: nothing cancels, so dw's error stays relative to its
// own terms, as in the pairwise form (the identity through reverse sums of
// r dr - k dk would cancel O(1) terms). The chunk's 64 tokens are four
// sub-chunks of 16; A is kept as sums within each sub-chunk plus whole
// sub-chunks' sums, so a decay within a sub-chunk is one small exponent.
// For t in sub-chunk i and s in j < i, e^{A_{t-1} - A_s} = e^{A_{t-1} -
// A(start of i)} e^{A(start of i) - A_s}: both factors <= 1, one folded into
// each operand of an off-diagonal 16 x 16 tile. Within a diagonal tile the
// split would not do: at the clamp's floor (w = -e**2) 16 tokens span
// e^-118, past fp32's range if split both ways. Phases:
//   C0, cp.async: r, k, v, dy, w, L_c and G_C into shared memory, rows
//       past the chunk's end zero (w 0: no decay).
//   C1a, mma.sync m16n8k16 (bf16 operands, fp32 sums), warps (m, h) the
//       rows of sub-chunk m and half h of the outputs' columns: Q, X1 =
//       L_c dy, X2 = G_C v and X3 = (K e^{A_C - A}) G_C. L_c, G_C and the
//       decayed K are fp32 (dw and dstate are held to 1e-4), split into
//       bf16 hi + lo, the products hi hi + hi lo (+ lo hi): a residual of
//       2^-16 of each term, as csrc/flash_attention.cu does. L_c and G_C are
//       never rounded to bf16 alone.
//   The tables: the tiles' decayed operands, K3(i)_s = k_s e^{A(start of i)
//       - A_s} and R3(i)_t = r_t e^{A_{t-1} - A(start of i)}, hi and lo.
//   C1b: X = sum_{j<m} Q[m, j] K3(m)_j and Y = sum_{i>m} Q[i, m]^T
//       R3(m+1)_i, Q split too (about fp32: they give dr's and dk's
//       off-diagonal parts and N's row and column sums, r_t e^{..} X_t and
//       k^_s Y_s, which dw needs); their partial sums over j < M give N
//       summed over s before M and tau after it (T_M); P^T's off-diagonal
//       tiles in bf16 (K3 and R3 hi), then dv's, P^T dY. dr, dk and dv are
//       held to two bf16 roundings.
//   C2, thread (k, sub-chunk M), fp32 on the CUDA cores: M's diagonal tile,
//       pair by pair, its parts of dr, dk, P (summed over K across the warp
//       by a reduce-scatter) and N; then dw_t for t in M from the tile's
//       straddle, sums within M of alpha = a + N's row sums and beta = b +
//       N's column sums, T_M, and a, b summed over whole sub-chunks.
//   C3: dr, dk and dv with the diagonal tiles' and u's terms, and du's part
//       of the chunk, from shared memory.
// Shared memory: r, k, v and dy in bf16, A and Q in fp32, and one region
// that holds L_c and G_C for C1a, the tables for C1b and the partial
// gradients after it; 172 KB at V 64 (VT 64), 204 KB at V 128 (VT 128), so
// one block an SM: 1,280 blocks at the training call. It is built for
// VT = 64 and 128; a narrower V runs on the next, its columns past V zero.
//   D'. rwkv6_bwd_du: du, the per-chunk sums that C' (or C3) wrote, added
//       over batch and chunk in order.
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
  float* D_out;          // (B, H, 1, K) scratch: phase A' writes the decay
                         // when T <= kChunkLen (mma body), else null
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
    if (a.D_out != nullptr) a.D_out[bh * K + tid] = expf(acc);
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

// ---------------------------------------------------------------------------
// The mma body: phase C of one chunk as matrix products (bf16 r/k/v/dy,
// K = 64, V a multiple of 16 up to 128, rows 16-byte aligned; see the
// header).

constexpr int kSub = 16;                  // tokens per sub-chunk
constexpr int kNSub = kChunkLen / kSub;   // sub-chunks per chunk
constexpr int kKT = 64;                   // K of the mma body
constexpr int kTcThreads = 256;           // 8 warps: two per sub-chunk
constexpr int kKP = kKT + 8;              // bf16 pitch of [token][K] rows
constexpr int kFP = kKT + 4;              // fp32 pitch of [token][K] rows
constexpr int kPairs = kSub * (kSub - 1) / 2;   // (tau > s) pairs a tile
constexpr int kSpans = (kNSub + 1) * (kNSub + 1);
constexpr int kTabRows = kSub * (kNSub - 1) * kNSub / 2;   // rows a table
constexpr float kLog2e = 1.4426950408889634f;

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// (x0, x1) = hi + lo + O(2^-17 |x|), each a packed bf16 pair (x0 low)
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack2(x0 - hf.x, x1 - hf.y);
}

// 2^x by the SFU (about 2 ulp; 0 far below -126)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from device memory into shared memory, or zeros when !valid
__device__ __forceinline__ void cp16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0));
}

// c (16x8 fp32) += a (16x16 bf16, row) * b (16x8 bf16, col)
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the A fragment of rows [row0, +16) and columns [col0, +16) of a
// row-major bf16 array
__device__ __forceinline__ void frag_a(uint32_t (&f)[4], const bf16* x,
                                       int pitch, int row0, int col0, int g,
                                       int c) {
  const bf16* p = x + (row0 + g) * pitch + col0 + 2 * c;
  f[0] = ld32(p);
  f[1] = ld32(p + 8 * pitch);
  f[2] = ld32(p + 8);
  f[3] = ld32(p + 8 * pitch + 8);
}

// the B fragments of two n-tiles, columns [col0, +8) and [col0 + 8, +8),
// over rows [row0, +16) (the contraction) of a row-major bf16 array:
// f[0], f[1] the first n-tile's, f[2], f[3] the second's
__device__ __forceinline__ void frag_b2_trans(uint32_t (&f)[4], const bf16* x,
                                              int pitch, int row0, int col0,
                                              int lane) {
  const int q = lane >> 3;
  const bf16* p = x + (row0 + (lane & 7) + 8 * (q & 1)) * pitch + col0 + 8 * (q >> 1);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(f[0]), "=r"(f[1]), "=r"(f[2]), "=r"(f[3])
               : "r"(smem_u32(p)));
}

// an accumulator pair of n-tiles (16 x 16 fp32) as an A fragment
__device__ __forceinline__ void frag_acc(uint32_t (&f)[4], const float (&x)[4],
                                         const float (&y)[4]) {
  f[0] = pack2(x[0], x[1]);
  f[1] = pack2(x[2], x[3]);
  f[2] = pack2(y[0], y[1]);
  f[3] = pack2(y[2], y[3]);
}

// sixteen floats of a row of shared memory, 16-byte aligned
__device__ __forceinline__ void load16(float (&x)[kSub], const float* p) {
#pragma unroll
  for (int y = 0; y < kSub; y += 4) {
    const float4 v = *reinterpret_cast<const float4*>(p + y);
    x[y] = v.x;
    x[y + 1] = v.y;
    x[y + 2] = v.z;
    x[y + 3] = v.w;
  }
}

// A sum over the four lanes of a quad (lanes 4j..4j+3), in a fixed order.
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// shared memory of the mma body, in bytes from the base
template <int VT>
struct TcLayout {
  static constexpr int VP = VT + 8;       // bf16 pitch of v and dy rows
  static constexpr int LP = VT + 8;       // fp32 pitch of L and G rows
  static constexpr int DP = VT + 4;       // fp32 pitch of dvp rows
  static constexpr size_t kRK = size_t(kChunkLen) * kKP * 2;
  static constexpr size_t kVD = size_t(kChunkLen) * VP * 2;
  static constexpr size_t kF = size_t(kChunkLen) * kFP * 4;
  static constexpr size_t kTab = size_t(kTabRows) * kKP * 2;
  // C1a: L, G; C1b: the tables K3 and R3, hi and lo; C2, C3: alpha,
  // beta, drp, dkp, dvp
  static constexpr size_t kU1 = 2 * size_t(kKT) * LP * 4;
  static constexpr size_t kU2 = 4 * kTab;
  static constexpr size_t kU3 = 4 * kF + size_t(kChunkLen) * DP * 4;
  static constexpr size_t kU = kU1 > kU2 ? (kU1 > kU3 ? kU1 : kU3)
                                         : (kU2 > kU3 ? kU2 : kU3);
  static constexpr size_t r = 0, k = kRK, v = 2 * kRK, dy = v + kVD;
  static constexpr size_t al = dy + kVD, q = al + kF, u = q + kF;
  static constexpr size_t pd = u + kU;
  static constexpr size_t small = pd + size_t(2) * kNSub * 128 * 4;
  // spans [5][5][kKT]; u, bonus, lg [kKT]; asum, bsum [4][kKT]; tpart
  // [4][4][kKT]
  static constexpr size_t bytes = small + size_t(kSpans + 3 + 8 + 16) * kKT * 4;
};

struct TcSmem {
  bf16 *r, *k, *v, *dy;
  float *al;     // [t][kFP]: w (log2 units) summed over t's sub-chunk to t
  float *q;      // [t][kFP]: Q_ts = dy_t . v_s (s <= t)
  float *L, *G;  // [k][LP] (phase C1a)
  bf16 *k3h, *k3l, *r3h, *r3l;   // [kTabRows][kKP] (phase C1b), tc_tables
  float *al_, *be, *drp, *dkp, *dvp;   // phases C2 and C3: alpha, beta, ...
  float *pd;     // [2][kNSub][128]: the diagonal tiles' P, by half of K
  float *spn;    // [kNSub + 1][kNSub + 1][kKT]: w summed over sub-chunks
  float *u, *bonus, *lg, *asum, *bsum, *tpart;

  __device__ float rv(int t, int i) const { return __bfloat162float(r[t * kKP + i]); }
  __device__ float kv(int t, int i) const { return __bfloat162float(k[t * kKP + i]); }
  // the sum of w over the tokens of t's sub-chunk before t
  __device__ float ae(int t, int i) const {
    return (t % kSub) ? al[(t - 1) * kFP + i] : 0.f;
  }
  // the sum of w over sub-chunks [m0, m1) (0 when m1 <= m0)
  __device__ float span(int m0, int m1, int i) const {
    return spn[(m0 * (kNSub + 1) + m1) * kKT + i];
  }
  __device__ float tot(int m, int i) const { return span(m, m + 1, i); }
  // the tables' row of token x for reference sub-chunk ref (1..3):
  // K3(ref) holds s < 16 ref, R3(ref) holds t >= 16 ref
  __device__ static int k3row(int ref, int s) { return (ref * (ref - 1) / 2) * kSub + s; }
  __device__ static int r3row(int ref, int t) {
    return (ref - 1) * (2 * kNSub - ref) / 2 * kSub + t - kSub * ref;
  }
};

// Phase C1b's operands: one exponent each, every factor <= 1, fp32 split
// into bf16 hi + lo (ref = 1..3, the sub-chunk whose start is the
// reference):
//   K3(ref)[s] = k_s e^{A(start of ref) - A_s}     for s < 16 ref
//   R3(ref)[t] = r_t e^{A_{t-1} - A(start of ref)}  for t >= 16 ref
// dr's tiles into sub-chunk i take K3(i) (read transposed); for s in
// sub-chunk j, dk's and P^T's tiles take R3(j + 1), and K3(j + 1)'s rows
// of j are k^_s = k_s e^{A(end of j) - A_s}.
__device__ __forceinline__ void tc_tables(const TcSmem& sm, int tid) {
  const int i = tid % kKT;
  for (int row = tid / kKT; row < 2 * kTabRows; row += kTcThreads / kKT) {
    float x;
    int at_row;
    if (row < kTabRows) {             // K3: rows 0-15 ref 1, 16-47 ref 2, 48-95 ref 3
      const int ref = row < 16 ? 1 : (row < 48 ? 2 : 3);
      const int s = row - (ref * (ref - 1) / 2) * kSub, j = s / kSub;
      x = sm.kv(s, i) * fast_exp2(sm.span(j + 1, ref, i) + (sm.tot(j, i) - sm.al[s * kFP + i]));
      at_row = row;
    } else {                          // R3: rows 0-47 ref 1, 48-79 ref 2, 80-95 ref 3
      const int rr = row - kTabRows;
      const int ref = rr < 48 ? 1 : (rr < 80 ? 2 : 3);
      const int t = rr - (ref - 1) * (2 * kNSub - ref) / 2 * kSub + kSub * ref;
      x = sm.rv(t, i) * fast_exp2(sm.span(ref, t / kSub, i) + sm.ae(t, i));
      at_row = rr;
    }
    const bf16 hi = __float2bfloat16(x);
    const bf16 lo = __float2bfloat16(x - __bfloat162float(hi));
    if (row < kTabRows) {
      sm.k3h[at_row * kKP + i] = hi;
      sm.k3l[at_row * kKP + i] = lo;
    } else {
      sm.r3h[at_row * kKP + i] = hi;
      sm.r3l[at_row * kKP + i] = lo;
    }
  }
}

// The A fragment (hi and lo) of rows [row0, +16), columns [col0, +16) of
// a row-major fp32 array
__device__ __forceinline__ void frag_a_split(uint32_t (&fh)[4], uint32_t (&fl)[4],
                                             const float* x, int pitch, int row0,
                                             int col0, int g, int c) {
  const float* p = x + (row0 + g) * pitch + col0 + 2 * c;
  const float2 v0 = *reinterpret_cast<const float2*>(p);
  const float2 v1 = *reinterpret_cast<const float2*>(p + 8 * pitch);
  const float2 v2 = *reinterpret_cast<const float2*>(p + 8);
  const float2 v3 = *reinterpret_cast<const float2*>(p + 8 * pitch + 8);
  split2(v0.x, v0.y, fh[0], fl[0]);
  split2(v1.x, v1.y, fh[1], fl[1]);
  split2(v2.x, v2.y, fh[2], fl[2]);
  split2(v3.x, v3.y, fh[3], fl[3]);
}

// The same of the transpose: element (row, col) is x[col][row]
__device__ __forceinline__ void frag_a_split_t(uint32_t (&fh)[4], uint32_t (&fl)[4],
                                               const float* x, int pitch, int row0,
                                               int col0, int g, int c) {
  const float* p = x + (col0 + 2 * c) * pitch + row0 + g;
  split2(p[0], p[pitch], fh[0], fl[0]);
  split2(p[8], p[pitch + 8], fh[1], fl[1]);
  split2(p[8 * pitch], p[9 * pitch], fh[2], fl[2]);
  split2(p[8 * pitch + 8], p[9 * pitch + 8], fh[3], fl[3]);
}

// c += a b in about fp32: (ah + al)(bh + bl) less al bl
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], uint32_t bh0,
                                     uint32_t bh1, uint32_t bl0, uint32_t bl1) {
  mma16816(c, ah, bh0, bh1);
  mma16816(c, ah, bl0, bl1);
  mma16816(c, al, bh0, bh1);
}

// The sums over a warp's 16 accumulator rows of its n-tile's two columns,
// in lanes 0-3 (a fixed order: the rows g and g + 8, then across g)
__device__ __forceinline__ float2 col_sums(const float (&x)[4]) {
  float s0 = x[0] + x[2], s1 = x[1] + x[3];
#pragma unroll
  for (int o = 4; o < 32; o <<= 1) {
    s0 += __shfl_xor_sync(0xffffffffu, s0, o);
    s1 += __shfl_xor_sync(0xffffffffu, s1, o);
  }
  return make_float2(s0, s1);
}

// Phase C1a, warp (m, h): Q's rows of sub-chunk m (into shared memory, by
// h 0), X1 = L_c dy and X2 = G_C v over m's rows and half h of K, and X3 =
// (k e^{A_C - A}) G_C over m's rows and half h of V. L_c, G_C and the
// decayed k are fp32, split into bf16 hi + lo.
template <int VT>
__device__ __forceinline__ void tc_c1a(const TcSmem& sm, int m, int h, int lane,
                                       float (&x1)[4][4], float (&x2)[4][4],
                                       float (&dvp)[VT / 16][4]) {
  using Ly = TcLayout<VT>;
  constexpr int VP = Ly::VP, LP = Ly::LP, NV = VT / 16;
  const int g = lane >> 2, c = lane & 3, row0 = m * kSub;
  uint32_t f[4];
  {
    float qa[8][4] = {};
#pragma unroll
    for (int kv = 0; kv < VT / 16; ++kv) {
      frag_a(f, sm.dy, VP, row0, 16 * kv, g, c);
#pragma unroll
      for (int ns = 0; ns < 8; ++ns) {
        if (ns <= 2 * m + 1) {
          const bf16* p = sm.v + (8 * ns + g) * VP + 16 * kv + 2 * c;
          mma16816(qa[ns], f, ld32(p), ld32(p + 8));
        }
      }
    }
    if (h == 0) {
#pragma unroll
      for (int ns = 0; ns < 8; ++ns) {
        if (ns <= 2 * m + 1) {
          float* p = sm.q + (row0 + g) * kFP + 8 * ns + 2 * c;
          *reinterpret_cast<float2*>(p) = make_float2(qa[ns][0], qa[ns][1]);
          *reinterpret_cast<float2*>(p + 8 * kFP) = make_float2(qa[ns][2], qa[ns][3]);
        }
      }
    }
  }
#pragma unroll
  for (int nk = 0; nk < 4; ++nk) {
#pragma unroll
    for (int e = 0; e < 4; ++e) x1[nk][e] = x2[nk][e] = 0.f;
  }
#pragma unroll
  for (int kv = 0; kv < VT / 16; ++kv) {
    uint32_t fv[4];
    frag_a(f, sm.dy, VP, row0, 16 * kv, g, c);
    frag_a(fv, sm.v, VP, row0, 16 * kv, g, c);
#pragma unroll
    for (int nk = 0; nk < 4; ++nk) {
      const int o = (32 * h + 8 * nk + g) * LP + 16 * kv + 2 * c;
      uint32_t h0, l0, h1, l1;
      const float2 p0 = *reinterpret_cast<const float2*>(sm.L + o);
      const float2 p1 = *reinterpret_cast<const float2*>(sm.L + o + 8);
      split2(p0.x, p0.y, h0, l0);
      split2(p1.x, p1.y, h1, l1);
      mma16816(x1[nk], f, h0, h1);
      mma16816(x1[nk], f, l0, l1);
      const float2 g0 = *reinterpret_cast<const float2*>(sm.G + o);
      const float2 g1 = *reinterpret_cast<const float2*>(sm.G + o + 8);
      split2(g0.x, g0.y, h0, l0);
      split2(g1.x, g1.y, h1, l1);
      mma16816(x2[nk], fv, h0, h1);
      mma16816(x2[nk], fv, l0, l1);
    }
  }
#pragma unroll
  for (int nv = 0; nv < NV; ++nv) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dvp[nv][e] = 0.f;
  }
#pragma unroll
  for (int kq = 0; kq < kKT / 16; ++kq) {
    float x[8];   // k_s e^{A_C - A_s}, rows g, g + 8
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int s = row0 + g + 8 * ((e >> 1) & 1);
      const int i = 16 * kq + 2 * c + (e & 1) + 8 * (e >> 2);
      x[e] = sm.kv(s, i) * fast_exp2(sm.span(m + 1, kNSub, i)
                                     + (sm.tot(m, i) - sm.al[s * kFP + i]));
    }
    uint32_t fh[4], fl[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) split2(x[2 * e], x[2 * e + 1], fh[e], fl[e]);
#pragma unroll
    for (int nv = 0; nv < NV; ++nv) {
      const float* p = sm.G + (16 * kq + 2 * c) * LP + h * (VT / 2) + 8 * nv + g;
      uint32_t h0, l0, h1, l1;
      split2(p[0], p[LP], h0, l0);
      split2(p[8 * LP], p[9 * LP], h1, l1);
      mma3(dvp[nv], fh, fl, h0, h1, l0, l1);
    }
  }
}

// Phase C1b, warp (m, h), after the tables. t side (m's rows as the later
// token t, half h of K): X = sum over the earlier sub-chunks j of Q[m, j]
// K3(m)[j], about fp32 (Q and K3 split), so dr's off-diagonal part is
// e^{A_{t-1} - A(start of m)} X and N's sum over those s is r_t e^{..} X;
// its partial sums over j < M are N over s < 16 M, whose column sums feed
// dw's straddle T_M (tpart). s side (m's rows as the earlier token s): Y =
// sum over the later sub-chunks of Q^T R3(m + 1), likewise; P^T in bf16
// (K3(m + 1) and R3(m + 1) hi) and dv's off-diagonal part P^T dY. The
// epilogue forms drp, dkp, alpha = a + r_t e^{..} X and beta = b + k^_s Y
// and the sums of a and b over m's rows.
template <int VT>
__device__ __forceinline__ void tc_c1b(const TcSmem& sm, int m, int h, int lane,
                                       const float (&x1)[4][4], const float (&x2)[4][4],
                                       float (&dvp)[VT / 16][4], float (&drp)[4][4],
                                       float (&alp)[4][4], float (&dkp)[4][4],
                                       float (&bet)[4][4]) {
  using Ly = TcLayout<VT>;
  constexpr int VP = Ly::VP, NV = VT / 16;
  const int g = lane >> 2, c = lane & 3, row0 = m * kSub;
  uint32_t fh[4], fl[4], bh[4], bl[4];

  // ---- t side ----
  float X[4][4] = {}, fr[4][4], ea[4][4];
#pragma unroll
  for (int nk = 0; nk < 4; ++nk) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int t = row0 + g + 8 * (e >> 1), i = 32 * h + 8 * nk + 2 * c + (e & 1);
      ea[nk][e] = fast_exp2(sm.ae(t, i));
      fr[nk][e] = sm.rv(t, i) * ea[nk][e];
    }
  }
  if (m > 0) {
    const int k3o = TcSmem::k3row(m, 0) * kKP;
#pragma unroll
    for (int js = 0; js < kNSub - 1; ++js) {
      if (js < m) {
        frag_a_split(fh, fl, sm.q, kFP, row0, 16 * js, g, c);
#pragma unroll
        for (int nk = 0; nk < 4; nk += 2) {
          frag_b2_trans(bh, sm.k3h + k3o, kKP, 16 * js, 32 * h + 8 * nk, lane);
          frag_b2_trans(bl, sm.k3l + k3o, kKP, 16 * js, 32 * h + 8 * nk, lane);
          mma3(X[nk], fh, fl, bh[0], bh[1], bl[0], bl[1]);
          mma3(X[nk + 1], fh, fl, bh[2], bh[3], bl[2], bl[3]);
        }
        if (js + 1 < m) {   // N over s < 16 (js + 1): its column sums for T_{js+1}
#pragma unroll
          for (int nk = 0; nk < 4; ++nk) {
            float y[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) y[e] = fr[nk][e] * X[nk][e];
            const float2 cs = col_sums(y);
            if (g == 0) {
              float* tp = sm.tpart + (m * kNSub + js + 1) * kKT + 32 * h + 8 * nk + 2 * c;
              tp[0] = cs.x;
              tp[1] = cs.y;
            }
          }
        }
      }
    }
  }
#pragma unroll
  for (int nk = 0; nk < 4; ++nk) {
    float y[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int t = row0 + g + 8 * (e >> 1), i = 32 * h + 8 * nk + 2 * c + (e & 1);
      const float eA = fast_exp2(sm.span(0, m, i)) * ea[nk][e];   // e^{A_{t-1}}
      drp[nk][e] = eA * x1[nk][e] + ea[nk][e] * X[nk][e];
      y[e] = sm.rv(t, i) * eA * x1[nk][e];                          // a_t
      alp[nk][e] = y[e] + fr[nk][e] * X[nk][e];
    }
    const float2 cs = col_sums(y);
    if (g == 0) {
      float* as = sm.asum + m * kKT + 32 * h + 8 * nk + 2 * c;
      as[0] = cs.x;
      as[1] = cs.y;
    }
  }

  // ---- s side ----
  float Y[4][4] = {};
  if (m < kNSub - 1) {
    const int r3o = TcSmem::r3row(m + 1, 0) * kKP;   // rows t >= 16 (m + 1)
    const int k3o = TcSmem::k3row(m + 1, 0) * kKP;   // rows s < 16 (m + 1)
#pragma unroll
    for (int jt = 1; jt < kNSub; ++jt) {
      if (jt > m) {
        frag_a_split_t(fh, fl, sm.q, kFP, row0, 16 * jt, g, c);
#pragma unroll
        for (int nk = 0; nk < 4; nk += 2) {
          frag_b2_trans(bh, sm.r3h + r3o, kKP, 16 * jt, 32 * h + 8 * nk, lane);
          frag_b2_trans(bl, sm.r3l + r3o, kKP, 16 * jt, 32 * h + 8 * nk, lane);
          mma3(Y[nk], fh, fl, bh[0], bh[1], bl[0], bl[1]);
          mma3(Y[nk + 1], fh, fl, bh[2], bh[3], bl[2], bl[3]);
        }
      }
    }
    float pt[8][4] = {};
#pragma unroll
    for (int kq = 0; kq < kKT / 16; ++kq) {
      frag_a(fh, sm.k3h + k3o, kKP, row0, 16 * kq, g, c);   // k^_s
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        if (nt >= 2 * m + 2) {
          const bf16* p = sm.r3h + r3o + (8 * nt + g) * kKP + 16 * kq + 2 * c;
          mma16816(pt[nt], fh, ld32(p), ld32(p + 8));
        }
      }
    }
#pragma unroll
    for (int jt = 1; jt < kNSub; ++jt) {
      if (jt > m) {
        frag_acc(fh, pt[2 * jt], pt[2 * jt + 1]);
#pragma unroll
        for (int nv = 0; nv < NV; nv += 2) {
          frag_b2_trans(bh, sm.dy, VP, 16 * jt, h * (VT / 2) + 8 * nv, lane);
          mma16816(dvp[nv], fh, bh[0], bh[1]);
          mma16816(dvp[nv + 1], fh, bh[2], bh[3]);
        }
      }
    }
  }
#pragma unroll
  for (int nk = 0; nk < 4; ++nk) {
    float y[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int s = row0 + g + 8 * (e >> 1), i = 32 * h + 8 * nk + 2 * c + (e & 1);
      const float own = sm.tot(m, i) - sm.al[s * kFP + i];
      const float eo = fast_exp2(own);
      const float eC = fast_exp2(sm.span(m + 1, kNSub, i) + own);
      const float kk = sm.kv(s, i);
      dkp[nk][e] = eC * x2[nk][e] + eo * Y[nk][e];
      y[e] = kk * eC * x2[nk][e];                                   // b_s
      bet[nk][e] = y[e] + kk * eo * Y[nk][e];
    }
    const float2 cs = col_sums(y);
    if (g == 0) {
      float* bs = sm.bsum + m * kKT + 32 * h + 8 * nk + 2 * c;
      bs[0] = cs.x;
      bs[1] = cs.y;
    }
  }
}

// Phase C2, thread (i, M): sub-chunk M's diagonal tile, pairwise (e^{A_{tau-1}
// - A_s} as one exponent, in fp32 on the CUDA cores): its part of dr, dk,
// P (summed over K across the warp, then the two warps) and N; then dw_t
// for t in M, each of its terms the decay along one path through w_t:
//   the tile's sum_{s < t < tau} N_tau,s, alpha over tau in M after t,
//   beta over s in M before t, T_M (s before M, tau after it), a over the
//   later sub-chunks, b over the earlier ones, and e^{A_C} L_c . G_C.
__device__ __forceinline__ void tc_owner(const TcSmem& sm, const Args& a, int i,
                                         int M, int lane, int b, int h, int tb,
                                         int n) {
  const int t0 = M * kSub;
  float rr[kSub], kr[kSub], al[kSub], dr[kSub], dk[kSub], acc[kSub], stash[kStage];
#pragma unroll
  for (int x = 0; x < kSub; ++x) {
    rr[x] = sm.rv(t0 + x, i);
    kr[x] = sm.kv(t0 + x, i);
    al[x] = sm.al[(t0 + x) * kFP + i];
    dk[x] = acc[x] = 0.f;
  }
  float* pd = sm.pd + ((i >= kLanes) * kNSub + M) * 128;
  dr[0] = 0.f;
#pragma unroll
  for (int tl = 1; tl < kSub; ++tl) {
    float q[kSub];
    load16(q, sm.q + (t0 + tl) * kFP + t0);
    float run = 0.f, d = 0.f;
#pragma unroll
    for (int sl = 0; sl < tl; ++sl) {
      const int p = tl * (tl - 1) / 2 + sl;
      const float E = fast_exp2(al[tl - 1] - al[sl]);
      const float x = rr[tl] * kr[sl] * E;
      d = fmaf(q[sl] * kr[sl], E, d);
      dk[sl] = fmaf(q[sl] * rr[tl], E, dk[sl]);
      run += q[sl] * x;
      if (sl + 1 < tl) acc[sl + 1] += run;
      stash[p % kStage] = x;
      if (p % kStage == kStage - 1 || p == kPairs - 1) {
#pragma unroll
        for (int z = p % kStage + 1; z < kStage; ++z) stash[z] = 0.f;
        const int base = p - p % kStage;
        const float sum = reduce_scatter(stash, lane);
        if (base + lane < kPairs) pd[base + lane] = sum;
      }
    }
    dr[tl] = d;
  }
#pragma unroll
  for (int x = 0; x < kSub; ++x) {
    sm.drp[(t0 + x) * kFP + i] += dr[x];
    sm.dkp[(t0 + x) * kFP + i] += dk[x];
  }
  float rest = sm.lg[i];
  for (int I = M + 1; I < kNSub && M > 0; ++I) rest += sm.tpart[(I * kNSub + M) * kKT + i];
  for (int I = M + 1; I < kNSub; ++I) rest += sm.asum[I * kKT + i];
  for (int J = 0; J < M; ++J) rest += sm.bsum[J * kKT + i];
  float run = 0.f;   // alpha over tau in M after t
#pragma unroll
  for (int x = kSub - 1; x >= 0; --x) {
    acc[x] += run;
    run += sm.al_[(t0 + x) * kFP + i];
  }
  run = 0.f;         // beta over s in M before t
#pragma unroll
  for (int x = 0; x < kSub; ++x) {
    acc[x] += run + rest;
    run += sm.be[(t0 + x) * kFP + i];
    if (t0 + x < n) a.dw[at(a.sdw, b, h, tb + t0 + x, i)] = acc[x];
  }
}

// The mma body's chunk kernel: one block per (batch * head, chunk).
template <int VT>
__global__ void __launch_bounds__(kTcThreads, 1)
rwkv6_bwd_chunk_mma(const Args a) {
  using Ly = TcLayout<VT>;
  constexpr int VP = Ly::VP, LP = Ly::LP, DP = Ly::DP, NV = VT / 16;
  extern __shared__ __align__(16) unsigned char smem_t[];
  TcSmem sm;
  sm.r = reinterpret_cast<bf16*>(smem_t + Ly::r);
  sm.k = reinterpret_cast<bf16*>(smem_t + Ly::k);
  sm.v = reinterpret_cast<bf16*>(smem_t + Ly::v);
  sm.dy = reinterpret_cast<bf16*>(smem_t + Ly::dy);
  sm.al = reinterpret_cast<float*>(smem_t + Ly::al);
  sm.q = reinterpret_cast<float*>(smem_t + Ly::q);
  unsigned char* un = smem_t + Ly::u;
  sm.L = reinterpret_cast<float*>(un);
  sm.G = sm.L + kKT * LP;
  sm.k3h = reinterpret_cast<bf16*>(un);
  sm.k3l = reinterpret_cast<bf16*>(un + Ly::kTab);
  sm.r3h = reinterpret_cast<bf16*>(un + 2 * Ly::kTab);
  sm.r3l = reinterpret_cast<bf16*>(un + 3 * Ly::kTab);
  sm.al_ = reinterpret_cast<float*>(un);
  sm.be = sm.al_ + kChunkLen * kFP;
  sm.drp = sm.be + kChunkLen * kFP;
  sm.dkp = sm.drp + kChunkLen * kFP;
  sm.dvp = sm.dkp + kChunkLen * kFP;
  sm.pd = reinterpret_cast<float*>(smem_t + Ly::pd);
  sm.spn = reinterpret_cast<float*>(smem_t + Ly::small);
  sm.u = sm.spn + kSpans * kKT;
  sm.bonus = sm.u + kKT;
  sm.lg = sm.bonus + kKT;
  sm.asum = sm.lg + kKT;
  sm.bsum = sm.asum + kNSub * kKT;
  sm.tpart = sm.bsum + kNSub * kKT;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bh = blockIdx.x, c = blockIdx.y;
  const int b = bh / a.H, h = bh % a.H;
  const int tb = c * kChunkLen;
  const int n = chunk_len(a, c);
  const int V = a.V;
  const bf16* r = static_cast<const bf16*>(a.r);
  const bf16* k = static_cast<const bf16*>(a.k);
  const bf16* v = static_cast<const bf16*>(a.v);
  const bf16* dy = static_cast<const bf16*>(a.dy);
  const long long s0 = (static_cast<long long>(bh) * a.nC + c) * kKT * V;
  const float* L = a.nC > 1 ? a.L + s0 : (a.s_in != nullptr ? a.s_in + s0 : nullptr);
  const float* Gx = a.M + s0;   // G_exit(c), phase B' (every chunk count)

  // ---- C0: the chunk into shared memory by cp.async, rows past n and
  // columns past V zero (w 0 there: no decay) ----
  for (int e = tid; e < kChunkLen * (kKT / 8); e += kTcThreads) {
    const int t = e / (kKT / 8), x = 8 * (e % (kKT / 8));
    const int tt = t < n ? t : 0;
    cp16(sm.r + t * kKP + x, r + at(a.sr, b, h, tb + tt, x), t < n);
    cp16(sm.k + t * kKP + x, k + at(a.sk, b, h, tb + tt, x), t < n);
  }
  for (int e = tid; e < kChunkLen * (kKT / 4); e += kTcThreads) {
    const int t = e / (kKT / 4), x = 4 * (e % (kKT / 4));
    const int tt = t < n ? t : 0;
    cp16(sm.al + t * kFP + x, a.w + at(a.sw, b, h, tb + tt, x), t < n);
  }
  for (int e = tid; e < kChunkLen * (VT / 8); e += kTcThreads) {
    const int t = e / (VT / 8), x = 8 * (e % (VT / 8));
    const bool ok = t < n && x < V;
    const int tt = ok ? t : 0, xx = ok ? x : 0;
    cp16(sm.v + t * VP + x, v + at(a.sv, b, h, tb + tt, xx), ok);
    cp16(sm.dy + t * VP + x, dy + at(a.sdy, b, h, tb + tt, xx), ok);
  }
  for (int e = tid; e < kKT * (VT / 4); e += kTcThreads) {
    const int i = e / (VT / 4), x = 4 * (e % (VT / 4));
    const bool ok = x < V;
    const long long off = ok ? static_cast<long long>(i) * V + x : 0;
    cp16(sm.L + i * LP + x, L != nullptr ? L + off : Gx, ok && L != nullptr);
    cp16(sm.G + i * LP + x, Gx + off, ok);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  if (tid < kKT) sm.u[tid] = a.u[h * kKT + tid];
  __syncthreads();
  {  // thread (i, m): w over sub-chunk m, summed from its start (log2 units)
    const int i = tid % kKT, m = tid / kKT;
    float run = 0.f;
#pragma unroll
    for (int x = 0; x < kSub; ++x) {
      float* p = sm.al + (m * kSub + x) * kFP + i;
      run += *p * kLog2e;
      *p = run;
    }
  }
  __syncthreads();
  if (tid < kKT) {   // the sums of w over runs of whole sub-chunks
#pragma unroll
    for (int m0 = 0; m0 <= kNSub; ++m0) {
      float run = 0.f;
#pragma unroll
      for (int m1 = 0; m1 <= kNSub; ++m1) {
        sm.spn[(m0 * (kNSub + 1) + m1) * kKT + tid] = run;
        if (m1 >= m0 && m1 < kNSub) run += sm.al[(m1 * kSub + kSub - 1) * kFP + tid];
      }
    }
  }
  {  // thread (token, quarter): sum_k r u k, as the forward does
    const int t = tid / 4, qr = tid % 4;
    float part = 0.f;
    for (int i = qr * 16; i < qr * 16 + 16; ++i) part += sm.rv(t, i) * sm.u[i] * sm.kv(t, i);
    part = quad_sum(part);
    if (qr == 0) sm.bonus[t] = part;
  }
  {  // thread (row i, quarter): L_c . G_C over row i
    const int i = tid / 4, qr = tid % 4;
    float part = 0.f;
    for (int x = qr; x < VT; x += 4) part = fmaf(sm.L[i * LP + x], sm.G[i * LP + x], part);
    part = quad_sum(part);
    if (qr == 0) sm.lg[i] = part;
  }
  __syncthreads();
  if (tid < kKT) sm.lg[tid] *= fast_exp2(sm.span(0, kNSub, tid));   // e^{A_C}

  // ---- C1: the products ----
  const int m = warp >> 1, hf = warp & 1, g = lane >> 2, cq = lane & 3;
  {
    float x1[4][4], x2[4][4], dvp[NV][4];
    tc_c1a<VT>(sm, m, hf, lane, x1, x2, dvp);
    __syncthreads();   // L and G read: their memory takes the tables
    tc_tables(sm, tid);
    __syncthreads();
    float drp[4][4], alp[4][4], dkp[4][4], bet[4][4];
    tc_c1b<VT>(sm, m, hf, lane, x1, x2, dvp, drp, alp, dkp, bet);
    __syncthreads();   // the tables read: their memory takes the results
#pragma unroll
    for (int nk = 0; nk < 4; ++nk) {
#pragma unroll
      for (int e = 0; e < 4; e += 2) {
        const int o = (m * kSub + g + 4 * e) * kFP + 32 * hf + 8 * nk + 2 * cq;
        *reinterpret_cast<float2*>(sm.drp + o) = make_float2(drp[nk][e], drp[nk][e + 1]);
        *reinterpret_cast<float2*>(sm.al_ + o) = make_float2(alp[nk][e], alp[nk][e + 1]);
        *reinterpret_cast<float2*>(sm.dkp + o) = make_float2(dkp[nk][e], dkp[nk][e + 1]);
        *reinterpret_cast<float2*>(sm.be + o) = make_float2(bet[nk][e], bet[nk][e + 1]);
      }
    }
#pragma unroll
    for (int nv = 0; nv < NV; ++nv) {
#pragma unroll
      for (int e = 0; e < 4; e += 2) {
        const int o = (m * kSub + g + 4 * e) * DP + hf * (VT / 2) + 8 * nv + 2 * cq;
        *reinterpret_cast<float2*>(sm.dvp + o) = make_float2(dvp[nv][e], dvp[nv][e + 1]);
      }
    }
  }
  __syncthreads();

  // ---- C2: the diagonal tiles and dw, thread (i, sub-chunk) ----
  tc_owner(sm, a, tid % kKT, tid / kKT, lane, b, h, tb, n);
  __syncthreads();

  // ---- C3: dr, dk, dv and du ----
  bf16* dr = static_cast<bf16*>(a.dr);
  bf16* dk = static_cast<bf16*>(a.dk);
  bf16* dv = static_cast<bf16*>(a.dv);
  for (int e = tid; e < n * (kKT / 2); e += kTcThreads) {
    const int t = e / (kKT / 2), i = 2 * (e % (kKT / 2));
    const float vd = sm.q[t * kFP + t];
    const float2 p = *reinterpret_cast<const float2*>(sm.drp + t * kFP + i);
    const float2 q = *reinterpret_cast<const float2*>(sm.dkp + t * kFP + i);
    const float2 kk = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(sm.k + t * kKP + i));
    const float2 rr = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(sm.r + t * kKP + i));
    const float u0 = sm.u[i] * vd, u1 = sm.u[i + 1] * vd;
    *reinterpret_cast<__nv_bfloat162*>(dr + at(a.sdr, b, h, tb + t, i)) =
        __floats2bfloat162_rn(p.x + u0 * kk.x, p.y + u1 * kk.y);
    *reinterpret_cast<__nv_bfloat162*>(dk + at(a.sdk, b, h, tb + t, i)) =
        __floats2bfloat162_rn(q.x + u0 * rr.x, q.y + u1 * rr.y);
  }
  {  // thread (sub-chunk mb, column j): dv of the sub-chunk's 16 tokens
    const int mb = tid / kKT;
    const float* p0 = sm.pd + mb * 128;
    const float* p1 = sm.pd + (kNSub + mb) * 128;
    for (int j = tid % kKT; j < V; j += kKT) {
      float d[kSub];   // sum_{tau > s} P_tau,s dy_tau within the sub-chunk
#pragma unroll
      for (int sl = 0; sl < kSub; ++sl) d[sl] = 0.f;
#pragma unroll
      for (int tl = 1; tl < kSub; ++tl) {
        const float y = __bfloat162float(sm.dy[(mb * kSub + tl) * VP + j]);
#pragma unroll
        for (int sl = 0; sl < tl; ++sl) {
          const int p = tl * (tl - 1) / 2 + sl;
          d[sl] = fmaf(p0[p] + p1[p], y, d[sl]);
        }
      }
#pragma unroll
      for (int sl = 0; sl < kSub; ++sl) {
        const int s = mb * kSub + sl;
        if (s < n) {
          const float out = sm.dvp[s * DP + j] + d[sl]
              + sm.bonus[s] * __bfloat162float(sm.dy[s * VP + j]);
          dv[at(a.sdv, b, h, tb + s, j)] = __float2bfloat16(out);
        }
      }
    }
  }
  {  // thread (column i, quarter of the tokens): du's part of the chunk
    const int i = tid / 4, qr = tid % 4;
    float part = 0.f;
    for (int t = qr * kSub; t < qr * kSub + kSub && t < n; ++t) {
      part = fmaf(sm.rv(t, i) * sm.kv(t, i), sm.q[t * kFP + t], part);
    }
    part = quad_sum(part);
    if (qr == 0) a.du_part[(static_cast<long long>(bh) * a.nC + c) * kKT + i] = part;
  }
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


template <int VT>
cudaError_t launch_mma(const Args& a, cudaStream_t s) {
  const int bh = a.B * a.H;
  cudaError_t err;
  if (bh > 0) {
    const size_t smem_a = sizeof(float) * kChunkLen * (2 * kKT + pad4(a.V));
    err = cudaFuncSetAttribute(rwkv6_bwd_chunk_adjoint<bf16, kKT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem_a));
    if (err != cudaSuccess) return err;
    rwkv6_bwd_chunk_adjoint<bf16, kKT><<<dim3(bh, a.nC), kThreadsA, smem_a, s>>>(a);
    const long long n = static_cast<long long>(bh) * kKT * a.V;
    rwkv6_bwd_chunk_carry<kKT><<<static_cast<unsigned int>((n + kThreadsB - 1) / kThreadsB),
                                 kThreadsB, 0, s>>>(a);
    const size_t smem = TcLayout<VT>::bytes;
    err = cudaFuncSetAttribute(rwkv6_bwd_chunk_mma<VT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    rwkv6_bwd_chunk_mma<VT><<<dim3(bh, a.nC), kTcThreads, smem, s>>>(a);
  }
  if (a.H > 0) rwkv6_bwd_du<kKT><<<(a.H * kKT + 255) / 256, 256, 0, s>>>(a);
  return cudaGetLastError();
}

// Whether a (batch, head, t, channel) array's rows can be read 16 bytes at
// a time (the mma body's cp.async): unit channel stride, the other strides
// multiples of `per` elements (16 bytes), the base 16-byte aligned.
bool rows16(const void* p, const long long* st, int per) {
  return p != nullptr && reinterpret_cast<uintptr_t>(p) % 16 == 0 && st[3] == 1 &&
         st[0] % per == 0 && st[1] % per == 0 && st[2] % per == 0;
}

}  // namespace

// dtype code of r, k, v, dy, dr, dk and dv: 0 = float32, 1 = bfloat16. K is
// 16, 32 or 64, V at most 256. Strides are in elements, ordered (batch,
// head, t, channel). L and D are the forward's chunk states and decays,
// (B, H, nC, K, V) and (B, H, nC, K) fp32 with nC = ceil(T / 64)
// (kChunkLen), as cobra_rwkv6_scan leaves them; M (B, H, nC, K, V) is
// scratch. On body 0 all three are unused (may be null) when nC is 1; on
// body 1 M is needed always and D, when nC is 1, is (B, H, 1, K) scratch.
// du_part is scratch of (B, H, nC, K) fp32 (nC = 1 when T <= 64). s_in,
// ds_out and dstate may be null (zeros in; not wanted out). body: 0 = the
// simt body, 1 = the mma body (bf16, K 64, V a multiple of 16 up to 128,
// r/k/v/w/dy rows 16-byte aligned, s_in 16-byte aligned; else refused).
extern "C" int cobra_rwkv6_scan_bwd(
    const void* r, const void* k, const void* v, const void* w, const void* u,
    const void* s_in, const void* dy, const void* ds_out, const void* L,
    const void* D, void* M, void* du_part, void* dr, void* dk, void* dv,
    void* dw, void* du, void* dstate, int B, int H, int T, int K, int V,
    const long long* sr, const long long* sk, const long long* sv,
    const long long* sw, const long long* sdy, const long long* sdr,
    const long long* sdk, const long long* sdv, const long long* sdw,
    int dtype, int body, void* stream) {
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
  a.D_out = nullptr;
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
  if (body == 1) {
    if (dtype != 1 || K != kKT || V % 16 != 0 || V < 16 || V > 128 ||
        M == nullptr || D == nullptr || !rows16(r, sr, 8) || !rows16(k, sk, 8) ||
        !rows16(v, sv, 8) || !rows16(dy, sdy, 8) || !rows16(w, sw, 4) ||
        (s_in != nullptr && reinterpret_cast<uintptr_t>(s_in) % 16 != 0)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    if (a.nC == 1) a.D_out = static_cast<float*>(const_cast<void*>(D));
    return static_cast<int>(V <= 64 ? launch_mma<64>(a, s) : launch_mma<128>(a, s));
  }
  if (body != 0) return static_cast<int>(cudaErrorInvalidValue);
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
