// Flash attention, backward: dq, dk, dv from the forward's saved output and
// row log-sum-exps, for Hopper (sm_90a).
//
// No TPU kernel to replace: the reference trains through its plain `sdpa`
// (src/repro/models/layers.py), which XLA differentiates, and never
// differentiates its Pallas flash_attention. This kernel computes the same
// gradient for the port's training path, whose forward is the hand-written
// csrc/flash_attention.cu. Inputs q (B,H,Tq,hd), k (B,KV,Tk,hd), v
// (B,KV,Tk,hdv) with hdv <= hd and H % KV == 0, the forward's output o and
// its gradient do (B,H,Tq,hdv), all bf16 or all fp32, and the rows'
// log-sum-exps lse (B,H,Tq) fp32. The masks are the forward's (causal,
// sliding window, chunk-local; queries at the tail of the keys), and the
// standard formulas are taken in fp32:
//
//   D  = rowsum(dO * O)             P  = exp(S * scale - lse)
//   dV = P^T dO                     dS = P * (dO V^T - D)
//   dQ = dS K * scale               dK = dS^T Q * scale
//
// with each GQA group's heads summed into its K/V head. Outputs are in the
// inputs' type.
//
// Deterministic, with no float atomics: every sum runs in one thread (or
// one wgmma accumulator) in a fixed order, so two calls on the same inputs
// give the same bits.
//   * flash_bwd_delta: D, one warp a row (flash_bwd_delta_vec: 8 threads a
//     row, 16 bytes at a time, for the wgmma body).
//   * dK/dV: one block per (batch, KV head, key tile). K and V stay in
//     shared memory while the block walks the query tiles that can see its
//     keys, for every head of the GQA group in turn, and holds dK and dV in
//     registers; it is the only writer of its rows of dk and dv (zeros for
//     keys no query sees).
//   * dQ: one block per (batch, head, query tile), walking the key tiles
//     its queries can see; the only writer of its rows of dq.
//   The dQ blocks recompute S and dP that the dK/dV blocks computed (seven
//   tile products against the forward's two).
//
// What bounds it: operations, 2.5x the forward's tile products at the least
// (5 against 2; 7 as computed here). Two bodies; the wrapper picks one
// (flash_attention.bwd_body) and passes it with the padded head dim:
//
// the wgmma body (flash_bwd_wg: dkdv_wg and dq_wg blocks in one launch,
// so that neither pass waits for the other's last blocks), for bf16 at the
// training head dims (64, 80, 96 with MLA's hdv 64, 128, 160) with q's,
// k's, v's, o's and dout's rows 16-byte aligned. The first design (mma.sync,
// 64 x 64 tiles, four warps a block) reached 20x its bound: every tile
// waited for its own loads, mma.sync cannot reach the tensor rate, P and dS
// went through the tensor cores twice (bf16 hi + lo), the causal triangle's
// longest blocks ran last, and hd 128 spilled. Here:
//   - the products are wgmma (sm_90a): a warpgroup owns 64 rows of a tile,
//     two warpgroups a block (128 keys in dK/dV, 128 queries in dQ), so
//     each walked tile in shared memory feeds both. In dK/dV, S^T = K Q^T
//     and dP^T = V dO^T read both operands from shared memory; P^T and
//     dS^T go from the accumulator registers straight to the A fragments
//     of dV += P^T dO and dK += dS^T Q, whose B (dO, Q) is read MN-major
//     from the same tiles. dQ: S = Q K^T, dP = dO V^T, dQ += dS K alike;
//   - the walked tiles (Q, dO and the rows' lse and D in dK/dV; K and V in
//     dQ) sit in a ring of kStages slots filled by cp.async: the loads of
//     tile n + kStages - 1 are in flight while tile n is multiplied. Tiles
//     are in the core-matrix layout wgmma reads without swizzle (8 rows of
//     16 bytes contiguous), which takes hd 80 and 96 as they are: wgmma's
//     N is any multiple of 8 and its depth 16, so nothing is padded;
//   - P and dS are rounded to bf16 once, as FlashAttention's backward does;
//   - the heaviest causal blocks go first: key tile 0 (dK/dV) and the last
//     query tile (dQ) are launched before the others;
//   - tiles that the masks leave whole skip the per-element mask test.
//   hd 160 walks 32-query tiles in dK/dV, so that dK, dV, S^T and dP^T fit
//   the registers.
//   What holds it back now (tools/attention_bwd_variants.py --ablate times
//   the steps with their exponentials, products or loads cut out): within a
//   warpgroup the exponentials wait for S and the next products for them,
//   the two warpgroups of a block step together, and the loads share the
//   SM with both, so the tensor cores idle through the exponentials (their
//   MUFU rate, twice over: the dQ pass recomputes S, dP and P) and through
//   part of the loads. dQ stays a pass of its own: folding it into the
//   dK/dV pass (five products) would need its fp32 sums added in key-tile
//   order to stay deterministic, which makes each key block of a head wait
//   for the one before it, query tile by query tile.
//
// the CUDA-core body (flash_bwd_dkdv / flash_bwd_dq), for fp32 inputs and
// for bf16 that the wgmma body does not take (rows off 16 bytes, other head
// dims), at a width of 64, 128 or 160: fp32 throughout; a thread owns a
// 4 x 4 block of the 64 x 64 score tile (or 4 keys / queries x width/16
// dims of an output tile), reads its operands from shared memory with rows
// padded to an odd stride (no bank conflicts) and does 16 fused
// multiply-adds per two to four shared loads. Its loads take any stride.
//
// Every entry point launches on the caller's stream, allocates nothing (D
// lives in a scratch the wrapper allocates) and returns cudaGetLastError()
// so the Python wrapper can raise on a refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;       // 16 x 16 threads
constexpr int kTile = 64;           // queries of a query tile, keys of a key tile
constexpr int kPS = kTile + 1;      // P / dS row stride (odd)
constexpr size_t kMaxSmem = 232448;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__host__ __device__ __forceinline__ int floor_div(int a, int b) {
  int q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

struct Args {
  const void *q, *k, *v, *o, *dout;
  const float* lse;  // (B*H*Tq)
  float* delta;      // (B*H*Tq) scratch: D
  void *dq, *dk, *dv;
  int B, H, KV, Tq, Tk, hd, hdv;
  // element strides (b, head, t, d)
  long long sq[4], sk[4], sv[4], so[4], sdo[4], sdq[4], sdk[4], sdv[4];
  int causal, window, chunk;  // window / chunk: 0 = none
  float scale;
  int vec;  // q, k, v, o and dout rows 16-byte aligned (the wgmma body's loads)
};

__device__ __forceinline__ bool allowed(const Args& a, int qpos, int kpos) {
  bool ok = true;
  if (a.causal) ok = ok && kpos <= qpos;
  if (a.window > 0) ok = ok && kpos > qpos - a.window;
  if (a.chunk > 0) ok = ok && floor_div(kpos, a.chunk) == floor_div(qpos, a.chunk);
  return ok;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// D = rowsum(dO * O), one warp a row
template <typename T>
__global__ void __launch_bounds__(kThreads) flash_bwd_delta(const Args a) {
  const long long row = static_cast<long long>(blockIdx.x) * (kThreads / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= static_cast<long long>(a.B) * a.H * a.Tq) return;
  const int t = static_cast<int>(row % a.Tq);
  const int h = static_cast<int>((row / a.Tq) % a.H);
  const int b = static_cast<int>(row / (static_cast<long long>(a.Tq) * a.H));
  const T* o = static_cast<const T*>(a.o) + b * a.so[0] + h * a.so[1] + t * a.so[2];
  const T* dout = static_cast<const T*>(a.dout) + b * a.sdo[0] + h * a.sdo[1] + t * a.sdo[2];
  float s = 0.f;
  for (int d = lane; d < a.hdv; d += 32) s += to_f32(o[d * a.so[3]]) * to_f32(dout[d * a.sdo[3]]);
  s = warp_sum(s);
  if (lane == 0) a.delta[row] = s;
}

template <int NC>
struct Tile {
  static constexpr int HDP = NC * 16;  // head dims padded; columns past hd (hdv) are 0
  static constexpr int RS = HDP + 1;   // fp32 row stride (odd: a column's rows in distinct banks)
  static constexpr size_t kBytes =
      sizeof(float) * (4 * kTile * RS + 2 * kTile * kPS + 2 * kTile);
  static_assert(kBytes <= kMaxSmem, "tiles exceed a block's shared memory");
};

// rows [r0, r0 + kTile) of one (batch, head) slice into dst as fp32, width
// columns, zero past the rows' end and past width
template <typename T, int NC>
__device__ __forceinline__ void load_rows(float* dst, const T* base, long long st, long long sd,
                                          int r0, int n_rows, int width) {
  constexpr int HDP = Tile<NC>::HDP, RS = Tile<NC>::RS;
  for (int e = threadIdx.x; e < kTile * HDP; e += kThreads) {
    const int i = e / HDP, d = e % HDP;
    const int r = r0 + i;
    float x = 0.f;
    if (r < n_rows && d < width) x = to_f32(base[r * st + d * sd]);
    dst[i * RS + d] = x;
  }
}

// One 64-query x 64-key tile: P and dS = P * (dO V^T - D) into ps (when
// given) and dss, [query][key]. Thread (ty, tx) takes queries ty + 16 r and
// keys tx + 16 c. Queries past Tq, keys past Tk and masked pairs give 0.
template <int NC, bool WRITE_P>
__device__ __forceinline__ void p_ds_tile(const Args& a, const float* qs, const float* dos,
                                          const float* ks, const float* vs,
                                          const float* lse_s, const float* dl_s, float* ps,
                                          float* dss, int t0, int k0, int ty, int tx) {
  constexpr int HDP = Tile<NC>::HDP, RS = Tile<NC>::RS;
  float s[4][4], dp[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int c = 0; c < 4; ++c) s[r][c] = dp[r][c] = 0.f;
  }
#pragma unroll 4
  for (int d = 0; d < HDP; ++d) {
    float qv[4], kv[4], ov[4], vv[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      qv[r] = qs[(ty + 16 * r) * RS + d];
      ov[r] = dos[(ty + 16 * r) * RS + d];
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      kv[c] = ks[(tx + 16 * c) * RS + d];
      vv[c] = vs[(tx + 16 * c) * RS + d];
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[r][c] = fmaf(qv[r], kv[c], s[r][c]);
        dp[r][c] = fmaf(ov[r], vv[c], dp[r][c]);
      }
    }
  }
  const int q_off = a.Tk - a.Tq;
  const float sl2 = a.scale * kLog2e;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = ty + 16 * r;
    const int t = t0 + i;
    const float lse2 = lse_s[i] * kLog2e, dl = dl_s[i];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = tx + 16 * c;
      const int kp = k0 + j;
      const bool ok = t < a.Tq && kp < a.Tk && allowed(a, q_off + t, kp);
      const float p = ok ? exp2f(s[r][c] * sl2 - lse2) : 0.f;
      if (WRITE_P) ps[i * kPS + j] = p;
      dss[i * kPS + j] = p * (dp[r][c] - dl);
    }
  }
}

// the query tile's rows of q and do, and its lse and D, into shared memory
template <typename T, int NC>
__device__ __forceinline__ void load_queries(const Args& a, float* qs, float* dos, float* lse_s,
                                             float* dl_s, int b, int h, int t0) {
  const T* q = static_cast<const T*>(a.q) + b * a.sq[0] + h * a.sq[1];
  const T* dout = static_cast<const T*>(a.dout) + b * a.sdo[0] + h * a.sdo[1];
  load_rows<T, NC>(qs, q, a.sq[2], a.sq[3], t0, a.Tq, a.hd);
  load_rows<T, NC>(dos, dout, a.sdo[2], a.sdo[3], t0, a.Tq, a.hdv);
  if (threadIdx.x < kTile) {
    const int t = t0 + threadIdx.x;
    const long long row = (static_cast<long long>(b) * a.H + h) * a.Tq + t;
    lse_s[threadIdx.x] = t < a.Tq ? a.lse[row] : INFINITY;
    dl_s[threadIdx.x] = t < a.Tq ? a.delta[row] : 0.f;
  }
}

template <typename T, int NC>
__global__ void __launch_bounds__(kThreads, 1) flash_bwd_dkdv(const Args a) {
  constexpr int RS = Tile<NC>::RS;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;               // [kTile][RS]
  float* vs = ks + kTile * RS;    // [kTile][RS]
  float* qs = vs + kTile * RS;    // [kTile][RS]
  float* dos = qs + kTile * RS;   // [kTile][RS]
  float* ps = dos + kTile * RS;   // [kTile][kPS]
  float* dss = ps + kTile * kPS;  // [kTile][kPS]
  float* lse_s = dss + kTile * kPS;
  float* dl_s = lse_s + kTile;

  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int kvh = blockIdx.y % a.KV, b = blockIdx.y / a.KV;
  const int k0 = blockIdx.x * kTile;
  const int k1 = min(k0 + kTile, a.Tk) - 1;
  const int rep = a.H / a.KV;
  const int q_off = a.Tk - a.Tq;

  load_rows<T, NC>(ks, static_cast<const T*>(a.k) + b * a.sk[0] + kvh * a.sk[1], a.sk[2],
                   a.sk[3], k0, a.Tk, a.hd);
  load_rows<T, NC>(vs, static_cast<const T*>(a.v) + b * a.sv[0] + kvh * a.sv[1], a.sv[2],
                   a.sv[3], k0, a.Tk, a.hdv);

  // the queries (t = qpos - q_off) that may see keys [k0, k1]
  int qlo = 0, qhi = a.Tq - 1;
  if (a.causal) qlo = max(qlo, k0 - q_off);
  if (a.window > 0) qhi = min(qhi, k1 + a.window - 1 - q_off);
  if (a.chunk > 0) {
    qlo = max(qlo, floor_div(k0, a.chunk) * a.chunk - q_off);
    qhi = min(qhi, (floor_div(k1, a.chunk) + 1) * a.chunk - 1 - q_off);
  }

  // thread (ty, tx): keys ty + 16 r, dims tx + 16 c
  float dk[4][NC], dv[4][NC];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int c = 0; c < NC; ++c) dk[r][c] = dv[r][c] = 0.f;
  }

  if (qlo <= qhi) {
    for (int hh = 0; hh < rep; ++hh) {
      const int h = kvh * rep + hh;
      for (int t0 = (qlo / kTile) * kTile; t0 <= qhi; t0 += kTile) {
        __syncthreads();  // K/V written; the last tile's rows consumed
        load_queries<T, NC>(a, qs, dos, lse_s, dl_s, b, h, t0);
        __syncthreads();
        p_ds_tile<NC, true>(a, qs, dos, ks, vs, lse_s, dl_s, ps, dss, t0, k0, ty, tx);
        __syncthreads();
#pragma unroll 2
        for (int i = 0; i < kTile; ++i) {
          float p[4], ds[4], ov[NC], qv[NC];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            p[r] = ps[i * kPS + ty + 16 * r];
            ds[r] = dss[i * kPS + ty + 16 * r];
          }
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            ov[c] = dos[i * RS + tx + 16 * c];
            qv[c] = qs[i * RS + tx + 16 * c];
          }
#pragma unroll
          for (int r = 0; r < 4; ++r) {
#pragma unroll
            for (int c = 0; c < NC; ++c) {
              dv[r][c] = fmaf(p[r], ov[c], dv[r][c]);
              dk[r][c] = fmaf(ds[r], qv[c], dk[r][c]);
            }
          }
        }
      }
    }
  }

  T* dkp = static_cast<T*>(a.dk) + b * a.sdk[0] + kvh * a.sdk[1];
  T* dvp = static_cast<T*>(a.dv) + b * a.sdv[0] + kvh * a.sdv[1];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int kp = k0 + ty + 16 * r;
    if (kp >= a.Tk) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = tx + 16 * c;
      if (d < a.hd) dkp[kp * a.sdk[2] + d * a.sdk[3]] = from_f32<T>(dk[r][c] * a.scale);
      if (d < a.hdv) dvp[kp * a.sdv[2] + d * a.sdv[3]] = from_f32<T>(dv[r][c]);
    }
  }
}

template <typename T, int NC>
__global__ void __launch_bounds__(kThreads, 1) flash_bwd_dq(const Args a) {
  constexpr int RS = Tile<NC>::RS;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;
  float* vs = ks + kTile * RS;
  float* qs = vs + kTile * RS;
  float* dos = qs + kTile * RS;
  float* dss = dos + kTile * RS + kTile * kPS;  // the P slot stays unused
  float* lse_s = dss + kTile * kPS;
  float* dl_s = lse_s + kTile;

  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int h = blockIdx.y % a.H, b = blockIdx.y / a.H;
  const int kvh = h / (a.H / a.KV);
  const int t0 = blockIdx.x * kTile;
  const int t1 = min(t0 + kTile, a.Tq) - 1;
  const int q_off = a.Tk - a.Tq;

  load_queries<T, NC>(a, qs, dos, lse_s, dl_s, b, h, t0);

  // the keys the tile's queries may see
  const int qlo = q_off + t0, qhi = q_off + t1;
  int kmin = 0, kmax = a.Tk - 1;
  if (a.causal) kmax = min(kmax, qhi);
  if (a.window > 0) kmin = max(kmin, qlo - a.window + 1);
  if (a.chunk > 0) {
    kmin = max(kmin, floor_div(qlo, a.chunk) * a.chunk);
    kmax = min(kmax, floor_div(qhi, a.chunk) * a.chunk + a.chunk - 1);
  }

  // thread (ty, tx): queries ty + 16 r, dims tx + 16 c
  float dq[4][NC];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int c = 0; c < NC; ++c) dq[r][c] = 0.f;
  }

  const T* kb = static_cast<const T*>(a.k) + b * a.sk[0] + kvh * a.sk[1];
  const T* vb = static_cast<const T*>(a.v) + b * a.sv[0] + kvh * a.sv[1];
  if (kmin <= kmax) {
    for (int k0 = (kmin / kTile) * kTile; k0 <= kmax; k0 += kTile) {
      __syncthreads();  // the query rows written; the last key tile consumed
      load_rows<T, NC>(ks, kb, a.sk[2], a.sk[3], k0, a.Tk, a.hd);
      load_rows<T, NC>(vs, vb, a.sv[2], a.sv[3], k0, a.Tk, a.hdv);
      __syncthreads();
      p_ds_tile<NC, false>(a, qs, dos, ks, vs, lse_s, dl_s, nullptr, dss, t0, k0, ty, tx);
      __syncthreads();
#pragma unroll 2
      for (int j = 0; j < kTile; ++j) {
        float ds[4], kv[NC];
#pragma unroll
        for (int r = 0; r < 4; ++r) ds[r] = dss[(ty + 16 * r) * kPS + j];
#pragma unroll
        for (int c = 0; c < NC; ++c) kv[c] = ks[j * RS + tx + 16 * c];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
#pragma unroll
          for (int c = 0; c < NC; ++c) dq[r][c] = fmaf(ds[r], kv[c], dq[r][c]);
        }
      }
    }
  }

  T* dqp = static_cast<T*>(a.dq) + b * a.sdq[0] + h * a.sdq[1];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int t = t0 + ty + 16 * r;
    if (t >= a.Tq) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = tx + 16 * c;
      if (d < a.hd) dqp[t * a.sdq[2] + d * a.sdq[3]] = from_f32<T>(dq[r][c] * a.scale);
    }
  }
}

// ---------------------------------------------------------------------------
// the wgmma body (bf16 at the training head dims, rows 16-byte aligned)
// ---------------------------------------------------------------------------

constexpr int kStages = 3;           // the ring's slots
constexpr int kNwg = 2;              // warpgroups a block, 64 rows each
constexpr int kAhead = kStages - 1;  // tiles in flight beyond the one multiplied
constexpr int kWgRows = 64;          // a warpgroup's rows of a tile: wgmma's M

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 h) {
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// this thread's shared-memory writes (cp.async) made visible to wgmma,
// which reads through the async proxy
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until at most N committed groups of this warpgroup are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// pins registers a wgmma reads or writes in place between its fence and
// its wait, so that no other instruction touches them there
template <int N>
__device__ __forceinline__ void hold(float (&r)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n) {
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+f"(r[n][i])::"memory");
  }
}

template <int N>
__device__ __forceinline__ void hold(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n) {
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(r[n][i])::"memory");
  }
}

// A bf16 tile [R][W] (W % 8 == 0) in shared memory, in the core-matrix
// layout that wgmma reads without swizzle: 8 rows x 8 columns (16 bytes a
// row) contiguous, the matrices of an 8-row group side by side (128 bytes
// apart), row groups W * 16 bytes apart. Element (r, c) is at
// ((r / 8) * (W / 8) + c / 8) * 64 + (r % 8) * 8 + c % 8.
//
// An operand descriptor, no swizzle: the start address, lbo the bytes
// between core matrices along the product's depth (K), sbo along its M or
// N. A tile read with its columns as the depth (K-major) has lbo 128 and
// sbo W * 16; read with its rows as the depth (MN-major), lbo W * 16 and
// sbo 128.
__device__ __forceinline__ uint64_t wg_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32);
}

// rows [r0, r0 + R) of one (batch, head) slice into a [R][W] tile by
// cp.async, 16 bytes a thread, zeros past n_rows. Eight neighbouring
// threads fill one core matrix (128 contiguous bytes of shared memory);
// a warp reads 64 contiguous bytes of each of 8 rows.
template <int R, int W, int NT>
__device__ __forceinline__ void cp_tile(__nv_bfloat16* dst, const __nv_bfloat16* base,
                                        long long st, int r0, int n_rows) {
  constexpr int C8 = W / 8;
#pragma unroll
  for (int i = 0; i < (R * C8 + NT - 1) / NT; ++i) {
    const int e = threadIdx.x + i * NT;
    if (R * C8 % NT != 0 && e >= R * C8) break;
    const int r8 = e & 7, c8 = (e >> 3) % C8, rg = (e >> 3) / C8;
    const int r = r0 + rg * 8 + r8;
    const bool ok = r < n_rows;
    cp_async16(dst + (rg * C8 + c8) * 64 + r8 * 8, ok ? base + r * st + c8 * 8 : base,
               ok ? 16 : 0);
  }
}

// the log-sum-exps and the D of rows [t0, t0 + R) of one (batch, head)
// into lse_s / dl_s by cp.async, 4 bytes a thread (2 R threads), zeros past
// Tq (those rows are masked)
template <int R>
__device__ __forceinline__ void cp_stats(float* lse_s, float* dl_s, const float* lse,
                                         const float* dl, int t0, int Tq) {
  const int i = threadIdx.x;
  if (i >= 2 * R) return;
  const int r = i % R, t = t0 + r;
  const bool ok = t < Tq;
  const float* src = i < R ? lse : dl;
  cp_async4((i < R ? lse_s : dl_s) + r, ok ? src + t : src, ok ? 4 : 0);
}

#define WG_D(j) "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])

// d (64 x N fp32, in the accumulator layout) = (accumulate ? d : 0) + A B,
// A and B bf16 in shared memory, both K-major
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 8][4], uint64_t da, uint64_t db,
                                         int accumulate);

// d (64 x N fp32) += A B, A the bf16 fragments in registers (the mma.sync
// A layout, a warp's 16 rows), B bf16 in shared memory, MN-major
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 8][4], const uint32_t (&a)[4],
                                         uint64_t db);

template <>
__device__ __forceinline__ void wgmma_ss<32>(float (&d)[4][4], uint64_t da, uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : WG_D(0), WG_D(1), WG_D(2), WG_D(3)
      : "l"(da), "l"(db), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[8][4], uint64_t da, uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : WG_D(0), WG_D(1), WG_D(2), WG_D(3), WG_D(4), WG_D(5), WG_D(6), WG_D(7)
      : "l"(da), "l"(db), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[8][4], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WG_D(0), WG_D(1), WG_D(2), WG_D(3), WG_D(4), WG_D(5), WG_D(6), WG_D(7)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<80>(float (&d)[10][4], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : WG_D(0), WG_D(1), WG_D(2), WG_D(3), WG_D(4), WG_D(5), WG_D(6), WG_D(7),
        WG_D(8), WG_D(9)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<96>(float (&d)[12][4], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
      : WG_D(0), WG_D(1), WG_D(2), WG_D(3), WG_D(4), WG_D(5), WG_D(6), WG_D(7),
        WG_D(8), WG_D(9), WG_D(10), WG_D(11)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[16][4], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : WG_D(0), WG_D(1), WG_D(2), WG_D(3), WG_D(4), WG_D(5), WG_D(6), WG_D(7),
        WG_D(8), WG_D(9), WG_D(10), WG_D(11), WG_D(12), WG_D(13), WG_D(14), WG_D(15)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<160>(float (&d)[20][4], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %85, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79}, "
      "{%80, %81, %82, %83}, %84, p, 1, 1, 1;\n}\n"
      : WG_D(0), WG_D(1), WG_D(2), WG_D(3), WG_D(4), WG_D(5), WG_D(6), WG_D(7),
        WG_D(8), WG_D(9), WG_D(10), WG_D(11), WG_D(12), WG_D(13), WG_D(14), WG_D(15),
        WG_D(16), WG_D(17), WG_D(18), WG_D(19)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef WG_D

// d (64 x N) = a b^T over D columns: a a [64][D] tile, b a [N][D] tile
template <int N, int D>
__device__ __forceinline__ void wg_rows_by_rows(float (&d)[N / 8][4], const __nv_bfloat16* a,
                                                const __nv_bfloat16* b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    wgmma_ss<N>(d, wg_desc(a + kk * 128, 128, D * 16), wg_desc(b + kk * 128, 128, D * 16), kk > 0);
  }
}

// d (64 x W) += f b: f the A fragments of a 64 x (16 KF) product, 16
// columns each, b a [16 KF][W] tile
template <int W, int KF>
__device__ __forceinline__ void wg_frags_by_rows(float (&d)[W / 8][4], const uint32_t (&f)[KF][4],
                                                 const __nv_bfloat16* b) {
#pragma unroll
  for (int kk = 0; kk < KF; ++kk) wgmma_rs<W>(d, f[kk], wg_desc(b + kk * 16 * W, W * 16, 128));
}

// the A fragments of the 16-column slices of a 64 x (8 NB) tile held in
// the accumulator layout (the A fragment of wgmma and mma.sync holds the
// same elements as two 8-wide accumulator tiles), rounded to bf16 once
template <int NB>
__device__ __forceinline__ void to_frags(uint32_t (&f)[NB / 2][4], const float (&x)[NB][4]) {
#pragma unroll
  for (int kk = 0; kk < NB / 2; ++kk) {
    f[kk][0] = bits(__floats2bfloat162_rn(x[2 * kk][0], x[2 * kk][1]));
    f[kk][1] = bits(__floats2bfloat162_rn(x[2 * kk][2], x[2 * kk][3]));
    f[kk][2] = bits(__floats2bfloat162_rn(x[2 * kk + 1][0], x[2 * kk + 1][1]));
    f[kk][3] = bits(__floats2bfloat162_rn(x[2 * kk + 1][2], x[2 * kk + 1][3]));
  }
}

// whether every (query, key) pair of queries [t_lo, t_hi] and keys
// [k_lo, k_hi] lies inside the rows and passes the masks
__device__ __forceinline__ bool tile_whole(const Args& a, int t_lo, int t_hi, int k_lo, int k_hi) {
  if (t_hi >= a.Tq || k_hi >= a.Tk) return false;
  const int q_off = a.Tk - a.Tq;
  const int p_lo = q_off + t_lo, p_hi = q_off + t_hi;
  if (a.causal && k_hi > p_lo) return false;
  if (a.window > 0 && k_lo <= p_hi - a.window) return false;
  if (a.chunk > 0) {
    const int c = floor_div(k_lo, a.chunk);
    if (floor_div(k_hi, a.chunk) != c || floor_div(p_lo, a.chunk) != c ||
        floor_div(p_hi, a.chunk) != c)
      return false;
  }
  return true;
}

// 2^x in one MUFU instruction (flushes results below 2^-126 to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// s <- P = exp(s * scale - lse) on a warp's 16 rows of a wgmma tile, NB
// 8-wide column tiles, the rows keys and the columns queries (TRANS: the
// dK/dV kernel) or the other way round; lse_s holds the log-sum-exps of the
// statistics' tile (unscaled), row_l the first row's index there (queries
// as rows). MASK false for a whole tile (tile_whole): no mask is read.
template <bool TRANS, bool MASK, int NB>
__device__ __forceinline__ void probs_tile(const Args& a, float (&s)[NB][4], const float* lse_s,
                                           int row_g, int row_l, int col_g, int lane) {
  const int g = lane >> 2, tig = lane & 3;
  const int q_off = a.Tk - a.Tq;
  const float sl2 = a.scale * kLog2e;
#pragma unroll
  for (int n = 0; n < NB; ++n) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int rr = g + (i >> 1) * 8;
      const int cl = n * 8 + tig * 2 + (i & 1);
      const int ql = TRANS ? cl : row_l + rr;
      bool ok = true;
      if (MASK) {
        const int t = TRANS ? col_g + cl : row_g + rr;
        const int kp = TRANS ? row_g + rr : col_g + cl;
        ok = t < a.Tq && kp < a.Tk && allowed(a, q_off + t, kp);
      }
      s[n][i] = ok ? ex2(fmaf(s[n][i], sl2, -lse_s[ql] * kLog2e)) : 0.f;
    }
  }
}

template <bool TRANS, int NB>
__device__ __forceinline__ void probs(const Args& a, float (&s)[NB][4], const float* lse_s,
                                      int row_g, int row_l, int col_g, bool whole, int lane) {
  if (whole) {
    probs_tile<TRANS, false, NB>(a, s, lse_s, row_g, row_l, col_g, lane);
  } else {
    probs_tile<TRANS, true, NB>(a, s, lse_s, row_g, row_l, col_g, lane);
  }
}

// dp <- dS = P * (dp - D) in the same layout (P is 0 where masked)
template <bool TRANS, int NB>
__device__ __forceinline__ void dscores(const float (&p)[NB][4], float (&dp)[NB][4],
                                        const float* dl_s, int row_l, int lane) {
  const int g = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int n = 0; n < NB; ++n) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int ql = TRANS ? n * 8 + tig * 2 + (i & 1) : row_l + g + (i >> 1) * 8;
      dp[n][i] = p[n][i] * (dp[n][i] - dl_s[ql]);
    }
  }
}

// a warp's 16 rows of a 64 x W accumulator, times mul, to rows r0.. of a
// (batch, head) slice with unit column stride, two bf16 a store
template <int W>
__device__ __forceinline__ void store_acc(const float (&o)[W / 8][4], __nv_bfloat16* base,
                                          long long st, int r0, int n_rows, float mul, int lane) {
  const int g = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + g + half * 8;
    if (r >= n_rows) continue;
#pragma unroll
    for (int n = 0; n < W / 8; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(base + r * st + n * 8 + tig * 2) =
          __floats2bfloat162_rn(o[n][2 * half] * mul, o[n][2 * half + 1] * mul);
    }
  }
}

template <int HD, int HDV, int BQ>
struct WgDkdv {
  static constexpr int kThreads = kNwg * 128;
  static constexpr int kKeys = kNwg * kWgRows;                     // keys a block
  static constexpr int kStage = 2 * BQ * (HD + HDV) + 2 * 4 * BQ;  // bytes: q, dO, lse, D
  static constexpr size_t kBytes = 2 * kKeys * (HD + HDV) + kStages * kStage;
  static_assert(HD % 16 == 0 && HDV % 16 == 0 && BQ % 16 == 0, "wgmma depth is 16");
  static_assert(kStage % 128 == 0, "ring slots 128-byte aligned");
  static_assert(kBytes <= kMaxSmem, "tiles exceed a block's shared memory");
};

// dK and dV of a block's kNwg x 64 keys (batch and KV head bx, key tile
// by): each warpgroup's 64 keys against every BQ-query tile of the GQA
// group that can see them, walked through the ring
template <int HD, int HDV, int BQ>
__device__ __forceinline__ void dkdv_wg(const Args& a, unsigned char* wg_smem, int bx, int by) {
  using L = WgDkdv<HD, HDV, BQ>;
  constexpr int NT = L::kThreads;
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(wg_smem);  // [kKeys][HD]
  __nv_bfloat16* vs = ks + L::kKeys * HD;                          // [kKeys][HDV]
  unsigned char* ring = reinterpret_cast<unsigned char*>(vs + L::kKeys * HDV);

  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const int wg = threadIdx.x >> 7;
  const int kvh = bx % a.KV, b = bx / a.KV;
  const int k0 = by * L::kKeys;
  const int k1 = min(k0 + L::kKeys, a.Tk) - 1;
  const int rep = a.H / a.KV;
  const int q_off = a.Tk - a.Tq;

  int qlo = 0, qhi = a.Tq - 1;
  if (a.causal) qlo = max(qlo, k0 - q_off);
  if (a.window > 0) qhi = min(qhi, k1 + a.window - 1 - q_off);
  if (a.chunk > 0) {
    qlo = max(qlo, floor_div(k0, a.chunk) * a.chunk - q_off);
    qhi = min(qhi, (floor_div(k1, a.chunk) + 1) * a.chunk - 1 - q_off);
  }
  const int tf = (qlo / BQ) * BQ;
  const int nqt = qlo <= qhi ? (qhi - tf) / BQ + 1 : 0;
  const int steps = rep * nqt;  // (head, query tile) pairs

  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(a.q) + b * a.sq[0];
  const __nv_bfloat16* dout = static_cast<const __nv_bfloat16*>(a.dout) + b * a.sdo[0];
  cp_tile<L::kKeys, HD, NT>(
      ks, static_cast<const __nv_bfloat16*>(a.k) + b * a.sk[0] + kvh * a.sk[1], a.sk[2], k0, a.Tk);
  cp_tile<L::kKeys, HDV, NT>(
      vs, static_cast<const __nv_bfloat16*>(a.v) + b * a.sv[0] + kvh * a.sv[1], a.sv[2], k0, a.Tk);
  cp_async_commit();

  auto load = [&](int step) {
    const int h = kvh * rep + step / nqt, t0 = tf + (step % nqt) * BQ;
    __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(ring + (step % kStages) * L::kStage);
    __nv_bfloat16* dos = qs + BQ * HD;
    float* lse_s = reinterpret_cast<float*>(dos + BQ * HDV);
    const long long row = (static_cast<long long>(b) * a.H + h) * a.Tq;
    cp_tile<BQ, HD, NT>(qs, q + h * a.sq[1], a.sq[2], t0, a.Tq);
    cp_tile<BQ, HDV, NT>(dos, dout + h * a.sdo[1], a.sdo[2], t0, a.Tq);
    cp_stats<BQ>(lse_s, lse_s + BQ, a.lse + row, a.delta + row, t0, a.Tq);
  };
#pragma unroll
  for (int i = 0; i < kAhead; ++i) {
    if (i < steps) load(i);
    cp_async_commit();
  }

  float dk[HD / 8][4], dv[HDV / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) dk[n][0] = dk[n][1] = dk[n][2] = dk[n][3] = 0.f;
#pragma unroll
  for (int n = 0; n < HDV / 8; ++n) dv[n][0] = dv[n][1] = dv[n][2] = dv[n][3] = 0.f;
  hold(dk);
  hold(dv);
  const __nv_bfloat16* kw = ks + wg * kWgRows * HD;  // this warpgroup's keys
  const __nv_bfloat16* vw = vs + wg * kWgRows * HDV;
  const int kr = k0 + wg * kWgRows;

  // a step's two halves: S^T and dP^T, P and dV += P^T dO (start); dS and
  // dK += dS^T Q (finish). P^T's exponentials run while dP^T is in flight.
  float st[BQ / 8][4], dpt[BQ / 8][4];
  uint32_t pf[BQ / 16][4], sf[BQ / 16][4];
  auto slot = [&](int step) {
    return reinterpret_cast<const __nv_bfloat16*>(ring + (step % kStages) * L::kStage);
  };
  auto start = [&](int step) {
    const int t0 = tf + (step % nqt) * BQ;
    const __nv_bfloat16* qs = slot(step);
    const __nv_bfloat16* dos = qs + BQ * HD;
    const float* lse_s = reinterpret_cast<const float*>(dos + BQ * HDV);
    wgmma_fence();
    wg_rows_by_rows<BQ, HD>(st, kw, qs);  // S^T = K Q^T
    wgmma_commit();
    wg_rows_by_rows<BQ, HDV>(dpt, vw, dos);  // dP^T = V dO^T
    wgmma_commit();
    wgmma_wait<1>();
    hold(st);
    probs<true, BQ / 8>(a, st, lse_s, kr + warp * 16, 0, t0,
                        tile_whole(a, t0, t0 + BQ - 1, kr, kr + kWgRows - 1), lane);
    to_frags<BQ / 8>(pf, st);
    hold(pf);
    wgmma_fence();
    wg_frags_by_rows<HDV, BQ / 16>(dv, pf, dos);  // dV += P^T dO
    wgmma_commit();
  };
  auto finish = [&](int step) {
    const __nv_bfloat16* qs = slot(step);
    const float* dl_s = reinterpret_cast<const float*>(qs + BQ * (HD + HDV)) + BQ;
    wgmma_wait<1>();  // dP^T (dV's product may still run)
    hold(dpt);
    dscores<true, BQ / 8>(st, dpt, dl_s, 0, lane);
    to_frags<BQ / 8>(sf, dpt);
    hold(sf);
    wgmma_fence();
    wg_frags_by_rows<HD, BQ / 16>(dk, sf, qs);  // dK += dS^T Q
    wgmma_commit();
    wgmma_wait<0>();
    hold(pf);
    hold(sf);
    hold(dv);
    hold(dk);
  };

  for (int step = 0; step < steps; ++step) {
    cp_async_wait<kAhead - 1>();  // the block's fixed tiles and this step's slot landed
    fence_async_smem();
    __syncthreads();  // every thread's copies in; the slot refilled below consumed
    if (step + kAhead < steps) load(step + kAhead);
    cp_async_commit();
    start(step);
    finish(step);
  }
  cp_async_wait<0>();

  store_acc<HD>(dk, static_cast<__nv_bfloat16*>(a.dk) + b * a.sdk[0] + kvh * a.sdk[1], a.sdk[2],
                kr + warp * 16, a.Tk, a.scale, lane);
  store_acc<HDV>(dv, static_cast<__nv_bfloat16*>(a.dv) + b * a.sdv[0] + kvh * a.sdv[1], a.sdv[2],
                 kr + warp * 16, a.Tk, 1.f, lane);
}

template <int HD, int HDV>
struct WgDq {
  static constexpr int kThreads = kNwg * 128;
  static constexpr int kRows = kNwg * kWgRows;              // queries a block
  static constexpr int kStage = 2 * kTile * (HD + HDV);  // bytes: K, V
  static constexpr int kFixed = 2 * kRows * (HD + HDV) + 2 * 4 * kRows;  // q, dO, lse, D
  static constexpr size_t kBytes = kFixed + kStages * kStage;
  static_assert(kFixed % 128 == 0 && kStage % 128 == 0, "ring slots 128-byte aligned");
  static_assert(kBytes <= kMaxSmem, "tiles exceed a block's shared memory");
};

// dQ of a block's kNwg x 64 queries (batch and head bx, query tile by):
// each warpgroup's 64 queries against every 64-key tile they can see,
// walked through the ring
template <int HD, int HDV>
__device__ __forceinline__ void dq_wg(const Args& a, unsigned char* wg_smem, int bx, int by) {
  using L = WgDq<HD, HDV>;
  constexpr int NT = L::kThreads;
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(wg_smem);  // [kRows][HD]
  __nv_bfloat16* dos = qs + L::kRows * HD;                         // [kRows][HDV]
  float* lse_s = reinterpret_cast<float*>(dos + L::kRows * HDV);
  float* dl_s = lse_s + L::kRows;
  unsigned char* ring = wg_smem + L::kFixed;

  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const int wg = threadIdx.x >> 7;
  const int h = bx % a.H, b = bx / a.H;
  const int kvh = h / (a.H / a.KV);
  const int t0 = by * L::kRows;
  const int t1 = min(t0 + L::kRows, a.Tq) - 1;
  const int q_off = a.Tk - a.Tq;

  const int qlo = q_off + t0, qhi = q_off + t1;
  int kmin = 0, kmax = a.Tk - 1;
  if (a.causal) kmax = min(kmax, qhi);
  if (a.window > 0) kmin = max(kmin, qlo - a.window + 1);
  if (a.chunk > 0) {
    kmin = max(kmin, floor_div(qlo, a.chunk) * a.chunk);
    kmax = min(kmax, floor_div(qhi, a.chunk) * a.chunk + a.chunk - 1);
  }
  const int kf = (kmin / kTile) * kTile;
  const int steps = kmin <= kmax ? (kmax - kf) / kTile + 1 : 0;

  const long long row = (static_cast<long long>(b) * a.H + h) * a.Tq;
  cp_tile<L::kRows, HD, NT>(
      qs, static_cast<const __nv_bfloat16*>(a.q) + b * a.sq[0] + h * a.sq[1], a.sq[2], t0, a.Tq);
  cp_tile<L::kRows, HDV, NT>(
      dos, static_cast<const __nv_bfloat16*>(a.dout) + b * a.sdo[0] + h * a.sdo[1], a.sdo[2], t0,
      a.Tq);
  cp_stats<L::kRows>(lse_s, dl_s, a.lse + row, a.delta + row, t0, a.Tq);
  cp_async_commit();

  const __nv_bfloat16* kb = static_cast<const __nv_bfloat16*>(a.k) + b * a.sk[0] + kvh * a.sk[1];
  const __nv_bfloat16* vb = static_cast<const __nv_bfloat16*>(a.v) + b * a.sv[0] + kvh * a.sv[1];
  auto load = [&](int step) {
    __nv_bfloat16* kst = reinterpret_cast<__nv_bfloat16*>(ring + (step % kStages) * L::kStage);
    cp_tile<kTile, HD, NT>(kst, kb, a.sk[2], kf + step * kTile, a.Tk);
    cp_tile<kTile, HDV, NT>(kst + kTile * HD, vb, a.sv[2], kf + step * kTile, a.Tk);
  };
#pragma unroll
  for (int i = 0; i < kAhead; ++i) {
    if (i < steps) load(i);
    cp_async_commit();
  }

  float dq[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;
  hold(dq);
  const __nv_bfloat16* qw = qs + wg * kWgRows * HD;  // this warpgroup's queries
  const __nv_bfloat16* dow = dos + wg * kWgRows * HDV;
  const int tr = t0 + wg * kWgRows;

  // a step's two halves: S and dP issued (start); P, dS and dQ += dS K
  // (finish), P's exponentials while dP is in flight
  float sc[kTile / 8][4], dpc[kTile / 8][4];
  uint32_t sf[kTile / 16][4];
  auto slot = [&](int step) {
    return reinterpret_cast<const __nv_bfloat16*>(ring + (step % kStages) * L::kStage);
  };
  auto start = [&](int step) {
    const __nv_bfloat16* kst = slot(step);
    wgmma_fence();
    wg_rows_by_rows<kTile, HD>(sc, qw, kst);  // S = Q K^T
    wgmma_commit();
    wg_rows_by_rows<kTile, HDV>(dpc, dow, kst + kTile * HD);  // dP = dO V^T
    wgmma_commit();
  };
  auto finish = [&](int step) {
    const int k0 = kf + step * kTile;
    const __nv_bfloat16* kst = slot(step);
    wgmma_wait<1>();
    hold(sc);
    probs<false, kTile / 8>(a, sc, lse_s, tr + warp * 16, wg * kWgRows + warp * 16, k0,
                            tile_whole(a, tr, tr + kWgRows - 1, k0, k0 + kTile - 1), lane);
    wgmma_wait<0>();
    hold(dpc);
    dscores<false, kTile / 8>(sc, dpc, dl_s, wg * kWgRows + warp * 16, lane);
    to_frags<kTile / 8>(sf, dpc);
    hold(sf);
    wgmma_fence();
    wg_frags_by_rows<HD, kTile / 16>(dq, sf, kst);  // dQ += dS K
    wgmma_commit();
    wgmma_wait<0>();
    hold(sf);
    hold(dq);
  };

  for (int step = 0; step < steps; ++step) {
    cp_async_wait<kAhead - 1>();  // the block's fixed tiles and this step's slot landed
    fence_async_smem();
    __syncthreads();  // every thread's copies in; the slot refilled below consumed
    if (step + kAhead < steps) load(step + kAhead);
    cp_async_commit();
    start(step);
    finish(step);
  }
  cp_async_wait<0>();

  store_acc<HD>(dq, static_cast<__nv_bfloat16*>(a.dq) + b * a.sdq[0] + h * a.sdq[1], a.sdq[2],
                tr + warp * 16, a.Tq, a.scale, lane);
}

// Both passes in one launch, so that neither waits for the other's last
// blocks: the first n_dkdv blocks take dK/dV, key tile by key tile (tile 0,
// the longest causal walk, first), the rest dQ, from the last query tile
// (the longest walk) down. They share nothing but D.
template <int HD, int HDV, int BQ>
__global__ void __launch_bounds__(kNwg * 128, 1) flash_bwd_wg(const Args a, int n_dkdv) {
  extern __shared__ __align__(128) unsigned char wg_smem[];
  const int i = blockIdx.x;
  if (i < n_dkdv) {
    dkdv_wg<HD, HDV, BQ>(a, wg_smem, i % (a.B * a.KV), i / (a.B * a.KV));
  } else {
    const int j = i - n_dkdv;
    const int n_qt = (a.Tq + WgDq<HD, HDV>::kRows - 1) / WgDq<HD, HDV>::kRows;
    dq_wg<HD, HDV>(a, wg_smem, j % (a.B * a.H), n_qt - 1 - j / (a.B * a.H));
  }
}

// D = rowsum(dO * O) for the wgmma body (o's and dout's rows 16-byte
// aligned): 8 threads a row, 16 bytes each at a time, so that a warp reads
// each of its 4 rows' bytes side by side in either layout, (B, H, T, hdv)
// or (B, T, H, hdv); the 8 partial sums meet by shuffles in a fixed order
template <int HDV>
__global__ void __launch_bounds__(kThreads) flash_bwd_delta_vec(const Args a) {
  const long long row = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) >> 3;
  const int part = threadIdx.x & 7;
  const bool ok = row < static_cast<long long>(a.B) * a.H * a.Tq;
  float s = 0.f;
  if (ok) {
    const int t = static_cast<int>(row % a.Tq);
    const int h = static_cast<int>((row / a.Tq) % a.H);
    const int b = static_cast<int>(row / (static_cast<long long>(a.Tq) * a.H));
    const uint4* o = reinterpret_cast<const uint4*>(static_cast<const __nv_bfloat16*>(a.o) +
                                                    b * a.so[0] + h * a.so[1] + t * a.so[2]);
    const uint4* dout = reinterpret_cast<const uint4*>(
        static_cast<const __nv_bfloat16*>(a.dout) + b * a.sdo[0] + h * a.sdo[1] + t * a.sdo[2]);
#pragma unroll
    for (int c = part; c < HDV / 8; c += 8) {
      const uint4 x = __ldg(o + c), y = __ldg(dout + c);
      const __nv_bfloat162* xp = reinterpret_cast<const __nv_bfloat162*>(&x);
      const __nv_bfloat162* yp = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 xf = __bfloat1622float2(xp[j]), yf = __bfloat1622float2(yp[j]);
        s = fmaf(xf.x, yf.x, s);
        s = fmaf(xf.y, yf.y, s);
      }
    }
  }
  s += __shfl_xor_sync(0xffffffffu, s, 1);
  s += __shfl_xor_sync(0xffffffffu, s, 2);
  s += __shfl_xor_sync(0xffffffffu, s, 4);
  if (ok && part == 0) a.delta[row] = s;
}

template <typename T>
cudaError_t launch_delta(const Args& a, cudaStream_t s) {
  const long long rows = static_cast<long long>(a.B) * a.H * a.Tq;
  if (rows > 0) {
    flash_bwd_delta<T><<<static_cast<unsigned int>((rows + kThreads / 32 - 1) / (kThreads / 32)),
                         kThreads, 0, s>>>(a);
  }
  return cudaGetLastError();
}

template <typename T, int NC>
cudaError_t launch_simt(const Args& a, cudaStream_t s) {
  const size_t smem = Tile<NC>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv<T, NC>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dq<T, NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  err = launch_delta<T>(a, s);
  if (err != cudaSuccess) return err;
  if (a.Tk > 0) {  // with Tq = 0 the blocks write zeros
    flash_bwd_dkdv<T, NC><<<dim3((a.Tk + kTile - 1) / kTile, a.B * a.KV), kThreads, smem, s>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (a.Tq > 0) {  // with Tk = 0 the blocks write zeros
    flash_bwd_dq<T, NC><<<dim3((a.Tq + kTile - 1) / kTile, a.B * a.H), kThreads, smem, s>>>(a);
  }
  return cudaGetLastError();
}

template <int HD, int HDV, int BQ>
cudaError_t launch_wg(const Args& a, cudaStream_t s) {
  using D1 = WgDkdv<HD, HDV, BQ>;
  using D2 = WgDq<HD, HDV>;
  constexpr size_t smem = D1::kBytes > D2::kBytes ? D1::kBytes : D2::kBytes;
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_wg<HD, HDV, BQ>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const long long rows = static_cast<long long>(a.B) * a.H * a.Tq;
  if (rows > 0) {
    flash_bwd_delta_vec<HDV>
        <<<static_cast<unsigned int>((8 * rows + kThreads - 1) / kThreads), kThreads, 0, s>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  // with Tq = 0 the dK/dV blocks write zeros, with Tk = 0 the dQ blocks
  const long long n_dkdv =
      static_cast<long long>(a.B) * a.KV * ((a.Tk + D1::kKeys - 1) / D1::kKeys);
  const long long n_dq = static_cast<long long>(a.B) * a.H * ((a.Tq + D2::kRows - 1) / D2::kRows);
  if (n_dkdv + n_dq > 0) {
    flash_bwd_wg<HD, HDV, BQ><<<static_cast<unsigned int>(n_dkdv + n_dq), kNwg * 128, smem, s>>>(
        a, static_cast<int>(n_dkdv));
  }
  return cudaGetLastError();
}

// the wgmma body, at the training head dims only (one kernel each; hd 160
// walks 32-query dK/dV steps, its registers' limit)
cudaError_t launch_wgmma(const Args& a, cudaStream_t s) {
  if (!a.vec) return cudaErrorInvalidValue;
  if (a.hd == 64 && a.hdv == 64) return launch_wg<64, 64, 64>(a, s);
  if (a.hd == 80 && a.hdv == 80) return launch_wg<80, 80, 64>(a, s);
  if (a.hd == 96 && a.hdv == 64) return launch_wg<96, 64, 64>(a, s);
  if (a.hd == 128 && a.hdv == 128) return launch_wg<128, 128, 64>(a, s);
  if (a.hd == 160 && a.hdv == 160) return launch_wg<160, 160, 32>(a, s);
  return cudaErrorInvalidValue;
}

// the CUDA-core body at width = NC * 16 (hd padded with zero columns)
template <typename T>
cudaError_t launch_simt_width(const Args& a, int width, cudaStream_t s) {
  switch (width) {
    case 64: return launch_simt<T, 4>(a, s);
    case 128: return launch_simt<T, 8>(a, s);
    case 160: return launch_simt<T, 10>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, for q, k, v, o, dout, dq, dk and dv
// alike. lse: the forward's (B,H,Tq) fp32 log-sum-exps; delta: a (B,H,Tq)
// fp32 scratch. Strides are in elements, ordered (batch, head, t, dim);
// hd <= 160 and hdv <= hd. body: 0 = CUDA cores, 1 = wgmma; width: the
// head dim the body pads hd to (flash_attention.bwd_body picks both). vec:
// q's, k's, v's, o's and dout's rows may be read 16 bytes at a time (each
// with unit stride along its head dim, its other strides, its width and its
// base 16-byte aligned); the wgmma body needs it.
extern "C" int cobra_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o, const void* dout,
    const void* lse, void* delta, void* dq, void* dk, void* dv, int B, int H, int KV, int Tq,
    int Tk, int hd, int hdv, const long long* sq, const long long* sk, const long long* sv,
    const long long* so, const long long* sdo, const long long* sdq, const long long* sdk,
    const long long* sdv, int causal, int window, int chunk, float scale, int dtype, int body,
    int width, int vec, void* stream) {
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.dout = dout;
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<float*>(delta);
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.B = B;
  a.H = H;
  a.KV = KV;
  a.Tq = Tq;
  a.Tk = Tk;
  a.hd = hd;
  a.hdv = hdv;
  for (int i = 0; i < 4; ++i) {
    a.sq[i] = sq[i];
    a.sk[i] = sk[i];
    a.sv[i] = sv[i];
    a.so[i] = so[i];
    a.sdo[i] = sdo[i];
    a.sdq[i] = sdq[i];
    a.sdk[i] = sdk[i];
    a.sdv[i] = sdv[i];
  }
  a.causal = causal;
  a.window = window;
  a.chunk = chunk;
  a.scale = scale;
  a.vec = vec;
  if (B == 0 || H == 0 || (Tq == 0 && Tk == 0)) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (body == 1 && dtype == 1) {
    err = launch_wgmma(a, s);
  } else if (body == 0 && dtype == 0) {
    err = launch_simt_width<float>(a, width, s);
  } else if (body == 0 && dtype == 1) {
    err = launch_simt_width<__nv_bfloat16>(a, width, s);
  }
  return static_cast<int>(err);
}
