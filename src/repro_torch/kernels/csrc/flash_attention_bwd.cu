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
// Deterministic, with no float atomics: every sum runs in one thread in a
// fixed order, so two calls on the same inputs give the same bits.
//   * flash_bwd_delta: D, one warp a row.
//   * dK/dV: one block per (batch, KV head, 64-key tile). K and V stay in
//     shared memory while the block walks the query tiles that can see its
//     keys, for every head of the GQA group in turn, and holds dK and dV in
//     registers; it is the only writer of its rows of dk and dv (zeros for
//     keys no query sees).
//   * dQ: one block per (batch, head, 64-query tile), walking the key tiles
//     its queries can see; the only writer of its rows of dq.
//   The dQ blocks recompute S and dP that the dK/dV blocks computed (seven
//   tile products against the forward's two).
//
// What bounds it: operations, about 2.5x the forward's tile products (5
// against 2). Two bodies:
//
// *_mma, for bf16 inputs with head dims up to 128 (the training path): the
// products go through mma.sync.m16n8k16 (bf16 in, fp32 sums), with the
// forward's fragment layouts. A warp owns 16 rows of a 64 x 64 tile pair:
// in the dK/dV kernel its 16 keys, so S^T = K Q^T and dP^T = V dO^T come
// out in registers with the keys as rows, and P^T and dS^T are the A
// operands of dV += P^T dO and dK += dS^T Q straight from those registers
// (as the forward's P feeds P.V); in the dQ kernel its 16 queries, dS the A
// operand of dQ += dS K. Tiles are bf16 in shared memory, rows padded
// against bank conflicts, read by ldmatrix (.trans for the second operand
// of the P and dS products); loads are 16 bytes a thread where the rows
// allow. P and dS are split into bf16 hi + lo (two products each), so
// their rounding stays near 2^-16, not the 2^-9 of one bf16 rounding.
//
// the CUDA-core body (flash_bwd_dkdv / flash_bwd_dq), for fp32 inputs and
// for bf16 head dims past 128 (stablelm's 160, whose two fp32 accumulator
// tiles would not fit the mma body's registers): fp32 throughout; a thread
// owns a 4 x 4 block of the 64 x 64 score tile (or 4 keys / queries x
// hd/16 dims of an output tile), reads its operands from shared memory
// with rows padded to an odd stride (no bank conflicts) and does 16 fused
// multiply-adds per two to four shared loads.
//
// Neither uses wgmma or TMA yet (ROADMAP B0).
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
  int vec;  // q, k, v and dout rows 16-byte aligned (the tensor-core body's loads)
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
// the tensor-core body (bf16 inputs, head dims up to 128)
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// c (16x8 fp32) += a (16x16 bf16, row) * b (16x8 bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 h) {
  return *reinterpret_cast<uint32_t*>(&h);
}

// (x0, x1) = hi + lo + O(2^-17 |x|), both halves packed bf16 pairs (x0 in
// the low 16 bits, as the mma fragments order them)
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
}

constexpr int kWarpsTc = 4;                  // 16 rows a warp: 64-row tiles
constexpr int kThreadsTc = kWarpsTc * 32;
constexpr int KN = kTile / 8;                // 8-wide score tiles of a row block

template <int KS>
struct MmaTile {
  static constexpr int HDP = KS * 16;   // head dims padded to the mma depth (zeros)
  static constexpr int ROW = HDP + 8;   // bf16 row stride: ldmatrix without bank conflicts
  static constexpr int NT = HDP / 8;    // 8-wide output column tiles
  static constexpr size_t kBytes =
      4 * sizeof(__nv_bfloat16) * kTile * ROW + 2 * sizeof(float) * kTile;
};

// s (16 x 64: this warp's 16 rows of a, against the 64 rows of b) = a b^T
// over KS 16-deep slices, both [row][dim] bf16 tiles in shared memory
template <int KS>
__device__ __forceinline__ void rows_by_rows(float (&s)[KN][4], const __nv_bfloat16* a,
                                             const __nv_bfloat16* b, int lane) {
  constexpr int ROW = MmaTile<KS>::ROW;
#pragma unroll
  for (int n = 0; n < KN; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
  const int arow = lane & 15, acol = (lane >> 4) * 8;
  const int brow = (lane & 7) + (lane >> 4) * 8, bcol = ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    uint32_t af[4];
    ldmatrix_x4(af, a + arow * ROW + kk * 16 + acol);
#pragma unroll
    for (int np = 0; np < KN / 2; ++np) {
      uint32_t bf[4];
      ldmatrix_x4(bf, b + (np * 16 + brow) * ROW + kk * 16 + bcol);
      mma_bf16(s[2 * np], af, bf[0], bf[1]);
      mma_bf16(s[2 * np + 1], af, bf[2], bf[3]);
    }
  }
}

// o (16 x HDP) += p (16 x 64, the score layout) b, b a [64][dim] bf16 tile
// read by ldmatrix.trans; p split into bf16 hi + lo (two products), so its
// rounding stays near 2^-16
template <int KS>
__device__ __forceinline__ void scores_by_rows(float (&o)[MmaTile<KS>::NT][4],
                                               const float (&p)[KN][4],
                                               const __nv_bfloat16* b, int lane) {
  constexpr int ROW = MmaTile<KS>::ROW, NT = MmaTile<KS>::NT;
  const int vrow = (lane & 7) + ((lane >> 3) & 1) * 8, vcol = (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < kTile / 16; ++kk) {
    uint32_t ph[4], pl[4];
    split2(p[2 * kk][0], p[2 * kk][1], ph[0], pl[0]);
    split2(p[2 * kk][2], p[2 * kk][3], ph[1], pl[1]);
    split2(p[2 * kk + 1][0], p[2 * kk + 1][1], ph[2], pl[2]);
    split2(p[2 * kk + 1][2], p[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
    for (int dp = 0; dp < NT / 2; ++dp) {
      uint32_t bv[4];
      ldmatrix_x4_trans(bv, b + (kk * 16 + vrow) * ROW + dp * 16 + vcol);
      mma_bf16(o[2 * dp], ph, bv[0], bv[1]);
      mma_bf16(o[2 * dp + 1], ph, bv[2], bv[3]);
      mma_bf16(o[2 * dp], pl, bv[0], bv[1]);
      mma_bf16(o[2 * dp + 1], pl, bv[2], bv[3]);
    }
  }
}

// rows [r0, r0 + kTile) of one (batch, head) slice of bf16 into a padded
// [kTile][ROW] tile, zero past the rows' end and past width (to HDP); 16
// bytes at a time where the rows allow it (a.vec)
template <int KS>
__device__ __forceinline__ void load_tile_bf16(const Args& a, __nv_bfloat16* dst,
                                               const __nv_bfloat16* base, long long st,
                                               long long sd, int r0, int n_rows, int width) {
  constexpr int HDP = MmaTile<KS>::HDP, ROW = MmaTile<KS>::ROW;
  if (a.vec) {
    constexpr int CPR = HDP / 8;  // 16-byte chunks a row
    for (int e = threadIdx.x; e < kTile * CPR; e += kThreadsTc) {
      const int i = e / CPR, d = (e % CPR) * 8;
      const int r = r0 + i;
      uint4 x = make_uint4(0u, 0u, 0u, 0u);
      if (r < n_rows && d < width) x = *reinterpret_cast<const uint4*>(base + r * st + d);
      *reinterpret_cast<uint4*>(dst + i * ROW + d) = x;
    }
    return;
  }
  const __nv_bfloat16 zero = __float2bfloat16(0.f);
  for (int e = threadIdx.x; e < kTile * HDP; e += kThreadsTc) {
    const int i = e / HDP, d = e % HDP;
    const int r = r0 + i;
    dst[i * ROW + d] = (r < n_rows && d < width) ? base[r * st + d * sd] : zero;
  }
}

// the log2-scaled lse and the D of queries [t0, t0 + kTile) into shared memory
__device__ __forceinline__ void load_row_stats(const Args& a, float* lse2_s, float* dl_s, int b,
                                               int h, int t0) {
  if (threadIdx.x < kTile) {
    const int t = t0 + threadIdx.x;
    const long long row = (static_cast<long long>(b) * a.H + h) * a.Tq + t;
    lse2_s[threadIdx.x] = t < a.Tq ? a.lse[row] * kLog2e : INFINITY;
    dl_s[threadIdx.x] = t < a.Tq ? a.delta[row] : 0.f;
  }
}

// s <- p = exp(s * scale - lse) under the masks, dp <- dS = p * (dp - D),
// in the score layout of a warp's 16 rows. The rows are keys and the
// columns queries (TRANS: the dK/dV kernel), or the other way round;
// row_g / col_g are the first row's and column's global indices, row_l the
// first row's index within its tile
template <bool TRANS>
__device__ __forceinline__ void p_and_ds(const Args& a, float (&s)[KN][4], float (&dp)[KN][4],
                                         const float* lse2_s, const float* dl_s, int row_g,
                                         int row_l, int col_g, int lane) {
  const int g = lane >> 2, tig = lane & 3;
  const int q_off = a.Tk - a.Tq;
  const float sl2 = a.scale * kLog2e;
#pragma unroll
  for (int n = 0; n < KN; ++n) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int rr = g + (i >> 1) * 8;
      const int cl = n * 8 + tig * 2 + (i & 1);
      const int ql = TRANS ? cl : row_l + rr;          // the query, in its tile
      const int t = TRANS ? col_g + cl : row_g + rr;   // the query
      const int kp = TRANS ? row_g + rr : col_g + cl;  // the key
      const bool ok = t < a.Tq && kp < a.Tk && allowed(a, q_off + t, kp);
      const float p = ok ? exp2f(s[n][i] * sl2 - lse2_s[ql]) : 0.f;
      s[n][i] = p;
      dp[n][i] = p * (dp[n][i] - dl_s[ql]);
    }
  }
}

template <int KS>
__device__ __forceinline__ void store_rows(const float (&o)[MmaTile<KS>::NT][4],
                                           __nv_bfloat16* base, long long st, long long sd,
                                           int r0, int n_rows, int width, float mul, int lane) {
  const int g = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + g + half * 8;
    if (r >= n_rows) continue;
#pragma unroll
    for (int n = 0; n < MmaTile<KS>::NT; ++n) {
      const int d = n * 8 + tig * 2;
      if (d < width) base[r * st + d * sd] = __float2bfloat16(o[n][2 * half] * mul);
      if (d + 1 < width) base[r * st + (d + 1) * sd] = __float2bfloat16(o[n][2 * half + 1] * mul);
    }
  }
}

// dK and dV of a 64-key tile on the tensor cores: each warp's 16 keys
// against every query tile of the GQA group, S^T and dP^T in registers,
// their P^T and dS^T the A operands of dV += P^T dO and dK += dS^T Q
template <int KS>
__global__ void __launch_bounds__(kThreadsTc) flash_bwd_dkdv_mma(const Args a) {
  using M = MmaTile<KS>;
  constexpr int ROW = M::ROW, NT = M::NT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [kTile][ROW] each
  __nv_bfloat16* vs = ks + kTile * ROW;
  __nv_bfloat16* qs = vs + kTile * ROW;
  __nv_bfloat16* dos = qs + kTile * ROW;
  float* lse2_s = reinterpret_cast<float*>(dos + kTile * ROW);
  float* dl_s = lse2_s + kTile;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int kvh = blockIdx.y % a.KV, b = blockIdx.y / a.KV;
  const int k0 = blockIdx.x * kTile;
  const int k1 = min(k0 + kTile, a.Tk) - 1;
  const int rep = a.H / a.KV;
  const int q_off = a.Tk - a.Tq;
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(a.q);
  const __nv_bfloat16* dout = static_cast<const __nv_bfloat16*>(a.dout);

  load_tile_bf16<KS>(a, ks, static_cast<const __nv_bfloat16*>(a.k) + b * a.sk[0] + kvh * a.sk[1],
                     a.sk[2], a.sk[3], k0, a.Tk, a.hd);
  load_tile_bf16<KS>(a, vs, static_cast<const __nv_bfloat16*>(a.v) + b * a.sv[0] + kvh * a.sv[1],
                     a.sv[2], a.sv[3], k0, a.Tk, a.hdv);

  int qlo = 0, qhi = a.Tq - 1;
  if (a.causal) qlo = max(qlo, k0 - q_off);
  if (a.window > 0) qhi = min(qhi, k1 + a.window - 1 - q_off);
  if (a.chunk > 0) {
    qlo = max(qlo, floor_div(k0, a.chunk) * a.chunk - q_off);
    qhi = min(qhi, (floor_div(k1, a.chunk) + 1) * a.chunk - 1 - q_off);
  }

  float dk[NT][4], dv[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) {
#pragma unroll
    for (int i = 0; i < 4; ++i) dk[n][i] = dv[n][i] = 0.f;
  }

  if (qlo <= qhi) {
    for (int hh = 0; hh < rep; ++hh) {
      const int h = kvh * rep + hh;
      for (int t0 = (qlo / kTile) * kTile; t0 <= qhi; t0 += kTile) {
        __syncthreads();  // K/V written; the last tile's rows consumed
        load_tile_bf16<KS>(a, qs, q + b * a.sq[0] + h * a.sq[1], a.sq[2], a.sq[3], t0, a.Tq,
                           a.hd);
        load_tile_bf16<KS>(a, dos, dout + b * a.sdo[0] + h * a.sdo[1], a.sdo[2], a.sdo[3], t0,
                           a.Tq, a.hdv);
        load_row_stats(a, lse2_s, dl_s, b, h, t0);
        __syncthreads();
        float s[KN][4], dp[KN][4];
        rows_by_rows<KS>(s, ks + warp * 16 * ROW, qs, lane);    // S^T = K Q^T
        rows_by_rows<KS>(dp, vs + warp * 16 * ROW, dos, lane);  // dP^T = V dO^T
        p_and_ds<true>(a, s, dp, lse2_s, dl_s, k0 + warp * 16, warp * 16, t0, lane);
        scores_by_rows<KS>(dv, s, dos, lane);   // dV += P^T dO
        scores_by_rows<KS>(dk, dp, qs, lane);   // dK += dS^T Q
      }
    }
  }
  store_rows<KS>(dk, static_cast<__nv_bfloat16*>(a.dk) + b * a.sdk[0] + kvh * a.sdk[1], a.sdk[2],
                 a.sdk[3], k0 + warp * 16, a.Tk, a.hd, a.scale, lane);
  store_rows<KS>(dv, static_cast<__nv_bfloat16*>(a.dv) + b * a.sdv[0] + kvh * a.sdv[1], a.sdv[2],
                 a.sdv[3], k0 + warp * 16, a.Tk, a.hdv, 1.f, lane);
}

// dQ of a 64-query tile on the tensor cores: each warp's 16 queries against
// every key tile they see, dS the A operand of dQ += dS K
template <int KS>
__global__ void __launch_bounds__(kThreadsTc) flash_bwd_dq_mma(const Args a) {
  using M = MmaTile<KS>;
  constexpr int ROW = M::ROW, NT = M::NT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* vs = ks + kTile * ROW;
  __nv_bfloat16* qs = vs + kTile * ROW;
  __nv_bfloat16* dos = qs + kTile * ROW;
  float* lse2_s = reinterpret_cast<float*>(dos + kTile * ROW);
  float* dl_s = lse2_s + kTile;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int h = blockIdx.y % a.H, b = blockIdx.y / a.H;
  const int kvh = h / (a.H / a.KV);
  const int t0 = blockIdx.x * kTile;
  const int t1 = min(t0 + kTile, a.Tq) - 1;
  const int q_off = a.Tk - a.Tq;

  load_tile_bf16<KS>(a, qs, static_cast<const __nv_bfloat16*>(a.q) + b * a.sq[0] + h * a.sq[1],
                     a.sq[2], a.sq[3], t0, a.Tq, a.hd);
  load_tile_bf16<KS>(a, dos,
                     static_cast<const __nv_bfloat16*>(a.dout) + b * a.sdo[0] + h * a.sdo[1],
                     a.sdo[2], a.sdo[3], t0, a.Tq, a.hdv);
  load_row_stats(a, lse2_s, dl_s, b, h, t0);

  const int qlo = q_off + t0, qhi = q_off + t1;
  int kmin = 0, kmax = a.Tk - 1;
  if (a.causal) kmax = min(kmax, qhi);
  if (a.window > 0) kmin = max(kmin, qlo - a.window + 1);
  if (a.chunk > 0) {
    kmin = max(kmin, floor_div(qlo, a.chunk) * a.chunk);
    kmax = min(kmax, floor_div(qhi, a.chunk) * a.chunk + a.chunk - 1);
  }

  float dq[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;

  const __nv_bfloat16* kb = static_cast<const __nv_bfloat16*>(a.k) + b * a.sk[0] + kvh * a.sk[1];
  const __nv_bfloat16* vb = static_cast<const __nv_bfloat16*>(a.v) + b * a.sv[0] + kvh * a.sv[1];
  if (kmin <= kmax) {
    for (int k0 = (kmin / kTile) * kTile; k0 <= kmax; k0 += kTile) {
      __syncthreads();  // the query rows written; the last key tile consumed
      load_tile_bf16<KS>(a, ks, kb, a.sk[2], a.sk[3], k0, a.Tk, a.hd);
      load_tile_bf16<KS>(a, vs, vb, a.sv[2], a.sv[3], k0, a.Tk, a.hdv);
      __syncthreads();
      float s[KN][4], dp[KN][4];
      rows_by_rows<KS>(s, qs + warp * 16 * ROW, ks, lane);    // S = Q K^T
      rows_by_rows<KS>(dp, dos + warp * 16 * ROW, vs, lane);  // dP = dO V^T
      p_and_ds<false>(a, s, dp, lse2_s, dl_s, t0 + warp * 16, warp * 16, k0, lane);
      scores_by_rows<KS>(dq, dp, ks, lane);   // dQ += dS K
    }
  }
  store_rows<KS>(dq, static_cast<__nv_bfloat16*>(a.dq) + b * a.sdq[0] + h * a.sdq[1], a.sdq[2],
                 a.sdq[3], t0 + warp * 16, a.Tq, a.hd, a.scale, lane);
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

template <int KS>
cudaError_t launch_mma(const Args& a, cudaStream_t s) {
  const size_t smem = MmaTile<KS>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv_mma<KS>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dq_mma<KS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  err = launch_delta<__nv_bfloat16>(a, s);
  if (err != cudaSuccess) return err;
  if (a.Tk > 0) {  // with Tq = 0 the blocks write zeros
    flash_bwd_dkdv_mma<KS><<<dim3((a.Tk + kTile - 1) / kTile, a.B * a.KV), kThreadsTc, smem, s>>>(
        a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (a.Tq > 0) {  // with Tk = 0 the blocks write zeros
    flash_bwd_dq_mma<KS><<<dim3((a.Tq + kTile - 1) / kTile, a.B * a.H), kThreadsTc, smem, s>>>(a);
  }
  return cudaGetLastError();
}

// bf16: the tensor-core body at the smallest instantiated depth KS (16-deep
// slices) with KS * 16 >= hd, up to 128 (the published head dims: 64, 80,
// 96, 128; a smaller one takes KS 4, its padding zero); past it the
// CUDA-core body
cudaError_t launch_bf16(const Args& a, cudaStream_t s) {
  switch ((a.hd + 15) / 16) {
    case 1:
    case 2:
    case 3:
    case 4: return launch_mma<4>(a, s);
    case 5: return launch_mma<5>(a, s);
    case 6: return launch_mma<6>(a, s);
    case 7:
    case 8: return launch_mma<8>(a, s);
    case 9:
    case 10: return launch_simt<__nv_bfloat16, 10>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

// fp32 (no training path of the port's uses it: the parameters are bf16):
// the CUDA-core body at NC 4, 8 or 10 (16-wide dim slices), the smallest
// with NC * 16 >= hd
cudaError_t launch_fp32(const Args& a, cudaStream_t s) {
  switch ((a.hd + 15) / 16) {
    case 1:
    case 2:
    case 3:
    case 4: return launch_simt<float, 4>(a, s);
    case 5:
    case 6:
    case 7:
    case 8: return launch_simt<float, 8>(a, s);
    case 9:
    case 10: return launch_simt<float, 10>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, for q, k, v, o, dout, dq, dk and dv
// alike. lse: the forward's (B,H,Tq) fp32 log-sum-exps; delta: a (B,H,Tq)
// fp32 scratch. Strides are in elements, ordered (batch, head, t, dim);
// hd <= 160 and hdv <= hd. vec: q's, k's, v's and dout's rows may be read 16
// bytes at a time (each with unit stride along its head dim, its other
// strides, its width and its base 16-byte aligned).
extern "C" int cobra_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o, const void* dout,
    const void* lse, void* delta, void* dq, void* dk, void* dv, int B, int H, int KV, int Tq,
    int Tk, int hd, int hdv, const long long* sq, const long long* sk, const long long* sv,
    const long long* so, const long long* sdo, const long long* sdq, const long long* sdk,
    const long long* sdv, int causal, int window, int chunk, float scale, int dtype, int vec,
    void* stream) {
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
  cudaError_t err;
  if (dtype == 1) {
    err = launch_bf16(a, s);
  } else if (dtype == 0) {
    err = launch_fp32(a, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
