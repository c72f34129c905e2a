// Blocked online-softmax attention (flash attention, forward), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py:
// flash_attention (its _kernel). q (B,H,Tq,hd), k (B,KV,Tk,hd), v
// (B,KV,Tk,hdv) with hdv <= hd (MLA's v head is narrower than its q.k one;
// every other caller has hdv = hd), GQA with H % KV == 0, causal /
// sliding-window / chunk-local masks, the query block at the tail of the
// keys (q_offset = Tk - Tq). Running max, sum and accumulator are fp32;
// masked scores are -1e30 with p = 0, and the output (B,H,Tq,hdv) is
// acc / max(l, 1e-30), so a row with every key masked gives 0.
//
// Three bodies share the grid, the masks and the split-key combine; the
// wrapper picks one from what the call shows (flash_attention.fwd_body):
// flash_fwd_wg for bf16 q with Tq >= 64 at a built (hd, hdv) pair with
// q's, k's, v's and out's rows 16-byte aligned (the prefill and the
// training forward), flash_fwd_mma for any other bf16 q (decode, rows off
// 16 bytes, other head dims), flash_fwd_simt for fp32 q.
//
// flash_fwd_mma, for bf16 q over an fp32 or bf16 cache (the serving path).
// What bounds it: operations. A prefill call (Tq = Tk = 4,500, window
// 4,096) does about 4e11 flops, which the tensor cores can do in a tenth
// of the time the CUDA cores need. The products go through
// mma.sync.m16n8k16 (bf16 in, fp32 sums), so the operands must be bf16
// without losing what the fp32 cache holds. Each fp32 K/V tile is split in
// shared memory into hi = bf16(x) and lo = bf16(x - hi); q is bf16 already,
// so q.k = q.k_hi + q.k_lo is exact up to fp32 summation and a residual of
// about 2^-17 |k|. The serving path writes bf16 values into its fp32 cache
// (RoPE and the projection return bf16), so lo is 0 there: a flag per tile,
// set with __syncthreads_or while converting, skips the lo products, and
// the tensor work is that of one bf16 pass. p is split the same way
// (p = p_hi + p_lo) for P.V, which keeps its error near 2^-16 max|v|
// where one bf16 rounding of p would put about 2^-9 on every output.
//   * One block per (batch, KV head, query tile): the heads of one GQA
//     group times consecutive positions, so every K/V tile is read and
//     converted once for the whole group. Each warp owns one 16-row mma
//     tile, its q fragments loaded once. A long call takes 8 warps (128
//     rows: 4 heads x 32 positions at prefill), so each tile's staging
//     serves twice the products; a short one (decode) 4.
//   * 64-key tiles: cp.async 16-byte copies into an fp32 (or bf16) stage,
//     converted to padded bf16 hi (and lo) tiles, rows padded against bank
//     conflicts and hd padded to the mma depth (KS slices of 16) with
//     zeros, that ldmatrix reads. KS is instantiated for 1..6, 8 and 10
//     (hd up to 96, 128, 160); a head dim between them takes the next one
//     up, its padding zero. A v narrower than hd (VN) is a variant of its
//     own, built at KS 6 only (MLA: hd 96, hdv 64): V rows are staged hdv
//     wide and zero-padded the same way, so the P.V tiles past hdv give 0,
//     and the stores stop at hdv. Every other instantiation has hdv = hd
//     at compile time (a runtime hdv cost danube's prefill 4-5 %; skipping
//     the P.V tiles past hdv made MLA's slower: PERF.md).
//   * The next tile's copies are in flight while this one is converted
//     and multiplied: two stages in an 8-warp block where they fit in the
//     232,448 bytes a block may take (one block an SM, as its registers
//     allow: 127 KB at hd 80, 201 KB at hd 128 over fp32), else one stage
//     issued after the conversion (hd 160 over fp32: 168 KB; and every
//     4-warp block, 86 KB at hd 80, two blocks an SM). The stage count is a
//     function of the cache type, KS and the warps (Stages below).
//   * Masks are applied per element only on tiles that straddle the
//     causal, window or chunk edge or the end of the keys; tiles wholly
//     outside them are never visited. The online softmax runs in registers
//     on the accumulator layout, row max and sum by shuffles in each quad,
//     exp2 on the SFU. The products with and without the lo tiles are
//     separate unrolled code, chosen once per tile.
// Each warp runs the copy wait, conversion, flags, products and softmax of
// a tile in turn, and only the next tile's copy overlaps them, which keeps
// it far below the tensor cores' rate (PERF.md): long calls at the built
// head dims take flash_fwd_wg instead; decode keeps this body (a Tq-1 call
// is bound by the cache's bytes).
//
// flash_fwd_wg, warp-specialised on wgmma (sm_90a), for the long calls:
// the same split arithmetic (K/V hi and lo wherever lo is nonzero, P hi and
// lo always, fp32 sums), built for (hd, hdv) = (80, 80) and (96, 64) over
// an fp32 or a bf16 cache. A block of 384 threads takes the same 128 rows
// (a GQA group's heads x consecutive positions):
//   * a producer warpgroup copies each 64-key tile's K and V rows by
//     cp.async into a ring of three raw slots (two tiles in flight: with
//     one tile in registers the copies were bound by their latency),
//     converts each into the bf16 hi (and lo) tiles that wgmma reads,
//     in the core-matrix layout without swizzle (hdv 64 is not padded),
//     stores a lo tile only where some lo is nonzero (a flag per tile, by
//     a barrier reduction over the producer), and hands K and V over by
//     separate mbarrier rings of two;
//   * two consumer warpgroups of 64 rows hold q's A fragments in registers
//     and issue S_n = q K_n^T (K hi, and lo when flagged) with
//     O += P_{n-1} V_{n-1} (P hi and lo against V hi, P hi against V lo
//     when flagged) as one wgmma stage, run the online softmax of S_n
//     (exp2 of one FFMA an element) while the P V products run, then split
//     P_n into its hi and lo A fragments. Each stage is straight-line code
//     (the lo products guarded by a predicate, the roles and flags
//     broadcast from lane 0): ptxas serializes wgmmas that a branch or a
//     copy splits from their wait. Turns between the two consumers on
//     named barriers were tried and gave no steady gain (PERF.md).
//
// flash_fwd_simt, for fp32 q (the fp32/fp32 pair, which no serving path
// uses). A two-way bf16 split cannot meet fp32's 2e-5 tolerance, so fp32 q
// stays on the CUDA cores (67 TFLOP/s): a lane scores one key of a 32-key
// tile against four rows at a time from shared memory and accumulates p.V
// with each lane owning 32-dim slices of the head (HC = 1..5 slices: hd up
// to 160, 84 KB of shared memory there). At decode (Tq = 1) the call is
// bound by the bytes of the cache, and the mma body, whose cp.async
// copies keep a whole tile in flight, beat the CUDA-core body there too on
// the H100 (PERF.md), so bf16 q takes it at every shape.
//
// Every body writes each row's log-sum-exp of its scaled scores (fp32,
// (B,H,Tq), natural log; +inf for a row with every key masked) when given
// a pointer for it: the training forward saves it for the backward kernel
// (csrc/flash_attention_bwd.cu); serving passes none.
//
// Every body: few blocks (decode: B x KV) would leave most SMs idle, so
// the wrapper splits the key range over a grid dimension; each split
// writes fp32 partials (acc, m, l) and flash_combine folds them in split
// order. Strides are arguments: q may be the (B,T,H,hd) projection and k/v
// the (B,S,KV,hd) cache, viewed as (B,H,T,hd) without a copy; where a K or
// V row is not 16-byte aligned the mma body copies both element by
// element. Ragged Tq and Tk are masked in the kernel. Head dims 1..160.
//
// Every entry point launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError() so the Python wrapper can raise on a refused
// launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 64;                    // query rows per block
constexpr int kRowsPerWarp = kRows / kWarps;  // 16
constexpr int kGroup = 4;                    // rows scored together
constexpr int kKeys = 32;                    // keys per tile, one per lane (simt)
constexpr int kKeysTc = 64;                  // keys per tile (mma)
constexpr int kLoads = 8;                    // K/V loads in flight per thread
constexpr size_t kMaxSmem = 232448;          // dynamic shared memory a block may take
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

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
  float* part_acc;  // (splits, B*H*Tq, hdv) when splits > 1
  float* part_ml;   // (splits, B*H*Tq, 2)
  float* lse;       // (B*H*Tq) row log-sum-exps, or null (serving)
  int B, H, KV, Tq, Tk, hd;
  int hdv;          // v's head dim (<= hd): the output's
  long long sq[4], sk[4], sv[4], so[4];  // element strides (b, head, t, d)
  int causal, window, chunk;             // window / chunk: 0 = none
  float scale;
  int group;      // heads of a GQA group in one block
  int n_hgroups;  // blocks across one GQA group's heads
  int bt;         // query positions per block
  int splits;
  int vec;        // K and V rows 16-byte aligned: cp.async (mma body)
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

// The keys any query of a block may see, and the tiles of them that this
// split (blockIdx.z) visits: [tile_lo, tile_hi) in tiles of `keys`.
struct Span {
  int qlo, qhi, kmin, kmax, tile_lo, tile_hi;
};

__device__ __forceinline__ Span span_of(const Args& a, int t0, int t1, int keys) {
  const int q_off = a.Tk - a.Tq;
  Span sp;
  sp.qlo = q_off + t0;
  sp.qhi = q_off + t1 - 1;
  sp.kmin = 0;
  sp.kmax = a.Tk - 1;
  if (a.causal) sp.kmax = min(sp.kmax, sp.qhi);
  if (a.window > 0) sp.kmin = max(sp.kmin, sp.qlo - a.window + 1);
  if (a.chunk > 0) {
    sp.kmin = max(sp.kmin, floor_div(sp.qlo, a.chunk) * a.chunk);
    sp.kmax = min(sp.kmax, floor_div(sp.qhi, a.chunk) * a.chunk + a.chunk - 1);
  }
  sp.tile_lo = sp.tile_hi = 0;
  if (sp.kmax >= sp.kmin && t1 > t0) {
    const int first = sp.kmin / keys, last = sp.kmax / keys;
    const int per = (last - first + 1 + a.splits - 1) / a.splits;
    sp.tile_lo = first + blockIdx.z * per;
    sp.tile_hi = min(last + 1, sp.tile_lo + per);
  }
  return sp;
}

// whether every key of the 64-key tile at kbase exists and passes the
// masks for every query of the block's span (no mask per element there)
__device__ __forceinline__ bool tile_whole(const Args& a, const Span& sp, int kbase) {
  const int klast = kbase + kKeysTc - 1;
  bool full = klast < a.Tk && kbase >= sp.kmin && klast <= sp.kmax;
  if (a.causal) full = full && klast <= sp.qlo;
  if (a.window > 0) full = full && kbase > sp.qhi - a.window;
  if (a.chunk > 0) {
    const int c = floor_div(kbase, a.chunk);
    full = full && floor_div(klast, a.chunk) == c && floor_div(sp.qlo, a.chunk) == c &&
           floor_div(sp.qhi, a.chunk) == c;
  }
  return full;
}

// fp32 q over an fp32 cache
template <int HC>
__global__ void __launch_bounds__(kThreads)
flash_fwd_simt(const Args a) {
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

  const float* q = static_cast<const float*>(a.q);
  const float* k = static_cast<const float*>(a.k);
  const float* v = static_cast<const float*>(a.v);

  // the block's query tile, scaled as the TPU kernel does (q * scale)
  for (int e = tid; e < kRows * hdp; e += kThreads) {
    const int i = e / hdp, d = e % hdp;
    const Row r = row_of(a, i, kvh, hg, t0);
    float x = 0.f;
    if (r.valid && d < a.hd) {
      x = q[b * a.sq[0] + r.head * a.sq[1] + r.t * a.sq[2] + d * a.sq[3]] * a.scale;
    }
    q_s[e] = x;
  }

  const Span sp = span_of(a, t0, t1, kKeys);
  const int kmin = sp.kmin, kmax = sp.kmax;

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][HC];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    m[rr] = kNegInf;
    l[rr] = 0.f;
#pragma unroll
    for (int c = 0; c < HC; ++c) acc[rr][c] = 0.f;
  }

  for (int tile = sp.tile_lo; tile < sp.tile_hi; ++tile) {
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
          kx[i] = k[b * a.sk[0] + kvh * a.sk[1] + kp * a.sk[2] + d * a.sk[3]];
        }
        if (kp < a.Tk && d < a.hdv) {
          vx[i] = v[b * a.sv[0] + kvh * a.sv[1] + kp * a.sv[2] + d * a.sv[3]];
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
      float* out = static_cast<float*>(a.out);
      const float denom = fmaxf(l[rr], 1e-30f);
      if (a.lse != nullptr && lane == 0) {
        a.lse[(static_cast<long long>(b) * a.H + r.head) * a.Tq + r.t] =
            l[rr] > 0.f ? m[rr] + logf(l[rr]) : INFINITY;
      }
#pragma unroll
      for (int c = 0; c < HC; ++c) {
        const int d = c * 32 + lane;
        if (d < a.hdv) {
          out[b * a.so[0] + r.head * a.so[1] + r.t * a.so[2] + d * a.so[3]] =
              acc[rr][c] / denom;
        }
      }
    } else {
      const long long row =
          (static_cast<long long>(b) * a.H + r.head) * a.Tq + r.t;
      const long long at = static_cast<long long>(blockIdx.z) * n_rows + row;
#pragma unroll
      for (int c = 0; c < HC; ++c) {
        const int d = c * 32 + lane;
        if (d < a.hdv) a.part_acc[at * a.hdv + d] = acc[rr][c];
      }
      if (lane == 0) {
        a.part_ml[at * 2] = m[rr];
        a.part_ml[at * 2 + 1] = l[rr];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// the tensor-core body
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, zero-filled past src_bytes
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most the last committed group is in flight
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
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

// two consecutive elements of a stage row as floats, 0 past hd
__device__ __forceinline__ float2 load2(const float* row, int d, int hd) {
  if (d + 1 < hd) return *reinterpret_cast<const float2*>(row + d);
  return make_float2(d < hd ? row[d] : 0.f, 0.f);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* row, int d, int hd) {
  if (d + 1 < hd) return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(row + d));
  return make_float2(d < hd ? __bfloat162float(row[d]) : 0.f, 0.f);
}

// 2^x by the SFU (about 2 ulp; 0 for x = -1e30)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// s (16 x 64 scores of a warp) = q k_hi^T (+ q k_lo^T when LO); the K
// fragments by ldmatrix from the [key][d] tiles
template <int KS, bool LO>
__device__ __forceinline__ void qk_tile(float (&s)[kKeysTc / 8][4], const uint32_t (&qf)[KS][4],
                                        const __nv_bfloat16* kh, const __nv_bfloat16* kl,
                                        int row, int lane) {
  constexpr int KN = kKeysTc / 8;
#pragma unroll
  for (int n = 0; n < KN; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
  const int krow = (lane & 7) + (lane >> 4) * 8, kcol = ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
    for (int np = 0; np < KN / 2; ++np) {
      uint32_t bk[4];
      const int at = (np * 16 + krow) * row + kk * 16 + kcol;
      ldmatrix_x4(bk, kh + at);
      mma_bf16(s[2 * np], qf[kk], bk[0], bk[1]);
      mma_bf16(s[2 * np + 1], qf[kk], bk[2], bk[3]);
      if (LO) {
        ldmatrix_x4(bk, kl + at);
        mma_bf16(s[2 * np], qf[kk], bk[0], bk[1]);
        mma_bf16(s[2 * np + 1], qf[kk], bk[2], bk[3]);
      }
    }
  }
}

// o += p_hi v_hi + p_lo v_hi (+ p_hi v_lo when LO), p the warp's
// probabilities in the score layout (the A fragments of the product); the V
// fragments by ldmatrix.trans. Columns past v's head dim are zero in the
// tiles, so their o stays 0 and is never stored
template <int NT, bool LO>
__device__ __forceinline__ void pv_tile(float (&o)[NT][4], const float (&p)[kKeysTc / 8][4],
                                        const __nv_bfloat16* vh, const __nv_bfloat16* vl,
                                        int row, int lane) {
  const int vrow = (lane & 7) + ((lane >> 3) & 1) * 8, vcol = (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < kKeysTc / 16; ++kk) {
    uint32_t ph[4], pl[4];
    split2(p[2 * kk][0], p[2 * kk][1], ph[0], pl[0]);
    split2(p[2 * kk][2], p[2 * kk][3], ph[1], pl[1]);
    split2(p[2 * kk + 1][0], p[2 * kk + 1][1], ph[2], pl[2]);
    split2(p[2 * kk + 1][2], p[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
    for (int dp = 0; dp < NT / 2; ++dp) {
      uint32_t bv[4];
      const int at = (kk * 16 + vrow) * row + dp * 16 + vcol;
      ldmatrix_x4_trans(bv, vh + at);
      mma_bf16(o[2 * dp], ph, bv[0], bv[1]);
      mma_bf16(o[2 * dp + 1], ph, bv[2], bv[3]);
      mma_bf16(o[2 * dp], pl, bv[0], bv[1]);
      mma_bf16(o[2 * dp + 1], pl, bv[2], bv[3]);
      if (LO) {
        ldmatrix_x4_trans(bv, vl + at);
        mma_bf16(o[2 * dp], ph, bv[0], bv[1]);
        mma_bf16(o[2 * dp + 1], ph, bv[2], bv[3]);
      }
    }
  }
}

template <int KS>
struct MmaTile {
  static constexpr int HDP = KS * 16;   // head dim padded to the mma depth
  static constexpr int ROW = HDP + 8;   // bf16 row stride: ldmatrix without bank conflicts
  static constexpr int NT = HDP / 8;    // 8-wide output column tiles
  static constexpr int KN = kKeysTc / 8;  // 8-key score tiles
};

template <typename KT, int KS>
constexpr size_t mma_smem_bytes(int stages) {
  return stages * 2 * sizeof(KT) * kKeysTc * MmaTile<KS>::HDP  // K and V stages
         + 4 * sizeof(__nv_bfloat16) * kKeysTc * MmaTile<KS>::ROW;  // K, V hi and lo
}

// K/V stages in flight: one for 4-warp blocks (two blocks share an SM),
// two for 8-warp blocks (one block an SM: the next tile is copied while this
// one is converted and multiplied) where both fit in a block's shared
// memory, else one (hd 160 over an fp32 cache)
template <typename KT, int KS, int WARPS>
struct Stages {
  static constexpr int N = (WARPS == 8 && mma_smem_bytes<KT, KS>(2) <= kMaxSmem) ? 2 : 1;
  static constexpr size_t kBytes = mma_smem_bytes<KT, KS>(N);
  static_assert(kBytes <= kMaxSmem, "K/V tiles exceed a block's shared memory");
};

// VN: v's head dim a.hdv is below hd (MLA); else hdv = hd
template <typename KT, int KS, int WARPS, bool VN>
__global__ void __launch_bounds__(WARPS * 32, WARPS == 4 ? 2 : 1)
flash_fwd_mma(const Args a) {
  constexpr int kThreadsW = WARPS * 32;
  using M = MmaTile<KS>;
  constexpr int HDP = M::HDP, ROW = M::ROW, NT = M::NT, KN = M::KN;
  constexpr int STAGES = Stages<KT, KS, WARPS>::N, STAGE = 2 * kKeysTc * HDP;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  KT* stages = reinterpret_cast<KT*>(smem_raw);     // [STAGES][K, V][kKeysTc][HDP] as loaded
  __nv_bfloat16* kh = reinterpret_cast<__nv_bfloat16*>(stages + STAGES * STAGE);
  __nv_bfloat16* kl = kh + kKeysTc * ROW;           // [kKeysTc][ROW] each
  __nv_bfloat16* vh = kl + kKeysTc * ROW;
  __nv_bfloat16* vl = vh + kKeysTc * ROW;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  int y = blockIdx.y;
  const int hg = y % a.n_hgroups;
  y /= a.n_hgroups;
  const int kvh = y % a.KV;
  const int b = y / a.KV;
  const int t0 = blockIdx.x * a.bt;
  const int t1 = min(t0 + a.bt, a.Tq);
  const int q_off = a.Tk - a.Tq;
  const int hd = a.hd, hdv = VN ? a.hdv : hd;

  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(a.q);
  const KT* k = static_cast<const KT*>(a.k);
  const KT* v = static_cast<const KT*>(a.v);
  const KT* kb0 = k + b * a.sk[0] + kvh * a.sk[1];
  const KT* vb0 = v + b * a.sv[0] + kvh * a.sv[1];

  // this lane's two rows of the warp's 16-row tile, and their q fragments
  // (bf16 as given: exact), zero past hd and on rows past the tile
  const Row r0 = row_of(a, warp * 16 + g, kvh, hg, t0);
  const Row r1 = row_of(a, warp * 16 + g + 8, kvh, hg, t0);
  uint32_t qf[KS][4];
  {
    const __nv_bfloat16 zero = __float2bfloat16(0.f);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const Row& r = (i & 1) ? r1 : r0;
        const int d = kk * 16 + (i >> 1) * 8 + tig * 2;
        const long long at = b * a.sq[0] + r.head * a.sq[1] + r.t * a.sq[2];
        const __nv_bfloat16 x0 = (r.valid && d < hd) ? q[at + d * a.sq[3]] : zero;
        const __nv_bfloat16 x1 = (r.valid && d + 1 < hd) ? q[at + (d + 1) * a.sq[3]] : zero;
        qf[kk][i] = bits(__halves2bfloat162(x0, x1));
      }
    }
  }
  const int qp0 = q_off + r0.t, qp1 = q_off + r1.t;

  const Span sp = span_of(a, t0, t1, kKeysTc);

  // one K/V tile into the stage, K hd and V hdv wide: 16-byte cp.async
  // copies where both tensors' rows are aligned (zero-filled past Tk), else
  // element by element
  auto load_tile = [&](int tile) {
    const int kbase = tile * kKeysTc;
    KT* k_st = stages + ((tile - sp.tile_lo) % STAGES) * STAGE;
    KT* v_st = k_st + kKeysTc * HDP;
    if (a.vec) {
      constexpr int EPC = 16 / sizeof(KT);
      const int cpr = hd / EPC;
      for (int e = tid; e < kKeysTc * cpr; e += kThreadsW) {
        const int j = e / cpr, d = (e % cpr) * EPC;
        const int kp = kbase + j;
        const bool in = kp < a.Tk;
        const long long kq = in ? kp : 0;
        cp_async16(k_st + j * HDP + d, kb0 + kq * a.sk[2] + d, in ? 16 : 0);
        if (!VN || d < hdv) cp_async16(v_st + j * HDP + d, vb0 + kq * a.sv[2] + d, in ? 16 : 0);
      }
      cp_async_commit();
    } else {
      for (int e = tid; e < kKeysTc * hd; e += kThreadsW) {
        const int j = e / hd, d = e % hd;
        const int kp = kbase + j;
        KT kx = from_f32<KT>(0.f), vx = kx;
        if (kp < a.Tk) {
          kx = kb0[kp * a.sk[2] + d * a.sk[3]];
          if (!VN || d < hdv) vx = vb0[kp * a.sv[2] + d * a.sv[3]];
        }
        k_st[j * HDP + d] = kx;
        if (!VN || d < hdv) v_st[j * HDP + d] = vx;
      }
    }
  };

  float m0 = kNegInf, m1 = kNegInf;  // running max of rows g and g + 8 (log2 units)
  float l0 = 0.f, l1 = 0.f;          // this lane's part of the row sums
  float o[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  const float sl2 = a.scale * kLog2e;

  if (sp.tile_lo < sp.tile_hi) load_tile(sp.tile_lo);
  for (int tile = sp.tile_lo; tile < sp.tile_hi; ++tile) {
    const int kbase = tile * kKeysTc;
    const KT* k_st = stages + ((tile - sp.tile_lo) % STAGES) * STAGE;
    const KT* v_st = k_st + kKeysTc * HDP;
    if (STAGES == 2 && tile + 1 < sp.tile_hi) {
      load_tile(tile + 1);  // the other stage, read by the last conversion
      cp_async_wait_one();
    } else {
      cp_async_wait_all();
    }
    __syncthreads();  // the stage holds this tile; the last tile's hi/lo are consumed
    // the stage as bf16 hi tiles, hd padded with zeros. A value whose low
    // 16 bits are 0 is a bf16 value: hi holds it and its lo is 0, so the lo
    // tiles are made (and their products taken) only for a tile that holds
    // another value somewhere
    int k_lo = 0, v_lo = 0;
    for (int e = tid; e < kKeysTc * (HDP / 2); e += kThreadsW) {
      const int j = e / (HDP / 2), d = (e % (HDP / 2)) * 2;
      const float2 kx = load2(k_st + j * HDP, d, hd);
      const float2 vx = load2(v_st + j * HDP, d, hdv);
      *reinterpret_cast<__nv_bfloat162*>(kh + j * ROW + d) = __floats2bfloat162_rn(kx.x, kx.y);
      *reinterpret_cast<__nv_bfloat162*>(vh + j * ROW + d) = __floats2bfloat162_rn(vx.x, vx.y);
      k_lo |= (__float_as_uint(kx.x) | __float_as_uint(kx.y)) & 0xffffu;
      v_lo |= (__float_as_uint(vx.x) | __float_as_uint(vx.y)) & 0xffffu;
    }
    // barriers: hi written; a flag per tile for the lo products
    k_lo = __syncthreads_or(k_lo);
    v_lo = __syncthreads_or(v_lo);
    if (k_lo | v_lo) {
      for (int e = tid; e < kKeysTc * (HDP / 2); e += kThreadsW) {
        const int j = e / (HDP / 2), d = (e % (HDP / 2)) * 2;
        uint32_t hi, lo;
        const float2 kx = load2(k_st + j * HDP, d, hd);
        split2(kx.x, kx.y, hi, lo);
        *reinterpret_cast<uint32_t*>(kl + j * ROW + d) = lo;
        const float2 vx = load2(v_st + j * HDP, d, hdv);
        split2(vx.x, vx.y, hi, lo);
        *reinterpret_cast<uint32_t*>(vl + j * ROW + d) = lo;
      }
      __syncthreads();  // lo written, the stage consumed
    }
    if (STAGES == 1 && tile + 1 < sp.tile_hi) load_tile(tile + 1);  // overlaps the products below

    // S = q k^T (+ q k_lo^T), 16 rows x 64 keys per warp
    float s[KN][4];
    if (k_lo) {
      qk_tile<KS, true>(s, qf, kh, kl, ROW, lane);
    } else {
      qk_tile<KS, false>(s, qf, kh, kl, ROW, lane);
    }

    // scale (log2 units), and mask only a tile that straddles an edge
    const bool full = tile_whole(a, sp, kbase);
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int n = 0; n < KN; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float x = s[n][i] * sl2;
        if (!full) {
          const int kp = kbase + n * 8 + tig * 2 + (i & 1);
          if (kp >= a.Tk || !allowed(a, i < 2 ? qp0 : qp1, kp)) x = kNegInf;
        }
        s[n][i] = x;
      }
      mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
      mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
    }
    mx0 = quad_max(mx0);
    mx1 = quad_max(mx1);
    const float alpha0 = fast_exp2(m0 - mx0), alpha1 = fast_exp2(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
    for (int n = 0; n < KN; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float mm = i < 2 ? mx0 : mx1;
        s[n][i] = s[n][i] == kNegInf ? 0.f : fast_exp2(s[n][i] - mm);
      }
      ls0 += s[n][0] + s[n][1];
      ls1 += s[n][2] + s[n][3];
    }
    l0 = l0 * alpha0 + ls0;
    l1 = l1 * alpha1 + ls1;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      o[n][0] *= alpha0;
      o[n][1] *= alpha0;
      o[n][2] *= alpha1;
      o[n][3] *= alpha1;
    }

    // O += p_hi v + p_lo v (+ p_hi v_lo): the score tiles are the A fragments
    if (v_lo) {
      pv_tile<NT, true>(o, s, vh, vl, ROW, lane);
    } else {
      pv_tile<NT, false>(o, s, vh, vl, ROW, lane);
    }
  }

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const long long n_rows = static_cast<long long>(a.B) * a.H * a.Tq;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const Row& r = half ? r1 : r0;
    if (!r.valid) continue;
    const float l = half ? l1 : l0;
    const float m = half ? m1 : m0;
    if (a.splits == 1) {
      __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.out);
      const long long at = b * a.so[0] + r.head * a.so[1] + r.t * a.so[2];
      const float denom = fmaxf(l, 1e-30f);
      if (a.lse != nullptr && tig == 0) {  // m in log2 units
        a.lse[(static_cast<long long>(b) * a.H + r.head) * a.Tq + r.t] =
            l > 0.f ? (m + log2f(l)) * kLn2 : INFINITY;
      }
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int d = n * 8 + tig * 2;
        if (d < hdv) out[at + d * a.so[3]] = __float2bfloat16(o[n][2 * half] / denom);
        if (d + 1 < hdv) out[at + (d + 1) * a.so[3]] = __float2bfloat16(o[n][2 * half + 1] / denom);
      }
    } else {
      const long long row = (static_cast<long long>(b) * a.H + r.head) * a.Tq + r.t;
      const long long at = static_cast<long long>(blockIdx.z) * n_rows + row;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int d = n * 8 + tig * 2;
        if (d < hdv) a.part_acc[at * hdv + d] = o[n][2 * half];
        if (d + 1 < hdv) a.part_acc[at * hdv + d + 1] = o[n][2 * half + 1];
      }
      if (tig == 0) {  // flash_combine weighs the splits by exp(m) in natural units
        a.part_ml[at * 2] = m == kNegInf ? kNegInf : m * kLn2;
        a.part_ml[at * 2 + 1] = l;
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
    if (d < a.hdv) acc += a.part_acc[at * a.hdv + d] * w;
  }
  if (a.lse != nullptr && d == 0) a.lse[row] = lsum > 0.f ? mx + logf(lsum) : INFINITY;
  if (d < a.hdv) {
    const int t = static_cast<int>(row % a.Tq);
    const int head = static_cast<int>((row / a.Tq) % a.H);
    const int b = static_cast<int>(row / (static_cast<long long>(a.Tq) * a.H));
    QT* out = static_cast<QT*>(a.out);
    out[b * a.so[0] + head * a.so[1] + t * a.so[2] + d * a.so[3]] =
        from_f32<QT>(acc / fmaxf(lsum, 1e-30f));
  }
}

// ---------------------------------------------------------------------------
// the warp-specialised wgmma body (long bf16 calls at the routed head dims)
// ---------------------------------------------------------------------------

constexpr int kWgThreads = 384;  // a producer warpgroup, two consumer warpgroups
constexpr int kRaw = 3;          // K/V tiles as copied, in flight (cp.async)
constexpr int kConv = 2;         // converted K tiles, and V tiles, in the rings
constexpr int kBarProducer = 1;  // the producer warps' named barrier (0 is __syncthreads)

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// this thread's arrival (release: its shared-memory writes before it are
// seen by a thread whose wait completes the phase)
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("{\n.reg .b64 st;\nmbarrier.arrive.shared::cta.b64 st, [%0];\n}\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// until the phase of the given parity has completed (a fresh barrier is in
// phase 0, so a wait for parity 1 passes at once)
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// this thread's shared-memory writes made visible to wgmma, which reads
// through the async proxy
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// until at most N committed groups of this warpgroup are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// pins registers a wgmma reads or writes in place between its issue and
// its wait
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

// A bf16 tile [R][W] (W % 8 == 0) in the core-matrix layout that wgmma
// reads without swizzle (as csrc/flash_attention_bwd.cu lays its tiles):
// element (r, c) at ((r / 8) * (W / 8) + c / 8) * 64 + (r % 8) * 8 + c % 8.
// An operand descriptor: the start address, lbo the bytes between core
// matrices along the product's depth, sbo along its M or N. Read with its
// columns as the depth (K-major): lbo 128, sbo W * 16; with its rows as the
// depth (MN-major): lbo W * 16, sbo 128.
__device__ __forceinline__ uint64_t wg_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32);
}

#define WG_D(j) "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])

// d (64 x N fp32, the accumulator layout) = (acc ? d : 0) + a b where on
// (else d as it was): a the bf16 A fragments in registers (the mma.sync A
// layout, a warp's 16 rows), b a bf16 tile in shared memory, K-major (TB 0)
// or MN-major (TB 1). on must be the same in the whole warpgroup; it guards
// the instruction, so that no branch splits the code between a wgmma and
// its wait (ptxas serializes the wgmmas of such code)
template <int N, int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 8][4], const uint32_t (&a)[4],
                                         uint64_t db, int acc, int on);

template <>
__device__ __forceinline__ void wgmma_rs<64, 0>(float (&d)[8][4], const uint32_t (&a)[4],
                                                uint64_t db, int acc, int on) {
  asm volatile(
      "{\n.reg .pred p, g;\nsetp.ne.b32 p, %37, 0;\nsetp.ne.b32 g, %38, 0;\n"
      "@g wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : WG_D(0), WG_D(1), WG_D(2), WG_D(3), WG_D(4), WG_D(5), WG_D(6), WG_D(7)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc), "r"(on));
}

template <>
__device__ __forceinline__ void wgmma_rs<64, 1>(float (&d)[8][4], const uint32_t (&a)[4],
                                                uint64_t db, int acc, int on) {
  asm volatile(
      "{\n.reg .pred p, g;\nsetp.ne.b32 p, %37, 0;\nsetp.ne.b32 g, %38, 0;\n"
      "@g wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WG_D(0), WG_D(1), WG_D(2), WG_D(3), WG_D(4), WG_D(5), WG_D(6), WG_D(7)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc), "r"(on));
}

template <>
__device__ __forceinline__ void wgmma_rs<80, 1>(float (&d)[10][4], const uint32_t (&a)[4],
                                                uint64_t db, int acc, int on) {
  asm volatile(
      "{\n.reg .pred p, g;\nsetp.ne.b32 p, %45, 0;\nsetp.ne.b32 g, %46, 0;\n"
      "@g wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : WG_D(0), WG_D(1), WG_D(2), WG_D(3), WG_D(4), WG_D(5), WG_D(6), WG_D(7),
        WG_D(8), WG_D(9)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc), "r"(on));
}

#undef WG_D

// A producer thread's share of a [64][W] K or V tile: W / 16 units of 8
// elements of a row (one 16-byte store of bf16), eight neighbouring threads
// one core matrix; a unit is R 16-byte words as copied (2 of fp32, 1 of
// bf16). The rows are copied as they are into a raw tile, its rows padded
// by 16 bytes so that the 8 rows a quarter-warp reads fall in distinct banks.
template <typename KT, int W>
struct Units {
  static constexpr int N = kKeysTc * W / 8 / 128, C8 = W / 8;
  static constexpr int R = static_cast<int>(sizeof(KT)) / 2;
  static constexpr int EPC = 16 / static_cast<int>(sizeof(KT));  // elements a 16-byte word
  static constexpr int RS = W + EPC;                              // raw row stride
  static constexpr int kRawBytes = static_cast<int>(sizeof(KT)) * kKeysTc * RS;
  static_assert(kKeysTc * W % (8 * 128) == 0, "units split evenly over 128 threads");
  uint4 x[N][R];
  uint32_t lo[N][4];

  __device__ __forceinline__ static int row(int e) { return ((e >> 3) / C8) * 8 + (e & 7); }
  __device__ __forceinline__ static int at(int e) {  // in the core-matrix layout
    return (((e >> 3) / C8) * C8 + (e >> 3) % C8) * 64 + (e & 7) * 8;
  }

  // rows [kbase, kbase + 64) of one (batch, head) slice into a raw tile by
  // cp.async, 16 bytes a thread, neighbouring threads along a row; zeros
  // past Tk
  __device__ __forceinline__ static void copy(KT* raw, const KT* base, long long st, int kbase,
                                              int Tk, int pt) {
    constexpr int CK = W / EPC;
#pragma unroll
    for (int u = 0; u < kKeysTc * CK / 128; ++u) {
      const int e = pt + u * 128, j = e / CK, c = e % CK;
      const int kp = kbase + j;
      const bool in = kp < Tk;
      cp_async16(raw + j * RS + c * EPC, base + (in ? kp : 0) * st + c * EPC, in ? 16 : 0);
    }
  }

  // this thread's units from a raw tile
  __device__ __forceinline__ void fetch(const KT* raw, int pt) {
#pragma unroll
    for (int u = 0; u < N; ++u) {
      const int e = pt + u * 128;
      const uint4* src = reinterpret_cast<const uint4*>(raw + row(e) * RS + ((e >> 3) % C8) * 8);
#pragma unroll
      for (int r = 0; r < R; ++r) x[u][r] = src[r];
    }
  }

  // the bf16 hi tile into shared memory; over fp32 the lo parts (lo =
  // bf16(x - hi)) kept here. Returns whether any lo is nonzero
  __device__ __forceinline__ bool store_hi(__nv_bfloat16* hi, int pt) {
    uint32_t any = 0;
#pragma unroll
    for (int u = 0; u < N; ++u) {
      uint4 h;
      if constexpr (R == 2) {
        const uint32_t* w = reinterpret_cast<const uint32_t*>(&x[u][0]);
        uint32_t* hw = reinterpret_cast<uint32_t*>(&h);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          split2(__uint_as_float(w[2 * j]), __uint_as_float(w[2 * j + 1]), hw[j], lo[u][j]);
          any |= lo[u][j];
        }
      } else {
        h = x[u][0];
      }
      *reinterpret_cast<uint4*>(hi + at(pt + u * 128)) = h;
    }
    return any != 0;
  }

  __device__ __forceinline__ void store_lo(__nv_bfloat16* lo_tile, int pt) const {
#pragma unroll
    for (int u = 0; u < N; ++u) {
      *reinterpret_cast<uint4*>(lo_tile + at(pt + u * 128)) =
          make_uint4(lo[u][0], lo[u][1], lo[u][2], lo[u][3]);
    }
  }
};

// The shared memory of a wgmma-body block, in bytes: the converted K tiles
// (bf16 hi, and lo over an fp32 cache) and V tiles, each a ring of kConv;
// the K and V rows as copied, a ring of kRaw; a lo flag per K and V slot;
// the rings' barriers.
template <typename KT, int HD, int HDV>
struct WgFwd {
  static constexpr bool kLo = sizeof(KT) == 4;  // fp32 K/V: a lo tile beside each hi
  static constexpr int kParts = kLo ? 2 : 1;
  static constexpr int kKTile = kKeysTc * HD;  // elements of one bf16 K (V) tile
  static constexpr int kVTile = kKeysTc * HDV;
  static constexpr int kKSlot = 2 * kParts * kKTile;  // bytes
  static constexpr int kVSlot = 2 * kParts * kVTile;
  static constexpr int kRawAt = kConv * (kKSlot + kVSlot);
  static constexpr int kRawK = Units<KT, HD>::kRawBytes;
  static constexpr int kRawSlot = kRawK + Units<KT, HDV>::kRawBytes;
  static constexpr int kFlagAt = kRawAt + kRaw * kRawSlot;  // [K, V][kConv] words
  static constexpr int kBarAt = kFlagAt + 4 * 2 * kConv;    // kfull, kempty, vfull, vempty
  static constexpr size_t kBytes = kBarAt + 8 * 4 * kConv;
  static_assert(HD % 16 == 0 && HDV % 16 == 0 && HDV <= HD, "wgmma depth is 16");
  static_assert(kKSlot % 128 == 0 && kVSlot % 128 == 0 && kRawK % 16 == 0 &&
                    kRawSlot % 128 == 0 && kBarAt % 8 == 0,
                "slots aligned");
  static_assert(kBytes <= kMaxSmem, "tiles exceed a block's shared memory");
};

// whether x is set in any of the n threads at named barrier id (a barrier)
__device__ __forceinline__ bool bar_or(int id, int n, bool x) {
  uint32_t r;
  asm volatile(
      "{\n.reg .pred p, q;\nsetp.ne.u32 p, %1, 0;\nbar.red.or.pred q, %2, %3, p;\n"
      "selp.u32 %0, 1, 0, q;\n}\n"
      : "=r"(r)
      : "r"(static_cast<uint32_t>(x)), "r"(id), "r"(n)
      : "memory");
  return r != 0;
}

// one tile's K or V into ring slot hi (its lo tile after it), once the
// slot is free: the hi tile, then the lo tile where some lo is nonzero (its
// flag), made visible to wgmma and handed over by the full barrier
template <typename KT, int W>
__device__ __forceinline__ void hand_over(Units<KT, W>& t, __nv_bfloat16* hi, int* flag,
                                          uint64_t* empty, uint64_t* full, uint32_t parity,
                                          int pt) {
  mbar_wait(empty, parity);
  const bool any = t.store_hi(hi, pt);
  if constexpr (Units<KT, W>::R == 2) {
    const bool lo = bar_or(kBarProducer, 128, any);
    if (lo) t.store_lo(hi + kKeysTc * W, pt);
    if (pt == 0) *flag = lo;
  }
  fence_async_smem();
  mbar_arrive(full);
}

// s (a warpgroup's 64 rows x 64 keys) = q k_hi^T (+ q k_lo^T when lo): q
// the A fragments, K [64][HD] K-major
template <int HD, bool LO>
__device__ __forceinline__ void wg_scores(float (&s)[kKeysTc / 8][4], const uint32_t (&qf)[HD / 16][4],
                                          const __nv_bfloat16* kh, const __nv_bfloat16* kl,
                                          int lo) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    wgmma_rs<64, 0>(s, qf[kk], wg_desc(kh + kk * 128, 128, HD * 16), kk > 0, 1);
  }
  if constexpr (LO) {
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      wgmma_rs<64, 0>(s, qf[kk], wg_desc(kl + kk * 128, 128, HD * 16), 1, lo);
    }
  }
}

// o += p_hi v_hi + p_lo v_hi (+ p_hi v_lo when lo): V [64][HDV] MN-major
template <int HDV, bool LO>
__device__ __forceinline__ void wg_values(float (&o)[HDV / 8][4], const uint32_t (&ph)[4][4],
                                          const uint32_t (&pl)[4][4], const __nv_bfloat16* vh,
                                          const __nv_bfloat16* vl, int lo) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    wgmma_rs<HDV, 1>(o, ph[kk], wg_desc(vh + kk * 16 * HDV, HDV * 16, 128), 1, 1);
  }
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    wgmma_rs<HDV, 1>(o, pl[kk], wg_desc(vh + kk * 16 * HDV, HDV * 16, 128), 1, 1);
  }
  if constexpr (LO) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_rs<HDV, 1>(o, ph[kk], wg_desc(vl + kk * 16 * HDV, HDV * 16, 128), 1, lo);
    }
  }
}

// a slot's lo flag, broadcast from lane 0 so that the compiler sees it
// uniform
__device__ __forceinline__ bool lo_flag(const int* f) {
  return __shfl_sync(0xffffffffu, *f, 0) != 0;
}

// Warpgroup 0 is the producer: it copies each 64-key tile's K and V rows
// by cp.async into a ring of kRaw raw slots (tiles n + 1 and n + 2 in
// flight while tile n is converted), converts each tile into the bf16 hi
// (and lo) tiles of the K and V rings, flags a tile whose lo is nonzero
// anywhere (storing the lo tile only then), and hands each over by an
// mbarrier. Warpgroups 1 and 2 are the consumers, 64 rows each (the
// block's rows as the mma body maps them), q's A fragments in registers.
// For tile n a consumer issues S_n = q K_n^T and then O += P_{n-1} V_{n-1},
// releases K_n once S_n is in, runs the online softmax of S_n while
// P_{n-1} V_{n-1} is in flight, then releases V_{n-1}, rescales O and
// splits P_n into its hi and lo A fragments.
template <typename KT, int HD, int HDV>
__global__ void __launch_bounds__(kWgThreads, 1) flash_fwd_wg(const Args a) {
  using L = WgFwd<KT, HD, HDV>;
  extern __shared__ __align__(128) unsigned char smem_wg[];
  auto k_hi = [&](int s) {
    return reinterpret_cast<__nv_bfloat16*>(smem_wg + s * L::kKSlot);
  };
  auto v_hi = [&](int s) {
    return reinterpret_cast<__nv_bfloat16*>(smem_wg + kConv * L::kKSlot + s * L::kVSlot);
  };
  int* kflag = reinterpret_cast<int*>(smem_wg + L::kFlagAt);  // [kConv]
  int* vflag = kflag + kConv;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem_wg + L::kBarAt);
  uint64_t* kfull = bars;
  uint64_t* kempty = bars + kConv;
  uint64_t* vfull = bars + 2 * kConv;
  uint64_t* vempty = bars + 3 * kConv;

  // the warp's roles broadcast from lane 0, so that the compiler sees them
  // uniform across the warp: a wgmma on a path it cannot prove uniform is
  // serialized
  const int tid = threadIdx.x, lane = tid & 31;
  const int warp = __shfl_sync(0xffffffffu, (tid >> 5) & 3, 0);
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);
  int y = blockIdx.y;
  const int hg = y % a.n_hgroups;
  y /= a.n_hgroups;
  const int kvh = y % a.KV;
  const int b = y / a.KV;
  const int t0 = (gridDim.x - 1 - blockIdx.x) * a.bt;  // the longest causal walks first
  const int t1 = min(t0 + a.bt, a.Tq);
  const Span sp = span_of(a, t0, t1, kKeysTc);
  const int n = sp.tile_hi - sp.tile_lo;

  if (tid == 0) {
    for (int s = 0; s < kConv; ++s) {
      mbar_init(kfull + s, 128);
      mbar_init(vfull + s, 128);
      mbar_init(kempty + s, 256);
      mbar_init(vempty + s, 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // the producer: tiles n + 1 and n + 2 in flight (cp.async) while tile n
    // is converted and handed over
    const KT* kb0 = static_cast<const KT*>(a.k) + b * a.sk[0] + kvh * a.sk[1];
    const KT* vb0 = static_cast<const KT*>(a.v) + b * a.sv[0] + kvh * a.sv[1];
    auto raw = [&](int i) {
      return reinterpret_cast<KT*>(smem_wg + L::kRawAt + (i % kRaw) * L::kRawSlot);
    };
    auto copy = [&](int i) {  // tile tile_lo + i into raw slot i % kRaw
      const int kbase = (sp.tile_lo + i) * kKeysTc;
      Units<KT, HD>::copy(raw(i), kb0, a.sk[2], kbase, a.Tk, tid);
      Units<KT, HDV>::copy(raw(i) + L::kRawK / sizeof(KT), vb0, a.sv[2], kbase, a.Tk, tid);
    };
#pragma unroll
    for (int r = 0; r < kRaw - 1; ++r) {
      if (r < n) copy(r);
      cp_async_commit();
    }
    Units<KT, HD> kt;
    Units<KT, HDV> vt;
    for (int i = 0; i < n; ++i) {
      asm volatile("cp.async.wait_group %0;\n" ::"n"(kRaw - 2) : "memory");
      bar_sync(kBarProducer, 128);  // tile i in from every thread; tile i - 1 fetched
      if (i + kRaw - 1 < n) copy(i + kRaw - 1);
      cp_async_commit();
      const int s = i % kConv;
      const uint32_t free_parity = ((i / kConv) & 1) ^ 1;
      kt.fetch(raw(i), tid);
      hand_over(kt, k_hi(s), kflag + s, kempty + s, kfull + s, free_parity, tid);
      vt.fetch(raw(i) + L::kRawK / sizeof(KT), tid);
      hand_over(vt, v_hi(s), vflag + s, vempty + s, vfull + s, free_parity, tid);
    }
    return;
  }

  // a consumer: warpgroup cw's 64 rows, this lane's two of its warp's 16
  const int cw = wg - 1, g = lane >> 2, tig = lane & 3;
  const int q_off = a.Tk - a.Tq;
  const Row r0 = row_of(a, cw * 64 + warp * 16 + g, kvh, hg, t0);
  const Row r1 = row_of(a, cw * 64 + warp * 16 + g + 8, kvh, hg, t0);
  const int qp0 = q_off + r0.t, qp1 = q_off + r1.t;
  uint32_t qf[HD / 16][4];  // bf16 as given: exact; 0 on rows past the tile
  {
    const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(a.q);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const Row& r = (i & 1) ? r1 : r0;
        const int d = kk * 16 + (i >> 1) * 8 + tig * 2;
        qf[kk][i] = r.valid ? *reinterpret_cast<const uint32_t*>(
                                  q + b * a.sq[0] + r.head * a.sq[1] + r.t * a.sq[2] + d)
                            : 0u;
      }
    }
  }
  const float sl2 = a.scale * kLog2e;
  float m0 = -INFINITY, m1 = -INFINITY;  // running max of rows g and g + 8 (log2 units)
  float l0 = 0.f, l1 = 0.f;              // this lane's part of the row sums
  float o[HDV / 8][4], s[kKeysTc / 8][4];
  uint32_t ph[4][4], pl[4][4];
#pragma unroll
  for (int j = 0; j < HDV / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
#pragma unroll
  for (int j = 0; j < kKeysTc / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) ph[j][0] = ph[j][1] = ph[j][2] = ph[j][3] = 0u;
#pragma unroll
  for (int j = 0; j < 4; ++j) pl[j][0] = pl[j][1] = pl[j][2] = pl[j][3] = 0u;

  // softmax of tile i's scores in s (log2 units): mask a tile that
  // straddles an edge (-inf: p = 0); the row max of the raw scores, then
  // p = 2^(s * scale * log2 e - max) in one FFMA; rescale O's factors
  auto softmax = [&](int i, float& alpha0, float& alpha1) {
    const int kbase = (sp.tile_lo + i) * kKeysTc;
    if (!tile_whole(a, sp, kbase)) {
#pragma unroll
      for (int j = 0; j < kKeysTc / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kp = kbase + j * 8 + tig * 2 + (e & 1);
          if (kp >= a.Tk || !allowed(a, e < 2 ? qp0 : qp1, kp)) s[j][e] = -INFINITY;
        }
      }
    }
    float mx0 = s[0][0], mx1 = s[0][2];
#pragma unroll
    for (int j = 0; j < kKeysTc / 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
    mx0 = fmaxf(m0, quad_max(mx0) * sl2);
    mx1 = fmaxf(m1, quad_max(mx1) * sl2);
    // a row with every key masked so far keeps max -inf; its offset 0
    // gives p = 0 and alpha = 0 (o and l are 0 there)
    const float off0 = mx0 == -INFINITY ? 0.f : mx0, off1 = mx1 == -INFINITY ? 0.f : mx1;
    alpha0 = fast_exp2(m0 - off0);
    alpha1 = fast_exp2(m1 - off1);
    m0 = mx0;
    m1 = mx1;
    float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
    for (int j = 0; j < kKeysTc / 8; ++j) {
      s[j][0] = fast_exp2(fmaf(s[j][0], sl2, -off0));
      s[j][1] = fast_exp2(fmaf(s[j][1], sl2, -off0));
      s[j][2] = fast_exp2(fmaf(s[j][2], sl2, -off1));
      s[j][3] = fast_exp2(fmaf(s[j][3], sl2, -off1));
      ls0 += s[j][0] + s[j][1];
      ls1 += s[j][2] + s[j][3];
    }
    l0 = l0 * alpha0 + ls0;
    l1 = l1 * alpha1 + ls1;
  };
  // P as the A fragments of the next product, split p = p_hi + p_lo
  auto split_p = [&]() {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      split2(s[2 * kk][0], s[2 * kk][1], ph[kk][0], pl[kk][0]);
      split2(s[2 * kk][2], s[2 * kk][3], ph[kk][1], pl[kk][1]);
      split2(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[kk][2], pl[kk][2]);
      split2(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[kk][3], pl[kk][3]);
    }
  };
  auto k_ready = [&](int i) {  // K_i landed; its lo flag
    const int sl = i % kConv;
    mbar_wait(kfull + sl, (i / kConv) & 1);
    return L::kLo ? static_cast<int>(lo_flag(kflag + sl)) : 0;
  };
  auto v_ready = [&](int i) {
    const int sl = i % kConv;
    mbar_wait(vfull + sl, (i / kConv) & 1);
    return L::kLo ? static_cast<int>(lo_flag(vflag + sl)) : 0;
  };

  // Each pipeline stage below, from its fence to its last wait, is
  // straight-line code (the lo products are guarded, not branched around):
  // the first tile's S, then each later tile's S with the last P V, then
  // the last tile's P V.
  if (n > 0) {
    const int k_lo = k_ready(0);
    wgmma_fence();
    wg_scores<HD, L::kLo>(s, qf, k_hi(0), k_hi(0) + L::kKTile, k_lo);
    wgmma_commit();
    wgmma_wait<0>();
    hold(s);
    mbar_arrive(kempty);
    float alpha0, alpha1;
    softmax(0, alpha0, alpha1);
    split_p();
  }
  for (int i = 1; i < n; ++i) {  // S_i, and P_{i-1} V_{i-1}
    const int s_k = i % kConv, s_v = (i - 1) % kConv;
    const int k_lo = k_ready(i), v_lo = v_ready(i - 1);
    wgmma_fence();
    wg_scores<HD, L::kLo>(s, qf, k_hi(s_k), k_hi(s_k) + L::kKTile, k_lo);
    wgmma_commit();
    wg_values<HDV, L::kLo>(o, ph, pl, v_hi(s_v), v_hi(s_v) + L::kVTile, v_lo);
    wgmma_commit();
    wgmma_wait<1>();  // S_i in; P_{i-1} V_{i-1} may run under the softmax
    hold(s);
    mbar_arrive(kempty + s_k);
    float alpha0, alpha1;
    softmax(i, alpha0, alpha1);
    wgmma_wait<0>();
    hold(o);
    hold(ph);
    hold(pl);
    mbar_arrive(vempty + s_v);
#pragma unroll
    for (int j = 0; j < HDV / 8; ++j) {
      o[j][0] *= alpha0;
      o[j][1] *= alpha0;
      o[j][2] *= alpha1;
      o[j][3] *= alpha1;
    }
    split_p();
  }
  if (n > 0) {  // the last tile's P V
    const int s_v = (n - 1) % kConv;
    const int v_lo = v_ready(n - 1);
    wgmma_fence();
    wg_values<HDV, L::kLo>(o, ph, pl, v_hi(s_v), v_hi(s_v) + L::kVTile, v_lo);
    wgmma_commit();
    wgmma_wait<0>();
    hold(o);
    mbar_arrive(vempty + s_v);
  }

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const long long n_rows = static_cast<long long>(a.B) * a.H * a.Tq;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const Row& r = half ? r1 : r0;
    if (!r.valid) continue;
    const float l = half ? l1 : l0;
    const float m = half ? m1 : m0;
    if (a.splits == 1) {
      __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.out) + b * a.so[0] +
                           r.head * a.so[1] + r.t * a.so[2];
      const float denom = fmaxf(l, 1e-30f);
      if (a.lse != nullptr && tig == 0) {  // m in log2 units
        a.lse[(static_cast<long long>(b) * a.H + r.head) * a.Tq + r.t] =
            l > 0.f ? (m + log2f(l)) * kLn2 : INFINITY;
      }
#pragma unroll
      for (int j = 0; j < HDV / 8; ++j) {
        *reinterpret_cast<__nv_bfloat162*>(out + j * 8 + tig * 2) =
            __floats2bfloat162_rn(o[j][2 * half] / denom, o[j][2 * half + 1] / denom);
      }
    } else {
      const long long row = (static_cast<long long>(b) * a.H + r.head) * a.Tq + r.t;
      const long long at = static_cast<long long>(blockIdx.z) * n_rows + row;
#pragma unroll
      for (int j = 0; j < HDV / 8; ++j) {
        *reinterpret_cast<float2*>(a.part_acc + at * HDV + j * 8 + tig * 2) =
            make_float2(o[j][2 * half], o[j][2 * half + 1]);
      }
      if (tig == 0) {  // flash_combine weighs the splits by exp(m) in natural units
        a.part_ml[at * 2] = m == -INFINITY ? kNegInf : m * kLn2;
        a.part_ml[at * 2 + 1] = l;
      }
    }
  }
}

size_t smem_bytes(int hd, int hc) {
  const int hdp = (hd + 3) & ~3;
  return sizeof(float) * (static_cast<size_t>(kRows) * hdp +
                          static_cast<size_t>(kKeys) * (hdp + 4) +
                          static_cast<size_t>(kKeys) * hc * 32 +
                          static_cast<size_t>(kWarps) * kKeys * kGroup);
}

template <typename QT>
void launch_combine(const Args& a, cudaStream_t s) {
  if (a.splits > 1) {
    const long long n_rows = static_cast<long long>(a.B) * a.H * a.Tq;
    flash_combine<QT><<<static_cast<unsigned int>(n_rows), ((a.hdv + 31) / 32) * 32, 0, s>>>(a);
  }
}

dim3 grid_of(const Args& a) {
  return dim3((a.Tq + a.bt - 1) / a.bt, a.B * a.KV * a.n_hgroups, a.splits);
}

template <int HC>
cudaError_t launch_simt(const Args& a, cudaStream_t s) {
  const size_t smem = smem_bytes(a.hd, HC);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_simt<HC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  flash_fwd_simt<HC><<<grid_of(a), kThreads, smem, s>>>(a);
  launch_combine<float>(a, s);
  return cudaGetLastError();
}

cudaError_t launch_simt_hd(const Args& a, cudaStream_t s) {
  switch ((a.hd + 31) / 32) {
    case 1: return launch_simt<1>(a, s);
    case 2: return launch_simt<2>(a, s);
    case 3: return launch_simt<3>(a, s);
    case 4: return launch_simt<4>(a, s);
    case 5: return launch_simt<5>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename KT, int KS, int WARPS, bool VN>
cudaError_t launch_mma_w(const Args& a, cudaStream_t s) {
  const size_t smem = Stages<KT, KS, WARPS>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_mma<KT, KS, WARPS, VN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  flash_fwd_mma<KT, KS, WARPS, VN><<<grid_of(a), WARPS * 32, smem, s>>>(a);
  launch_combine<__nv_bfloat16>(a, s);
  return cudaGetLastError();
}

// 16 query rows per warp: a block of up to 64 (group * bt) rows has 4
// warps, of up to 128 rows 8
template <typename KT, int KS, bool VN = false>
cudaError_t launch_mma(const Args& a, cudaStream_t s) {
  const int rows = a.group * a.bt;
  if (rows <= 64) return launch_mma_w<KT, KS, 4, VN>(a, s);
  if (rows <= 128) return launch_mma_w<KT, KS, 8, VN>(a, s);
  return cudaErrorInvalidValue;
}

// the smallest instantiated depth KS (16-deep slices) with KS * 16 >= hd:
// 1..6, then 8 (hd 128) and 10 (hd 160); the slices past hd are zero. A v
// narrower than hd takes the VN variant, built for KS 6 only (MLA's 96/64)
template <typename KT>
cudaError_t launch_mma_hd(const Args& a, cudaStream_t s) {
  if (a.hdv != a.hd) {
    return (a.hd + 15) / 16 == 6 ? launch_mma<KT, 6, true>(a, s) : cudaErrorInvalidValue;
  }
  switch ((a.hd + 15) / 16) {
    case 1: return launch_mma<KT, 1>(a, s);
    case 2: return launch_mma<KT, 2>(a, s);
    case 3: return launch_mma<KT, 3>(a, s);
    case 4: return launch_mma<KT, 4>(a, s);
    case 5: return launch_mma<KT, 5>(a, s);
    case 6: return launch_mma<KT, 6>(a, s);
    case 7:
    case 8: return launch_mma<KT, 8>(a, s);
    case 9:
    case 10: return launch_mma<KT, 10>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename KT, int HD, int HDV>
cudaError_t launch_wg(const Args& a, cudaStream_t s) {
  constexpr size_t smem = WgFwd<KT, HD, HDV>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_wg<KT, HD, HDV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  flash_fwd_wg<KT, HD, HDV><<<grid_of(a), kWgThreads, smem, s>>>(a);
  launch_combine<__nv_bfloat16>(a, s);
  return cudaGetLastError();
}

// the wgmma body, built for the routed (hd, hdv) pairs only, 128-row blocks
// with q's, k's, v's and out's rows 16-byte aligned
template <typename KT>
cudaError_t launch_wg_hd(const Args& a, cudaStream_t s) {
  if (!a.vec || a.group * a.bt > 128) return cudaErrorInvalidValue;
  if (a.hd == 80 && a.hdv == 80) return launch_wg<KT, 80, 80>(a, s);
  if (a.hd == 96 && a.hdv == 64) return launch_wg<KT, 96, 64>(a, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. lse: null, or (B,H,Tq) fp32 for
// each row's log-sum-exp. q and out share q_dtype; k and v
// share kv_dtype. The (q, k/v) pairs built are fp32/fp32, bf16/fp32 (the
// serving path: bf16 activations over the fp32 cache) and bf16/bf16. body
// (flash_attention.fwd_body picks it): 0 = simt (fp32 q), 1 = mma (bf16
// q), 2 = wgmma (bf16 q, (hd, hdv) = (80, 80) or (96, 64), vec covering
// q's and out's rows too). hd is q's and k's head dim, hdv (<= hd) v's and
// the output's; with bf16 q, hdv < hd only for hd 81..96. Strides are in
// elements, ordered (batch, head, t, dim). vec: K's and V's rows may both
// be copied 16 bytes at a time (each with unit stride along its head dim,
// its other strides, its width and its base 16-byte aligned).
extern "C" int cobra_flash_attention(
    const void* q, const void* k, const void* v, void* out, void* part_acc,
    void* part_ml, void* lse, int B, int H, int KV, int Tq, int Tk, int hd, int hdv,
    const long long* sq, const long long* sk, const long long* sv,
    const long long* so, int causal, int window, int chunk, float scale,
    int group, int n_hgroups, int bt, int splits, int q_dtype, int kv_dtype,
    int body, int vec, void* stream) {
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.out = out;
  a.part_acc = static_cast<float*>(part_acc);
  a.part_ml = static_cast<float*>(part_ml);
  a.lse = static_cast<float*>(lse);
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
  }
  a.causal = causal;
  a.window = window;
  a.chunk = chunk;
  a.scale = scale;
  a.group = group;
  a.n_hgroups = n_hgroups;
  a.bt = bt;
  a.splits = splits;
  a.vec = vec;
  if (B == 0 || H == 0 || Tq == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (body == 2 && q_dtype == 1 && kv_dtype == 0) {
    err = launch_wg_hd<float>(a, s);
  } else if (body == 2 && q_dtype == 1 && kv_dtype == 1) {
    err = launch_wg_hd<__nv_bfloat16>(a, s);
  } else if (body == 1 && q_dtype == 1 && kv_dtype == 0) {
    err = launch_mma_hd<float>(a, s);
  } else if (body == 1 && q_dtype == 1 && kv_dtype == 1) {
    err = launch_mma_hd<__nv_bfloat16>(a, s);
  } else if (body == 0 && q_dtype == 0 && kv_dtype == 0) {
    err = launch_simt_hd(a, s);
  }
  return static_cast<int>(err);
}
