// Flash-attention backward for NVIDIA Hopper (sm_90a), CUDA C++ with a plain
// C interface (loaded through ctypes by kernels/flash_attention.py).
//
// The JAX package has no backward kernel: it differentiates
// repro/models/layers.py::attention, an online-softmax scan whose body is
// wrapped in jax.checkpoint, so jax.grad recomputes each (Tq, block) score
// tile in the VJP instead of saving it.  This file computes the same gradient
// the same way, from what the forward kernel (flash_attention.cu) leaves:
// q, k, v, o and the row log-sum-exp, with dO from the caller.  For each
// score tile it recomputes S = scale * Q K^T (soft-capped as the forward
// does), P = exp(S - lse) and dP = dO V^T, and forms
//   dS = P * (dP - delta), times (1 - tanh^2(s/cap)) under a soft-cap,
//   delta = rowsum(dO * O),
//   dV = P^T dO,  dK = scale * dS^T Q,  dQ = scale * dS K,
// dK and dV summed over the G query heads of each kv head.
//
// It takes what training reaches through the forward: causal attention with
// Tq == Tk (self-attention; a sliding window, qpos - kpos < window), or
// non-causal attention with any Tq, Tk >= 1 and no window (the VLM's cross
// blocks: Tq text positions over Tk media tokens); ragged tails masked
// (query rows past Tq and keys past Tk get P = 0: a zero-filled row past Tq
// reads an LSE of 0 and would get P = 1), a tanh soft-cap, D in {64, 80,
// 128, 256}, float32 or bfloat16.  All tensors contiguous: q, o, dO, dQ
// (B, Tq, H, D); k, v, dK, dV (B, Tk, H/G, D); lse, delta (B, H, Tq) float32.
//
// What bounds it on this card: at granite-3-2b's training shape (B=4, T=2048,
// H=32, K=8, D=64, bf16, causal) the five T^2 D products of the gradient
// (S, dP, dV, dK, dQ) are 171.9 GFLOP, 0.174 ms at 989 TFLOP/s, against
// ~169 MB of q, k, v, o, dO, lse in and dQ, dK, dV out (0.05 ms at 3.35
// TB/s): compute-bound.  This design runs seven products, not five (S and
// dP are formed again in the dQ kernel, which keeps dQ free of atomics and
// the result deterministic), so its own bound is 7/5 of that, 0.243 ms.
// Times are in PERF.md.
//
// Three kernels, no atomics, each output written once by one block:
//   1. delta: one warp a row, rowsum(dO * O) in float32.
//   2. dK/dV: one block a (batch, kv head, key tile); it loops over the G
//      query heads of its kv head and the query tiles from the diagonal on
//      (bounded by the window; all of them when not causal), so the GQA sum
//      stays in registers.  Key tile 0 has the most query tiles and is
//      launched first.
//   3. dQ: one block a (batch, query head, query tile), looping over the key
//      tiles up to the diagonal (all of them when not causal); the last
//      query tile is launched first.
// bfloat16 (the training path), on the tensor cores with wgmma fed by TMA:
//   * warp specialisation: a producer warp (its warpgroup gives up its
//     registers with setmaxnreg) loads the fixed tiles once (K, V in dK/dV;
//     Q, dO in dQ) and keeps TMA loads of the streamed tiles in flight
//     through a ring of 2-4 stages with mbarriers; no __syncthreads in the
//     loop.  Two consumer warpgroups (setmaxnreg to 240) own 64 rows each;
//   * S^T = K Q^T and dP^T = V dO^T (dQ: S = Q K^T, dP = dO V^T) are wgmma
//     products with both operands from shared memory, on 64 x 128 score
//     tiles at D = 64 (m64n128k16; 64 x 64 at D >= 128, where the registers
//     allow no more).  P^T and dS^T are rounded to bf16 in registers, where
//     the accumulator layout is the A-fragment layout of the next product,
//     and dV += P^T dO, dK += dS^T Q (dQ += dS K) are wgmma m64nDCk16 with A
//     from registers and B read MN-major from the same swizzled tiles
//     (hopper.cuh);
//   * the exponentials of P run while dP is still on the tensor cores, and
//     dQ's product stays in flight into the next tile;
//   * masking only where a tile crosses the diagonal, the window's edge or
//     the end of the sequence: interior tiles run an unmasked body; both
//     bodies sit between the products, never around one (a wgmma under a
//     runtime branch serializes all of them);
//   * P = 2^(s scale log2(e) - lse2) with one ex2 on the special-function
//     unit a score: the LSE is scaled by log2(e) once a row (by the
//     producer lanes in dK/dV, which store it beside delta in the stage; by
//     each consumer thread for its two rows in dQ);
//   * D = 256: dK and dV of 64 keys by 256 columns would need 256 registers
//     a thread, so a block accumulates 128 of the columns (two blocks a
//     tile, each forming S and dP) with one consumer warpgroup, whose K, V
//     and two-stage ring fill ~194 KB of shared memory; dQ likewise;
//   * D = 80 (zamba2) runs on the D = 128 tiles, as the forward does: the
//     tensor maps end at column 80, so TMA zero-fills columns 80..127 of
//     every tile; S and dP take the 5 k16 steps of the 80 real columns,
//     the dV, dK and dQ products the tile's 128 (their last 48 columns are
//     zeros, 1.6x the work of those three), and only 80 columns are
//     stored.
// float32: CUDA cores, 32 x 32 tiles, 256 threads a block, same loop
// structure, P and dS staged in shared memory (a tensor-core product would
// round the f32 inputs).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr float LOG2E = 1.4426950408889634f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;
  float* delta;
  void* dq;
  void* dk;
  void* dv;
  int B, H, G, Tq, Tk;
  int causal, window;
  float softcap, scale;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

// whether query qpos sees key kpos: causal (kpos <= qpos, which keeps kpos
// below Tk = Tq) or, not causal, every key below Tk; within the window; and
// a query row below Tq
__device__ __forceinline__ bool visible(int qpos, int kpos, const Params& p) {
  return (p.causal ? kpos <= qpos : kpos < p.Tk) && qpos < p.Tq &&
         (p.window <= 0 || qpos - kpos < p.window);
}

// P and dS of one score: s is the raw dot product q.k, lse2 the row's
// log-sum-exp times log2(e), delta the row's rowsum(dO * O)
__device__ __forceinline__ void p_ds(float s, float dp, int qpos, int kpos,
                                     float lse2, float delta,
                                     const Params& p, float& pr, float& ds) {
  float x = s * p.scale, dcap = 1.f;
  if (p.softcap > 0.f) {
    const float th = tanhf(x / p.softcap);
    x = p.softcap * th;
    dcap = 1.f - th * th;
  }
  pr = visible(qpos, kpos, p) ? exp2f(fmaf(x, LOG2E, -lse2)) : 0.f;
  ds = pr * (dp - delta) * dcap;
}

// ---- delta = rowsum(dO * O): one warp a (batch, time, head) row ------------

template <typename T, int D>
__global__ void __launch_bounds__(256) delta_kernel(const Params p) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long row = (long long)blockIdx.x * 8 + warp;
  if (row >= (long long)p.B * p.Tq * p.H) return;
  const T* O = static_cast<const T*>(p.o) + row * D;
  const T* dO = static_cast<const T*>(p.dout) + row * D;
  float s = 0.f;
#pragma unroll
  for (int d = lane; d < D; d += 32) s = fmaf(to_f(O[d]), to_f(dO[d]), s);
#pragma unroll
  for (int off = 16; off; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) {
    const int h = (int)(row % p.H);
    const long long bt = row / p.H;
    const int t = (int)(bt % p.Tq), b = (int)(bt / p.Tq);
    p.delta[((long long)b * p.H + h) * p.Tq + t] = s;
  }
}

// ---- bfloat16: TMA ring + wgmma, warp-specialised --------------------------
//
// Both kernels cut the scores into tiles of 64 rows by BN columns (BN =
// 128 at D = 64, else 64).  A consumer warpgroup owns 64 rows of them (keys
// in dK/dV, queries in dQ) and walks the column tiles that one producer
// warp streams through a ring of S shared-memory stages: a "full" barrier a
// stage (TMA bytes landed, and in dK/dV the producer lanes' stores of the
// stage's row statistics) and an "empty" one (every consumer warp done with
// it).  A tile of n rows of D bf16 is stored as D / 64 chunks of n rows of
// 128 bytes in the 128-byte swizzled layout of a TMA load, so it is a wgmma
// operand as it lands: K-major for S^T = K Q^T (S = Q K^T in dQ), MN-major
// for dV += P^T dO and dK += dS^T Q (dQ += dS K), from the same bytes.

constexpr int BR = 64;              // rows and columns of a score tile
constexpr int CHUNK = BR * 128;     // one 64-column chunk of a 64-row tile

template <int D>
struct Bf16Cfg {
  // consumer warpgroups a block: two at D <= 128 (the producer warpgroup
  // hands them its registers); one at D = 256, where two would not fit
  // their K, V and ring in 227 KB
  static constexpr int NW = D == 256 ? 1 : 2;
  static constexpr int NT = 128 * (NW + 1);
  // gradient columns a block accumulates: at D = 256 two blocks a row tile
  // take 128 columns each, each recomputing S and dP, so that dK + dV stay
  // at 128 registers a thread
  static constexpr int DC = D == 256 ? 128 : D;
  static constexpr int NC = D / DC;
  static constexpr int CH = D / 64;                 // 128-byte chunks a row
  static constexpr uint32_t TILE = CH * CHUNK;      // 64 rows of D bf16
  static constexpr int S = D == 64 ? 4 : D == 128 ? 3 : 2;   // ring stages
  // columns of a score tile (queries in dK/dV, keys in dQ): 128 at D = 64
  // (wider products, half the waits a column); at D >= 128 the registers
  // allow 64
  static constexpr int BN = D == 64 ? 128 : 64;
  static constexpr uint32_t CTILE = CH * BN * 128;  // BN rows of D bf16
  // dK/dV: K, V of the block; a stage is a column tile of Q and of dO and
  // their (lse2, delta)
  static constexpr size_t SMEM_KV = 1024 + 2 * NW * TILE +
                                    S * (2 * CTILE + BN * sizeof(float2)) +
                                    (2 * S + 1) * sizeof(uint64_t);
  // dQ: Q, dO of the block; a stage is a column tile of K and of V
  static constexpr size_t SMEM_Q = 1024 + 2 * NW * TILE + 2 * S * CTILE +
                                   (2 * S + 1) * sizeof(uint64_t);
};

struct Maps {
  CUtensorMap q, k, v, dout;    // (D, heads, T, B), boxes 64 x 1 x 64 x 1
};

// The constants of P and dS in log2 units: P = 2^(s scale log2(e) - lse2),
// or under a soft-cap P = 2^(cap log2(e) tanh(s scale / cap) - lse2)
struct Consts {
  float scale2, cap2, inv;
};

// a tile of queries [q0, q0 + nq) and keys [k0, k0 + nk) needs no mask when
// every key is at or before every query (causal) or before Tk (not causal),
// within the window, and every row is before Tq
__device__ __forceinline__ bool interior(int q0, int nq, int k0, int nk,
                                         const Params& p) {
  return (p.causal ? k0 + nk - 1 <= q0 : k0 + nk <= p.Tk) &&
         q0 + nq <= p.Tq && (p.window <= 0 || q0 + nq - 1 - k0 < p.window);
}

// (x, y) -> bf16x2, x in the low half
__device__ __forceinline__ uint32_t pack(float x, float y) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// P and dS = P (dP - delta) (times 1 - tanh^2 under a soft-cap) of a
// warpgroup's 64 x N tile from the accumulators s (raw dot products q.k)
// and dp (dO.v), in one pass, as the bf16 A fragments pf and sf of the
// next products: fragment kq holds columns 16 kq .. 16 kq + 15, the
// accumulator layout of n8 blocks 2 kq and 2 kq + 1 (hopper.cuh).  s and
// dp die as the fragments grow, so that a 64 x 128 tile fits beside dK and
// dV.  Element e of block j is row r0 + 8 (e >> 1), column c0 + 8 j +
// (e & 1) (r0 = the tile's row + 16 warp + lane / 4, c0 = its column +
// 2 (lane % 4)); KEYROWS: rows are keys (dK/dV), else queries (dQ).
// stat(j, e) -> (lse2, delta) of the element's query.  MASK: ``visible``,
// else none.
template <bool MASK, bool CAP, bool KEYROWS, int N, typename Stat>
__device__ __forceinline__ void tile_p_ds(const float (&s)[N / 2],
                                          const float (&dp)[N / 2],
                                          uint32_t (&pf)[N / 16][4],
                                          uint32_t (&sf)[N / 16][4], int r0,
                                          int c0, Stat stat, const Params& p,
                                          const Consts& k) {
#pragma unroll
  for (int kq = 0; kq < N / 16; ++kq) {
    float pr[8], ds[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int j = 2 * kq + i / 4, e = i % 4, x = 4 * j + e;
      const float2 st = stat(j, e);
      if (CAP) {
        const float th = tanhf(s[x] * k.inv);
        pr[i] = hopper::ex2(fmaf(k.cap2, th, -st.x));
        ds[i] = pr[i] * (dp[x] - st.y) * (1.f - th * th);
      } else {
        pr[i] = hopper::ex2(fmaf(s[x], k.scale2, -st.x));
        ds[i] = pr[i] * (dp[x] - st.y);
      }
      if (MASK) {
        const int r = r0 + 8 * (e >> 1), c = c0 + 8 * j + (e & 1);
        const int qpos = KEYROWS ? c : r, kpos = KEYROWS ? r : c;
        if (!visible(qpos, kpos, p)) pr[i] = ds[i] = 0.f;
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      pf[kq][r] = pack(pr[2 * r], pr[2 * r + 1]);
      sf[kq][r] = pack(ds[2 * r], ds[2 * r + 1]);
    }
  }
}

// Without a soft-cap the pass splits in two, so that the exponentials run
// while dP^T is still on the tensor cores: tile_p_inplace turns s into P
// (masked to 0), tile_pack_ds then forms the fragments of P and of
// dS = P (dP - delta).
template <bool MASK, bool KEYROWS, int N, typename Stat>
__device__ __forceinline__ void tile_p_inplace(float (&s)[N / 2], int r0,
                                               int c0, Stat stat,
                                               const Params& p,
                                               const Consts& k) {
#pragma unroll
  for (int x = 0; x < N / 2; ++x) {
    const int j = x / 4, e = x % 4;
    float pr = hopper::ex2(fmaf(s[x], k.scale2, -stat(j, e).x));
    if (MASK) {
      const int r = r0 + 8 * (e >> 1), c = c0 + 8 * j + (e & 1);
      const int qpos = KEYROWS ? c : r, kpos = KEYROWS ? r : c;
      if (!visible(qpos, kpos, p)) pr = 0.f;
    }
    s[x] = pr;
  }
}

template <int N, typename Stat>
__device__ __forceinline__ void tile_pack_ds(const float (&s)[N / 2],
                                             const float (&dp)[N / 2],
                                             uint32_t (&pf)[N / 16][4],
                                             uint32_t (&sf)[N / 16][4],
                                             Stat stat) {
#pragma unroll
  for (int kq = 0; kq < N / 16; ++kq) {
    float ds[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int j = 2 * kq + i / 4, e = i % 4, x = 4 * j + e;
      ds[i] = s[x] * (dp[x] - stat(j, e).y);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      pf[kq][r] = pack(s[8 * kq + 2 * r], s[8 * kq + 2 * r + 1]);
      sf[kq][r] = pack(ds[2 * r], ds[2 * r + 1]);
    }
  }
}

// P and dS of a 64 x N tile around the wait for dP^T: before() while dP^T
// is in flight, after() once it has landed; the four bodies (masked or not,
// soft-cap or not) are chosen by warp-uniform branches, and no wgmma is
// issued under them (ptxas would serialize every wgmma)
template <bool KEYROWS, int N, typename Stat>
struct PdS {
  float (&s)[N / 2];
  const float (&dp)[N / 2];
  bool masked;
  int r0, c0;
  Stat stat;
  const Params& p;
  const Consts& k;

  __device__ __forceinline__ void before() {
    if (p.softcap > 0.f) return;
    if (masked)
      tile_p_inplace<true, KEYROWS, N>(s, r0, c0, stat, p, k);
    else
      tile_p_inplace<false, KEYROWS, N>(s, r0, c0, stat, p, k);
  }
  __device__ __forceinline__ void after(uint32_t (&pf)[N / 16][4],
                                        uint32_t (&sf)[N / 16][4]) {
    if (p.softcap > 0.f) {
      if (masked)
        tile_p_ds<true, true, KEYROWS, N>(s, dp, pf, sf, r0, c0, stat, p, k);
      else
        tile_p_ds<false, true, KEYROWS, N>(s, dp, pf, sf, r0, c0, stat, p,
                                           k);
    } else {
      tile_pack_ds<N>(s, dp, pf, sf, stat);
    }
  }
};

// X = A B^T over D for a warpgroup's 64 x N tile: A (64 rows) and B (N
// rows) K-major at shared addresses a and b, their 64-column chunks
// 64 x 128 and N x 128 bytes apart
template <int D, int N>
__device__ __forceinline__ void issue_scores(float (&x)[N / 2], uint32_t a,
                                             uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk % 4) * 32;
    hopper::Wgmma<N>::ss_bf16(
        x, hopper::desc_sw128(a + (kk / 4) * CHUNK + off, 16),
        hopper::desc_sw128(b + (kk / 4) * N * 128 + off, 16), kk > 0);
  }
}

// acc += F B over K rows of B: F the bf16 A fragments (K / 16 of them), B
// MN-major at b (K rows, 64-column chunks K x 128 bytes apart), DC of its
// columns from column c0
template <int DC, int K>
__device__ __forceinline__ void issue_grad(float (&acc)[DC / 2],
                                           const uint32_t (&f)[K / 16][4],
                                           uint32_t b, int c0) {
#pragma unroll
  for (int kq = 0; kq < K / 16; ++kq)
    hopper::Wgmma<DC>::rs_bf16_tb(
        acc, f[kq],
        hopper::desc_sw128(b + (c0 / 64) * K * 128 + kq * 16 * 128, K * 128),
        1);
}

template <int K>
__device__ __forceinline__ void fence_frags(uint32_t (&f)[K][4]) {
#pragma unroll
  for (int kq = 0; kq < K; ++kq) hopper::fence_regs(f[kq]);
}

// a warpgroup's 64 x DC accumulator (rows row0 + 16 warp + lane / 4 (+ 8))
// times f into X (row stride ld) from column c0; rows >= n and columns >=
// ncol are left out
template <int DC>
__device__ __forceinline__ void store_rows(bf16* X, long long ld, int row0,
                                           int n, int c0, int ncol,
                                           const float (&acc)[DC / 2],
                                           float f) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int warp = (threadIdx.x % 128) / 32;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 16 * warp + g + 8 * r;
    if (row >= n) continue;
#pragma unroll
    for (int j = 0; j < DC / 8; ++j) {
      if (c0 + 8 * j >= ncol) continue;
      *reinterpret_cast<__nv_bfloat162*>(X + row * ld + c0 + 8 * j + 2 * t) =
          __floats2bfloat162_rn(acc[4 * j + 2 * r] * f,
                                acc[4 * j + 2 * r + 1] * f);
    }
  }
}

__device__ __forceinline__ void release(uint64_t* bar) {
  __syncwarp();
  if (threadIdx.x % 32 == 0) hopper::mbar_arrive(bar);
}

// dK, dV: one block a (kv head, column chunk, batch; blockIdx.x) and key
// tile of NW x 64 keys (blockIdx.y, key tile 0, the longest, first).  The
// producer loads K and V once and streams Q, dO and (lse2, delta) of every
// query tile (BN queries each) that sees one of the block's keys (every
// query tile when not causal), for each of the G query heads of the kv head
// in turn, so the GQA sum stays in registers.  D is the tile's width, DT
// the head dim (80 on the 128-wide tile, else D).
template <int D, int DT>
__global__ void __launch_bounds__(Bf16Cfg<D>::NT, 1)
dkdv_bf16_kernel(const __grid_constant__ Maps maps, const Params p) {
  using C = Bf16Cfg<D>;
  constexpr int NW = C::NW, DC = C::DC, CH = C::CH, S = C::S, BN = C::BN;
  constexpr uint32_t TILE = C::TILE, CTILE = C::CTILE;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sK = hopper::align1024(smem_raw);    // NW tiles
  unsigned char* sV = sK + NW * TILE;                 // NW tiles
  unsigned char* sQ = sV + NW * TILE;                 // ring: S query tiles
  unsigned char* sO = sQ + S * CTILE;                 // ring: S tiles of dO
  float2* sStat = reinterpret_cast<float2*>(sO + S * CTILE);  // S x BN
  uint64_t* full = reinterpret_cast<uint64_t*>(sStat + S * BN);
  uint64_t* empty = full + S;
  uint64_t* kvbar = empty + S;

  const int KV = p.H / p.G;
  const int kh = blockIdx.x % KV, cc = (blockIdx.x / KV) % C::NC;
  const int b = blockIdx.x / (KV * C::NC);
  const int bk0 = blockIdx.y * NW * BR;
  const int nt = (p.Tq + BN - 1) / BN;
  // query tiles that see a key of the block: from the diagonal on (from 0
  // when not causal), up to the last query in the window of its last key;
  // iteration it is query tile qt_lo + it % nq of query head kh G + it / nq
  const int qt_lo = p.causal ? bk0 / BN : 0;
  int qt_hi = nt;
  if (p.window > 0)
    qt_hi = min(nt, (bk0 + NW * BR - 1 + p.window - 1) / BN + 1);
  const int nq = qt_hi - qt_lo, n_it = p.G * nq;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      hopper::mbar_init(&full[s], 32);          // the producer warp's lanes
      hopper::mbar_init(&empty[s], 4 * NW);     // one arrival a consumer warp
    }
    hopper::mbar_init(kvbar, 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128, lane = threadIdx.x % 32;
  if (wg == NW) {
    // ---- producer: K, V once; Q, dO, lse2, delta through the ring ----
    if constexpr (NW > 1) hopper::setmaxnreg_dec<24>();
    if (threadIdx.x / 32 != 4 * NW) return;
    if (lane == 0) {
      hopper::mbar_arrive_expect_tx(kvbar, 2 * NW * TILE);
      for (int w = 0; w < NW; ++w)
        for (int c = 0; c < CH; ++c) {
          hopper::tma_load_4d(sK + w * TILE + c * CHUNK, &maps.k, kvbar,
                              c * 64, kh, bk0 + w * BR, b);
          hopper::tma_load_4d(sV + w * TILE + c * CHUNK, &maps.v, kvbar,
                              c * 64, kh, bk0 + w * BR, b);
        }
    }
    for (int it = 0; it < n_it; ++it) {
      const int s = it % S, h = kh * p.G + it / nq;
      const int q0 = (qt_lo + it % nq) * BN;
      if (it >= S) hopper::mbar_wait(&empty[s], ((it / S) - 1) & 1);
      if (lane == 0) {
        hopper::mbar_expect_tx(&full[s], 2 * CTILE);
        // chunk c of a query tile holds its BN rows, 64 a box
        for (int c = 0; c < CH; ++c)
          for (int r = 0; r < BN; r += BR) {
            const uint32_t off = s * CTILE + c * BN * 128 + r * 128;
            hopper::tma_load_4d(sQ + off, &maps.q, &full[s], c * 64, h,
                                q0 + r, b);
            hopper::tma_load_4d(sO + off, &maps.dout, &full[s], c * 64, h,
                                q0 + r, b);
          }
      }
      // the LSE in log2 units, once a query; rows past Tq are masked
      const long long r_off = ((long long)b * p.H + h) * p.Tq;
      for (int r = lane; r < BN; r += 32) {
        const int q = q0 + r;
        sStat[s * BN + r] =
            q < p.Tq ? make_float2(p.lse[r_off + q] * LOG2E,
                                   p.delta[r_off + q])
                     : make_float2(0.f, 0.f);
      }
      hopper::mbar_arrive(&full[s]);
    }
    return;
  }

  // ---- consumers: 64 keys a warpgroup ----
  if constexpr (NW > 1) hopper::setmaxnreg_inc<240>();
  const int warp = (threadIdx.x % 128) / 32, g = lane / 4, t = lane % 4;
  const int k0 = bk0 + wg * BR;
  const uint32_t k_addr = hopper::smem_u32(sK + wg * TILE);
  const uint32_t v_addr = hopper::smem_u32(sV + wg * TILE);
  const Consts kc{p.scale * LOG2E, p.softcap * LOG2E,
                  p.softcap > 0.f ? p.scale / p.softcap : 0.f};
  float dk[DC / 2], dv[DC / 2], s[BN / 2], dp[BN / 2];
  uint32_t pf[BN / 16][4], sf[BN / 16][4];
#pragma unroll
  for (int i = 0; i < DC / 2; ++i) dk[i] = dv[i] = 0.f;

  // S^T, dP^T and dV + dK go out as three groups, all retired within the
  // tile (groups left in flight across the loop's back edge made ptxas
  // serialize every wgmma, for want of registers at a 64 x 128 tile)
  hopper::mbar_wait(kvbar, 0);
  for (int it = 0; it < n_it; ++it) {
    const int st = it % S, q0 = (qt_lo + it % nq) * BN;
    const uint32_t q_addr = hopper::smem_u32(sQ + st * CTILE);
    const uint32_t o_addr = hopper::smem_u32(sO + st * CTILE);
    // query 8 j + 2 t + {0, 1} of the tile: one 16-byte load for the pair
    const float2* stat = sStat + st * BN + 2 * t;
    auto col_stat = [&](int j, int e) {
      const float4 v = *reinterpret_cast<const float4*>(stat + 8 * j);
      return (e & 1) ? make_float2(v.z, v.w) : make_float2(v.x, v.y);
    };
    hopper::mbar_wait(&full[st], (it / S) & 1);
    // S^T = K Q^T, dP^T = V dO^T
    hopper::fence_regs(s);
    hopper::fence_regs(dp);
    hopper::wgmma_fence();
    issue_scores<DT, BN>(s, k_addr, q_addr);
    hopper::wgmma_commit();
    issue_scores<DT, BN>(dp, v_addr, o_addr);
    hopper::wgmma_commit();
    PdS<true, BN, decltype(col_stat)> pds{s, dp, !interior(q0, BN, k0, BR, p),
                                          k0 + 16 * warp + g, q0 + 2 * t,
                                          col_stat, p, kc};
    hopper::wgmma_wait<1>();
    hopper::fence_regs(s);
    pds.before();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(dp);
    pds.after(pf, sf);
    // dV += P^T dO, dK += dS^T Q
    fence_frags(pf);
    fence_frags(sf);
    hopper::fence_regs(dk);
    hopper::fence_regs(dv);
    hopper::wgmma_fence();
    issue_grad<DC, BN>(dv, pf, o_addr, cc * DC);
    issue_grad<DC, BN>(dk, sf, q_addr, cc * DC);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(dk);
    hopper::fence_regs(dv);
    release(&empty[st]);
  }
  const long long ldk = (long long)KV * DT;
  const long long kv_off = ((long long)b * p.Tk * KV + kh) * DT;
  store_rows<DC>(static_cast<bf16*>(p.dk) + kv_off, ldk, k0, p.Tk, cc * DC,
                 DT, dk, p.scale);
  store_rows<DC>(static_cast<bf16*>(p.dv) + kv_off, ldk, k0, p.Tk, cc * DC,
                 DT, dv, 1.f);
}

// dQ: one block a (query head, column chunk, batch; blockIdx.x) and query
// tile of NW x 64 queries (blockIdx.y, the last tile, the longest, first).
// The producer loads Q and dO once and streams K and V of the key tiles
// (BN keys each) from the first in the window of the block's first query
// up to the diagonal of its last (every key tile when not causal).
template <int D, int DT>
__global__ void __launch_bounds__(Bf16Cfg<D>::NT, 1)
dq_bf16_kernel(const __grid_constant__ Maps maps, const Params p) {
  using C = Bf16Cfg<D>;
  constexpr int NW = C::NW, DC = C::DC, CH = C::CH, S = C::S, BN = C::BN;
  constexpr uint32_t TILE = C::TILE, CTILE = C::CTILE;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sQ = hopper::align1024(smem_raw);    // NW tiles
  unsigned char* sO = sQ + NW * TILE;                 // NW tiles of dO
  unsigned char* sK = sO + NW * TILE;                 // ring: S key tiles
  unsigned char* sV = sK + S * CTILE;                 // ring: S key tiles
  uint64_t* full = reinterpret_cast<uint64_t*>(sV + S * CTILE);
  uint64_t* empty = full + S;
  uint64_t* qbar = empty + S;

  const int h = blockIdx.x % p.H, cc = (blockIdx.x / p.H) % C::NC;
  const int b = blockIdx.x / (p.H * C::NC), kh = h / p.G;
  const int bq0 = (gridDim.y - 1 - blockIdx.y) * NW * BR;
  const int nt = (p.Tk + BN - 1) / BN;
  const int kt_lo = p.window > 0 ? max(0, bq0 - p.window + 1) / BN : 0;
  const int kt_hi = p.causal ? min(nt, (bq0 + NW * BR - 1) / BN + 1) : nt;
  const int n_it = kt_hi - kt_lo;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 4 * NW);     // one arrival a consumer warp
    }
    hopper::mbar_init(qbar, 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128, lane = threadIdx.x % 32;
  if (wg == NW) {
    // ---- producer: Q, dO once; K, V through the ring ----
    if constexpr (NW > 1) hopper::setmaxnreg_dec<24>();
    if (threadIdx.x != 128 * NW) return;
    hopper::mbar_arrive_expect_tx(qbar, 2 * NW * TILE);
    for (int w = 0; w < NW; ++w)
      for (int c = 0; c < CH; ++c) {
        hopper::tma_load_4d(sQ + w * TILE + c * CHUNK, &maps.q, qbar, c * 64,
                            h, bq0 + w * BR, b);
        hopper::tma_load_4d(sO + w * TILE + c * CHUNK, &maps.dout, qbar,
                            c * 64, h, bq0 + w * BR, b);
      }
    for (int it = 0; it < n_it; ++it) {
      const int s = it % S, k0 = (kt_lo + it) * BN;
      if (it >= S) hopper::mbar_wait(&empty[s], ((it / S) - 1) & 1);
      hopper::mbar_arrive_expect_tx(&full[s], 2 * CTILE);
      // chunk c of a key tile holds its BN rows, 64 a box
      for (int c = 0; c < CH; ++c)
        for (int r = 0; r < BN; r += BR) {
          const uint32_t off = s * CTILE + c * BN * 128 + r * 128;
          hopper::tma_load_4d(sK + off, &maps.k, &full[s], c * 64, kh,
                              k0 + r, b);
          hopper::tma_load_4d(sV + off, &maps.v, &full[s], c * 64, kh,
                              k0 + r, b);
        }
    }
    return;
  }

  // ---- consumers: 64 queries a warpgroup ----
  if constexpr (NW > 1) hopper::setmaxnreg_inc<240>();
  const int warp = (threadIdx.x % 128) / 32, g = lane / 4, t = lane % 4;
  const int q0 = bq0 + wg * BR, row0 = q0 + 16 * warp + g;
  const uint32_t q_addr = hopper::smem_u32(sQ + wg * TILE);
  const uint32_t o_addr = hopper::smem_u32(sO + wg * TILE);
  const Consts kc{p.scale * LOG2E, p.softcap * LOG2E,
                  p.softcap > 0.f ? p.scale / p.softcap : 0.f};
  // (lse2, delta) of rows row0, row0 + 8: the LSE in log2 units once a row
  float2 rs[2];
  const long long r_off = ((long long)b * p.H + h) * p.Tq;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    rs[r] = row < p.Tq
                ? make_float2(p.lse[r_off + row] * LOG2E, p.delta[r_off + row])
                : make_float2(0.f, 0.f);
  }
  float dq[DC / 2], s[BN / 2], dp[BN / 2];
  uint32_t pf[BN / 16][4], sf[BN / 16][4];
#pragma unroll
  for (int i = 0; i < DC / 2; ++i) dq[i] = 0.f;

  // as in dK/dV, P is formed while dP is on the tensor cores; the dQ product
  // stays in flight into the next tile, under its S and dP (nothing else
  // touches its accumulators in the loop, so ptxas keeps the wgmmas
  // asynchronous)
  auto row_stat = [&](int, int e) { return rs[e >> 1]; };
  hopper::mbar_wait(qbar, 0);
  for (int it = 0; it < n_it; ++it) {
    const int st = it % S, k0 = (kt_lo + it) * BN;
    const uint32_t k_addr = hopper::smem_u32(sK + st * CTILE);
    hopper::mbar_wait(&full[st], (it / S) & 1);
    // S = Q K^T, dP = dO V^T
    hopper::fence_regs(s);
    hopper::fence_regs(dp);
    hopper::wgmma_fence();
    issue_scores<DT, BN>(s, q_addr, k_addr);
    hopper::wgmma_commit();
    issue_scores<DT, BN>(dp, o_addr, hopper::smem_u32(sV + st * CTILE));
    hopper::wgmma_commit();
    PdS<false, BN, decltype(row_stat)> pds{s, dp, !interior(q0, BR, k0, BN, p),
                                           row0, k0 + 2 * t, row_stat, p, kc};
    hopper::wgmma_wait<1>();            // S, and tile it - 1's dQ
    hopper::fence_regs(s);
    if (it > 0) release(&empty[(it - 1) % S]);
    pds.before();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(dp);
    pds.after(pf, sf);
    // dQ += dS K
    fence_frags(sf);
    hopper::fence_regs(dq);
    hopper::wgmma_fence();
    issue_grad<DC, BN>(dq, sf, k_addr, cc * DC);
    hopper::wgmma_commit();
  }
  hopper::wgmma_wait<0>();
  hopper::fence_regs(dq);
  release(&empty[(n_it - 1) % S]);
  const long long ldq = (long long)p.H * DT;
  const long long q_off = ((long long)b * p.Tq * p.H + h) * DT;
  store_rows<DC>(static_cast<bf16*>(p.dq) + q_off, ldq, q0, p.Tq, cc * DC,
                 DT, dq, p.scale);
}

// ---- float32: CUDA cores ---------------------------------------------------

constexpr int FT = 32;         // rows of a block's tile and of the inner tile
constexpr int NT32 = 256;      // a 16 x 16 grid of threads

template <int D>
constexpr size_t smem32() {
  // four [FT][D + 1] tiles, two [FT][FT + 1] tiles, lse and delta
  return sizeof(float) *
         (size_t)(4 * FT * (D + 1) + 2 * FT * (FT + 1) + 2 * FT);
}

// FT rows from row r0 of X (row stride ld); rows >= n read as zeros
template <int D>
__device__ __forceinline__ void load_rows32(float* s, const float* X,
                                            long long ld, int r0, int n) {
  for (int i = threadIdx.x; i < FT * D; i += NT32) {
    const int r = i / D, d = i % D;
    s[r * (D + 1) + d] = r0 + r < n ? X[(r0 + r) * ld + d] : 0.f;
  }
}

// (lse2, delta) of query rows r0 .. r0 + FT - 1; rows >= Tq read as zeros
// (``visible`` masks them)
__device__ __forceinline__ void load_row_stats32(float* sL, float* sD,
                                                 const float* L,
                                                 const float* Dl, int r0,
                                                 int Tq) {
  if (threadIdx.x < FT) {
    const int r = r0 + threadIdx.x;
    sL[threadIdx.x] = r < Tq ? L[r] * LOG2E : 0.f;
    sD[threadIdx.x] = r < Tq ? Dl[r] : 0.f;
  }
}

template <int D>
__global__ void __launch_bounds__(NT32) dkdv_f32_kernel(const Params p) {
  constexpr int LD = D + 1, SP = FT + 1, DJ = D / 16;
  extern __shared__ float smem32_buf[];
  float* sK = smem32_buf;
  float* sV = sK + FT * LD;
  float* sQ = sV + FT * LD;
  float* sO = sQ + FT * LD;
  float* sP = sO + FT * LD;
  float* sS = sP + FT * SP;
  float* sL = sS + FT * SP;
  float* sD = sL + FT;

  const int KV = p.H / p.G;
  const int nt = (p.Tq + FT - 1) / FT;
  const int kt = blockIdx.x, k0 = kt * FT, kh = blockIdx.y, b = blockIdx.z;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const long long ldq = (long long)p.H * D, ldk = (long long)KV * D;
  const long long kv_off = ((long long)b * p.Tk * KV + kh) * D;
  load_rows32<D>(sK, static_cast<const float*>(p.k) + kv_off, ldk, k0, p.Tk);
  load_rows32<D>(sV, static_cast<const float*>(p.v) + kv_off, ldk, k0, p.Tk);

  float dv[2][DJ], dk[2][DJ];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) dv[i][j] = dk[i][j] = 0.f;

  int qt_hi = nt;
  if (p.window > 0) qt_hi = min(nt, (k0 + FT - 1 + p.window - 1) / FT + 1);
  for (int hg = 0; hg < p.G; ++hg) {
    const int h = kh * p.G + hg;
    const long long q_off = ((long long)b * p.Tq * p.H + h) * D;
    const float* L = p.lse + ((long long)b * p.H + h) * p.Tq;
    const float* Dl = p.delta + ((long long)b * p.H + h) * p.Tq;
    for (int qt = p.causal ? kt : 0; qt < qt_hi; ++qt) {
      const int q0 = qt * FT;
      __syncthreads();
      load_rows32<D>(sQ, static_cast<const float*>(p.q) + q_off, ldq, q0,
                     p.Tq);
      load_rows32<D>(sO, static_cast<const float*>(p.dout) + q_off, ldq, q0,
                     p.Tq);
      load_row_stats32(sL, sD, L, Dl, q0, p.Tq);
      __syncthreads();
      // S^T and dP^T: thread owns keys ty + 16 i, queries tx + 16 j
      float s[2][2] = {}, dp[2][2] = {};
#pragma unroll 8
      for (int d = 0; d < D; ++d) {
        float a[2], av[2], c[2], co[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          a[i] = sK[(ty + 16 * i) * LD + d];
          av[i] = sV[(ty + 16 * i) * LD + d];
          c[i] = sQ[(tx + 16 * i) * LD + d];
          co[i] = sO[(tx + 16 * i) * LD + d];
        }
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            s[i][j] = fmaf(a[i], c[j], s[i][j]);
            dp[i][j] = fmaf(av[i], co[j], dp[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int kl = ty + 16 * i, ql = tx + 16 * j;
          float pr, ds;
          p_ds(s[i][j], dp[i][j], q0 + ql, k0 + kl, sL[ql], sD[ql], p, pr,
               ds);
          sP[kl * SP + ql] = pr;
          sS[kl * SP + ql] = ds;
        }
      __syncthreads();
      // dV += P^T dO, dK += dS^T Q: thread owns keys ty + 16 i, columns
      // tx + 16 j
#pragma unroll 4
      for (int q = 0; q < FT; ++q) {
        float pr[2], ds[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          pr[i] = sP[(ty + 16 * i) * SP + q];
          ds[i] = sS[(ty + 16 * i) * SP + q];
        }
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          const float o = sO[q * LD + tx + 16 * j];
          const float qq = sQ[q * LD + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            dv[i][j] = fmaf(pr[i], o, dv[i][j]);
            dk[i][j] = fmaf(ds[i], qq, dk[i][j]);
          }
        }
      }
    }
  }
  float* dK = static_cast<float*>(p.dk) + kv_off;
  float* dV = static_cast<float*>(p.dv) + kv_off;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = k0 + ty + 16 * i;
    if (key >= p.Tk) continue;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      dK[key * ldk + tx + 16 * j] = dk[i][j] * p.scale;
      dV[key * ldk + tx + 16 * j] = dv[i][j];
    }
  }
}

template <int D>
__global__ void __launch_bounds__(NT32) dq_f32_kernel(const Params p) {
  constexpr int LD = D + 1, SP = FT + 1, DJ = D / 16;
  extern __shared__ float smem32_buf[];
  float* sQ = smem32_buf;
  float* sO = sQ + FT * LD;
  float* sK = sO + FT * LD;
  float* sV = sK + FT * LD;
  float* sS = sV + FT * LD;
  float* sL = sS + FT * SP;
  float* sD = sL + FT;

  const int KV = p.H / p.G;
  const int nq = (p.Tq + FT - 1) / FT, nk = (p.Tk + FT - 1) / FT;
  const int qt = nq - 1 - (int)blockIdx.x, q0 = qt * FT;
  const int h = blockIdx.y, kh = h / p.G, b = blockIdx.z;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const long long ldq = (long long)p.H * D, ldk = (long long)KV * D;
  const long long q_off = ((long long)b * p.Tq * p.H + h) * D;
  const long long kv_off = ((long long)b * p.Tk * KV + kh) * D;
  const float* K = static_cast<const float*>(p.k) + kv_off;
  const float* V = static_cast<const float*>(p.v) + kv_off;
  load_rows32<D>(sQ, static_cast<const float*>(p.q) + q_off, ldq, q0, p.Tq);
  load_rows32<D>(sO, static_cast<const float*>(p.dout) + q_off, ldq, q0,
                 p.Tq);
  load_row_stats32(sL, sD, p.lse + ((long long)b * p.H + h) * p.Tq,
                   p.delta + ((long long)b * p.H + h) * p.Tq, q0, p.Tq);

  float dq[2][DJ];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) dq[i][j] = 0.f;

  const int kt_lo = p.window > 0 ? max(0, q0 - p.window + 1) / FT : 0;
  const int kt_hi = p.causal ? qt : nk - 1;
  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int k0 = kt * FT;
    __syncthreads();
    load_rows32<D>(sK, K, ldk, k0, p.Tk);
    load_rows32<D>(sV, V, ldk, k0, p.Tk);
    __syncthreads();
    // S and dP: thread owns queries ty + 16 i, keys tx + 16 j
    float s[2][2] = {}, dp[2][2] = {};
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[2], ao[2], c[2], cv[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        a[i] = sQ[(ty + 16 * i) * LD + d];
        ao[i] = sO[(ty + 16 * i) * LD + d];
        c[i] = sK[(tx + 16 * i) * LD + d];
        cv[i] = sV[(tx + 16 * i) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          s[i][j] = fmaf(a[i], c[j], s[i][j]);
          dp[i][j] = fmaf(ao[i], cv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int ql = ty + 16 * i, kl = tx + 16 * j;
        float pr, ds;
        p_ds(s[i][j], dp[i][j], q0 + ql, k0 + kl, sL[ql], sD[ql], p, pr, ds);
        sS[ql * SP + kl] = ds;
      }
    __syncthreads();
    // dQ += dS K: thread owns queries ty + 16 i, columns tx + 16 j
#pragma unroll 4
    for (int kk = 0; kk < FT; ++kk) {
      float ds[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) ds[i] = sS[(ty + 16 * i) * SP + kk];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float kv = sK[kk * LD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 2; ++i) dq[i][j] = fmaf(ds[i], kv, dq[i][j]);
      }
    }
  }
  float* dQ = static_cast<float*>(p.dq) + q_off;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= p.Tq) continue;
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      dQ[row * ldq + tx + 16 * j] = dq[i][j] * p.scale;
  }
}

// ---- launch ---------------------------------------------------------------

template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, dim3 grid, int threads, size_t smem,
                   cudaStream_t stream, const Args&... args) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kernel<<<grid, threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

// q, dO (B, Tq, H, DT) and k, v (B, Tk, KV, DT) as 4-D tensor maps (DT,
// heads, time, B), boxes of 64 head-dim elements (128 bytes, swizzled) by
// one head by 64 rows, on tiles D wide (columns DT..D-1 zero-filled)
template <int D, int DT>
cudaError_t run_bf16(const Params& p, cudaStream_t s) {
  using C = Bf16Cfg<D>;
  const int KV = p.H / p.G;
  Maps maps;
  const uint64_t row = DT * sizeof(bf16);
  const uint32_t box[4] = {64, 1, BR, 1};
  const uint64_t q_dims[4] = {DT, (uint64_t)p.H, (uint64_t)p.Tq,
                              (uint64_t)p.B};
  const uint64_t kv_dims[4] = {DT, (uint64_t)KV, (uint64_t)p.Tk,
                               (uint64_t)p.B};
  const uint64_t q_str[3] = {row, row * p.H, row * p.H * p.Tq};
  const uint64_t kv_str[3] = {row, row * KV, row * KV * p.Tk};
  const auto bf = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const auto sw = CU_TENSOR_MAP_SWIZZLE_128B;
  if (!hopper_host::make_map(&maps.q, bf, 4, p.q, q_dims, q_str, box, sw) ||
      !hopper_host::make_map(&maps.dout, bf, 4, p.dout, q_dims, q_str, box,
                             sw) ||
      !hopper_host::make_map(&maps.k, bf, 4, p.k, kv_dims, kv_str, box, sw) ||
      !hopper_host::make_map(&maps.v, bf, 4, p.v, kv_dims, kv_str, box, sw))
    return cudaErrorInvalidValue;
  constexpr int ROWS = C::NW * BR;          // rows of a block's tile
  const unsigned k_tiles = (unsigned)((p.Tk + ROWS - 1) / ROWS);
  const unsigned q_tiles = (unsigned)((p.Tq + ROWS - 1) / ROWS);
  cudaError_t e = launch(dkdv_bf16_kernel<D, DT>,
                         dim3(KV * C::NC * p.B, k_tiles),
                         C::NT, C::SMEM_KV, s, maps, p);
  if (e != cudaSuccess) return e;
  return launch(dq_bf16_kernel<D, DT>, dim3(p.H * C::NC * p.B, q_tiles), C::NT,
                C::SMEM_Q, s, maps, p);
}

template <int D>
cudaError_t run_f32(const Params& p, cudaStream_t s) {
  const int nq = (p.Tq + FT - 1) / FT, nk = (p.Tk + FT - 1) / FT;
  const int KV = p.H / p.G;
  cudaError_t e = launch(dkdv_f32_kernel<D>, dim3(nk, KV, p.B), NT32,
                         smem32<D>(), s, p);
  if (e != cudaSuccess) return e;
  return launch(dq_f32_kernel<D>, dim3(nq, p.H, p.B), NT32, smem32<D>(), s,
                p);
}

template <int D>
cudaError_t run(const Params& p, int dtype, cudaStream_t s) {
  const long long rows = (long long)p.B * p.Tq * p.H;
  const dim3 grid((unsigned)((rows + 7) / 8));
  if (dtype == 0) {
    delta_kernel<float, D><<<grid, 256, 0, s>>>(p);
    cudaError_t e = cudaGetLastError();
    return e != cudaSuccess ? e : run_f32<D>(p, s);
  }
  delta_kernel<bf16, D><<<grid, 256, 0, s>>>(p);
  cudaError_t e = cudaGetLastError();
  return e != cudaSuccess ? e : run_bf16<D == 80 ? 128 : D, D>(p, s);
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16; all tensors contiguous and 16-byte
// aligned (the bf16 path reads q, k, v and dout through TMA tensor maps).
// q, o, dout, dq: (B, Tq, H, D); k, v, dk, dv: (B, Tk, KV, D); lse:
// (B, H, Tq) float32 from the forward; delta: (B, H, Tq) float32 scratch.
// Causal with Tq == Tk, or not causal with no window.  Returns a
// cudaError_t (0 on success).
int fa_bwd(const void* q, const void* k, const void* v, const void* o,
           const float* lse, const void* dout, void* dq, void* dk, void* dv,
           float* delta, int dtype, int B, int H, int KV, int Tq, int Tk,
           int D, int causal, int window, float softcap, float scale,
           void* stream) {
  if (KV <= 0 || H % KV != 0 || B <= 0 || Tq <= 0 || Tk <= 0 ||
      (causal && Tq != Tk) || (!causal && window > 0) ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const Params p{q, k, v, o, dout, lse, delta, dq, dk, dv, B, H, H / KV,
                 Tq, Tk, causal != 0, window, softcap, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return (int)run<64>(p, dtype, s);
    case 80: return (int)run<80>(p, dtype, s);
    case 128: return (int)run<128>(p, dtype, s);
    case 256: return (int)run<256>(p, dtype, s);
  }
  return (int)cudaErrorInvalidValue;
}

const char* fa_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
