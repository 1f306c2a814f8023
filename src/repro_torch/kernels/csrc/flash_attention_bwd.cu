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
// Tq == Tk, any T (ragged tails masked: rows and keys past T get P = 0), a
// sliding window (qpos - kpos < window), a tanh soft-cap, D in {64, 128,
// 256}, float32 or bfloat16.  All tensors contiguous: q, o, dO, dQ
// (B, T, H, D); k, v, dK, dV (B, T, H/G, D); lse, delta (B, H, T) float32.
//
// Design (FA2-style, deterministic, no atomics): three kernels.
//   1. delta: one warp a row, rowsum(dO * O) in float32.
//   2. dK/dV: one block per (batch, kv head, 64-key tile[, 128-column
//      chunk]).  It loops over the G query heads of its kv head and over the
//      query tiles from the diagonal on (bounded by the window), recomputes
//      S^T and dP^T for its keys and accumulates dV and dK in registers, so
//      the GQA sum needs no atomics.  Key tile 0 has the most query tiles
//      and is launched first.
//   3. dQ: one block per (batch, q head, 64-query tile[, column chunk]),
//      looping over the key tiles up to the diagonal; the last query tile
//      (the longest) is launched first.
// bf16: four warps a block, each owning 16 rows of the block's tile; the
// products run on the tensor cores with mma.sync m16n8k16 (bf16 in, f32
// accumulation), their operands loaded from shared memory by ldmatrix (the
// .trans form for the operands read along the row dimension: Q and dO in
// dK/dV, K in dQ).  The accumulator fragment of S^T (or S) is the A-operand
// fragment of the next product, so P and dS go from registers to the tensor
// cores after one bf16 rounding each.  The streamed tiles (Q, dO, lse, delta
// in dK/dV; K, V in dQ) come in by cp.async into two stages, the next
// tile's loads in flight under this tile's products.  At D = 256 a block
// accumulates 128 of the 256 columns (two blocks per tile, each recomputing
// S and dP) to keep dK + dV at 128 registers a thread.
// float32: CUDA cores, 32 x 32 tiles, 256 threads a block, same loop
// structure, P and dS staged in shared memory.
//
// What bounds it on this card: at granite-3-2b's training shape (B=4, T=2048,
// H=32, K=8, D=64, bf16, causal) the five T^2 D products of the gradient
// (S, dP, dV, dK, dQ) are 171.8 GFLOP, 0.174 ms at 989 TFLOP/s, against
// ~168 MB of q, k, v, o, dO, lse in and dQ, dK, dV out (0.05 ms at 3.35
// TB/s): compute-bound.  This design recomputes S and dP in both the dK/dV
// and the dQ kernel (seven products, not five) and uses mma.sync, not
// wgmma; TMA and wgmma are for a later change.  Times are in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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
  int B, H, G, T;
  int window;
  float softcap, scale;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

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
  const bool ok = kpos <= qpos && qpos < p.T &&
                  (p.window <= 0 || qpos - kpos < p.window);
  pr = ok ? exp2f(fmaf(x, LOG2E, -lse2)) : 0.f;
  ds = pr * (dp - delta) * dcap;
}

// ---- delta = rowsum(dO * O): one warp a (batch, time, head) row ------------

template <typename T, int D>
__global__ void __launch_bounds__(256) delta_kernel(const Params p) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long row = (long long)blockIdx.x * 8 + warp;
  if (row >= (long long)p.B * p.T * p.H) return;
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
    const int t = (int)(bt % p.T), b = (int)(bt / p.T);
    p.delta[((long long)b * p.H + h) * p.T + t] = s;
  }
}

// ---- bfloat16: mma.sync on the tensor cores --------------------------------

constexpr int BT = 64;         // rows of a block's tile and of the inner tile
constexpr int NT16 = 128;      // four warps

template <int D>
struct Cfg16 {
  static constexpr int DC = D > 128 ? 128 : D;  // accumulated columns a block
  static constexpr int NC = D / DC;             // column chunks
  static constexpr int LD = D + 8;    // row pitch: ldmatrix is conflict-free
  // two fixed tiles, two stages of two streamed tiles; lse and delta for two
  // stages
  static constexpr size_t SMEM =
      sizeof(bf16) * 6 * BT * LD + sizeof(float) * 4 * BT;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 (or 4) bytes global -> shared, asynchronously; zeros when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// four 8 x 8 bf16 matrices, one row address a thread (lane / 8 picks the
// matrix); .trans hands each thread a column pair instead of a row pair
__device__ __forceinline__ void ldsm(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// Fragment addresses in a [row][col] tile X of pitch LD, for lane
// (m = lane / 8, r = lane % 8):
//   A, rows r0..r0+15, cols k0..k0+15:           a_frag(X, r0, k0)
//   B of two n-tiles from X[n][k] (n r0..r0+15): bn_frag(X, r0, k0)
//   B of two n-tiles from X[k][n] (k r0..r0+15, n c0..c0+15, transposed):
//                                                 bk_frag(X, r0, c0)
template <int LD>
__device__ __forceinline__ const bf16* a_frag(const bf16* X, int r0, int k0) {
  const int lane = threadIdx.x % 32, m = lane / 8, r = lane % 8;
  return X + (r0 + r + 8 * (m & 1)) * LD + k0 + 8 * (m >> 1);
}
template <int LD>
__device__ __forceinline__ const bf16* bn_frag(const bf16* X, int r0,
                                               int k0) {
  const int lane = threadIdx.x % 32, m = lane / 8, r = lane % 8;
  return X + (r0 + r + 8 * (m >> 1)) * LD + k0 + 8 * (m & 1);
}
template <int LD>
__device__ __forceinline__ const bf16* bk_frag(const bf16* X, int r0,
                                               int c0) {
  return a_frag<LD>(X, r0, c0);
}

// (x, y) -> bf16x2, x in the low half
__device__ __forceinline__ uint32_t pack(float x, float y) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// c += A B, A 16 x 16 (fragment a), B 16 x 8 (fragment b0, b1)
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// rows [r0, r0 + BT) of X (row stride ld) into s[BT][D + 8], asynchronously;
// rows >= T are zero
template <int D>
__device__ __forceinline__ void copy_rows(bf16* s, const bf16* X,
                                          long long ld, int r0, int T) {
  constexpr int V = D / 8;                // 16-byte vectors a row
  for (int i = threadIdx.x; i < BT * V; i += NT16) {
    const int r = i / V, c = (i % V) * 8, row = r0 + r;
    cp_async16(s + r * (D + 8) + c, X + min(row, T - 1) * ld + c, row < T);
  }
}

// lse and delta of rows [r0, r0 + BT) into sL, sD, asynchronously
__device__ __forceinline__ void copy_stats(float* sL, float* sD,
                                           const float* L, const float* Dl,
                                           int r0, int T) {
  if (threadIdx.x < BT) {
    const int row = r0 + threadIdx.x, src = min(row, T - 1);
    cp_async4(sL + threadIdx.x, L + src, row < T);
    cp_async4(sD + threadIdx.x, Dl + src, row < T);
  }
}

// the A fragment of 16 rows by 16 columns (n-tiles 2 j, 2 j + 1) of an
// accumulator, rounded to bf16
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4],
                                         const float (&c)[8][4], int j) {
  a[0] = pack(c[2 * j][0], c[2 * j][1]);
  a[1] = pack(c[2 * j][2], c[2 * j][3]);
  a[2] = pack(c[2 * j + 1][0], c[2 * j + 1][1]);
  a[3] = pack(c[2 * j + 1][2], c[2 * j + 1][3]);
}

// store a warp's 16 x DC accumulator (rows row0 + g, row0 + g + 8) times f
template <int DC>
__device__ __forceinline__ void store_acc(bf16* X, long long ld, int row0,
                                          int T, int c0,
                                          const float (&acc)[DC / 8][4],
                                          float f) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= T) continue;
#pragma unroll
    for (int n = 0; n < DC / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(X + row * ld + c0 + 8 * n + 2 * t) =
          __floats2bfloat162_rn(acc[n][2 * r] * f, acc[n][2 * r + 1] * f);
  }
}

// S = A B^T and dP = E F^T for a warp's 16 rows by 64 columns: A, E the
// row tiles (rows r0..r0+15), B, F the column tiles, all [row][d]
template <int D>
__device__ __forceinline__ void scores(float (&s)[8][4], float (&dp)[8][4],
                                       const bf16* A, const bf16* E, int r0,
                                       const bf16* B, const bf16* F) {
  constexpr int LD = D + 8;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4], e[4];
    ldsm(a, a_frag<LD>(A, r0, 16 * kk));
    ldsm(e, a_frag<LD>(E, r0, 16 * kk));
#pragma unroll
    for (int jp = 0; jp < 4; ++jp) {
      uint32_t b[4], f[4];
      ldsm(b, bn_frag<LD>(B, 16 * jp, 16 * kk));
      ldsm(f, bn_frag<LD>(F, 16 * jp, 16 * kk));
      mma(s[2 * jp], a, b[0], b[1]);
      mma(s[2 * jp + 1], a, b[2], b[3]);
      mma(dp[2 * jp], e, f[0], f[1]);
      mma(dp[2 * jp + 1], e, f[2], f[3]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(NT16) dkdv_bf16_kernel(const Params p) {
  using C = Cfg16<D>;
  constexpr int DC = C::DC, LD = C::LD;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + BT * LD;
  bf16* sQ = sV + BT * LD;              // two stages
  bf16* sO = sQ + 2 * BT * LD;          // dO, two stages
  float* sL = reinterpret_cast<float*>(sO + 2 * BT * LD);   // two stages
  float* sD = sL + 2 * BT;

  const int KV = p.H / p.G;
  const int nt = (p.T + BT - 1) / BT;
  const int kt = blockIdx.x, k0 = kt * BT;
  const int kh = blockIdx.y / C::NC, c0 = (blockIdx.y % C::NC) * DC;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const long long ldq = (long long)p.H * D, ldk = (long long)KV * D;

  // query tiles that see a key of this tile: from the diagonal on, up to the
  // last query in the window of the tile's last key; iteration it is query
  // tile kt + it % nq of query head kh G + it / nq
  int qt_hi = nt;
  if (p.window > 0) qt_hi = min(nt, (k0 + BT - 1 + p.window - 1) / BT + 1);
  const int nq = qt_hi - kt, n_it = p.G * nq;
  auto prefetch = [&](int it) {     // Q, dO, lse, delta of iteration it
    const int st = it & 1, h = kh * p.G + it / nq;
    const int q0 = (kt + it % nq) * BT;
    const long long q_off = ((long long)b * p.T * p.H + h) * D;
    const long long r_off = ((long long)b * p.H + h) * p.T;
    copy_rows<D>(sQ + st * BT * LD, static_cast<const bf16*>(p.q) + q_off,
                 ldq, q0, p.T);
    copy_rows<D>(sO + st * BT * LD, static_cast<const bf16*>(p.dout) + q_off,
                 ldq, q0, p.T);
    copy_stats(sL + st * BT, sD + st * BT, p.lse + r_off, p.delta + r_off,
               q0, p.T);
    cp_commit();
  };

  const long long kv_off = ((long long)b * p.T * KV + kh) * D;
  copy_rows<D>(sK, static_cast<const bf16*>(p.k) + kv_off, ldk, k0, p.T);
  copy_rows<D>(sV, static_cast<const bf16*>(p.v) + kv_off, ldk, k0, p.T);
  prefetch(0);

  float dv[DC / 8][4], dk[DC / 8][4];
#pragma unroll
  for (int n = 0; n < DC / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dv[n][e] = dk[n][e] = 0.f;

  for (int it = 0; it < n_it; ++it) {
    if (it + 1 < n_it)
      prefetch(it + 1);                 // loads under this tile's products
    else
      cp_commit();
    cp_wait<1>();
    __syncthreads();
    const int st = it & 1, q0 = (kt + it % nq) * BT;
    const bf16* cQ = sQ + st * BT * LD;
    const bf16* cO = sO + st * BT * LD;
    const float* cL = sL + st * BT;
    const float* cD = sD + st * BT;

    // S^T = K Q^T and dP^T = V dO^T: this warp's 16 keys by 64 queries
    float st_[8][4], dpt[8][4];
    scores<D>(st_, dpt, sK, sV, 16 * warp, cQ, cO);
    // element (e) of n-tile j: key row 16 warp + g + 8 (e >> 1), query
    // column 8 j + 2 t + (e & 1)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kl = 16 * warp + g + 8 * (e >> 1);
        const int ql = 8 * j + 2 * t + (e & 1);
        float pr, ds;
        p_ds(st_[j][e], dpt[j][e], q0 + ql, k0 + kl, cL[ql] * LOG2E, cD[ql],
             p, pr, ds);
        st_[j][e] = pr;
        dpt[j][e] = ds;
      }
    // dV += P^T dO and dK += dS^T Q over the tile's 64 queries, 16 at a
    // time: n-tiles 2 kq and 2 kq + 1 of the accumulator are the A
    // fragment of queries 16 kq .. 16 kq + 15
#pragma unroll
    for (int kq = 0; kq < BT / 16; ++kq) {
      uint32_t pa[4], sa[4];
      acc_to_a(pa, st_, kq);
      acc_to_a(sa, dpt, kq);
#pragma unroll
      for (int np = 0; np < DC / 16; ++np) {
        uint32_t bo[4], bq[4];
        ldsm_t(bo, bk_frag<LD>(cO, 16 * kq, c0 + 16 * np));
        ldsm_t(bq, bk_frag<LD>(cQ, 16 * kq, c0 + 16 * np));
        mma(dv[2 * np], pa, bo[0], bo[1]);
        mma(dv[2 * np + 1], pa, bo[2], bo[3]);
        mma(dk[2 * np], sa, bq[0], bq[1]);
        mma(dk[2 * np + 1], sa, bq[2], bq[3]);
      }
    }
    __syncthreads();                    // before the next prefetch reuses it
  }
  store_acc<DC>(static_cast<bf16*>(p.dk) + kv_off, ldk, k0 + 16 * warp, p.T,
                c0, dk, p.scale);
  store_acc<DC>(static_cast<bf16*>(p.dv) + kv_off, ldk, k0 + 16 * warp, p.T,
                c0, dv, 1.f);
}

template <int D>
__global__ void __launch_bounds__(NT16) dq_bf16_kernel(const Params p) {
  using C = Cfg16<D>;
  constexpr int DC = C::DC, LD = C::LD;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sO = sQ + BT * LD;              // dO
  bf16* sK = sO + BT * LD;              // two stages
  bf16* sV = sK + 2 * BT * LD;          // two stages
  float* sL = reinterpret_cast<float*>(sV + 2 * BT * LD);
  float* sD = sL + BT;

  const int KV = p.H / p.G;
  const int nt = (p.T + BT - 1) / BT;
  const int qt = nt - 1 - (int)blockIdx.x, q0 = qt * BT;
  const int h = blockIdx.y / C::NC, c0 = (blockIdx.y % C::NC) * DC;
  const int kh = h / p.G, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const long long ldq = (long long)p.H * D, ldk = (long long)KV * D;

  // key tiles up to the diagonal, from the first key in the window of the
  // tile's first query
  const int kt_lo = p.window > 0 ? max(0, q0 - p.window + 1) / BT : 0;
  const int n_it = qt - kt_lo + 1;
  const long long kv_off = ((long long)b * p.T * KV + kh) * D;
  auto prefetch = [&](int it) {     // K, V of key tile kt_lo + it
    const int st = it & 1, k0 = (kt_lo + it) * BT;
    copy_rows<D>(sK + st * BT * LD, static_cast<const bf16*>(p.k) + kv_off,
                 ldk, k0, p.T);
    copy_rows<D>(sV + st * BT * LD, static_cast<const bf16*>(p.v) + kv_off,
                 ldk, k0, p.T);
    cp_commit();
  };

  const long long q_off = ((long long)b * p.T * p.H + h) * D;
  const long long r_off = ((long long)b * p.H + h) * p.T;
  copy_rows<D>(sQ, static_cast<const bf16*>(p.q) + q_off, ldq, q0, p.T);
  copy_rows<D>(sO, static_cast<const bf16*>(p.dout) + q_off, ldq, q0, p.T);
  copy_stats(sL, sD, p.lse + r_off, p.delta + r_off, q0, p.T);
  prefetch(0);

  float dq[DC / 8][4];
#pragma unroll
  for (int n = 0; n < DC / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;

  for (int it = 0; it < n_it; ++it) {
    if (it + 1 < n_it)
      prefetch(it + 1);                 // loads under this tile's products
    else
      cp_commit();
    cp_wait<1>();
    __syncthreads();
    const int st = it & 1, k0 = (kt_lo + it) * BT;
    const bf16* cK = sK + st * BT * LD;
    const bf16* cV = sV + st * BT * LD;

    // S = Q K^T and dP = dO V^T: this warp's 16 queries by 64 keys
    float s[8][4], dp[8][4];
    scores<D>(s, dp, sQ, sO, 16 * warp, cK, cV);
    // element (e) of n-tile j: query row 16 warp + g + 8 (e >> 1), key
    // column 8 j + 2 t + (e & 1)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ql = 16 * warp + g + 8 * (e >> 1);
        const int kl = 8 * j + 2 * t + (e & 1);
        float pr, ds;
        p_ds(s[j][e], dp[j][e], q0 + ql, k0 + kl, sL[ql] * LOG2E, sD[ql], p,
             pr, ds);
        dp[j][e] = ds;
      }
    // dQ += dS K over the tile's 64 keys, 16 at a time
#pragma unroll
    for (int kk = 0; kk < BT / 16; ++kk) {
      uint32_t sa[4];
      acc_to_a(sa, dp, kk);
#pragma unroll
      for (int np = 0; np < DC / 16; ++np) {
        uint32_t bk[4];
        ldsm_t(bk, bk_frag<LD>(cK, 16 * kk, c0 + 16 * np));
        mma(dq[2 * np], sa, bk[0], bk[1]);
        mma(dq[2 * np + 1], sa, bk[2], bk[3]);
      }
    }
    __syncthreads();                    // before the next prefetch reuses it
  }
  store_acc<DC>(static_cast<bf16*>(p.dq) + q_off, ldq, q0 + 16 * warp, p.T,
                c0, dq, p.scale);
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

template <int D>
__device__ __forceinline__ void load_rows32(float* s, const float* X,
                                            long long ld, int r0, int T) {
  for (int i = threadIdx.x; i < FT * D; i += NT32) {
    const int r = i / D, d = i % D;
    s[r * (D + 1) + d] = r0 + r < T ? X[(r0 + r) * ld + d] : 0.f;
  }
}

__device__ __forceinline__ void load_row_stats32(float* sL, float* sD,
                                                 const float* L,
                                                 const float* Dl, int r0,
                                                 int T) {
  if (threadIdx.x < FT) {
    const int r = r0 + threadIdx.x;
    sL[threadIdx.x] = r < T ? L[r] * LOG2E : 0.f;
    sD[threadIdx.x] = r < T ? Dl[r] : 0.f;
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
  const int nt = (p.T + FT - 1) / FT;
  const int kt = blockIdx.x, k0 = kt * FT, kh = blockIdx.y, b = blockIdx.z;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const long long ldq = (long long)p.H * D, ldk = (long long)KV * D;
  const long long kv_off = ((long long)b * p.T * KV + kh) * D;
  load_rows32<D>(sK, static_cast<const float*>(p.k) + kv_off, ldk, k0, p.T);
  load_rows32<D>(sV, static_cast<const float*>(p.v) + kv_off, ldk, k0, p.T);

  float dv[2][DJ], dk[2][DJ];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) dv[i][j] = dk[i][j] = 0.f;

  int qt_hi = nt;
  if (p.window > 0) qt_hi = min(nt, (k0 + FT - 1 + p.window - 1) / FT + 1);
  for (int hg = 0; hg < p.G; ++hg) {
    const int h = kh * p.G + hg;
    const long long q_off = ((long long)b * p.T * p.H + h) * D;
    const float* L = p.lse + ((long long)b * p.H + h) * p.T;
    const float* Dl = p.delta + ((long long)b * p.H + h) * p.T;
    for (int qt = kt; qt < qt_hi; ++qt) {
      const int q0 = qt * FT;
      __syncthreads();
      load_rows32<D>(sQ, static_cast<const float*>(p.q) + q_off, ldq, q0,
                     p.T);
      load_rows32<D>(sO, static_cast<const float*>(p.dout) + q_off, ldq, q0,
                     p.T);
      load_row_stats32(sL, sD, L, Dl, q0, p.T);
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
    if (key >= p.T) continue;
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
  const int nt = (p.T + FT - 1) / FT;
  const int qt = nt - 1 - (int)blockIdx.x, q0 = qt * FT;
  const int h = blockIdx.y, kh = h / p.G, b = blockIdx.z;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const long long ldq = (long long)p.H * D, ldk = (long long)KV * D;
  const long long q_off = ((long long)b * p.T * p.H + h) * D;
  const long long kv_off = ((long long)b * p.T * KV + kh) * D;
  const float* K = static_cast<const float*>(p.k) + kv_off;
  const float* V = static_cast<const float*>(p.v) + kv_off;
  load_rows32<D>(sQ, static_cast<const float*>(p.q) + q_off, ldq, q0, p.T);
  load_rows32<D>(sO, static_cast<const float*>(p.dout) + q_off, ldq, q0,
                 p.T);
  load_row_stats32(sL, sD, p.lse + ((long long)b * p.H + h) * p.T,
                   p.delta + ((long long)b * p.H + h) * p.T, q0, p.T);

  float dq[2][DJ];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) dq[i][j] = 0.f;

  const int kt_lo = p.window > 0 ? max(0, q0 - p.window + 1) / FT : 0;
  for (int kt = kt_lo; kt <= qt; ++kt) {
    const int k0 = kt * FT;
    __syncthreads();
    load_rows32<D>(sK, K, ldk, k0, p.T);
    load_rows32<D>(sV, V, ldk, k0, p.T);
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
    if (row >= p.T) continue;
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      dQ[row * ldq + tx + 16 * j] = dq[i][j] * p.scale;
  }
}

// ---- launch ---------------------------------------------------------------

template <typename Kernel>
cudaError_t launch(Kernel kernel, dim3 grid, int threads, size_t smem,
                   const Params& p, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kernel<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t run_bf16(const Params& p, cudaStream_t s) {
  using C = Cfg16<D>;
  const int nt = (p.T + BT - 1) / BT, KV = p.H / p.G;
  cudaError_t e = launch(dkdv_bf16_kernel<D>, dim3(nt, KV * C::NC, p.B),
                         NT16, C::SMEM, p, s);
  if (e != cudaSuccess) return e;
  return launch(dq_bf16_kernel<D>, dim3(nt, p.H * C::NC, p.B), NT16,
                C::SMEM, p, s);
}

template <int D>
cudaError_t run_f32(const Params& p, cudaStream_t s) {
  const int nt = (p.T + FT - 1) / FT, KV = p.H / p.G;
  cudaError_t e = launch(dkdv_f32_kernel<D>, dim3(nt, KV, p.B), NT32,
                         smem32<D>(), p, s);
  if (e != cudaSuccess) return e;
  return launch(dq_f32_kernel<D>, dim3(nt, p.H, p.B), NT32, smem32<D>(), p,
                s);
}

template <int D>
cudaError_t run(const Params& p, int dtype, cudaStream_t s) {
  const long long rows = (long long)p.B * p.T * p.H;
  const dim3 grid((unsigned)((rows + 7) / 8));
  if (dtype == 0) {
    delta_kernel<float, D><<<grid, 256, 0, s>>>(p);
    cudaError_t e = cudaGetLastError();
    return e != cudaSuccess ? e : run_f32<D>(p, s);
  }
  delta_kernel<bf16, D><<<grid, 256, 0, s>>>(p);
  cudaError_t e = cudaGetLastError();
  return e != cudaSuccess ? e : run_bf16<D>(p, s);
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16; all tensors contiguous and 16-byte
// aligned.  q, o, dout, dq: (B, T, H, D); k, v, dk, dv: (B, T, KV, D); lse:
// (B, H, T) float32 from the forward; delta: (B, H, T) float32 scratch.
// Causal.  Returns a cudaError_t (0 on success).
int fa_bwd(const void* q, const void* k, const void* v, const void* o,
           const float* lse, const void* dout, void* dq, void* dk, void* dv,
           float* delta, int dtype, int B, int H, int KV, int T, int D,
           int window, float softcap, float scale, void* stream) {
  if (KV <= 0 || H % KV != 0 || B <= 0 || T <= 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const Params p{q, k, v, o, dout, lse, delta, dq, dk, dv, B, H, H / KV, T,
                 window, softcap, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return (int)run<64>(p, dtype, s);
    case 128: return (int)run<128>(p, dtype, s);
    case 256: return (int)run<256>(p, dtype, s);
  }
  return (int)cudaErrorInvalidValue;
}

const char* fa_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
