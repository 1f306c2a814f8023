// Flash-attention forward for NVIDIA Hopper (sm_90a), CUDA C++ with a plain
// C interface (loaded through ctypes by kernels/flash_attention.py).
//
// Replaces repro/kernels/flash_attention.py::flash_attention, the Pallas TPU
// kernel: causal online-softmax attention with an optional sliding window
// (qpos - kpos < window) and a tanh logit soft-cap, scores, running max,
// denominator and accumulator in float32, masked scores filled with the
// finite NEG_INF = -1e30 (a fully masked tile then gets weight exp(0) and the
// next real tile's correction exp(-1e30 - m) zeroes it exactly; with -inf it
// would be NaN).  Output acc / max(l, 1e-30), cast to the input type.
//
// Differences from the TPU kernel, none of which change the result:
//   * the TPU walks key blocks on a sequential grid axis and carries the
//     running state in VMEM scratch; blocks on Hopper run in no order, so one
//     block owns (batch*head, query tile) and loops over the key tiles itself;
//   * GQA indexes kv head h / G instead of the G-fold K/V broadcast of
//     repro/kernels/ops.py (16x the K/V bytes for glm4-9b);
//   * ragged tails are masked in the kernel (no T % 128 == 0 assert): key
//     columns at or past Tk get -inf, i.e. weight exactly 0, so the result is
//     that of attention over exactly Tk keys;
//   * key tiles wholly above the causal diagonal are skipped (exact: every
//     row that has such a tile also has its diagonal key unmasked, so the
//     skipped tile's weight would be exp(-1e30 - m) = 0); the bf16 path
//     also skips tiles wholly outside the window when every row of the
//     block keeps an unmasked key, by the same argument.
//
// Layout: q (B, Tq, H, D), k/v (B, Tk, H/G, D), o (B, Tq, H, D); heads and
// head_dim contiguous, batch and time strides given in elements (so a slice
// of a longer KV cache is taken without a copy).  Inputs float32 or bfloat16,
// D in {64, 80, 128, 256}; bf16 runs D = 80 (zamba2) on the 128-wide tile
// with columns 80..127 zero-filled by TMA, so its products cost 128/80 =
// 1.6x the work of the function.  The bf16 path reads q, k, v through TMA tensor maps,
// so the wrapper requires 16-byte aligned base pointers and batch and time
// strides that are multiples of 8 elements (16 bytes).
//
// What bounds it on this card: at the serving prefill shape (B=4, H=32, K=2,
// T=1100, D=128, bf16) the causal work is 39.7 GFLOP, 40 us at the H100's
// 989 TFLOP/s bf16 tensor rate, against ~77 MB of q/k/v/o traffic, ~23 us at
// 3.35 TB/s: it is compute-bound, so the bf16 path runs both products on the
// tensor cores with wgmma, fed by a TMA ring under a producer warp (see the
// note above fa_fwd_bf16_kernel); P's hi + lo split makes the P V work
// twice, so the design's own bound is 1.5 x 40 = 60 us.  The f32 path keeps
// all math in f32 on the CUDA cores (a tensor-core product would round the
// f32 inputs).  The measured times are in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int BQ = 64;          // query rows per block
constexpr int BK = 64;          // key rows per tile
constexpr int NT = 256;         // threads per block, a 16 x 16 grid
constexpr float NEG_INF = -1e30f;


struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int H, G, Tq, Tk;
  long long q_sb, q_st, k_sb, k_st, v_sb, v_st, o_sb, o_st;
  int causal, window;
  float softcap, scale;
  int B;
  float* lse;                 // (B, H, Tq) row log-sum-exp, or null
  long long lse_sb, lse_sh;   // its batch and head strides (time: 1)
};

template <int D>
constexpr size_t smem_bytes() {
  // sQ, sK padded to D+1 floats a row; sV; sS padded to BK+1; corr, l, m
  return sizeof(float) *
         (size_t)(BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1) + 3 * BQ);
}

// ---- float32: CUDA cores ----------------------------------------------------

template <int D>
__global__ void __launch_bounds__(NT) fa_fwd_f32_kernel(const Params p) {
  constexpr int DP = D + 1;  // (row + d) % 32: conflict-free column reads
  constexpr int SP = BK + 1;
  constexpr int DJ = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + BQ * DP;
  float* sV = sK + BK * DP;
  float* sS = sV + BK * D;
  float* sCorr = sS + BQ * SP;
  float* sL = sCorr + BQ;
  float* sM = sL + BQ;

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh % p.H, kh = h / p.G;
  const int q0 = blockIdx.y * BQ;

  const float* Q = static_cast<const float*>(p.q) + b * p.q_sb + (long long)h * D;
  const float* K = static_cast<const float*>(p.k) + b * p.k_sb + (long long)kh * D;
  const float* V = static_cast<const float*>(p.v) + b * p.v_sb + (long long)kh * D;
  float* O = static_cast<float*>(p.o) + b * p.o_sb + (long long)h * D;

  for (int i = tid; i < BQ * D; i += NT) {
    const int r = i / D, d = i % D, t = q0 + r;
    sQ[r * DP + d] = t < p.Tq ? Q[t * p.q_st + d] : 0.f;
  }
  if (tid < BQ) {
    sM[tid] = NEG_INF;
    sL[tid] = 0.f;
  }

  float acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;

  int nkt = (p.Tk + BK - 1) / BK;
  if (p.causal) nkt = min(nkt, (q0 + BQ - 1) / BK + 1);

  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // previous tile's P.V is done with sK, sV, sS
    for (int i = tid; i < BK * D; i += NT) {
      const int r = i / D, d = i % D, t = k0 + r;
      const bool in = t < p.Tk;
      sK[r * DP + d] = in ? K[t * p.k_st + d] : 0.f;
      sV[r * D + d] = in ? V[t * p.v_st + d] : 0.f;
    }
    __syncthreads();

    // scores: thread owns rows ty + 16i, columns tx + 16j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[4], c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sQ[(ty + 16 * i) * DP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) c[j] = sK[(tx + 16 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], c[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i, qpos = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j, kpos = k0 + c;
        float x = s[i][j] * p.scale;
        if (p.softcap > 0.f) x = p.softcap * tanhf(x / p.softcap);
        bool ok = true;
        if (p.causal) ok = ok && kpos <= qpos;
        if (p.window > 0) ok = ok && (qpos - kpos) < p.window;
        if (!ok) x = NEG_INF;
        if (kpos >= p.Tk) x = -INFINITY;  // past the ragged end: weight 0
        sS[r * SP + c] = x;
      }
    }
    __syncthreads();

    // online softmax: four neighbouring lanes share a row, 16 columns each
    {
      const int r = tid >> 2, part = tid & 3;
      float* row = sS + r * SP + part * 16;
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < 16; ++c) mx = fmaxf(mx, row[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_prev = sM[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const float e = expf(row[c] - m_new);
        row[c] = e;
        sum += e;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (part == 0) {
        const float corr = expf(m_prev - m_new);
        sL[r] = sL[r] * corr + sum;
        sM[r] = m_new;
        sCorr[r] = corr;
      }
    }
    __syncthreads();

    // acc = acc * corr + P @ V: thread owns rows ty + 16i, columns tx + 16j
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float corr = sCorr[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= corr;
    }
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pr[i] = sS[(ty + 16 * i) * SP + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float vv = sV[c * D + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pr[i], vv, acc[i][j]);
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i, t = q0 + r;
    if (t >= p.Tq) continue;
    const float l = fmaxf(sL[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < DJ; ++j) O[t * p.o_st + tx + 16 * j] = acc[i][j] / l;
  }
  // the row log-sum-exp in natural-log units, for the backward
  if (p.lse != nullptr && tid < BQ && q0 + tid < p.Tq)
    p.lse[b * p.lse_sb + h * p.lse_sh + q0 + tid] =
        sM[tid] + logf(fmaxf(sL[tid], 1e-30f));
}


// ---- bfloat16: TMA ring + wgmma, warp-specialised --------------------------
//
// Work items are 128 query rows of one (batch, head), longest first; a
// persistent grid of one block an SM walks them.  A block holds two consumer
// warpgroups of 64 rows each and one producer warpgroup, of which one thread
// issues the TMA loads: Q once an item (a "qfree" barrier says when the
// consumers are done with the last one), and K and V tiles of BK keys
// through a ring of S stages, each with a "full" barrier (TMA bytes landed)
// and an "empty" barrier (all 8 consumer warps done with it); the ring runs
// on across items, so the next item's first tiles load under this one's
// tail.  Each row of 128 bytes is one 64-element chunk of the head dim
// (D/64 chunks), 128-byte swizzled, so the tiles are wgmma operands as
// they land.
//
// S = Q K^T: wgmma m64nBKk16, both operands from shared memory (K-major),
// f32 accumulation (products of bf16 values are exact in f32).  The online
// softmax runs on the accumulator fragment in registers, in log2 units.
// O += P V: wgmma m64nDk16 with A = P from registers and B = V from shared
// memory, MN-major (transposed).  P is split into hi + lo bf16 parts and
// both are multiplied, so P keeps ~16 significant bits as the reference's
// f32 p @ v needs, where one bf16 P would keep 8.  The accumulator layout
// of S is the register-A layout of the P V product, so P never leaves
// registers.  setmaxnreg moves registers from the producer (24) to the
// consumers (240).
//
// Tiles wholly above the causal diagonal or wholly outside the window are
// skipped.

constexpr int FQ = 128;        // query rows per block: 2 consumer warpgroups
constexpr int FT = 384;        // threads: warpgroups 0, 1 consume; 2 produces
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct Bf16Cfg {
  static constexpr int BK = D == 256 ? 64 : 128;     // keys per tile
  static constexpr int S = D == 256 ? 2 : 3;         // ring stages
  static constexpr int CH = D / 64;                  // 128-byte row chunks
  static constexpr uint32_t Q_BYTES = CH * FQ * 128;
  static constexpr uint32_t KV_BYTES = CH * BK * 128;  // one of K or V
  static constexpr size_t SMEM =
      1024 + Q_BYTES + 2 * S * KV_BYTES + (2 * S + 1) * sizeof(uint64_t);
};

struct Bf16Maps {
  CUtensorMap q, k, v;
};

// (x, y) -> bf16x2 hi and lo with hi + lo ~= (x, y); x in the low half.  hi
// is the top 16 bits of each float (one byte permute, no conversion); lo =
// x - hi is exact in f32, below 2^-7 |x|, and rounds to bf16 within 2^-8 of
// itself, so hi + lo is within 2^-15 |x| of x.
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  const uint32_t xb = __float_as_uint(x), yb = __float_as_uint(y);
  hi = __byte_perm(xb, yb, 0x7632);
  const __nv_bfloat162 l =
      __floats2bfloat162_rn(x - __uint_as_float(xb & 0xffff0000u),
                            y - __uint_as_float(yb & 0xffff0000u));
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// 2^x on the special-function unit; subnormal results flush to 0
__device__ __forceinline__ float ex2(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(x));
  return r;
}

// D: the tile's head dim (the wgmma widths); DT <= D: the tensors' head
// dim.  Columns DT..D-1 of q, k and v land as zeros (the tensor maps end
// at DT), so they add nothing to QK^T and give zero columns of O, which
// the epilogue does not store.
template <int D, int DT = D>
__global__ void __launch_bounds__(FT, 1)
fa_fwd_bf16_kernel(const __grid_constant__ Bf16Maps maps, const Params p) {
  static_assert(DT <= D && DT % 8 == 0, "the stored head dim");
  using Cfg = Bf16Cfg<D>;
  constexpr int BK = Cfg::BK, S = Cfg::S, CH = Cfg::CH;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sQ = hopper::align1024(smem_raw);
  unsigned char* sK = sQ + Cfg::Q_BYTES;
  unsigned char* sV = sK + S * Cfg::KV_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(sV + S * Cfg::KV_BYTES);
  uint64_t* empty = full + S;
  uint64_t* qbar = empty + S;
  uint64_t* qfree = qbar + 1;

  // Work item w: query tile nqt - 1 - w / (B H) of (batch, head) w % (B H),
  // so items run longest first.  The grid is persistent: in round r a
  // block takes item r G + (block, or G - 1 - block in odd rounds), so the
  // long and the short tiles of neighbouring rounds even out.
  const int nqt = (p.Tq + FQ - 1) / FQ;
  const int n_items = p.B * p.H * nqt;
  auto item_of = [&](int r) {
    const int G = gridDim.x;
    return r * G + ((r & 1) ? G - 1 - (int)blockIdx.x : (int)blockIdx.x);
  };
  struct Item {
    int b, h, q0, kt_lo, n;
  };
  auto decode = [&](int w) {
    Item it;
    const int bh = w % (p.B * p.H);
    it.b = bh / p.H;
    it.h = bh % p.H;
    it.q0 = (nqt - 1 - w / (p.B * p.H)) * FQ;
    // key tiles [kt_lo, kt_hi): those above the causal diagonal of the
    // last row, and, when every row keeps an unmasked key, those wholly
    // outside the window of the first row, carry weight exp(-1e30 - m) = 0
    int kt_hi = (p.Tk + BK - 1) / BK;
    if (p.causal) kt_hi = min(kt_hi, (it.q0 + FQ - 1) / BK + 1);
    it.kt_lo = 0;
    if (p.window > 0 && min(it.q0 + FQ, p.Tq) - 1 - p.window < p.Tk - 1)
      it.kt_lo = max(0, it.q0 - p.window + 1) / BK;
    it.n = kt_hi - it.kt_lo;
    return it;
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 8);    // one arrival per consumer warp
    }
    hopper::mbar_init(qbar, 1);
    hopper::mbar_init(qfree, 8);
    hopper::mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer: Q once an item, K/V tiles through the ring ----
    hopper::setmaxnreg_dec<24>();
    if (threadIdx.x == 256) {
      int gt = 0;                           // tiles issued, over all items
      for (int r = 0; item_of(r) < n_items; ++r) {
        const Item it = decode(item_of(r));
        const int kh = it.h / p.G;
        if (r > 0) hopper::mbar_wait(qfree, (r - 1) & 1);
        hopper::mbar_arrive_expect_tx(qbar, Cfg::Q_BYTES);
        for (int c = 0; c < CH; ++c)
          hopper::tma_load_4d(sQ + c * FQ * 128, &maps.q, qbar, c * 64, it.h,
                              it.q0, it.b);
        for (int i = 0; i < it.n; ++i, ++gt) {
          const int s = gt % S;
          if (gt >= S) hopper::mbar_wait(&empty[s], ((gt / S) - 1) & 1);
          hopper::mbar_arrive_expect_tx(&full[s], 2 * Cfg::KV_BYTES);
          const int k0 = (it.kt_lo + i) * BK;
          unsigned char* k_dst = sK + s * Cfg::KV_BYTES;
          unsigned char* v_dst = sV + s * Cfg::KV_BYTES;
          for (int c = 0; c < CH; ++c) {
            hopper::tma_load_4d(k_dst + c * BK * 128, &maps.k, &full[s],
                                c * 64, kh, k0, it.b);
            hopper::tma_load_4d(v_dst + c * BK * 128, &maps.v, &full[s],
                                c * 64, kh, k0, it.b);
          }
        }
      }
    }
  } else {
    // ---- consumers ----
    // Phase i of an item issues S_i = Q K_i and O += P_{i-1} V_{i-1}
    // together, runs the softmax of S_i while the P V product finishes,
    // then rescales O and splits P_i; the first phase has no P V, the last
    // no S.  The two warpgroups take turns to issue (named barriers 2 and
    // 3), so one's softmax overlaps the other's products.  No wgmma is
    // issued under a branch: ptxas serializes them all if one is.
    hopper::setmaxnreg_inc<240>();
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
    const uint32_t q_addr = hopper::smem_u32(sQ) + wg * 64 * 128;
    const int bar_mine = 2 + wg, bar_other = 3 - wg;
    const float scale2 = p.scale * LOG2E;

    float o[D / 2];
    float m_r[2], l_r[2];   // rows row0, row0 + 8 (log2 units); this
                            // thread's share of the row sums
    uint32_t ph[BK / 16][4], pl[BK / 16][4];
    float sc[BK / 2];
    float corr[2];          // the rescale of O by tile i's new maxima
    int q0 = 0, row0 = 0, kt_lo = 0;

    auto issue_s = [&](int gi) {          // S = Q K of ring tile gi
      const uint32_t k_addr = hopper::smem_u32(sK + (gi % S) * Cfg::KV_BYTES);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;    // k16 step in the chunk
        hopper::Wgmma<BK>::ss_bf16(
            sc, hopper::desc_sw128(q_addr + (kk / 4) * FQ * 128 + off, 16),
            hopper::desc_sw128(k_addr + (kk / 4) * BK * 128 + off, 16),
            kk > 0);
      }
    };
    auto issue_pv = [&](int gi) {         // O += P_hi V + P_lo V
      const uint32_t v_addr = hopper::smem_u32(sV + (gi % S) * Cfg::KV_BYTES);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t dv =
            hopper::desc_sw128(v_addr + kk * 16 * 128, BK * 128);
        hopper::Wgmma<D>::rs_bf16_tb(o, ph[kk], dv, 1);
        hopper::Wgmma<D>::rs_bf16_tb(o, pl[kk], dv, 1);
      }
    };
    auto begin_issue = [&]() {
      hopper::named_sync(bar_mine, 256);
      hopper::fence_regs(o);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        hopper::fence_regs(ph[kk]);
        hopper::fence_regs(pl[kk]);
      }
      hopper::wgmma_fence();
    };
    // the second warpgroup's last arrival of an item is left out, so that
    // each item's arrivals match its waits
    auto end_issue = [&](bool last) {
      hopper::wgmma_commit();
      if (!(last && wg == 1)) hopper::named_arrive(bar_other, 256);
      hopper::wgmma_wait<0>();
      hopper::fence_regs(o);
      hopper::fence_regs(sc);
    };
    auto release = [&](uint64_t* bar) {
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(bar);
    };
    // scores of tile i in log2 units: scale, soft-cap, mask; masking only
    // where a tile crosses the diagonal, the window's edge or the ragged
    // end; then the online softmax: maxima, exponentials, sums
    auto softmax = [&](int i) {
      const int k0 = (kt_lo + i) * BK;
      if (p.softcap > 0.f) {
        const float c2 = p.softcap * LOG2E, inv = p.scale / p.softcap;
#pragma unroll
        for (int e = 0; e < BK / 2; ++e) sc[e] = c2 * tanhf(sc[e] * inv);
      } else {
#pragma unroll
        for (int e = 0; e < BK / 2; ++e) sc[e] *= scale2;
      }
      if (k0 + BK > p.Tk || (p.causal && k0 + BK - 1 > q0) ||
          (p.window > 0 && q0 + FQ - 1 - k0 >= p.window)) {
        // column c = 8j + (e & 1) of this thread is key k0 + 2t + c: row
        // r keeps c in (lo[r], hi[r]], and c >= past is beyond the end
        const int cb = k0 + 2 * t, past = p.Tk - cb;
        int lo[2], hi[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int qpos = row0 + 8 * r;
          hi[r] = p.causal ? qpos - cb : INT_MAX;
          lo[r] = p.window > 0 ? qpos - cb - p.window : INT_MIN;
        }
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = 8 * j + (e & 1), r = e >> 1;
            float x = sc[4 * j + e];
            if (c > hi[r] || c <= lo[r]) x = NEG_INF;
            if (c >= past) x = -INFINITY;     // past the ragged end: weight 0
            sc[4 * j + e] = x;
          }
      }
      // the four lanes of a quad share rows row0, row0 + 8; maxima and sums
      // in four interleaved partials a row (one serial chain would leave
      // the two warps of a scheduler waiting on latency)
      float mx[2][4], sm[2][4];
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          mx[r][c] = -INFINITY;
          sm[r][c] = 0.f;
        }
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          mx[r][j % 4] = fmaxf(mx[r][j % 4], fmaxf(sc[4 * j + 2 * r],
                                                   sc[4 * j + 2 * r + 1]));
      float m_new[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float m = fmaxf(fmaxf(mx[r][0], mx[r][1]), fmaxf(mx[r][2], mx[r][3]));
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
        m_new[r] = fmaxf(m_r[r], m);
        corr[r] = ex2(m_r[r] - m_new[r]);
        m_r[r] = m_new[r];
      }
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float p0 = ex2(sc[4 * j + 2 * r] - m_new[r]);
          const float p1 = ex2(sc[4 * j + 2 * r + 1] - m_new[r]);
          sc[4 * j + 2 * r] = p0;
          sc[4 * j + 2 * r + 1] = p1;
          sm[r][j % 4] += p0 + p1;
        }
#pragma unroll
      for (int r = 0; r < 2; ++r)
        l_r[r] = l_r[r] * corr[r] +
                 ((sm[r][0] + sm[r][1]) + (sm[r][2] + sm[r][3]));
    };
    // once the previous P V is done: O rescaled, P_i into hi + lo
    auto softmax_finish = [&]() {
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[4 * j + e] *= corr[e >> 1];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          split_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1], ph[kk][r],
                     pl[kk][r]);
    };

    int gt = 0;                             // ring tiles consumed
    for (int r = 0; item_of(r) < n_items; ++r) {
      const Item it = decode(item_of(r));
      q0 = it.q0;
      kt_lo = it.kt_lo;
      row0 = q0 + wg * 64 + warp * 16 + g;
      const int n = it.n;
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
      m_r[0] = m_r[1] = NEG_INF;
      l_r[0] = l_r[1] = 0.f;

      hopper::mbar_wait(qbar, r & 1);
      if (wg == 1) hopper::named_arrive(bar_other, 256);  // warpgroup 0 first
      hopper::mbar_wait(&full[gt % S], (gt / S) & 1);
      begin_issue();
      issue_s(gt);
      end_issue(false);
      if (n == 1) release(qfree);           // Q is done with
      softmax(0);
      softmax_finish();
      for (int i = 1; i < n; ++i) {
        // S_i and P_{i-1} V_{i-1} as two groups: the softmax of S_i runs
        // while the P V product is still on the tensor cores
        const int gi = gt + i;
        hopper::mbar_wait(&full[gi % S], (gi / S) & 1);
        begin_issue();
        issue_s(gi);
        hopper::wgmma_commit();
        issue_pv(gi - 1);
        hopper::wgmma_commit();
        hopper::named_arrive(bar_other, 256);
        hopper::wgmma_wait<1>();
        hopper::fence_regs(sc);
        if (i == n - 1) release(qfree);     // Q is done with
        softmax(i);
        hopper::wgmma_wait<0>();
        hopper::fence_regs(o);
        release(&empty[(gi - 1) % S]);      // K and V of tile i - 1
        softmax_finish();
      }
      begin_issue();
      issue_pv(gt + n - 1);
      end_issue(true);
      release(&empty[(gt + n - 1) % S]);
      gt += n;

      using bf16 = __nv_bfloat16;
      bf16* O = static_cast<bf16*>(p.o) + it.b * p.o_sb + (long long)it.h * DT;
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        float l = l_r[rr];
        l += __shfl_xor_sync(0xffffffffu, l, 1);
        l += __shfl_xor_sync(0xffffffffu, l, 2);
        l = fmaxf(l, 1e-30f);
        const int row = row0 + 8 * rr;
        if (row >= p.Tq) continue;
        // the row log-sum-exp: m and l are in log2 units
        if (p.lse != nullptr && t == 0)
          p.lse[it.b * p.lse_sb + it.h * p.lse_sh + row] =
              (m_r[rr] + log2f(l)) / LOG2E;
#pragma unroll
        for (int j = 0; j < DT / 8; ++j)
          *reinterpret_cast<__nv_bfloat162*>(O + row * p.o_st + j * 8 +
                                             2 * t) =
              __floats2bfloat162_rn(o[4 * j + 2 * rr] / l,
                                    o[4 * j + 2 * rr + 1] / l);
      }
    }
  }
}

template <int D>
cudaError_t launch_f32(const Params& p, int B, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t e = cudaFuncSetAttribute(
      fa_fwd_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(B * p.H, (p.Tq + BQ - 1) / BQ);
  fa_fwd_f32_kernel<D><<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

// q (B, Tq, H, DT), k/v (B, Tk, KV, DT) as 4-D tensor maps (DT, heads, T,
// B); boxes of 64 head-dim elements (128 bytes, swizzled) by one head by
// `rows`, D / 64 of them a row: those past DT are zero-filled
template <int D, int DT = D>
cudaError_t launch_bf16(const Params& p, int B, int KV, cudaStream_t stream) {
  using Cfg = Bf16Cfg<D>;
  Bf16Maps maps;
  const uint64_t row = DT * sizeof(__nv_bfloat16);
  const uint32_t q_box[4] = {64, 1, FQ, 1};
  const uint32_t kv_box[4] = {64, 1, (uint32_t)Cfg::BK, 1};
  const uint64_t q_dims[4] = {DT, (uint64_t)p.H, (uint64_t)p.Tq, (uint64_t)B};
  const uint64_t kv_dims[4] = {DT, (uint64_t)KV, (uint64_t)p.Tk, (uint64_t)B};
  const uint64_t q_str[3] = {row, 2ull * p.q_st, 2ull * p.q_sb};
  const uint64_t k_str[3] = {row, 2ull * p.k_st, 2ull * p.k_sb};
  const uint64_t v_str[3] = {row, 2ull * p.v_st, 2ull * p.v_sb};
  const auto bf = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const auto sw = CU_TENSOR_MAP_SWIZZLE_128B;
  if (!hopper_host::make_map(&maps.q, bf, 4, p.q, q_dims, q_str, q_box, sw) ||
      !hopper_host::make_map(&maps.k, bf, 4, p.k, kv_dims, k_str, kv_box, sw) ||
      !hopper_host::make_map(&maps.v, bf, 4, p.v, kv_dims, v_str, kv_box, sw))
    return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      fa_fwd_bf16_kernel<D, DT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)Cfg::SMEM);
  if (e != cudaSuccess) return e;
  static int sms = 0;                       // SMs of the card: one block each
  if (sms == 0) {
    int dev = 0;
    e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
  }
  const int items = B * p.H * ((p.Tq + FQ - 1) / FQ);
  fa_fwd_bf16_kernel<D, DT><<<items < sms ? items : sms, FT, Cfg::SMEM,
                              stream>>>(
      maps, p);
  return cudaGetLastError();
}

cudaError_t dispatch(const Params& p, int dtype, int B, int KV, int D,
                     cudaStream_t s) {
  if (dtype == 0) {
    switch (D) {
      case 64: return launch_f32<64>(p, B, s);
      case 80: return launch_f32<80>(p, B, s);
      case 128: return launch_f32<128>(p, B, s);
      case 256: return launch_f32<256>(p, B, s);
    }
  } else if (dtype == 1) {
    switch (D) {
      case 64: return launch_bf16<64>(p, B, KV, s);
      // zamba2's head dim, on the 128-wide tile (1.6x its products)
      case 80: return launch_bf16<128, 80>(p, B, KV, s);
      case 128: return launch_bf16<128>(p, B, KV, s);
      case 256: return launch_bf16<256>(p, B, KV, s);
    }
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16.  lse: null, or (B, H, Tq) float32 with
// strides lse_sb, lse_sh, 1, written with the row log-sum-exp of the scaled,
// soft-capped, masked scores in natural-log units (the backward recomputes
// P = exp(S - lse)).  Returns a cudaError_t (0 on success).
int fa_fwd(const void* q, const void* k, const void* v, void* o, int dtype,
           int B, int H, int KV, int Tq, int Tk, int D,
           long long q_sb, long long q_st, long long k_sb, long long k_st,
           long long v_sb, long long v_st, long long o_sb, long long o_st,
           int causal, int window, float softcap, float scale, float* lse,
           long long lse_sb, long long lse_sh, void* stream) {
  if (KV <= 0 || H % KV != 0 || B <= 0 || Tq <= 0 || Tk <= 0)
    return (int)cudaErrorInvalidValue;
  Params p{q, k, v, o, H, H / KV, Tq, Tk, q_sb, q_st, k_sb, k_st,
           v_sb, v_st, o_sb, o_st, causal, window, softcap, scale, B,
           lse, lse_sb, lse_sh};
  return (int)dispatch(p, dtype, B, KV, D,
                       static_cast<cudaStream_t>(stream));
}

const char* fa_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
