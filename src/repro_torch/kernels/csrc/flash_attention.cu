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
//     skipped tile's weight would be exp(-1e30 - m) = 0).
//
// Layout: q (B, Tq, H, D), k/v (B, Tk, H/G, D), o (B, Tq, H, D); heads and
// head_dim contiguous, batch and time strides given in elements (so a slice
// of a longer KV cache is taken without a copy).  Inputs float32 or bfloat16,
// D in {64, 128, 256}.  bf16 rows are copied as 16-byte vectors, so the
// wrapper requires 16-byte aligned base pointers and batch and time strides
// that are multiples of 8 elements.
//
// What bounds it on this card: at the serving prefill shape (B=4, H=32, K=2,
// T~1024, D=128, bf16) the causal work is ~34 GFLOP, ~35 us at the H100's
// 989 TFLOP/s bf16 tensor rate, against ~71 MB of q/k/v/o traffic, ~21 us at
// 3.35 TB/s: it is compute-bound, so the bf16 path runs both products on the
// tensor cores (mma.sync, f32 accumulation; see the note above
// fa_fwd_bf16_kernel for how P keeps f32-level precision).  The f32 path
// keeps all math in f32 on the CUDA cores (a tensor-core product would round
// the f32 inputs).  Neither overlaps its global loads with compute yet:
// cp.async/TMA pipelining, wgmma and warp specialisation are later work; the
// measured times are in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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
}


// ---- bfloat16: tensor cores (mma.sync m16n8k16, float32 accumulate) --------
//
// Four warps own 16 query rows each.  S = Q K^T: bf16 operands, f32
// accumulation (the products of two bf16 values are exact in f32).  P V: P
// is split into hi + lo bf16 parts (p - hi rounds to lo with a relative
// error of 2^-17), two products per tile, so P keeps ~16 significant bits
// where one bf16 P would keep 8; V is bf16 already.  The score accumulator
// layout of m16n8 is the A-operand layout of the next product, so P never
// leaves registers.

constexpr int MQ = 64;          // query rows per block, 16 per warp
constexpr int MK = 64;          // key rows per tile
constexpr int MT = 128;         // threads per block: 4 warps

template <int D>
constexpr size_t mma_smem_bytes() {
  // sQ, sK, sV as bf16 rows of D + 8: the 16-byte pad puts the 8 rows of
  // each ldmatrix on distinct banks
  return sizeof(__nv_bfloat16) * (size_t)(MQ + 2 * MK) * (D + 8);
}

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t* r) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t* r) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (x, y) -> bf16x2 hi and lo with hi + lo ~= (x, y); x in the low half
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = as_u32(h);
  lo = as_u32(__floats2bfloat162_rn(x - hf.x, y - hf.y));
}

// rows [row0, row0 + rows) of a (T, D) slice with row stride `stride`;
// rows at or past `valid` are zero-filled.  16-byte vector copies.
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* s,
                                          const __nv_bfloat16* g,
                                          long long stride, int row0,
                                          int valid, int rows) {
  constexpr int CH = D / 8;
  for (int i = threadIdx.x; i < rows * CH; i += MT) {
    const int r = i / CH, c = (i % CH) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < valid)
      v = *reinterpret_cast<const uint4*>(g + (long long)(row0 + r) * stride + c);
    *reinterpret_cast<uint4*>(s + r * (D + 8) + c) = v;
  }
}

template <int D>
__global__ void __launch_bounds__(MT) fa_fwd_bf16_kernel(const Params p) {
  constexpr int SR = D + 8;
  constexpr int NS = MK / 8;   // score n-tiles of 8 keys
  constexpr int NO = D / 8;    // output n-tiles of 8 columns
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + MQ * SR;
  __nv_bfloat16* sV = sK + MK * SR;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh % p.H, kh = h / p.G;
  const int q0 = blockIdx.y * MQ;
  const int wrow = warp * 16;

  using bf16 = __nv_bfloat16;
  const bf16* Q = static_cast<const bf16*>(p.q) + b * p.q_sb + (long long)h * D;
  const bf16* K = static_cast<const bf16*>(p.k) + b * p.k_sb + (long long)kh * D;
  const bf16* V = static_cast<const bf16*>(p.v) + b * p.v_sb + (long long)kh * D;
  bf16* O = static_cast<bf16*>(p.o) + b * p.o_sb + (long long)h * D;

  load_tile<D>(sQ, Q, p.q_st, q0, p.Tq, MQ);

  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m_r[2] = {NEG_INF, NEG_INF};  // rows g and g + 8 of this warp
  float l_r[2] = {0.f, 0.f};          // this thread's share of the row sums

  int nkt = (p.Tk + MK - 1) / MK;
  if (p.causal) nkt = min(nkt, (q0 + MQ - 1) / MK + 1);

  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * MK;
    __syncthreads();  // previous tile's products are done with sK, sV
    load_tile<D>(sK, K, p.k_st, k0, p.Tk, MK);
    load_tile<D>(sV, V, p.v_st, k0, p.Tk, MK);
    __syncthreads();

    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      ldsm_x4(smem_u32(sQ + (wrow + (lane & 7) + 8 * ((lane >> 3) & 1)) * SR +
                       kk * 16 + 8 * (lane >> 4)), a);
#pragma unroll
      for (int j = 0; j < NS; j += 2) {
        uint32_t bk[4];
        ldsm_x4(smem_u32(sK + (j * 8 + (lane & 7) + 8 * (lane >> 4)) * SR +
                         kk * 16 + 8 * ((lane >> 3) & 1)), bk);
        mma_bf16(s[j], a, bk[0], bk[1]);
        mma_bf16(s[j + 1], a, bk[2], bk[3]);
      }
    }

#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qpos = q0 + wrow + g + 8 * (e >> 1);
        const int kpos = k0 + j * 8 + 2 * t + (e & 1);
        float x = s[j][e] * p.scale;
        if (p.softcap > 0.f) x = p.softcap * tanhf(x / p.softcap);
        bool ok = true;
        if (p.causal) ok = ok && kpos <= qpos;
        if (p.window > 0) ok = ok && (qpos - kpos) < p.window;
        if (!ok) x = NEG_INF;
        if (kpos >= p.Tk) x = -INFINITY;  // past the ragged end: weight 0
        s[j][e] = x;
      }

    // online softmax; the four lanes of a quad share rows g and g + 8
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < NS; ++j)
        mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_r[r], mx);
      const float corr = expf(m_r[r] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        s[j][2 * r] = expf(s[j][2 * r] - m_new);
        s[j][2 * r + 1] = expf(s[j][2 * r + 1] - m_new);
        sum += s[j][2 * r] + s[j][2 * r + 1];
      }
      l_r[r] = l_r[r] * corr + sum;
      m_r[r] = m_new;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        o[n][2 * r] *= corr;
        o[n][2 * r + 1] *= corr;
      }
    }

    // O += P V, 16 keys a step
#pragma unroll
    for (int kk = 0; kk < MK / 16; ++kk) {
      uint32_t ph[4], pl[4];
      split_bf16(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
      split_bf16(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
      split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
      split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int n = 0; n < NO; n += 2) {
        uint32_t bv[4];
        ldsm_x4_trans(smem_u32(sV + (kk * 16 + (lane & 7) + 8 * ((lane >> 3) & 1)) * SR +
                               n * 8 + 8 * (lane >> 4)), bv);
        mma_bf16(o[n], ph, bv[0], bv[1]);
        mma_bf16(o[n], pl, bv[0], bv[1]);
        mma_bf16(o[n + 1], ph, bv[2], bv[3]);
        mma_bf16(o[n + 1], pl, bv[2], bv[3]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_r[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    l = fmaxf(l, 1e-30f);
    const int row = q0 + wrow + g + 8 * r;
    if (row >= p.Tq) continue;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<__nv_bfloat162*>(O + row * p.o_st + n * 8 + 2 * t) =
          __floats2bfloat162_rn(o[n][2 * r] / l, o[n][2 * r + 1] / l);
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

template <int D>
cudaError_t launch_bf16(const Params& p, int B, cudaStream_t stream) {
  constexpr size_t smem = mma_smem_bytes<D>();
  cudaError_t e = cudaFuncSetAttribute(
      fa_fwd_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(B * p.H, (p.Tq + MQ - 1) / MQ);
  fa_fwd_bf16_kernel<D><<<grid, MT, smem, stream>>>(p);
  return cudaGetLastError();
}

cudaError_t dispatch(const Params& p, int dtype, int B, int D, cudaStream_t s) {
  if (dtype == 0) {
    switch (D) {
      case 64: return launch_f32<64>(p, B, s);
      case 128: return launch_f32<128>(p, B, s);
      case 256: return launch_f32<256>(p, B, s);
    }
  } else if (dtype == 1) {
    switch (D) {
      case 64: return launch_bf16<64>(p, B, s);
      case 128: return launch_bf16<128>(p, B, s);
      case 256: return launch_bf16<256>(p, B, s);
    }
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16.  Returns a cudaError_t (0 on success).
int fa_fwd(const void* q, const void* k, const void* v, void* o, int dtype,
           int B, int H, int KV, int Tq, int Tk, int D,
           long long q_sb, long long q_st, long long k_sb, long long k_st,
           long long v_sb, long long v_st, long long o_sb, long long o_st,
           int causal, int window, float softcap, float scale, void* stream) {
  if (KV <= 0 || H % KV != 0 || B <= 0 || Tq <= 0 || Tk <= 0)
    return (int)cudaErrorInvalidValue;
  Params p{q, k, v, o, H, H / KV, Tq, Tk, q_sb, q_st, k_sb, k_st,
           v_sb, v_st, o_sb, o_st, causal, window, softcap, scale};
  return (int)dispatch(p, dtype, B, D, static_cast<cudaStream_t>(stream));
}

const char* fa_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
