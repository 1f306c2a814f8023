// 4-bit codebook (LUT) dequantizing matmul for NVIDIA Hopper (sm_90a), CUDA
// C++ with a plain C interface (loaded through ctypes by kernels/lut_matmul.py).
//
// Replaces repro/kernels/lut_matmul.py::lut_matmul, the Pallas TPU kernel:
//   Y[M, N] = X[M, K] @ W,  W[k, n] = lut[k / 64, n, codes[k, n]]
// x (M, K) float32 or bfloat16, codes (K, N) uint8 (one 4-bit code a byte),
// lut (K / 64, N, 16) float32 codebooks per (64-row group, column), y (M, N)
// float32.  W never exists in device memory: each block rebuilds its
// (BK x BN) weight tile in shared memory from the codes and the group's
// codebooks, as the TPU kernel rebuilds its tile in VMEM.
//
// Differences from the TPU kernel, none of which change the result beyond
// float32 rounding order: the TPU's grid walks K on a sequential axis and
// accumulates into the resident output block; here one block owns a
// (BM x BN) output tile and loops over K itself, accumulating in registers.
// M and N need not be multiples of the tile (edges are masked); K must be a
// multiple of 64, as the codebook layout requires.
//
// What bounds it on this card: 2*M*K*N flops, far above the bytes it moves
// (at M=1024, K=4096, N=16384: 137 GFLOP against 218 MB, 0.065 ms).  The
// products must keep float32 accuracy (the reference multiplies in f32 and
// its tests hold 1e-5, which one TF32 product misses), and on the CUDA cores
// f32 caps at 67 TFLOP/s (2.05 ms).  So the products run on the tensor cores
// as 3xTF32: each operand is split into a TF32 high part, rounded to nearest
// with cvt.rna (the tensor cores would truncate it), and the residual
// x - x_hi, exact in f32, which the tensor cores truncate to TF32 (an error
// of 2^-10 of the residual, below 2^-21 of x); x_hi w_hi + x_hi w_lo +
// x_lo w_hi is accumulated in f32 and the dropped x_lo w_lo is below 2^-22
// of each product.  bf16 x is exact in TF32, so x_lo = 0
// and two products suffice.  Bound: 3 x 137.4 GFLOP at 495 TFLOP/s, 0.833 ms.
//
// Design: a block owns a 128 x 128 output tile: two consumer warpgroups of
// 64 rows (wgmma m64n128k8, f32 accumulators in registers) and a producer
// warpgroup.  The producer fills a 4-stage ring, one stage per 32-deep k
// tile, under full/empty mbarriers: one thread streams the x tile (128 rows
// x 32 k) by TMA, and the 128 threads load, one column each, the tile's
// codes (packed four to a word) and, for the first tile of each 64-row
// group, the group's codebooks, split once per entry into TF32 (hi, lo)
// pairs and stored level-major, so that the lookups of a warp (32
// neighbouring columns) hit distinct banks.  W never leaves the block: the
// consumers rebuild tile k+1 from its stage ([n][k], 128-byte swizzled: the
// K-major B operand wgmma wants) into the other of two W buffers while the
// products of tile k run, and load tile k+1's x fragment from the swizzled
// x tile into registers: x_hi and x_lo, split in registers, are wgmma's
// register A operand.  Each tile's
// products go into a fresh accumulator that is added to the running sum on
// the CUDA cores: the tensor cores' own f32 accumulation truncates, and over
// K = 4096 that bias alone reached 1.7e-4.  setmaxnreg moves registers from
// the producer (72) to the consumers (216).  (Rebuilding W in the producer
// warpgroup instead, so that the consumers only multiply, measured 1.5x
// slower on the H100: its four warps could not keep up.)  The measured
// times are in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int GROUP = 64;   // K rows per codebook
constexpr int LEVELS = 16;  // entries per codebook
constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 32;      // one 128-byte row of f32; two tiles a group
constexpr int STAGES = 4;
constexpr int NT = 384;     // warpgroups 0, 1 consume; 2 produces
constexpr int NC = 256;     // consumer threads
constexpr uint32_t X_BYTES = BM * BK * 4;       // an f32 x tile
constexpr uint32_t C_BYTES = BK * BN;           // a codes tile, 4 to a word
constexpr uint32_t T_BYTES = LEVELS * BN * 8;   // a group's (hi, lo) table
constexpr uint32_t STAGE = X_BYTES + C_BYTES + T_BYTES;
constexpr uint32_t W_PART = BN * BK * 4;        // W_hi or W_lo of a tile
constexpr size_t SMEM =
    1024 + STAGES * STAGE + 4 * W_PART + 2 * STAGES * sizeof(uint64_t);

// x(row, k) of a stage: f32 tiles are 128-byte swizzled rows (TMA
// SWIZZLE_128B), bf16 tiles plain 64-byte rows
__device__ __forceinline__ float x_at(const unsigned char* t, int row, int k,
                                      float) {
  return *reinterpret_cast<const float*>(
      t + row * 128 + ((((k >> 2) ^ (row & 7)) << 4) | ((k & 3) << 2)));
}

__device__ __forceinline__ float x_at(const unsigned char* t, int row, int k,
                                      __nv_bfloat16) {
  return __bfloat162float(
      *reinterpret_cast<const __nv_bfloat16*>(t + row * 64 + k * 2));
}

template <typename TX>
__global__ void __launch_bounds__(NT, 1)
lut_matmul_kernel(const __grid_constant__ CUtensorMap xmap,
                  const uint8_t* __restrict__ codes,
                  const float* __restrict__ lut, float* __restrict__ y,
                  int M, int N, int K) {
  constexpr bool SPLIT_X = sizeof(TX) == 4;     // bf16 x is exact in TF32
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sS = hopper::align1024(smem_raw);
  unsigned char* sW = sS + STAGES * STAGE;      // [buffer][hi, lo][n][k]
  uint64_t* full = reinterpret_cast<uint64_t*>(sW + 4 * W_PART);
  uint64_t* empty = full + STAGES;
  // stage s: x tile, then codes [k / 4][n] words, then table [level][n]
  auto x_of = [&](int s) { return sS + s * STAGE; };
  auto codes_of = [&](int s) {
    return reinterpret_cast<uint32_t*>(sS + s * STAGE + X_BYTES);
  };
  auto table_of = [&](int s) {
    return reinterpret_cast<float2*>(sS + s * STAGE + X_BYTES + C_BYTES);
  };

  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int nk = K / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&full[s], 1 + 128);   // TMA's expect_tx + producers
      hopper::mbar_init(&empty[s], 8);        // one arrival per consumer warp
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= NC) {
    // ---- producer: column pn of every tile ----
    hopper::setmaxnreg_dec<72>();
    const int pn = threadIdx.x - NC;
    const bool ok = n0 + pn < N;
    const uint8_t* col = codes + (ok ? n0 + pn : 0);
    for (int kt = 0; kt < nk; ++kt) {
      const int s = kt % STAGES;
      if (kt >= STAGES) hopper::mbar_wait(&empty[s], ((kt / STAGES) - 1) & 1);
      if (pn == 0) {
        hopper::mbar_arrive_expect_tx(&full[s], BM * BK * sizeof(TX));
        hopper::tma_load_2d(x_of(s), &xmap, &full[s], kt * BK, m0);
      }
      uint32_t w[BK / 4] = {};
      if (ok) {
        const uint8_t* c = col + (long long)kt * BK * N;
#pragma unroll
        for (int k = 0; k < BK; ++k)
          w[k / 4] |= (uint32_t)__ldg(c + (long long)k * N) << (8 * (k % 4));
      }
      uint32_t* cs = codes_of(s);
#pragma unroll
      for (int i = 0; i < BK / 4; ++i) cs[i * BN + pn] = w[i];
      if (kt * BK % GROUP == 0) {
        float2* tab = table_of(s);
        const float4* src = reinterpret_cast<const float4*>(
            lut + ((long long)(kt * BK / GROUP) * N + n0 + pn) * LEVELS);
#pragma unroll
        for (int q = 0; q < LEVELS / 4; ++q) {
          const float4 v4 =
              ok ? __ldg(src + q) : make_float4(0.f, 0.f, 0.f, 0.f);
          const float v[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float hi = __uint_as_float(hopper::to_tf32(v[e]));
            tab[(4 * q + e) * BN + pn] = make_float2(hi, v[e] - hi);
          }
        }
      }
      hopper::mbar_arrive(&full[s]);
    }
    return;
  }

  // ---- consumers ----
  hopper::setmaxnreg_inc<216>();
  const int tid = threadIdx.x;
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int ra = wg * 64 + warp * 16 + g;       // and ra + 8
  // the rebuild: column dn, 16-byte k chunks dc + 2i (4 k each), i < 4
  const int dn = tid % BN, dc = tid / BN;

  // tile kt's W_hi, W_lo into buffer kt & 1, from its stage's codes and
  // the table in the stage of its group's first tile
  auto rebuild = [&](int kt) {
    const uint32_t* cs = codes_of(kt % STAGES);
    const float2* tab = table_of((kt - kt % (GROUP / BK)) % STAGES);
    unsigned char* whi = sW + (kt & 1) * 2 * W_PART;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kc = dc + 2 * i;
      const uint32_t cw = cs[kc * BN + dn];
      float hi[4], lo[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 e = tab[((cw >> (8 * j)) & 15) * BN + dn];
        hi[j] = e.x;
        lo[j] = e.y;
      }
      const int off = dn * 128 + ((kc ^ (dn & 7)) << 4);
      *reinterpret_cast<float4*>(whi + off) =
          make_float4(hi[0], hi[1], hi[2], hi[3]);
      *reinterpret_cast<float4*>(whi + W_PART + off) =
          make_float4(lo[0], lo[1], lo[2], lo[3]);
    }
  };

  float acc[BN / 2], part[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;

  // this thread's x_{row, k} of tile kt, rows ra (+8), k = 8 k8 + t (+4):
  // the register A fragment of wgmma's tf32 products
  float xv[4][4];
  auto load_x = [&](int kt) {
    const unsigned char* xt = x_of(kt % STAGES);
#pragma unroll
    for (int k8 = 0; k8 < 4; ++k8)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        xv[k8][r] = x_at(xt, ra + 8 * (r & 1), 8 * k8 + t + 4 * (r >> 1),
                         TX());
  };

  hopper::mbar_wait(&full[0], 0);
  rebuild(0);
  load_x(0);
  hopper::fence_proxy_async();
  hopper::named_sync(1, NC);

  for (int it = 0; it < nk; ++it) {
    const int s = it % STAGES;
    uint32_t ah[4][4], al[4][4];
#pragma unroll
    for (int k8 = 0; k8 < 4; ++k8)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        ah[k8][r] = hopper::to_tf32(xv[k8][r]);
        al[k8][r] = SPLIT_X ? __float_as_uint(xv[k8][r] -
                                              __uint_as_float(ah[k8][r]))
                            : 0u;
      }

    const uint32_t whi = hopper::smem_u32(sW + (it & 1) * 2 * W_PART);
    hopper::fence_regs(part);
    hopper::wgmma_fence();
#pragma unroll
    for (int k8 = 0; k8 < 4; ++k8) {
      const uint64_t dh = hopper::desc_sw128(whi + 32 * k8, 16);
      const uint64_t dl = hopper::desc_sw128(whi + W_PART + 32 * k8, 16);
      hopper::Wgmma<BN>::rs_tf32(part, ah[k8], dl, k8 > 0);
      if (SPLIT_X) hopper::Wgmma<BN>::rs_tf32(part, al[k8], dh, 1);
      hopper::Wgmma<BN>::rs_tf32(part, ah[k8], dh, 1);
    }
    hopper::wgmma_commit();

    // while the products run: the next tile's W into the other buffer and
    // its x fragment into registers
    if (it + 1 < nk) {
      hopper::mbar_wait(&full[(it + 1) % STAGES], ((it + 1) / STAGES) & 1);
      rebuild(it + 1);
      load_x(it + 1);
    }
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[s]);   // stage it is done
    hopper::wgmma_wait<0>();
    hopper::fence_regs(part);
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] += part[i];
    hopper::fence_proxy_async();
    hopper::named_sync(1, NC);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int m = m0 + ra + 8 * r;
    if (m >= M) continue;
    float* out = y + (long long)m * N;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int n = n0 + 8 * j + 2 * t;
      const float a = acc[4 * j + 2 * r], b = acc[4 * j + 2 * r + 1];
      if (N % 2 == 0 && n < N) {
        *reinterpret_cast<float2*>(out + n) = make_float2(a, b);
      } else {
        if (n < N) out[n] = a;
        if (n + 1 < N) out[n + 1] = b;
      }
    }
  }
}

template <typename TX>
cudaError_t launch(const void* x, const uint8_t* codes, const float* lut,
                   float* y, int M, int N, int K, cudaStream_t s) {
  CUtensorMap xmap;
  const uint64_t dims[2] = {(uint64_t)K, (uint64_t)M};
  const uint64_t strides[1] = {(uint64_t)K * sizeof(TX)};
  const uint32_t box[2] = {BK, BM};
  const bool f32 = sizeof(TX) == 4;
  if (!hopper_host::make_map(
          &xmap, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                     : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
          2, x, dims, strides, box,
          f32 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE))
    return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      lut_matmul_kernel<TX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM);
  if (e != cudaSuccess) return e;
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  lut_matmul_kernel<TX><<<grid, NT, SMEM, s>>>(xmap, codes, lut, y, M, N, K);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x dtype: 0 float32, 1 bfloat16.  All operands contiguous, K % 64 == 0,
// x 16-byte aligned.  Returns a cudaError_t (0 on success).
int lut_matmul_fwd(const void* x, const uint8_t* codes, const float* lut,
                   float* y, int dtype, int M, int N, int K, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % GROUP != 0 ||
      (uintptr_t)x % 16 != 0 || (uintptr_t)lut % 16 != 0)
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float>(x, codes, lut, y, M, N, K, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(x, codes, lut, y, M, N, K, s);
  return (int)cudaErrorInvalidValue;
}

const char* lm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
