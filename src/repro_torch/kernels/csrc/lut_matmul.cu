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
// What bounds it on this card: the products are float32, as in the TPU
// kernel (it multiplies in f32, and the reference tests hold f32 inputs to
// 1e-5, which TF32 on the tensor cores would miss), so they run on the CUDA
// cores: 2*M*K*N flops at 67 TFLOP/s, far above the bytes it moves (at
// M=1024, K=4096, N=16384: 137 GFLOP, 2.05 ms, against 218 MB, 0.065 ms).
// The design is the classic register-blocked SGEMM: 256 threads, each owning
// an 8 x 8 sub-tile of a 128 x 128 block, two blocks an SM, K tiles of 16
// double-buffered in shared memory with the next tile's x, codes (and, at a
// group boundary, codebooks) loaded into registers while the current tile is
// multiplied.
// The group's codebooks sit in shared memory level-major (16 x BN), so the
// lookups of a warp (32 neighbouring columns) hit 32 different banks.  No
// cp.async/TMA yet; the measured times are in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int GROUP = 64;   // K rows per codebook
constexpr int LEVELS = 16;  // entries per codebook
constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 16;
constexpr int NT = 256;     // a 16 x 16 grid of threads, 8 x 8 outputs each

// 8 consecutive x values of one row, as float
__device__ __forceinline__ void load_x8(const float* p, float (&v)[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p + 4));
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load_x8(const __nv_bfloat16* p,
                                        float (&v)[8]) {
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// at most 128 registers a thread, so that two blocks share an SM and one's
// loads and barriers overlap the other's products
template <typename TX>
__global__ void __launch_bounds__(NT, 2)
lut_matmul_kernel(const TX* __restrict__ x, const uint8_t* __restrict__ codes,
                  const float* __restrict__ lut, float* __restrict__ y,
                  int M, int N, int K) {
  __shared__ __align__(16) float As[2][BK][BM];   // x tile, k-major
  __shared__ __align__(16) float Ws[2][BK][BN];   // dequantized weight tile
  __shared__ float Ls[LEVELS][BN];                // the group's codebooks

  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int ty = tid / 16, tx = tid % 16;

  // x: row ar of the tile, k columns ak..ak+7
  const int ar = tid >> 1, ak = (tid & 1) * 8;
  const bool ar_ok = m0 + ar < M;
  const TX* xrow = x + (long long)(ar_ok ? m0 + ar : 0) * K + ak;
  // codes: column wn, rows wk0 + 2e for e < 8
  const int wn = tid % BN, wk0 = tid / BN;
  const bool wn_ok = n0 + wn < N;
  const uint8_t* ccol = codes + (wn_ok ? n0 + wn : 0);

  float xa[8];
  uint8_t cd[8];
  float4 lv[2];

  auto fetch = [&](int kt) {
    if (ar_ok) {
      load_x8(xrow + (long long)kt * BK, xa);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) xa[i] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < 8; ++e)
      cd[e] = wn_ok ? __ldg(ccol + (long long)(kt * BK + wk0 + 2 * e) * N) : 0;
  };
  auto fetch_lut = [&](int g) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int i4 = tid + e * NT;          // float4 index in the 128 x 16 slab
      const int n = i4 >> 2;
      lv[e] = n0 + n < N
                  ? __ldg(reinterpret_cast<const float4*>(
                        lut + ((long long)g * N + n0 + n) * LEVELS +
                        (i4 & 3) * 4))
                  : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  auto store_lut = [&]() {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int i4 = tid + e * NT;
      const int n = i4 >> 2, l0 = (i4 & 3) * 4;
      Ls[l0][n] = lv[e].x;
      Ls[l0 + 1][n] = lv[e].y;
      Ls[l0 + 2][n] = lv[e].z;
      Ls[l0 + 3][n] = lv[e].w;
    }
  };
  auto store_tile = [&](int buf) {
#pragma unroll
    for (int i = 0; i < 8; ++i) As[buf][ak + i][ar] = xa[i];
#pragma unroll
    for (int e = 0; e < 8; ++e) Ws[buf][wk0 + 2 * e][wn] = Ls[cd[e]][wn];
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int nkt = K / BK;
  fetch_lut(0);
  store_lut();
  fetch(0);
  __syncthreads();
  store_tile(0);
  __syncthreads();

  for (int kt = 0; kt < nkt; ++kt) {
    const int cur = kt & 1;
    const bool more = kt + 1 < nkt;
    const bool new_group = more && ((kt + 1) * BK) % GROUP == 0;
    if (more) {
      fetch(kt + 1);
      if (new_group) fetch_lut((kt + 1) * BK / GROUP);
    }
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[cur][k][ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&As[cur][k][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Ws[cur][k][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&Ws[cur][k][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (more) {
      if (new_group) {  // the previous tile's lookups ended at the last sync
        store_lut();
        __syncthreads();
      }
      store_tile(cur ^ 1);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (m >= M) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + h * 64 + tx * 4;
      float* out = y + (long long)m * N + n;
      if (N % 4 == 0 && n < N) {
        *reinterpret_cast<float4*>(out) =
            make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                        acc[i][4 * h + 3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (n + j < N) out[j] = acc[i][4 * h + j];
      }
    }
  }
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
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    lut_matmul_kernel<float><<<grid, NT, 0, s>>>(
        static_cast<const float*>(x), codes, lut, y, M, N, K);
  else if (dtype == 1)
    lut_matmul_kernel<__nv_bfloat16><<<grid, NT, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), codes, lut, y, M, N, K);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

const char* lm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
