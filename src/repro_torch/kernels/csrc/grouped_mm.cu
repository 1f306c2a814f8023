// Grouped matrix product over the kept prefixes of sorted segments, for
// NVIDIA Hopper (sm_90a), CUDA C++ with a plain C interface (loaded through
// ctypes by kernels/grouped_mm.py).
//
// Replaces no TPU kernel.  The reference runs the experts' FFN of its MoE
// layer as three einsums over an (E, C, d) buffer
// (src/repro/models/moe.py:74-77), which XLA compiles outside any Pallas
// kernel.  The port runs the same products on the token-expert assignments
// where the layer's stable sort puts them: rows sorted by expert, the kept
// rows of expert g the prefix [start_g, start_g + kept_g) of g's segment.
// No (E, C, d) buffer is filled, nothing is gathered back, and the work is
// that of the kept rows, not of every padded slot.
//
//   grouped_mm        Y[r] = X[r] @ W[g] for r in g's kept prefix (W (G, K,
//                     N); with trans_w W is (G, N, K) and W[g]^T is used,
//                     which gives dX = dY @ W[g]^T from the same entry
//                     point), and Y[r] = 0 for every other row;
//   grouped_mm_wgrad  dW[g] = A[rows of g]^T @ B[rows of g] over g's kept
//                     rows, zero where g keeps none.
//
// Segments are in ascending order of start and disjoint (start_g + kept_g
// <= start_{g+1}), as a sort lays them out; each is clamped into [0, R).
// Their lengths live on the device: no host read, so the MoE layer adds no
// synchronization.  The forward's grid is a static upper bound on its row
// tiles, min(ceil(R / BM) + G, G * ceil(cap / BM)), by the column tiles;
// each block computes the tile prefix of the G segments in shared memory and
// finds its segment by a binary search over it (and walks further tiles
// grid-stride if the bound was short).  Every block also writes the zeros
// of the rows no segment keeps in the raw row tiles blockIdx.y, blockIdx.y
// + gridDim.y, ... of its columns.  The weight gradient has one block per
// (expert, M tile, N tile), which walks its expert's kept rows itself.
// Neither uses atomics or splits a sum over blocks, so two calls are equal
// bit for bit.
//
// What bounds it on this card: at the MoE layers' shapes (qwen2-moe's
// served prefill 17,600 rows, K x N = 2048 x 1408 and 1408 x 2048; its
// training step 32,768 rows) the products, 2 R K N flops, far above the
// bytes of the operands; in a decode step (16 rows) the bytes of the
// experts' weights it reads.  bf16 runs on the tensor cores (mma.sync
// m16n8k16, f32 accumulators); float32 on the CUDA cores in full f32 (FMA),
// since the layer's float32 build is held at float32 accuracy.  A block
// owns a 128 x 128 output tile: bf16 4 warps of 64 x 64 over 64-deep k
// stages, f32 256 threads of 8 x 8 elements over 16-deep ones.  Operand
// tiles come through a three-stage cp.async ring of 16-byte copies,
// zero-filled past the edges, so widths need only be multiples of 16 bytes
// (qwen2-moe's TP shard of 88 columns works); bf16 fragments are read with
// ldmatrix, transposed where an operand is stored the other way round (W
// (G, K, N) and the weight gradient's A).  Other rings (2-5 stages, 32- or
// 64-deep), 8 warps of 64 x 32 and 128 x 256 blocks ran within 10% of this
// or slower on the H100: a 128 x 128 tile of mma.sync reaches about a
// quarter of the bf16 peak here, and wgmma with TMA-fed larger tiles is
// later work.  The measured times are in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;      // output rows (M) of a block's tile
constexpr int BK_BYTES = 128;  // the bf16 ring's k depth, bytes a row
constexpr int STAGES = 3;    // the ring's stages
constexpr int WN = 2;        // the bf16 block's warps along N
constexpr int WTN = 64;      // and a warp's columns
constexpr int MAX_G = 256;   // segments a call
static_assert(BK_BYTES % 32 == 0, "bf16 steps of k16, 16-byte pieces");

// A block's shape by type.  BK: the k depth of a stage (float32 keeps 64
// bytes a row); KS: a [rows][BK] (K-contiguous) tile's
// row, elements, padded by 16 bytes, and an M/N-contiguous [BK][cols]
// tile's row cols + 8, so that ldmatrix (bf16) and the f32 column loads
// meet no bank conflict.  bf16: 2 x WN warps of 64 x WTN each; f32: 256
// threads of 8 x 8 outputs each.
template <typename T> struct Cfg;
template <> struct Cfg<__nv_bfloat16> {
  static constexpr int BK = BK_BYTES / 2;
  static constexpr int KS = BK + 8;
  static constexpr int BN = WN * WTN;
  static constexpr int NT = 64 * WN;
  static constexpr int ACC = 2 * WTN;   // a warp's 64 x WTN over 32 lanes
};
template <> struct Cfg<float> {
  static constexpr int BK = 16;
  static constexpr int KS = BK + 4;
  static constexpr int BN = 128;
  static constexpr int NT = 256;
  static constexpr int ACC = 64;
};

// bytes of one operand tile of `ext` rows or columns, either layout
template <typename T, int EXT>
struct TileBytes {
  static constexpr int K_MAJOR = EXT * Cfg<T>::KS * (int)sizeof(T);
  static constexpr int MN_MAJOR = Cfg<T>::BK * (EXT + 8) * (int)sizeof(T);
  static constexpr int VALUE = K_MAJOR > MN_MAJOR ? K_MAJOR : MN_MAJOR;
};
template <typename T>
struct Smem {
  static constexpr int A = TileBytes<T, BM>::VALUE;
  static constexpr int STAGE = A + TileBytes<T, Cfg<T>::BN>::VALUE;
  static constexpr int TOTAL = STAGES * STAGE;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  // src-size 0 reads nothing and fills the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// An operand in device memory: element (o, i) at base[o * ld + i], present
// where o < o_lim and i < i_lim (i the contiguous index; i_lim a multiple
// of 16 bytes, so a 16-byte piece is wholly in or wholly out).
template <typename T>
struct View {
  const T* base;
  long long ld;
  int o_lim;
  int i_lim;
};

// ROWS x COLS elements (o0 + o, i0 + i) of v into s[o * ss + i]
template <typename T, int ROWS, int COLS>
__device__ __forceinline__ void load_tile(T* s, int ss, const View<T>& v,
                                          int o0, int i0) {
  constexpr int NT = Cfg<T>::NT;
  constexpr int VEC = 16 / sizeof(T);
  constexpr int PER_ROW = COLS / VEC;
  constexpr int PIECES = ROWS * PER_ROW;
  static_assert(PIECES % NT == 0, "pieces must divide among the threads");
#pragma unroll
  for (int j = 0; j < PIECES / NT; ++j) {
    const int p = threadIdx.x + j * NT;
    const int o = p / PER_ROW, i = (p % PER_ROW) * VEC;
    const bool ok = o0 + o < v.o_lim && i0 + i < v.i_lim;
    const T* src = ok ? v.base + (long long)(o0 + o) * v.ld + (i0 + i)
                      : v.base;
    cp_async16(s + o * ss + i, src, ok);
  }
}

// k tile kt of an operand of EXT rows (A) or columns (B): K-contiguous
// (KMAJ: [EXT from `fixed`][BK from kt * BK]) or M/N-contiguous ([BK from
// kt * BK][EXT from `fixed`])
template <typename T, bool KMAJ, int EXT>
__device__ __forceinline__ void load_operand(T* s, const View<T>& v,
                                             int fixed, int kt) {
  constexpr int BK = Cfg<T>::BK;
  if constexpr (KMAJ)
    load_tile<T, EXT, BK>(s, Cfg<T>::KS, v, fixed, kt * BK);
  else
    load_tile<T, BK, EXT>(s, EXT + 8, v, kt * BK, fixed);
}

// one stage's products, bf16 on the tensor cores: warp (wm, wn) owns rows
// wm..wm+63 and columns wn..wn+WTN-1, acc[(mt * NTL + nt) * 4 + q] in
// mma.sync's accumulator layout (NTL = WTN / 8 tiles of 8 columns)
template <bool AK, bool BKM>
__device__ __forceinline__ void compute(
    float (&acc)[Cfg<__nv_bfloat16>::ACC], const __nv_bfloat16* As,
    const __nv_bfloat16* Bs) {
  using C = Cfg<__nv_bfloat16>;
  constexpr int KS = C::KS, AMN = BM + 8, BMN = C::BN + 8;
  constexpr int NTL = WTN / 8;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = (warp / WN) * 64, wn = (warp % WN) * WTN;
  const int j = lane >> 3, r = lane & 7;
#pragma unroll
  for (int kk = 0; kk < C::BK; kk += 16) {
    uint32_t a[4][4], b[NTL][2];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      const int m0 = wm + mt * 16;
      if constexpr (AK)
        // a0..a3: rows m0 + (lane & 15), k kk and kk + 8
        ldsm_x4(a[mt], As + (m0 + (lane & 15)) * KS + kk + (lane >> 4) * 8);
      else
        // stored [k][m]: rows k, transposed into the row-major fragment
        ldsm_x4_t(a[mt], As + (kk + r + (j >> 1) * 8) * AMN + m0 + (j & 1) * 8);
    }
#pragma unroll
    for (int p = 0; p < NTL / 2; ++p) {
      const int n0 = wn + p * 16;
      uint32_t q[4];
      if constexpr (BKM)
        // stored [n][k]: b0, b1 of columns n0..n0+7, then of n0+8..n0+15
        ldsm_x4(q, Bs + (n0 + r + (j >> 1) * 8) * KS + kk + (j & 1) * 8);
      else
        // stored [k][n]
        ldsm_x4_t(q, Bs + (kk + r + (j & 1) * 8) * BMN + n0 + (j >> 1) * 8);
      b[2 * p][0] = q[0];
      b[2 * p][1] = q[1];
      b[2 * p + 1][0] = q[2];
      b[2 * p + 1][1] = q[3];
    }
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < NTL; ++nt)
        mma_bf16(acc + (mt * NTL + nt) * 4, a[mt], b[nt][0], b[nt][1]);
  }
}

// float32 on the CUDA cores: thread (tx, ty) owns rows ty + 16 i and
// columns tx + 16 j, acc[i * 8 + j]
template <bool AK, bool BKM>
__device__ __forceinline__ void compute(float (&acc)[Cfg<float>::ACC],
                                        const float* As, const float* Bs) {
  using C = Cfg<float>;
  constexpr int KS = C::KS, AMN = BM + 8, BMN = C::BN + 8;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int k = 0; k < C::BK; ++k) {
    float a[8], b[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int m = ty + 16 * i;
      a[i] = AK ? As[m * KS + k] : As[k * AMN + m];
    }
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int n = tx + 16 * jj;
      b[jj] = BKM ? Bs[n * KS + k] : Bs[k * BMN + n];
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
        acc[i * 8 + jj] = fmaf(a[i], b[jj], acc[i * 8 + jj]);
  }
}

// acc += A (BM x nk*BK) B (nk*BK x BN) through the cp.async ring; A's and
// B's `fixed` offsets as load_operand's
template <typename T, bool AK, bool BKM>
__device__ __forceinline__ void mainloop(float (&acc)[Cfg<T>::ACC],
                                         unsigned char* smem,
                                         const View<T>& va, int fa,
                                         const View<T>& vb, int fb, int nk) {
  constexpr int BN = Cfg<T>::BN, STAGE = Smem<T>::STAGE, A = Smem<T>::A;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) {
      load_operand<T, AK, BM>(reinterpret_cast<T*>(smem + s * STAGE), va, fa,
                              s);
      load_operand<T, BKM, BN>(reinterpret_cast<T*>(smem + s * STAGE + A),
                               vb, fb, s);
    }
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    // the stage refilled here was read in the previous iteration, which
    // every thread has left at the barrier above
    const int nxt = kt + STAGES - 1;
    if (nxt < nk) {
      unsigned char* st = smem + (nxt % STAGES) * STAGE;
      load_operand<T, AK, BM>(reinterpret_cast<T*>(st), va, fa, nxt);
      load_operand<T, BKM, BN>(reinterpret_cast<T*>(st + A), vb, fb, nxt);
    }
    cp_async_commit();
    const unsigned char* st = smem + (kt % STAGES) * STAGE;
    compute<AK, BKM>(acc, reinterpret_cast<const T*>(st),
                     reinterpret_cast<const T*>(st + A));
  }
  cp_async_wait<0>();
}

// the tile's output elements (m, n) with m < m_lim, n < n_lim at
// out[m * ld + n]
__device__ __forceinline__ void epilogue(
    const float (&acc)[Cfg<__nv_bfloat16>::ACC], __nv_bfloat16* out,
    long long ld, int m_lim, int n_lim) {
  constexpr int NTL = WTN / 8;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = (warp / WN) * 64, wn = (warp % WN) * WTN;
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < NTL; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = wm + mt * 16 + g + h * 8;
        const int n = wn + nt * 8 + 2 * t4;   // n_lim % 8 == 0: n + 1 too
        if (m < m_lim && n < n_lim) {
          const float* c = acc + (mt * NTL + nt) * 4 + 2 * h;
          *reinterpret_cast<__nv_bfloat162*>(out + m * ld + n) =
              __floats2bfloat162_rn(c[0], c[1]);
        }
      }
}

__device__ __forceinline__ void epilogue(const float (&acc)[Cfg<float>::ACC],
                                         float* out, long long ld, int m_lim,
                                         int n_lim) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = ty + 16 * i;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int n = tx + 16 * jj;
      if (m < m_lim && n < n_lim) out[m * ld + n] = acc[i * 8 + jj];
    }
  }
}

// [start, start + kept) of segment g, clamped into [0, R)
__device__ __forceinline__ void segment(const long long* start,
                                        const long long* kept, int g, int R,
                                        int& s, int& e) {
  long long a = start[g], n = kept[g];
  a = a < 0 ? 0 : (a > R ? R : a);
  n = n < 0 ? 0 : (n > R - a ? R - a : n);
  s = (int)a;
  e = (int)(a + n);
}

template <typename T, bool TRANS_W>
__global__ void __launch_bounds__(Cfg<T>::NT) grouped_mm_kernel(
    const T* __restrict__ x, const T* __restrict__ w,
    const long long* __restrict__ start, const long long* __restrict__ kept,
    T* __restrict__ y, int R, int K, int N, int G) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int s_start[MAX_G], s_end[MAX_G], s_tile[MAX_G + 1];
  __shared__ unsigned char s_cov[BM];
  constexpr int NT = Cfg<T>::NT, BN = Cfg<T>::BN, BK = Cfg<T>::BK;
  constexpr int VEC = 16 / sizeof(T);
  static_assert(NT >= BM, "a thread per row of the zero pass");

  for (int g = threadIdx.x; g < G; g += NT)
    segment(start, kept, g, R, s_start[g], s_end[g]);
  __syncthreads();
  if (threadIdx.x < 32) {
    // s_tile: exclusive prefix of each segment's row tiles, s_tile[G] the
    // total; warp 0, lane l owns a run of `per` segments
    const int lane = threadIdx.x, per = (G + 31) / 32, g0 = lane * per;
    int sum = 0;
    for (int i = 0; i < per && g0 + i < G; ++i)
      sum += (s_end[g0 + i] - s_start[g0 + i] + BM - 1) / BM;
    int inc = sum;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, inc, d);
      if (lane >= d) inc += v;
    }
    int run = inc - sum;
    for (int i = 0; i < per && g0 + i < G; ++i) {
      s_tile[g0 + i] = run;
      run += (s_end[g0 + i] - s_start[g0 + i] + BM - 1) / BM;
    }
    if (lane == 31) s_tile[G] = inc;
  }
  __syncthreads();
  const int n0 = blockIdx.x * BN;

  // zeros: the rows of raw row tile rt that no segment keeps
  for (int rt = blockIdx.y; (long long)rt * BM < R; rt += gridDim.y) {
    if (threadIdx.x < BM) {
      const int r = rt * BM + threadIdx.x;
      bool cov = false;
      if (r < R) {
        // the last segment starting at or before r
        int lo = 0, hi = G;
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (s_start[mid] <= r) lo = mid + 1;
          else hi = mid;
        }
        cov = lo > 0 && r < s_end[lo - 1];
      }
      s_cov[threadIdx.x] = cov;
    }
    __syncthreads();
    constexpr int PER_ROW = BN / VEC;
    for (int p = threadIdx.x; p < BM * PER_ROW; p += NT) {
      const int row = p / PER_ROW, n = n0 + (p % PER_ROW) * VEC;
      const int r = rt * BM + row;
      if (r < R && n < N && !s_cov[row])
        *reinterpret_cast<uint4*>(y + (long long)r * N + n) =
            make_uint4(0, 0, 0, 0);
    }
    __syncthreads();
  }

  // products: tile t of the kept prefixes
  const int total = s_tile[G];
  for (int t = blockIdx.y; t < total; t += gridDim.y) {
    // the last segment whose first tile is at or before t (an empty one
    // shares its successor's prefix, so it is never the last)
    int lo = 0, hi = G;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (s_tile[mid] <= t) lo = mid + 1;
      else hi = mid;
    }
    const int g = lo - 1;
    const int row0 = s_start[g] + (t - s_tile[g]) * BM;
    const int m_lim = min(BM, s_end[g] - row0);
    const View<T> va{x + (long long)row0 * K, K, m_lim, K};
    // W[g] as (N, K), K contiguous, or as (K, N), N contiguous
    const View<T> vb = TRANS_W ? View<T>{w + (long long)g * N * K, K, N, K}
                               : View<T>{w + (long long)g * K * N, N, K, N};
    float acc[Cfg<T>::ACC];
#pragma unroll
    for (int i = 0; i < Cfg<T>::ACC; ++i) acc[i] = 0.f;
    mainloop<T, true, TRANS_W>(acc, smem, va, 0, vb, n0, (K + BK - 1) / BK);
    epilogue(acc, y + (long long)row0 * N + n0, N, m_lim, N - n0);
    __syncthreads();
  }
}

template <typename T>
__global__ void __launch_bounds__(Cfg<T>::NT) grouped_mm_wgrad_kernel(
    const T* __restrict__ a, const T* __restrict__ b,
    const long long* __restrict__ start, const long long* __restrict__ kept,
    T* __restrict__ dw, int R, int M, int N) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int BN = Cfg<T>::BN, BK = Cfg<T>::BK;
  const int g = blockIdx.y;
  const int n_tiles = (N + BN - 1) / BN;
  const int m0 = (blockIdx.x / n_tiles) * BM, n0 = (blockIdx.x % n_tiles) * BN;
  int s, e;
  segment(start, kept, g, R, s, e);
  const int rows = e - s;
  // A^T: A's kept rows as [row][m], m contiguous; B's as [row][n]
  const View<T> va{a + (long long)s * M, M, rows, M};
  const View<T> vb{b + (long long)s * N, N, rows, N};
  float acc[Cfg<T>::ACC];
#pragma unroll
  for (int i = 0; i < Cfg<T>::ACC; ++i) acc[i] = 0.f;
  mainloop<T, false, false>(acc, smem, va, m0, vb, n0, (rows + BK - 1) / BK);
  epilogue(acc, dw + ((long long)g * M + m0) * N + n0, N, M - m0, N - n0);
}

bool aligned(const void* p) { return (uintptr_t)p % 16 == 0; }

template <typename T>
cudaError_t launch_fwd(const void* x, const void* w, const long long* start,
                       const long long* kept, void* y, int R, int K, int N,
                       int G, int cap, bool trans_w, cudaStream_t st) {
  auto kern = trans_w ? grouped_mm_kernel<T, true> : grouped_mm_kernel<T, false>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Smem<T>::TOTAL);
  if (e != cudaSuccess) return e;
  if (cap <= 0 || cap > R) cap = R;
  const long long bound = (R + BM - 1) / BM + (long long)G;
  const long long by_cap = (long long)G * ((cap + BM - 1) / BM);
  long long rows = bound < by_cap ? bound : by_cap;
  rows = rows < 1 ? 1 : (rows > 65535 ? 65535 : rows);
  const dim3 grid((N + Cfg<T>::BN - 1) / Cfg<T>::BN, (unsigned)rows);
  kern<<<grid, Cfg<T>::NT, Smem<T>::TOTAL, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), start, kept,
      static_cast<T*>(y), R, K, N, G);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_wgrad(const void* a, const void* b, const long long* start,
                         const long long* kept, void* dw, int R, int M, int N,
                         int G, cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(
      grouped_mm_wgrad_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, Smem<T>::TOTAL);
  if (e != cudaSuccess) return e;
  const dim3 grid(((M + BM - 1) / BM) * ((N + Cfg<T>::BN - 1) / Cfg<T>::BN),
                  G);
  grouped_mm_wgrad_kernel<T><<<grid, Cfg<T>::NT, Smem<T>::TOTAL, st>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), start, kept,
      static_cast<T*>(dw), R, M, N);
  return cudaGetLastError();
}

// widths a multiple of 16 bytes: 8 bf16 or 4 float32
bool widths_ok(int dtype, int a, int b) {
  const int vec = dtype == 1 ? 8 : 4;
  return a > 0 && b > 0 && a % vec == 0 && b % vec == 0;
}

}  // namespace

extern "C" {

// Y (R, N) = the kept rows of X (R, K) by W[g] (G, K, N), or by W[g]^T with
// W (G, N, K) when trans_w; zero elsewhere.  start, kept: (G,) int64 on the
// device; cap: an upper bound on every kept (<= 0: R), which only sizes the
// grid.  dtype 0 float32, 1 bfloat16 (X, W, Y alike).  Operands contiguous
// and 16-byte aligned, K and N multiples of 16 bytes, 1 <= G <= 256.
// Returns a cudaError_t (0 on success).
int grouped_mm(const void* x, const void* w, const long long* start,
               const long long* kept, void* y, int dtype, int R, int K,
               int N, int G, int cap, int trans_w, void* stream) {
  if (R < 0 || G < 1 || G > MAX_G || (dtype != 0 && dtype != 1) ||
      !widths_ok(dtype, K, N) || !aligned(x) || !aligned(w) || !aligned(y))
    return (int)cudaErrorInvalidValue;
  if (R == 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_fwd<float>(x, w, start, kept, y, R, K, N, G, cap,
                                  trans_w != 0, st);
  return (int)launch_fwd<__nv_bfloat16>(x, w, start, kept, y, R, K, N, G, cap,
                                        trans_w != 0, st);
}

// dW (G, M, N): dW[g] = A[kept rows of g]^T @ B[kept rows of g], A (R, M),
// B (R, N); zero for a segment that keeps no row.  Same types and rules as
// grouped_mm.
int grouped_mm_wgrad(const void* a, const void* b, const long long* start,
                     const long long* kept, void* dw, int dtype, int R,
                     int M, int N, int G, void* stream) {
  if (R < 0 || G < 1 || G > MAX_G || (dtype != 0 && dtype != 1) ||
      !widths_ok(dtype, M, N) || !aligned(a) || !aligned(b) || !aligned(dw))
    return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_wgrad<float>(a, b, start, kept, dw, R, M, N, G, st);
  return (int)launch_wgrad<__nv_bfloat16>(a, b, start, kept, dw, R, M, N, G,
                                          st);
}

const char* gmm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
