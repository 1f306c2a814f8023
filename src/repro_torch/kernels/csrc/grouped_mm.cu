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
// synchronization.  No kernel uses atomics or splits a sum over blocks, so
// two calls are equal bit for bit.
//
// What bounds it on this card: at the MoE layers' shapes (qwen2-moe's
// served prefill 17,600 rows, K x N = 2048 x 1408 and 1408 x 2048; its
// training step 32,768 rows) the products, 2 R K N flops, against the
// bytes of the operands (at 17,600 rows the 346 MB of the 60 experts'
// weights and the rows put the byte bound just above the flop bound); in a
// decode step (16 rows) the bytes of the weights of the experts that keep
// a row.
//
// bfloat16: wgmma on TMA-fed tiles, warp-specialised, persistent.
//   * A block is three warpgroups: two consumers, each owning 64 rows of a
//     128 x BN output tile and running wgmma m64nBNk16 with f32
//     accumulators in registers, and a producer, whose first thread issues
//     the TMA loads into a ring of 64-deep k stages (128-byte swizzled, so
//     they are wgmma operands as they land) under full/empty mbarriers.
//     setmaxnreg moves registers from the producer (40) to the consumers
//     (232).  The ring runs on across tiles: the next tile's first stages
//     load under this tile's last products and its epilogue.
//   * The epilogue writes each warpgroup's 64 x BN into a staging area of
//     shared memory (128-byte swizzled boxes of 64 x 64, so a warp's store
//     meets no bank conflict) and one thread stores the boxes by TMA; the
//     stores read the staging area while the next tile's products run.
//     Without it the weight gradient, whose tiles are short (qwen2-moe's
//     ~546 rows an expert in training: 9 k stages), spent a third of its
//     time storing dW from registers (0.58 against 0.39 ms on the H100).
//   * The grid is one block an SM, static (a CUDA graph captures it).  Each
//     block computes the tile prefix of the G segments from the (G,)
//     lengths in shared memory and walks tiles t = blockIdx.x, + gridDim.x,
//     ...; tile t's segment is found by a binary search over the prefix.
//     The forward's tiles are ordered expert-major (every column tile and
//     row tile of expert g, then g + 1; within g the row tiles of one
//     column tile in a row), so the blocks at work at one moment share a
//     few experts' weights (5.8 MB each at qwen2-moe's widths) in the 50 MB
//     L2, and a decode step reads each used expert's weight once.  The
//     weight gradient's tiles are (expert, M tile, N tile), expert-major;
//     an expert that keeps no row is a tile with no k stage, whose
//     epilogue writes its zeros.
//   * The forward's zeros of the rows no segment keeps are written by the
//     producer warpgroup's other three warps, 32 rows a warp at a time,
//     while the consumers multiply (those rows are disjoint from every
//     tile's stored rows).
//   * Operand layouts through wgmma's transpose bits, not copies: X is a
//     K-major A; W (G, K, N) an MN-major B (boxes of 64 columns x 64 k
//     rows, BN / 64 of them a stage); W (G, N, K) (the dX form) a K-major
//     B (one box of 64 k x BN rows); the weight gradient's A^T and B are
//     both MN-major (A's and B's rows are the sum's k).
//   * Tensor maps are made on the host per call and passed as
//     __grid_constant__: 2-D over X, A and B with the row coordinate at
//     the segment's row (any row: TMA takes it), 3-D over W (N, K, G) or
//     (K, N, G), so the zero fill past K or N (qwen2-moe's TP shard: N =
//     88 forward, K = 88 in its down product) stays inside one expert.
//     The contract (16-byte aligned bases, widths multiples of 16 bytes)
//     is exactly what TMA needs.
//   * BN is 256 wherever N > 128 (WIDE below), 128 for narrower outputs
//     (the TP shard's 88); the ring 3 stages of 48 KB or 5 of 32 KB, what
//     shared memory holds beside the staging area.  At qwen2-moe's N =
//     1408 the 256-wide tile (6 column tiles, the last half empty) ran
//     faster than 11 of 128 in training (0.370 against 0.397 ms) and in a
//     decode step (0.036 against 0.044: half the tiles on 132 SMs), slower
//     in the served prefill (0.255 against 0.241); other rings ran slower.
//     A 240-wide tile at N = 1408 (1440 columns, its last 48 stored
//     without TMA) moved the trained forward and dW by less than the
//     spread between runs, -5% and +4%, and was taken out
//     (benchmarks/grouped_mm_sweep.py, PERF.md).
// Where it could go wrong, and what the code does about it:
//   * rows past a segment's kept end inside a loaded box belong to the
//     next expert or are dropped rows (NaN there must not leak).  In the
//     forward they only feed output rows that are never stored: a
//     warpgroup whose 64 rows are not all the segment's stores rows <
//     m_lim from registers with masked st.global (a TMA store of its box
//     would overwrite a neighbouring segment's rows that another block
//     writes).  In the weight gradient they would be
//     summed: the last k stage of each tile has its rows >= the segment's
//     end zeroed in shared memory in both operands (a NaN times zero is
//     NaN), then fence.proxy.async and a barrier of the consumers before
//     the wgmma reads it;
//   * short segments (a decode step: 1-2 rows an expert) cost a 128-row
//     tile of tensor work each, but the step is bound by the weights'
//     bytes, which the expert-major walk reads once.  64-row tiles (both
//     warpgroups on the same rows, each on half the columns, chosen at
//     launch where the capacity is 64 or less) left qwen2-moe's decode
//     step where it was (0.0431 against 0.0408 ms) and were taken out;
//   * a wgmma under a runtime branch serializes every wgmma of a kernel
//     (ptxas's "wgmma serialized" note, C7518, checked in the build log):
//     the products are issued in straight-line code in the k loop, and the
//     zeroing and releases sit outside them.  So a tile's warpgroup whose
//     rows are all past the segment multiplies all the same: skipping its
//     products under a branch serialized the forward and cost up to 35%;
//   * G up to 256 (MAX_G): the tile prefix stays in shared memory;
//   * mbarrier waits trap after 2^22 polls: a fault is a launch error, not
//     a hung card.
//
// float32 stays on the CUDA cores in full f32 (FMA), since the layer's
// float32 build is held at float32 accuracy: a block owns a 128 x 128
// output tile, 256 threads of 8 x 8 elements over 16-deep k stages that
// come through a three-stage cp.async ring of 16-byte copies, zero-filled
// past the edges, one block per (row tile, column tile) or (expert, M
// tile, N tile).  The measured times are in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int MAX_G = 256;   // segments a call

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

// s_start, s_end of every segment and s_tile, the exclusive prefix of each
// segment's row tiles of `bm` rows (s_tile[G] the total), by all threads
// of the block
__device__ __forceinline__ void segment_tables(const long long* start,
                                               const long long* kept, int G,
                                               int R, int bm, int* s_start,
                                               int* s_end, int* s_tile) {
  for (int g = threadIdx.x; g < G; g += blockDim.x)
    segment(start, kept, g, R, s_start[g], s_end[g]);
  __syncthreads();
  if (threadIdx.x < 32) {
    // warp 0, lane l owns a run of `per` segments
    const int lane = threadIdx.x, per = (G + 31) / 32, g0 = lane * per;
    int sum = 0;
    for (int i = 0; i < per && g0 + i < G; ++i)
      sum += (s_end[g0 + i] - s_start[g0 + i] + bm - 1) / bm;
    int inc = sum;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, inc, d);
      if (lane >= d) inc += v;
    }
    int run = inc - sum;
    for (int i = 0; i < per && g0 + i < G; ++i) {
      s_tile[g0 + i] = run;
      run += (s_end[g0 + i] - s_start[g0 + i] + bm - 1) / bm;
    }
    if (lane == 31) s_tile[G] = inc;
  }
  __syncthreads();
}

// the last segment whose entry in `key_of` is at or before `key` (an empty
// segment shares its successor's start and tile prefix, so it is never the
// last)
__device__ __forceinline__ int last_at_or_before(const int* key_of, int G,
                                                 int key) {
  int lo = 0, hi = G;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (key_of[mid] <= key) lo = mid + 1;
    else hi = mid;
  }
  return lo - 1;
}

// ---- float32: CUDA cores, cp.async ring --------------------------------------

constexpr int BM = 128;      // output rows (M) of a block's tile
constexpr int STAGES = 3;    // the ring's stages
constexpr int F_BK = 16;     // k depth of a stage
constexpr int F_KS = F_BK + 4;   // a K-contiguous tile's row, padded
constexpr int F_BN = 128;
constexpr int F_NT = 256;    // threads: 8 x 8 outputs each
constexpr int F_ACC = 64;

// bytes of one operand tile of `ext` rows or columns, either layout
template <int EXT>
struct TileBytes {
  static constexpr int K_MAJOR = EXT * F_KS * 4;
  static constexpr int MN_MAJOR = F_BK * (EXT + 8) * 4;
  static constexpr int VALUE = K_MAJOR > MN_MAJOR ? K_MAJOR : MN_MAJOR;
};
constexpr int F_A = TileBytes<BM>::VALUE;
constexpr int F_STAGE = F_A + TileBytes<F_BN>::VALUE;
constexpr int F_SMEM = STAGES * F_STAGE;

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

// An operand in device memory: element (o, i) at base[o * ld + i], present
// where o < o_lim and i < i_lim (i the contiguous index; i_lim a multiple
// of 16 bytes, so a 16-byte piece is wholly in or wholly out).
struct View {
  const float* base;
  long long ld;
  int o_lim;
  int i_lim;
};

// ROWS x COLS elements (o0 + o, i0 + i) of v into s[o * ss + i]
template <int ROWS, int COLS>
__device__ __forceinline__ void load_tile(float* s, int ss, const View& v,
                                          int o0, int i0) {
  constexpr int VEC = 4;
  constexpr int PER_ROW = COLS / VEC;
  constexpr int PIECES = ROWS * PER_ROW;
  static_assert(PIECES % F_NT == 0, "pieces must divide among the threads");
#pragma unroll
  for (int j = 0; j < PIECES / F_NT; ++j) {
    const int p = threadIdx.x + j * F_NT;
    const int o = p / PER_ROW, i = (p % PER_ROW) * VEC;
    const bool ok = o0 + o < v.o_lim && i0 + i < v.i_lim;
    const float* src = ok ? v.base + (long long)(o0 + o) * v.ld + (i0 + i)
                          : v.base;
    cp_async16(s + o * ss + i, src, ok);
  }
}

// k tile kt of an operand of EXT rows (A) or columns (B): K-contiguous
// (KMAJ: [EXT from `fixed`][BK from kt * BK]) or M/N-contiguous ([BK from
// kt * BK][EXT from `fixed`])
template <bool KMAJ, int EXT>
__device__ __forceinline__ void load_operand(float* s, const View& v,
                                             int fixed, int kt) {
  if constexpr (KMAJ)
    load_tile<EXT, F_BK>(s, F_KS, v, fixed, kt * F_BK);
  else
    load_tile<F_BK, EXT>(s, EXT + 8, v, kt * F_BK, fixed);
}

// thread (tx, ty) owns rows ty + 16 i and columns tx + 16 j, acc[i * 8 + j]
template <bool AK, bool BKM>
__device__ __forceinline__ void compute(float (&acc)[F_ACC], const float* As,
                                        const float* Bs) {
  constexpr int AMN = BM + 8, BMN = F_BN + 8;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int k = 0; k < F_BK; ++k) {
    float a[8], b[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int m = ty + 16 * i;
      a[i] = AK ? As[m * F_KS + k] : As[k * AMN + m];
    }
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int n = tx + 16 * jj;
      b[jj] = BKM ? Bs[n * F_KS + k] : Bs[k * BMN + n];
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
template <bool AK, bool BKM>
__device__ __forceinline__ void mainloop(float (&acc)[F_ACC],
                                         unsigned char* smem, const View& va,
                                         int fa, const View& vb, int fb,
                                         int nk) {
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) {
      load_operand<AK, BM>(reinterpret_cast<float*>(smem + s * F_STAGE), va,
                           fa, s);
      load_operand<BKM, F_BN>(
          reinterpret_cast<float*>(smem + s * F_STAGE + F_A), vb, fb, s);
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
      unsigned char* st = smem + (nxt % STAGES) * F_STAGE;
      load_operand<AK, BM>(reinterpret_cast<float*>(st), va, fa, nxt);
      load_operand<BKM, F_BN>(reinterpret_cast<float*>(st + F_A), vb, fb,
                              nxt);
    }
    cp_async_commit();
    const unsigned char* st = smem + (kt % STAGES) * F_STAGE;
    compute<AK, BKM>(acc, reinterpret_cast<const float*>(st),
                     reinterpret_cast<const float*>(st + F_A));
  }
  cp_async_wait<0>();
}

// the tile's output elements (m, n) with m < m_lim, n < n_lim at
// out[m * ld + n]
__device__ __forceinline__ void epilogue(const float (&acc)[F_ACC],
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

template <bool TRANS_W>
__global__ void __launch_bounds__(F_NT) grouped_mm_f32_kernel(
    const float* __restrict__ x, const float* __restrict__ w,
    const long long* __restrict__ start, const long long* __restrict__ kept,
    float* __restrict__ y, int R, int K, int N, int G) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int s_start[MAX_G], s_end[MAX_G], s_tile[MAX_G + 1];
  __shared__ unsigned char s_cov[BM];
  constexpr int VEC = 4;
  static_assert(F_NT >= BM, "a thread per row of the zero pass");

  segment_tables(start, kept, G, R, BM, s_start, s_end, s_tile);
  const int n0 = blockIdx.x * F_BN;

  // zeros: the rows of raw row tile rt that no segment keeps
  for (int rt = blockIdx.y; (long long)rt * BM < R; rt += gridDim.y) {
    if (threadIdx.x < BM) {
      const int r = rt * BM + threadIdx.x;
      bool cov = false;
      if (r < R) {
        const int g = last_at_or_before(s_start, G, r);
        cov = g >= 0 && r < s_end[g];
      }
      s_cov[threadIdx.x] = cov;
    }
    __syncthreads();
    constexpr int PER_ROW = F_BN / VEC;
    for (int p = threadIdx.x; p < BM * PER_ROW; p += F_NT) {
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
    const int g = last_at_or_before(s_tile, G, t);
    const int row0 = s_start[g] + (t - s_tile[g]) * BM;
    const int m_lim = min(BM, s_end[g] - row0);
    const View va{x + (long long)row0 * K, K, m_lim, K};
    // W[g] as (N, K), K contiguous, or as (K, N), N contiguous
    const View vb = TRANS_W ? View{w + (long long)g * N * K, K, N, K}
                            : View{w + (long long)g * K * N, N, K, N};
    float acc[F_ACC];
#pragma unroll
    for (int i = 0; i < F_ACC; ++i) acc[i] = 0.f;
    mainloop<true, TRANS_W>(acc, smem, va, 0, vb, n0, (K + F_BK - 1) / F_BK);
    epilogue(acc, y + (long long)row0 * N + n0, N, m_lim, N - n0);
    __syncthreads();
  }
}

__global__ void __launch_bounds__(F_NT) grouped_mm_wgrad_f32_kernel(
    const float* __restrict__ a, const float* __restrict__ b,
    const long long* __restrict__ start, const long long* __restrict__ kept,
    float* __restrict__ dw, int R, int M, int N) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int g = blockIdx.y;
  const int n_tiles = (N + F_BN - 1) / F_BN;
  const int m0 = (blockIdx.x / n_tiles) * BM;
  const int n0 = (blockIdx.x % n_tiles) * F_BN;
  int s, e;
  segment(start, kept, g, R, s, e);
  const int rows = e - s;
  // A^T: A's kept rows as [row][m], m contiguous; B's as [row][n]
  const View va{a + (long long)s * M, M, rows, M};
  const View vb{b + (long long)s * N, N, rows, N};
  float acc[F_ACC];
#pragma unroll
  for (int i = 0; i < F_ACC; ++i) acc[i] = 0.f;
  mainloop<false, false>(acc, smem, va, m0, vb, n0, (rows + F_BK - 1) / F_BK);
  epilogue(acc, dw + ((long long)g * M + m0) * N + n0, N, M - m0, N - n0);
}

// ---- bfloat16: TMA ring + wgmma, warp-specialised, persistent -------------

using bf16 = __nv_bfloat16;

constexpr int TM = 128;          // a tile's rows: two consumer warpgroups
constexpr int TK = 64;           // a k stage: one 128-byte swizzled row
constexpr int NTHREADS = 384;    // warpgroups 0, 1 consume; 2 produces
constexpr int RING_N128 = 5;     // ring stages at BN = 128 (32 KB each)
constexpr int RING_N256 = 3;     // and at BN = 256 (48 KB each)
constexpr int WIDE = 2;          // BN = 256: 0 never, 1 where N % 256 == 0,
                                 // 2 where N > 128
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
constexpr uint32_t A_BYTES = TM * 128;   // an A stage: 128 rows x 64 k
constexpr uint32_t CHUNK = 64 * 128;     // a 64 x 64 box

// the ring's S stages, then each consumer warpgroup's staging area of 64
// output rows x BN for the epilogue's TMA stores, then the barriers
template <int BN>
struct Ring {
  static constexpr int S = BN == 256 ? RING_N256 : RING_N128;
  static constexpr uint32_t STAGE = A_BYTES + BN * 128;
  static constexpr uint32_t EPI = 64 * BN * 2;    // one warpgroup's
  static constexpr size_t SMEM =
      1024 + S * STAGE + 2 * EPI + 2 * S * sizeof(uint64_t);
};

bool wide(int N) {
  return WIDE == 2 ? N > 128 : WIDE == 1 ? N % 256 == 0 : false;
}

struct GmmMaps {
  CUtensorMap a, b, c;     // the two operands and the output
};

// hopper::mbar_wait, except that a wait far longer than any load takes
// (2^22 polls) traps: a launch error the wrapper reports, not a hang
__device__ __forceinline__ void wait_bar(uint64_t* bar, uint32_t parity) {
  for (int n = 0;; ++n) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(hopper::smem_u32(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (n == 1 << 22) __trap();
  }
}

// a consumer warp is done with the stage of `bar`
__device__ __forceinline__ void release(uint64_t* bar) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) hopper::mbar_arrive(bar);
}

__device__ __forceinline__ void init_ring(uint64_t* full, uint64_t* empty,
                                          int S) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      hopper::mbar_init(&full[s], 1);     // the producer's expect_tx
      hopper::mbar_init(&empty[s], 8);    // one arrival per consumer warp
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();
}

// A consumer warpgroup's products of one tile: nk stages from ring stage
// *gs on, acc = sum over them; A (TA) and B (TB) K-major (0) or MN-major
// (1).  `prep(kt, stage)` runs after stage kt has landed and before its
// products.  One group of products stays in flight; each stage is released
// once the products that read it are done.  Both warpgroups multiply
// even where one's rows are all past the segment: a wgmma under a runtime
// branch serializes every wgmma of the kernel (ptxas C7518).
template <int BN, int TA, int TB, typename Prep>
__device__ __forceinline__ void tile_products(
    float (&acc)[BN / 2], unsigned char* ring, uint64_t* full,
    uint64_t* empty, int& gs, int nk, int wg, Prep prep) {
  using C = Ring<BN>;
  constexpr int S = C::S;
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  for (int kt = 0; kt < nk; ++kt, ++gs) {
    const int s = gs % S;
    wait_bar(&full[s], (gs / S) & 1);
    unsigned char* st = ring + s * C::STAGE;
    prep(kt, st);
    // A K-major: this warpgroup's 64 rows, 8 KB in; MN-major: its 64
    // columns, the stage's chunk wg
    const uint32_t a = hopper::smem_u32(st) + wg * CHUNK;
    const uint32_t b = hopper::smem_u32(st + A_BYTES);
    hopper::fence_regs(acc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk) {
      const uint64_t da = TA ? hopper::desc_sw128(a + kk * 2048, CHUNK)
                             : hopper::desc_sw128(a + kk * 32, 16);
      const uint64_t db = TB ? hopper::desc_sw128(b + kk * 2048, CHUNK)
                             : hopper::desc_sw128(b + kk * 32, 16);
      hopper::WgmmaSS<BN>::template bf16<TA, TB>(acc, da, db, 1);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<1>();
    hopper::fence_regs(acc);
    if (kt > 0) release(&empty[(gs + S - 1) % S]);
  }
  hopper::wgmma_wait<0>();
  hopper::fence_regs(acc);
  if (nk > 0) release(&empty[(gs + S - 1) % S]);
}

// This consumer thread's accumulators into its warpgroup's staging area
// (64 rows x BN as BN / 64 boxes of 64 x 64 in the 128-byte swizzle, so
// the 8 rows of a warp's store land in distinct banks), once the previous
// tile's TMA stores have read it; then fence.proxy.async and a barrier of
// the warpgroup, after which its first thread may store the boxes.
template <int BN>
__device__ __forceinline__ void stage_tile(const float (&acc)[BN / 2],
                                           unsigned char* epi, int wg) {
  const int tid = threadIdx.x % 128, lane = tid % 32;
  if (tid == 0) hopper::bulk_wait_read<0>();
  hopper::named_sync(2 + wg, 128);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = (tid / 32) * 16 + lane / 4 + 8 * h;   // r % 8 == lane / 4
    unsigned char* row = epi + r * 128 + 4 * (lane % 4);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(
          row + (j / 8) * CHUNK + (((j % 8) ^ (lane / 4)) << 4)) =
          __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
  }
  hopper::fence_proxy_async();
  hopper::named_sync(2 + wg, 128);
}

// the accumulators of this consumer thread into rows < m_lim and columns
// < n_lim of the tile at out (row stride ld): row 16 warp + lane / 4 (+ 8)
// of the warpgroup's 64, columns 8 j + 2 (lane % 4) (+ 1)
template <int BN>
__device__ __forceinline__ void store_tile(const float (&acc)[BN / 2],
                                           bf16* out, long long ld, int wg,
                                           int m_lim, int n_lim) {
  const int tid = threadIdx.x % 128, lane = tid % 32;
  const int r0 = wg * 64 + (tid / 32) * 16 + lane / 4;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    if (r >= m_lim) continue;
    bf16* row = out + r * ld + 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
      if (8 * j < n_lim)        // n_lim % 8 == 0: both columns or neither
        *reinterpret_cast<__nv_bfloat162*>(row + 8 * j) =
            __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
  }
}

template <int BN, bool TRANS_W>
__global__ void __launch_bounds__(NTHREADS, 1) grouped_mm_bf16_kernel(
    const __grid_constant__ GmmMaps maps,
    const long long* __restrict__ start, const long long* __restrict__ kept,
    bf16* __restrict__ y, int R, int K, int N, int G) {
  using C = Ring<BN>;
  constexpr int S = C::S;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = hopper::align1024(smem_raw);
  unsigned char* epi = ring + S * C::STAGE;
  uint64_t* full = reinterpret_cast<uint64_t*>(epi + 2 * C::EPI);
  uint64_t* empty = full + S;
  __shared__ int s_start[MAX_G], s_end[MAX_G], s_tile[MAX_G + 1];

  segment_tables(start, kept, G, R, TM, s_start, s_end, s_tile);
  init_ring(full, empty, S);

  // tile t: column tile ct and row tile rt of segment g, expert-major,
  // the row tiles of one column tile in a row
  const int nct = (N + BN - 1) / BN, nk = (K + TK - 1) / TK;
  const int total = s_tile[G] * nct;
  struct Tile {
    int g, row0, m_lim, n0;
  };
  auto decode = [&](int t) {
    Tile tl;
    tl.g = last_at_or_before(s_tile, G, t / nct);
    const int nr = s_tile[tl.g + 1] - s_tile[tl.g];
    const int local = t - s_tile[tl.g] * nct;
    tl.row0 = s_start[tl.g] + (local % nr) * TM;
    tl.m_lim = min(TM, s_end[tl.g] - tl.row0);
    tl.n0 = (local / nr) * BN;
    return tl;
  };

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    hopper::setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 256) {
      // ---- producer: the ring, over every tile of this block ----
      int gs = 0;
      for (int t = blockIdx.x; t < total; t += gridDim.x) {
        const Tile tl = decode(t);
        for (int kt = 0; kt < nk; ++kt, ++gs) {
          const int s = gs % S;
          if (gs >= S) wait_bar(&empty[s], ((gs / S) - 1) & 1);
          hopper::mbar_arrive_expect_tx(&full[s], C::STAGE);
          unsigned char* st = ring + s * C::STAGE;
          hopper::tma_load_2d(st, &maps.a, &full[s], kt * TK, tl.row0);
          if (TRANS_W) {
            hopper::tma_load_3d(st + A_BYTES, &maps.b, &full[s], kt * TK,
                                tl.n0, tl.g);
          } else {
#pragma unroll
            for (int c = 0; c < BN / 64; ++c)
              hopper::tma_load_3d(st + A_BYTES + c * CHUNK, &maps.b,
                                  &full[s], tl.n0 + 64 * c, kt * TK, tl.g);
          }
        }
      }
    } else if (threadIdx.x >= 288) {
      // ---- zeros: 32 rows a warp; each lane finds whether its row is
      // kept, the warp writes the rows that are not ----
      const int lane = threadIdx.x % 32, wz = (threadIdx.x - 288) / 32;
      const int per_row = N / 8;              // 16-byte pieces
      for (long long q = (long long)blockIdx.x * 3 + wz; q * 32 < R;
           q += 3LL * gridDim.x) {
        const int r = (int)(q * 32) + lane;
        bool hole = false;
        if (r < R) {
          const int g = last_at_or_before(s_start, G, r);
          hole = !(g >= 0 && r < s_end[g]);
        }
        unsigned m = __ballot_sync(0xffffffffu, hole);
        while (m) {
          const int i = __ffs(m) - 1;
          m &= m - 1;
          uint4* row = reinterpret_cast<uint4*>(y + (q * 32 + i) * N);
          for (int p = lane; p < per_row; p += 32)
            row[p] = make_uint4(0, 0, 0, 0);
        }
      }
    }
    return;
  }

  // ---- consumers ----
  hopper::setmaxnreg_inc<CONSUMER_REGS>();
  const int tid = threadIdx.x % 128;
  unsigned char* my_epi = epi + wg * C::EPI;
  float acc[BN / 2];
  int gs = 0;
  for (int t = blockIdx.x; t < total; t += gridDim.x) {
    const Tile tl = decode(t);
    tile_products<BN, 0, TRANS_W ? 0 : 1>(acc, ring, full, empty, gs, nk, wg,
                                          [](int, unsigned char*) {});
    if (wg * 64 + 64 <= tl.m_lim) {
      // all 64 rows are the segment's: TMA stores, which read the staging
      // area while the next tile's products run
      stage_tile<BN>(acc, my_epi, wg);
      if (tid == 0) {
        for (int c = 0; c < BN / 64 && tl.n0 + 64 * c < N; ++c)
          hopper::tma_store_2d(&maps.c, my_epi + c * CHUNK, tl.n0 + 64 * c,
                               tl.row0 + 64 * wg);
        hopper::bulk_commit();
      }
    } else {
      // rows past m_lim are another block's: stores masked by row
      store_tile<BN>(acc, y + (long long)tl.row0 * N + tl.n0, N, wg,
                     tl.m_lim, N - tl.n0);
    }
  }
  if (tid == 0) hopper::bulk_wait_read<0>();
}

template <int BN>
__global__ void __launch_bounds__(NTHREADS, 1) grouped_mm_wgrad_bf16_kernel(
    const __grid_constant__ GmmMaps maps,
    const long long* __restrict__ start, const long long* __restrict__ kept,
    bf16* __restrict__ dw, int R, int M, int N, int G) {
  using C = Ring<BN>;
  constexpr int S = C::S;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = hopper::align1024(smem_raw);
  unsigned char* epi = ring + S * C::STAGE;
  uint64_t* full = reinterpret_cast<uint64_t*>(epi + 2 * C::EPI);
  uint64_t* empty = full + S;
  __shared__ int s_start[MAX_G], s_end[MAX_G];

  for (int g = threadIdx.x; g < G; g += blockDim.x)
    segment(start, kept, g, R, s_start[g], s_end[g]);
  init_ring(full, empty, S);

  // tile t: expert g, M tile, N tile, expert-major
  const int nmt = (M + TM - 1) / TM, nnt = (N + BN - 1) / BN;
  const int total = G * nmt * nnt;
  struct Tile {
    int g, m0, n0, s, e, nk;
  };
  auto decode = [&](int t) {
    Tile tl;
    tl.g = t / (nmt * nnt);
    const int local = t % (nmt * nnt);
    tl.m0 = (local / nnt) * TM;
    tl.n0 = (local % nnt) * BN;
    tl.s = s_start[tl.g];
    tl.e = s_end[tl.g];
    tl.nk = (tl.e - tl.s + TK - 1) / TK;
    return tl;
  };

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    hopper::setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x != 256) return;
    // ---- producer: A's 128 columns and B's BN of 64 rows a stage ----
    int gs = 0;
    for (int t = blockIdx.x; t < total; t += gridDim.x) {
      const Tile tl = decode(t);
      for (int kt = 0; kt < tl.nk; ++kt, ++gs) {
        const int s = gs % S;
        if (gs >= S) wait_bar(&empty[s], ((gs / S) - 1) & 1);
        hopper::mbar_arrive_expect_tx(&full[s], C::STAGE);
        unsigned char* st = ring + s * C::STAGE;
        const int row = tl.s + kt * TK;
        hopper::tma_load_2d(st, &maps.a, &full[s], tl.m0, row);
        hopper::tma_load_2d(st + CHUNK, &maps.a, &full[s], tl.m0 + 64, row);
#pragma unroll
        for (int c = 0; c < BN / 64; ++c)
          hopper::tma_load_2d(st + A_BYTES + c * CHUNK, &maps.b, &full[s],
                              tl.n0 + 64 * c, row);
      }
    }
    return;
  }

  // ---- consumers ----
  hopper::setmaxnreg_inc<CONSUMER_REGS>();
  const int tid = threadIdx.x % 128;
  unsigned char* my_epi = epi + wg * C::EPI;
  float acc[BN / 2];
  int gs = 0;
  for (int t = blockIdx.x; t < total; t += gridDim.x) {
    const Tile tl = decode(t);
    // the last stage's rows at or past the segment's end (the next
    // expert's, dropped or past R) are zeroed in both operands: this
    // warpgroup its A chunk and every other B chunk
    const int lim = tl.e - tl.s - (tl.nk - 1) * TK;
    auto prep = [&](int kt, unsigned char* st) {
      if (kt != tl.nk - 1 || lim >= TK) return;
      const uint4 z = make_uint4(0, 0, 0, 0);
      const int n16 = (TK - lim) * 8;         // 16-byte pieces a chunk
      for (int c = wg; c < 2 + BN / 64; c += 2) {
        uint4* p = reinterpret_cast<uint4*>(st + c * CHUNK + lim * 128);
        for (int i = tid; i < n16; i += 128) p[i] = z;
      }
      hopper::fence_proxy_async();
      hopper::named_sync(1, 256);
    };
    tile_products<BN, 1, 1>(acc, ring, full, empty, gs, tl.nk, wg, prep);
    // dW's tiles are disjoint and its map ends at M and N inside each
    // expert: TMA stores of the whole box
    stage_tile<BN>(acc, my_epi, wg);
    if (tid == 0) {
      if (tl.m0 + 64 * wg < M)
        for (int c = 0; c < BN / 64 && tl.n0 + 64 * c < N; ++c)
          hopper::tma_store_3d(&maps.c, my_epi + c * CHUNK, tl.n0 + 64 * c,
                               tl.m0 + 64 * wg, tl.g);
      hopper::bulk_commit();
    }
  }
  if (tid == 0) hopper::bulk_wait_read<0>();
}

bool aligned(const void* p) { return (uintptr_t)p % 16 == 0; }

// SMs of the card: one persistent block each
cudaError_t sm_count(int* sms) {
  static int cached = 0;
  if (cached == 0) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&cached, cudaDevAttrMultiProcessorCount,
                                 dev);
    if (e != cudaSuccess) return e;
  }
  *sms = cached;
  return cudaSuccess;
}

// a bf16 tensor map of `rank` dims, innermost first, 128-byte swizzled
bool bf16_map(CUtensorMap* map, int rank, const void* base,
              const uint64_t* dims, const uint64_t* strides,
              const uint32_t* box) {
  return hopper_host::make_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
                               base, dims, strides, box,
                               CU_TENSOR_MAP_SWIZZLE_128B);
}

template <typename Kern>
cudaError_t launch_persistent(Kern kern, size_t smem, const GmmMaps& maps,
                              cudaStream_t st, const long long* start,
                              const long long* kept, void* out, int R,
                              int K, int N, int G) {
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int sms = 0;
  if (e == cudaSuccess) e = sm_count(&sms);
  if (e != cudaSuccess) return e;
  kern<<<sms, NTHREADS, smem, st>>>(maps, start, kept,
                                    static_cast<bf16*>(out), R, K, N, G);
  return cudaGetLastError();
}

template <int BN, bool TRANS_W>
cudaError_t launch_fwd_bf16(const void* x, const void* w,
                            const long long* start, const long long* kept,
                            void* y, int R, int K, int N, int G,
                            cudaStream_t st) {
  GmmMaps maps;
  const uint64_t x_dims[2] = {(uint64_t)K, (uint64_t)R};
  const uint64_t x_str[1] = {2ull * K};
  const uint32_t x_box[2] = {TK, TM};
  // W (G, N, K) as (K, N, G), boxes of 64 k x BN rows; W (G, K, N) as
  // (N, K, G), boxes of 64 columns x 64 k
  const uint64_t w_dims[3] = {(uint64_t)(TRANS_W ? K : N),
                              (uint64_t)(TRANS_W ? N : K), (uint64_t)G};
  const uint64_t w_str[2] = {2ull * (TRANS_W ? K : N), 2ull * K * N};
  const uint32_t w_box[3] = {64, (uint32_t)(TRANS_W ? BN : TK), 1};
  const uint64_t y_dims[2] = {(uint64_t)N, (uint64_t)R};
  const uint64_t y_str[1] = {2ull * N};
  const uint32_t y_box[2] = {64, 64};
  if (!bf16_map(&maps.a, 2, x, x_dims, x_str, x_box) ||
      !bf16_map(&maps.b, 3, w, w_dims, w_str, w_box) ||
      !bf16_map(&maps.c, 2, y, y_dims, y_str, y_box))
    return cudaErrorInvalidValue;
  return launch_persistent(grouped_mm_bf16_kernel<BN, TRANS_W>,
                           Ring<BN>::SMEM, maps, st, start, kept, y, R, K, N,
                           G);
}

template <int BN>
cudaError_t launch_wgrad_bf16(const void* a, const void* b,
                              const long long* start, const long long* kept,
                              void* dw, int R, int M, int N, int G,
                              cudaStream_t st) {
  GmmMaps maps;
  const uint64_t a_dims[2] = {(uint64_t)M, (uint64_t)R};
  const uint64_t b_dims[2] = {(uint64_t)N, (uint64_t)R};
  const uint64_t a_str[1] = {2ull * M}, b_str[1] = {2ull * N};
  const uint32_t box[2] = {64, TK};
  // dW (G, M, N) as (N, M, G)
  const uint64_t c_dims[3] = {(uint64_t)N, (uint64_t)M, (uint64_t)G};
  const uint64_t c_str[2] = {2ull * N, 2ull * M * N};
  const uint32_t c_box[3] = {64, 64, 1};
  if (!bf16_map(&maps.a, 2, a, a_dims, a_str, box) ||
      !bf16_map(&maps.b, 2, b, b_dims, b_str, box) ||
      !bf16_map(&maps.c, 3, dw, c_dims, c_str, c_box))
    return cudaErrorInvalidValue;
  return launch_persistent(grouped_mm_wgrad_bf16_kernel<BN>, Ring<BN>::SMEM,
                           maps, st, start, kept, dw, R, M, N, G);
}

cudaError_t launch_fwd_f32(const void* x, const void* w,
                           const long long* start, const long long* kept,
                           void* y, int R, int K, int N, int G, int cap,
                           bool trans_w, cudaStream_t st) {
  auto kern = trans_w ? grouped_mm_f32_kernel<true>
                      : grouped_mm_f32_kernel<false>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, F_SMEM);
  if (e != cudaSuccess) return e;
  // a static upper bound on the row tiles, by the column tiles
  if (cap <= 0 || cap > R) cap = R;
  const long long bound = (R + BM - 1) / BM + (long long)G;
  const long long by_cap = (long long)G * ((cap + BM - 1) / BM);
  long long rows = bound < by_cap ? bound : by_cap;
  rows = rows < 1 ? 1 : (rows > 65535 ? 65535 : rows);
  const dim3 grid((N + F_BN - 1) / F_BN, (unsigned)rows);
  kern<<<grid, F_NT, F_SMEM, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(w), start, kept,
      static_cast<float*>(y), R, K, N, G);
  return cudaGetLastError();
}

cudaError_t launch_wgrad_f32(const void* a, const void* b,
                             const long long* start, const long long* kept,
                             void* dw, int R, int M, int N, int G,
                             cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(
      grouped_mm_wgrad_f32_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, F_SMEM);
  if (e != cudaSuccess) return e;
  const dim3 grid(((M + BM - 1) / BM) * ((N + F_BN - 1) / F_BN), G);
  grouped_mm_wgrad_f32_kernel<<<grid, F_NT, F_SMEM, st>>>(
      static_cast<const float*>(a), static_cast<const float*>(b), start, kept,
      static_cast<float*>(dw), R, M, N);
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
// float32 grid.  dtype 0 float32, 1 bfloat16 (X, W, Y alike).  Operands
// contiguous and 16-byte aligned, K and N multiples of 16 bytes, 1 <= G <=
// 256.  Returns a cudaError_t (0 on success).
int grouped_mm(const void* x, const void* w, const long long* start,
               const long long* kept, void* y, int dtype, int R, int K,
               int N, int G, int cap, int trans_w, void* stream) {
  if (R < 0 || G < 1 || G > MAX_G || (dtype != 0 && dtype != 1) ||
      !widths_ok(dtype, K, N) || !aligned(x) || !aligned(w) || !aligned(y))
    return (int)cudaErrorInvalidValue;
  if (R == 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_fwd_f32(x, w, start, kept, y, R, K, N, G, cap,
                               trans_w != 0, st);
  const bool w256 = wide(N);
  cudaError_t e;
  if (trans_w)
    e = w256 ? launch_fwd_bf16<256, true>(x, w, start, kept, y, R, K, N, G, st)
             : launch_fwd_bf16<128, true>(x, w, start, kept, y, R, K, N, G, st);
  else
    e = w256 ? launch_fwd_bf16<256, false>(x, w, start, kept, y, R, K, N, G,
                                           st)
             : launch_fwd_bf16<128, false>(x, w, start, kept, y, R, K, N, G,
                                           st);
  return (int)e;
}

// dW (G, M, N): dW[g] = A[kept rows of g]^T @ B[kept rows of g], A (R, M),
// B (R, N); zero for a segment that keeps none.  Same types and rules as
// grouped_mm.
int grouped_mm_wgrad(const void* a, const void* b, const long long* start,
                     const long long* kept, void* dw, int dtype, int R,
                     int M, int N, int G, void* stream) {
  if (R < 0 || G < 1 || G > MAX_G || (dtype != 0 && dtype != 1) ||
      !widths_ok(dtype, M, N) || !aligned(a) || !aligned(b) || !aligned(dw))
    return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_wgrad_f32(a, b, start, kept, dw, R, M, N, G, st);
  if (R == 0) {
    // no row to map: every segment is empty, dW is zero
    return (int)cudaMemsetAsync(dw, 0, 2ull * G * M * N, st);
  }
  return (int)(wide(N) ? launch_wgrad_bf16<256>(a, b, start, kept, dw, R, M,
                                                N, G, st)
                       : launch_wgrad_bf16<128>(a, b, start, kept, dw, R, M,
                                                N, G, st));
}

const char* gmm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
