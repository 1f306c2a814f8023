// Selective scans (the Mamba-1 and Mamba-2 recurrences) for NVIDIA Hopper
// (sm_90a), CUDA C++ with a plain C interface (loaded through ctypes by kernels/mamba_scan.py).
//
// Replaces repro/kernels/mamba_scan.py::mamba_scan, the Pallas TPU kernel:
//   h_t = decay_t * h_{t-1} + u_t,  y_t = sum_n h_t[:, n] * c_t[n],  h_{-1} = 0
// over decay, u (B, T, D, N), c (B, T, N), all float32, y (B, T, D) float32.
// Five C entry points (and four that report a call's plan):
//   * mamba_scan_fwd: the TPU kernel's contract, any T (no time block bt);
//   * selective_scan_fwd: the fused Mamba-1 form the model calls, as
//     repro/models/ssm.py::mamba1_block's make_chunk/emit_chunk compute it:
//     decay = exp(dt * A), u = (dt * x) * b, built in registers step by step,
//     from h0, returning y and the last state.  It reads dt (B, T, D) f32,
//     x (B, T, D) and b, c (B, T, N) in f32 or bf16, A (D, N) f32 and
//     h0 (B, D, N) f32, and writes y (B, T, D) f32 and h_last (B, D, N) f32;
//     the (B, T, D, N) decay and u are never stored.  It and mamba_scan_fwd
//     share one recurrence core (recur below);
//   * selective_scan_bwd: that form's gradient (ddt, dx, db, dc, dA, dh0
//     from dy and dh_last), a reverse-time walk on the CUDA cores over
//     states it recomputes, in selective_scan_fwd's lane layout, its inputs
//     through a ring of whole chunks loaded by TMA (below at
//     "selective_scan_bwd");
//   * mamba2_scan_fwd: the Mamba-2 form, as repro/models/ssm.py::mamba2_block
//     computes it: a scalar decay exp(dt * A_h) a head, u = (dt * x) * b over
//     a head's (P, N) state, b and c shared by all heads, from h0, returning
//     y (B, T, H, P) and h_last (B, H, P, N).  A prefill in bf16 runs the
//     chunked state-space-duality (SSD) form on the tensor cores (wgmma,
//     chunks of 64 steps, the state carried in registers); decode and the
//     float32 form run on the CUDA cores.  Its design is at its code below
//     ("mamba2_scan");
//   * mamba2_scan_bwd: that form's gradient (ddt, dx, db, dc, dA, dh0 from
//     dy and dh_last): a bf16 call with N <= 64 and T > 8 the chunked (SSD)
//     form's backward on the tensor cores, the others a reverse-time walk
//     on the CUDA cores over states it recomputes (below at
//     "mamba2_scan_bwd").
//
// Differences from the TPU kernel, none of which change the result beyond
// float32 rounding order: the TPU walks time blocks of bt steps on a
// sequential grid axis and carries the (D, N) state in VMEM scratch.  Blocks
// on Hopper run in parallel and in no order, so the time loop lives inside
// the thread: P neighbouring lanes own one (b, d) channel, each holding S of
// its N states in registers for the whole sequence, and y_t is the lanes'
// partial sums reduced with warp shuffles.  There is no T % bt requirement.
//
// mamba_scan_fwd moves 8 * B*T*D*N bytes of decay and u and does 2 flops per
// byte pair: memory-bound (1.107 GB, 0.33 ms at 3.35 TB/s for B=1, T=1024,
// D=8192, N=16).  It keeps S = 4, so that even B=1 gives enough lanes to keep
// every SM loading, and each lane loads the inputs of U steps ahead of their
// use (registers).
//
// selective_scan_fwd reads only ~10 bytes per (b, t, d) but evaluates
// B*T*D*N exponentials: the special-function units (16 a clock an SM) bound
// it, 577 M exp or ~0.14 ms at the serving prefill shape (B=4, T=1100,
// D=8192, N=16), with the bytes (~0.11 ms) close behind.  One lane a channel
// (the earlier design) gave ~8 warps an SM, too few to hide the latency of
// a step, and spent ~8 FMA-pipe instructions on each expf.  This design:
//   * splits a channel's N = 16 states over P = 2 lanes of S = 8 (more
//     generally S = 8 up to N = 16 and S = 16 above, P = next_pow2(N / S)),
//     so the serving shape fills an SM with 16 consumer warps; y is reduced
//     by log2(P) xor shuffles a step.  A sweep chose S = 8 over S = 4 (32
//     warps, but more shuffles and loads a state-step) and S = 16 (8
//     warps); PERF.md has its times;
//   * spends one MUFU.EX2 and one FMUL on each state-step: log2(e) is folded
//     into A once a channel and exp is ex2.approx.ftz (within 2 ulp);
//   * streams dt and x through a ring of STAGES shared-memory stages of TS
//     steps x CH channels, loaded by TMA (cp.async.bulk.tensor) under full /
//     empty mbarriers by one producer warp a block, so the consumers keep
//     no loads in registers and never meet at a block-wide barrier; a
//     channel's dt and x are loaded once a block and read by its P lanes as
//     broadcasts.  b and c (2N values a step, shared by every channel of a
//     batch row) are loaded by the producer warp's lanes, widened to f32 and
//     staged in the same stage, and read as 16-byte broadcasts.  An operand
//     whose base or strides TMA cannot take (16-byte aligned base, batch and
//     time strides multiples of 16 bytes) is loaded by the producer warp's
//     lanes too, into the same place: b and c always, dt and x by alignment;
//   * runs a short T (T <= DIRECT_T; decode is T = 1) without the ring: each
//     lane reads its inputs straight from global memory, and h0 / h_last
//     move as 16-byte vectors.
// plan_selective below makes these choices (plan_selective_bwd the
// backward's: its ring's depth and which operands TMA loads);
// kernels/mamba_scan.py mirrors both for the tests.  Neither of these two
// kernels, nor the Mamba-1 form's backward, uses the tensor cores (only the
// Mamba-2 form's chunked paths do); the measured times are in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include "hopper.cuh"

namespace {

constexpr int U = 8;        // steps whose inputs are loaded ahead of their use
constexpr int NT = 128;     // threads per block
constexpr int MAX_N = 128;  // state size the kernels take
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}

// The recurrence core, one step: h = decay * h + u over this lane's S
// states, and y = sum_n h * c reduced over the P lanes of the channel.
template <int S>
__device__ __forceinline__ float recur(float (&h)[S], const float (&decay)[S],
                                       const float (&u)[S],
                                       const float (&c)[S], int P) {
  float part = 0.f;
#pragma unroll
  for (int j = 0; j < S; ++j) {
    h[j] = fmaf(decay[j], h[j], u[j]);
    part = fmaf(h[j], c[j], part);
  }
  for (int off = P >> 1; off > 0; off >>= 1)
    part += __shfl_xor_sync(FULL, part, off);
  return part;
}

// P = next_pow2(ceil(N / S)) neighbouring lanes own one channel
int lanes_for(int N, int S) {
  int P = 1;
  while (P * S < N) P <<= 1;
  return P;
}

// ---- mamba_scan: decay, u (B,T,D,N), c (B,T,N) f32, contiguous ------------
// 4 states a lane, so that B=1 still gives 4 lanes a channel: the kernel is
// bound by the bytes of decay and u, and needs every SM loading.

constexpr int SA = 4;

template <bool VEC>
__global__ void __launch_bounds__(NT)
mamba_scan_kernel(const float* __restrict__ decay,
                  const float* __restrict__ u, const float* __restrict__ c,
                  float* __restrict__ y, int B, int T, int D, int N, int P) {
  const long long gid = (long long)blockIdx.x * NT + threadIdx.x;
  const long long ch = gid / P;
  const bool live = ch < (long long)B * D;
  const int b = live ? (int)(ch / D) : 0, d = live ? (int)(ch % D) : 0;
  const int n0 = (int)(gid % P) * SA;
  const bool lead = live && gid % P == 0;
  const long long st = (long long)D * N;  // time stride of decay and u
  const long long off = (long long)b * T * st + (long long)d * N + n0;
  const float* dp = decay + off;
  const float* up = u + off;
  const float* cp = c + (long long)b * T * N + n0;
  float* yp = y + (long long)b * T * D + d;
  float h[SA] = {0.f, 0.f, 0.f, 0.f};
  for (int t0 = 0; t0 < T; t0 += U) {
    float dv[U][SA], uv[U][SA], cv[U][SA];
#pragma unroll
    for (int s = 0; s < U; ++s) {
      const int t = t0 + s;
      const bool ok = live && t < T;
      if (VEC) {  // N % 4 == 0: this lane's 4 states are one float4
        const bool okv = ok && n0 < N;
        const float4 a = okv ? __ldg(reinterpret_cast<const float4*>(
                                   dp + t * st))
                             : make_float4(1.f, 1.f, 1.f, 1.f);
        const float4 w = okv ? __ldg(reinterpret_cast<const float4*>(
                                   up + t * st))
                             : make_float4(0.f, 0.f, 0.f, 0.f);
        const float4 z = okv ? __ldg(reinterpret_cast<const float4*>(
                                   cp + (long long)t * N))
                             : make_float4(0.f, 0.f, 0.f, 0.f);
        dv[s][0] = a.x; dv[s][1] = a.y; dv[s][2] = a.z; dv[s][3] = a.w;
        uv[s][0] = w.x; uv[s][1] = w.y; uv[s][2] = w.z; uv[s][3] = w.w;
        cv[s][0] = z.x; cv[s][1] = z.y; cv[s][2] = z.z; cv[s][3] = z.w;
      } else {
#pragma unroll
        for (int j = 0; j < SA; ++j) {
          const bool okj = ok && n0 + j < N;
          dv[s][j] = okj ? __ldg(dp + t * st + j) : 1.f;
          uv[s][j] = okj ? __ldg(up + t * st + j) : 0.f;
          cv[s][j] = okj ? __ldg(cp + (long long)t * N + j) : 0.f;
        }
      }
    }
#pragma unroll
    for (int s = 0; s < U; ++s) {
      const float yv = recur<SA>(h, dv[s], uv[s], cv[s], P);
      if (lead && t0 + s < T) yp[(long long)(t0 + s) * D] = yv;
    }
  }
}

// ---- selective_scan: the fused Mamba-1 form ---------------------------------

// The ring path's shape, chosen by benchmarks/selective_scan_sweep.py.
constexpr int TS = 32;                    // steps a ring stage holds
constexpr int STAGES = 3;
constexpr int NC = 256;                   // consumer threads a block
constexpr int SEL_NT = NC + 32;           // and one producer warp
constexpr int S_SMALL = 8;                // states a lane for N <= 16
constexpr int DIRECT_T = 8;               // the longest T run without the ring
constexpr int DIRECT_NT = 128;            // threads a block, direct path
constexpr float LOG2E = 1.4426950408889634f;

struct SelArgs {
  const float* dt;
  const void* x;
  const void* b;
  const void* c;
  const float* A;
  const float* h0;
  float* y;
  float* h_last;
  int B, T, D, N;
  long long dt_sb, dt_st, x_sb, x_st, b_sb, b_st, c_sb, c_st;
  int vec, tma_dt, tma_x;                 // from the plan
};

// How a call runs: S states a lane, P lanes a channel, CH channels a block
// (ring path), the direct path or the ring, TMA or lane loads for dt and x,
// 16-byte vectors for A, h0 and h_last, and the grid.
struct SelPlan {
  int S, P, CH, direct, tma_dt, tma_x, vec;
  unsigned gx, gy;
};

// a TMA tensor map takes a 16-byte aligned base and batch and time strides
// that are positive multiples of 16 bytes (a size-1 batch's is not used)
bool tma_ok(const void* p, long long sb, long long st, int itemsize, int B) {
  return (uintptr_t)p % 16 == 0 && st > 0 && st * itemsize % 16 == 0 &&
         (B == 1 || (sb > 0 && sb * itemsize % 16 == 0));
}

SelPlan plan_selective(const SelArgs& a, int itemsize) {
  SelPlan pl{};
  pl.S = a.N <= 16 ? S_SMALL : 16;
  pl.P = lanes_for(a.N, pl.S);
  pl.CH = NC / pl.P;
  pl.direct = a.T <= DIRECT_T;
  pl.tma_dt = !pl.direct && tma_ok(a.dt, a.dt_sb, a.dt_st, 4, a.B);
  pl.tma_x = !pl.direct && tma_ok(a.x, a.x_sb, a.x_st, itemsize, a.B);
  pl.vec = a.N % 4 == 0 &&
           ((uintptr_t)a.A | (uintptr_t)a.h0 | (uintptr_t)a.h_last) % 16 == 0;
  if (pl.direct) {
    pl.gx = (unsigned)(((long long)a.B * a.D * pl.P + DIRECT_NT - 1) /
                       DIRECT_NT);
    pl.gy = 1;
  } else {
    pl.gx = (unsigned)((a.D + pl.CH - 1) / pl.CH);
    pl.gy = (unsigned)a.B;
  }
  return pl;
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// S (a multiple of 4) states n0 .. n0+S-1 of a channel, N in all, from p
// (the address of state n0); zeros past N or off a live channel.  `vec`:
// N % 4 == 0 and 16-byte aligned bases, so four states are one float4.
template <int S>
__device__ __forceinline__ void load_states(float (&v)[S], const float* p,
                                            int n0, int N, bool live,
                                            bool vec) {
#pragma unroll
  for (int j = 0; j < S; j += 4) {
    if (vec) {
      const float4 w = live && n0 + j < N
                           ? __ldg(reinterpret_cast<const float4*>(p + j))
                           : make_float4(0.f, 0.f, 0.f, 0.f);
      v[j] = w.x; v[j + 1] = w.y; v[j + 2] = w.z; v[j + 3] = w.w;
    } else {
#pragma unroll
      for (int i = j; i < j + 4; ++i)
        v[i] = live && n0 + i < N ? __ldg(p + i) : 0.f;
    }
  }
}

template <int S>
__device__ __forceinline__ void store_states(const float (&v)[S], float* p,
                                             int n0, int N, bool live,
                                             bool vec) {
  if (!live) return;
#pragma unroll
  for (int j = 0; j < S; j += 4) {
    if (vec) {
      if (n0 + j < N)
        *reinterpret_cast<float4*>(p + j) =
            make_float4(v[j], v[j + 1], v[j + 2], v[j + 3]);
    } else {
#pragma unroll
      for (int i = j; i < j + 4; ++i)
        if (n0 + i < N) p[i] = v[i];
    }
  }
}

// One step of a lane: decay = 2^(dt * A log2 e), u = (dt * x) * b over its S
// states, then the shared core.  b and c are the lane's S values of the step.
template <int S, int P>
__device__ __forceinline__ float sel_step(float (&h)[S], const float (&A2)[S],
                                          float dt, float dx,
                                          const float (&bv)[S],
                                          const float (&cv)[S]) {
  float decay[S], u[S];
#pragma unroll
  for (int j = 0; j < S; ++j) {
    decay[j] = hopper::ex2(dt * A2[j]);
    u[j] = dx * bv[j];
  }
  return recur<S>(h, decay, u, cv, P);
}

// ---- direct path: short T, no shared memory ----------------------------------
// Lane q of channel (b, d) holds states q*S .. q*S+S-1 and reads each step's
// dt, x, b, c from global memory; a lane off the end (ch >= B*D) runs with
// zeros so that every lane of the warp takes part in the shuffles.

template <typename TX, int S, int P>
__global__ void __launch_bounds__(DIRECT_NT)
selective_direct_kernel(const SelArgs a) {
  const long long gid = (long long)blockIdx.x * DIRECT_NT + threadIdx.x;
  const long long ch = gid / P;
  const int N = a.N, q = (int)(gid % P), n0 = q * S;
  const bool live = ch < (long long)a.B * a.D;
  const int bb = live ? (int)(ch / a.D) : 0, d = live ? (int)(ch % a.D) : 0;
  const long long hoff = ((long long)bb * a.D + d) * N + n0;
  float h[S], A2[S];
  load_states<S>(h, a.h0 + hoff, n0, N, live, a.vec);
  load_states<S>(A2, a.A + (long long)d * N + n0, n0, N, live, a.vec);
#pragma unroll
  for (int j = 0; j < S; ++j) A2[j] *= LOG2E;
  const float* dtp = a.dt + bb * a.dt_sb + d;
  const TX* xp = static_cast<const TX*>(a.x) + bb * a.x_sb + d;
  const TX* bp = static_cast<const TX*>(a.b) + bb * a.b_sb + n0;
  const TX* cp = static_cast<const TX*>(a.c) + bb * a.c_sb + n0;
  float* yp = a.y + (long long)bb * a.T * a.D + d;
  for (int t = 0; t < a.T; ++t) {
    const float dt = live ? __ldg(dtp + t * a.dt_st) : 0.f;
    const float dx = dt * (live ? load(xp + t * a.x_st) : 0.f);
    float bv[S], cv[S];
#pragma unroll
    for (int j = 0; j < S; ++j) {
      const bool ok = live && n0 + j < N;
      bv[j] = ok ? load(bp + t * a.b_st + j) : 0.f;
      cv[j] = ok ? load(cp + t * a.c_st + j) : 0.f;
    }
    const float yv = sel_step<S, P>(h, A2, dt, dx, bv, cv);
    if (live && q == 0) yp[(long long)t * a.D] = yv;
  }
  store_states<S>(h, a.h_last + hoff, n0, N, live, a.vec);
}

// ---- ring path ----------------------------------------------------------------
// A block owns batch row blockIdx.y and CH = NC / P channels from
// blockIdx.x * CH; NC consumer threads (P a channel) and one producer warp.
// Each ring stage holds TS steps: dt [TS][CH] f32, x [TS][CH] in x's type,
// and b, c [TS][2][NP] widened to f32 (NP = S * P, zeros past N), then the
// full (producer -> consumers) and empty (consumers -> producer) barriers.
// Steps past T and channels past D read zeros (dt = 0: decay 1, u 0), so the
// state is left as it was and no branch enters the step.

template <typename TX, int S, int P>
struct Ring {
  static constexpr int CH = NC / P;
  static constexpr int NP = S * P;
  static constexpr uint32_t DT_BYTES = TS * CH * 4;
  static constexpr uint32_t X_BYTES = TS * CH * sizeof(TX);
  static constexpr uint32_t STAGE = DT_BYTES + X_BYTES + TS * 2 * NP * 4;
  static constexpr size_t SMEM =
      1024 + (size_t)STAGES * STAGE + 2 * STAGES * sizeof(uint64_t);
  // blocks an SM should hold for the registers: 4096 / (NC * S) (2 at
  // S = 8: 16 consumer warps), or as many as its 228 KB of shared memory
  // take (1 KB of it reserved a block), at least 1
  static constexpr int FIT = (int)(233472 / (SMEM + 1024));
  static constexpr int WANT = 4096 / (NC * S) < FIT ? 4096 / (NC * S) : FIT;
  static constexpr int MIN_BLOCKS = WANT > 0 ? WANT : 1;
  // steps unrolled in the consumer loop: all of a stage, 8 at S = 16 (whose
  // 4 x 16 live values a lane leave no registers for more)
  static constexpr int UNROLL = S >= 16 ? 8 : TS;
  static_assert(STAGE % 128 == 0 && DT_BYTES % 128 == 0 &&
                    X_BYTES % 128 == 0,
                "TMA destinations must stay 128-byte aligned");
  static_assert(TS % UNROLL == 0, "a stage is whole unrolled blocks");
};

struct SelMaps {
  CUtensorMap dt, x;
};

// A [TS][CH] tile of a (T, D) operand (rows st elements apart) by the
// producer warp's lanes, for an operand TMA cannot take; zeros off the edge.
template <int CH, typename TV>
__device__ __forceinline__ void fill_tile(TV* dst, const TV* src,
                                          long long st, int t0, int d0, int T,
                                          int D, int lane) {
#pragma unroll 4
  for (int i = lane; i < TS * CH; i += 32) {
    const int s = i / CH, c = i % CH;
    dst[i] = t0 + s < T && d0 + c < D ? src[(t0 + s) * st + d0 + c]
                                      : TV(0.f);
  }
}

template <typename TX, int S, int P>
__global__ void __launch_bounds__(SEL_NT, Ring<TX, S, P>::MIN_BLOCKS)
selective_ring_kernel(const __grid_constant__ SelMaps maps, const SelArgs a) {
  using R = Ring<TX, S, P>;
  constexpr int CH = R::CH, NP = R::NP;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = hopper::align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * R::STAGE);
  uint64_t* empty = full + STAGES;
  auto dt_tile = [&](int k) {
    return reinterpret_cast<float*>(smem + k * R::STAGE);
  };
  auto x_tile = [&](int k) {
    return reinterpret_cast<TX*>(smem + k * R::STAGE + R::DT_BYTES);
  };
  auto bc_tile = [&](int k) {
    return reinterpret_cast<float*>(smem + k * R::STAGE + R::DT_BYTES +
                                    R::X_BYTES);
  };
  const int tid = threadIdx.x, lane = tid % 32;
  const int bb = blockIdx.y, d0 = blockIdx.x * CH;
  const int T = a.T, N = a.N, stages = (T + TS - 1) / TS;
  if (tid == 0) {
    for (int k = 0; k < STAGES; ++k) {
      hopper::mbar_init(&full[k], 32);         // the producer warp's lanes
      hopper::mbar_init(&empty[k], NC / 32);   // one arrival a consumer warp
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (tid >= NC) {  // the producer warp
    const float* dtg = a.dt + bb * a.dt_sb;
    const TX* xg = static_cast<const TX*>(a.x) + bb * a.x_sb;
    const TX* bg = static_cast<const TX*>(a.b) + bb * a.b_sb;
    const TX* cg = static_cast<const TX*>(a.c) + bb * a.c_sb;
    const uint32_t tx = (a.tma_dt ? R::DT_BYTES : 0) +
                        (a.tma_x ? R::X_BYTES : 0);
    for (int k = 0; k < stages; ++k) {
      const int slot = k % STAGES, t0 = k * TS;
      if (k >= STAGES) hopper::mbar_wait(&empty[slot], (k / STAGES - 1) & 1);
      if (lane == 0 && tx) {
        hopper::mbar_expect_tx(&full[slot], tx);
        if (a.tma_dt)
          hopper::tma_load_3d(dt_tile(slot), &maps.dt, &full[slot], d0, t0,
                              bb);
        if (a.tma_x)
          hopper::tma_load_3d(x_tile(slot), &maps.x, &full[slot], d0, t0, bb);
      }
      if (!a.tma_dt)
        fill_tile<CH>(dt_tile(slot), dtg, a.dt_st, t0, d0, T, a.D, lane);
      if (!a.tma_x)
        fill_tile<CH>(x_tile(slot), xg, a.x_st, t0, d0, T, a.D, lane);
      float* bc = bc_tile(slot);
#pragma unroll 4
      for (int i = lane; i < TS * NP; i += 32) {
        const int s = i / NP, n = i % NP;
        const bool ok = t0 + s < T && n < N;
        bc[s * 2 * NP + n] = ok ? load(bg + (t0 + s) * a.b_st + n) : 0.f;
        bc[s * 2 * NP + NP + n] = ok ? load(cg + (t0 + s) * a.c_st + n) : 0.f;
      }
      hopper::mbar_arrive(&full[slot]);
    }
    return;
  }

  // consumers: lane q of channel cl holds states q*S .. q*S+S-1
  const int cl = tid / P, q = tid % P, n0 = q * S, d = d0 + cl;
  const bool live = d < a.D;
  const long long hoff = ((long long)bb * a.D + (live ? d : 0)) * N + n0;
  float h[S], A2[S];
  load_states<S>(h, a.h0 + hoff, n0, N, live, a.vec);
  load_states<S>(A2, a.A + (long long)(live ? d : 0) * N + n0, n0, N, live,
                 a.vec);
#pragma unroll
  for (int j = 0; j < S; ++j) A2[j] *= LOG2E;
  float* yp = a.y + (long long)bb * T * a.D + (live ? d : 0);
  const bool writer = live && q == 0;
  for (int k = 0; k < stages; ++k) {
    const int slot = k % STAGES, t0 = k * TS, left = T - t0;
    hopper::mbar_wait(&full[slot], (k / STAGES) & 1);
    const float* sd = dt_tile(slot) + cl;
    const TX* sx = x_tile(slot) + cl;
    const float* sbc = bc_tile(slot) + n0;
#pragma unroll 1
    for (int s0 = 0; s0 < TS; s0 += R::UNROLL)
#pragma unroll
    for (int s = s0; s < s0 + R::UNROLL; ++s) {
      const float dt = sd[s * CH];
      const float dx = dt * to_f(sx[s * CH]);
      float bv[S], cv[S];
#pragma unroll
      for (int j = 0; j < S; j += 4) {
        const float4 b4 =
            *reinterpret_cast<const float4*>(sbc + s * 2 * NP + j);
        const float4 c4 =
            *reinterpret_cast<const float4*>(sbc + s * 2 * NP + NP + j);
        bv[j] = b4.x; bv[j + 1] = b4.y; bv[j + 2] = b4.z; bv[j + 3] = b4.w;
        cv[j] = c4.x; cv[j + 1] = c4.y; cv[j + 2] = c4.z; cv[j + 3] = c4.w;
      }
      const float yv = sel_step<S, P>(h, A2, dt, dx, bv, cv);
      if (writer && s < left) yp[(long long)(t0 + s) * a.D] = yv;
    }
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[slot]);
  }
  store_states<S>(h, a.h_last + hoff, n0, N, live, a.vec);
}

// A (B, T, D) operand as a 3-D tensor map (D, T, B), boxes of CH channels by
// `rows` steps by one batch row, no swizzle.
bool map_operand(CUtensorMap* map, CUtensorMapDataType type, int itemsize,
                 const void* base, int B, int T, int D, long long sb,
                 long long st, uint32_t ch, uint32_t rows = TS) {
  const uint64_t dims[3] = {(uint64_t)D, (uint64_t)T, (uint64_t)B};
  const uint64_t bstride = B == 1 ? st * T : sb;   // unused when B == 1
  const uint64_t strides[2] = {(uint64_t)(st * itemsize),
                               bstride * itemsize};
  const uint32_t box[3] = {ch, rows, 1};
  return hopper_host::make_map(map, type, 3, base, dims, strides, box,
                               CU_TENSOR_MAP_SWIZZLE_NONE);
}

template <typename TX, int S, int P>
cudaError_t launch_sel(const SelArgs& a, const SelPlan& pl, cudaStream_t st) {
  const dim3 grid(pl.gx, pl.gy);
  if (pl.direct) {
    selective_direct_kernel<TX, S, P><<<grid, DIRECT_NT, 0, st>>>(a);
    return cudaGetLastError();
  }
  using R = Ring<TX, S, P>;
  SelMaps maps;
  memset(&maps, 0, sizeof maps);
  const auto tx_type = sizeof(TX) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                       : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  if (pl.tma_dt &&
      !map_operand(&maps.dt, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, a.dt, a.B,
                   a.T, a.D, a.dt_sb, a.dt_st, R::CH))
    return cudaErrorInvalidValue;
  if (pl.tma_x && !map_operand(&maps.x, tx_type, (int)sizeof(TX), a.x, a.B,
                               a.T, a.D, a.x_sb, a.x_st, R::CH))
    return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      selective_ring_kernel<TX, S, P>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)R::SMEM);
  if (e != cudaSuccess) return e;
  selective_ring_kernel<TX, S, P><<<grid, SEL_NT, R::SMEM, st>>>(maps, a);
  return cudaGetLastError();
}

// the (S, P) pairs plan_selective picks
template <typename TX>
cudaError_t dispatch_sel(const SelArgs& a, const SelPlan& pl,
                         cudaStream_t st) {
#define SEL_CASE(S_, P_) \
  if (pl.S == S_ && pl.P == P_) return launch_sel<TX, S_, P_>(a, pl, st);
  SEL_CASE(S_SMALL, 1)
  SEL_CASE(S_SMALL, 2)
  if constexpr (S_SMALL * 2 < 16) SEL_CASE(S_SMALL, 4)
  SEL_CASE(16, 2)
  SEL_CASE(16, 4)
  SEL_CASE(16, 8)
#undef SEL_CASE
  return cudaErrorInvalidValue;
}

// the arguments both C entry points take, checked; `itemsize` of x, b, c
bool sel_args(SelArgs* a, const float* dt, const void* x, const void* b,
              const void* c, const float* A, const float* h0, float* y,
              float* h_last, int dtype, int B, int T, int D, int N,
              long long dt_sb, long long dt_st, long long x_sb,
              long long x_st, long long b_sb, long long b_st, long long c_sb,
              long long c_st, int* itemsize) {
  if (B <= 0 || T <= 0 || D <= 0 || N <= 0 || N > MAX_N || B > 65535 ||
      (dtype != 0 && dtype != 1))
    return false;
  *a = SelArgs{dt, x, b, c, A, h0, y, h_last, B, T, D, N,
               dt_sb, dt_st, x_sb, x_st, b_sb, b_st, c_sb, c_st, 0, 0, 0};
  *itemsize = dtype == 1 ? 2 : 4;
  return true;
}

// ---- mamba2_scan: the Mamba-2 form ------------------------------------------
// decay_t = exp(dt_t * A_h) is one scalar a (b, t, h); u_t = (dt_t * x_t) * b_t
// fills a head's (P, N) state; b_t and c_t are shared by every head of a
// batch row.  Three paths, chosen from the shape and dtype (plan_mamba2):
//   * chunked (T > 8, bf16 x, b, c, N <= 64; zamba2's prefill): the
//     state-space-duality (SSD) form on the tensor cores, below at
//     mamba2_chunked_kernel;
//   * direct (T <= 8; decode is T = 1): CUDA cores, inputs read straight
//     from global memory, bound by the bytes of h0 and h_last;
//   * staged (T > 8 with float32 inputs or N > 64, which no served model
//     runs in bf16): CUDA cores through shared-memory stages.
//
// The two CUDA-core paths: a lane holds a 4 x 4 tile of a head's state,
// rows r0 .. r0+3 and states n0 .. n0+3, so the 4 values of b_t and of c_t
// it reads a step serve 16 state-steps.  NL = max(4, next_pow2(N / 4))
// lanes (a "row group") cover N for the same 4 rows, and a block of M2_NT
// threads holds R = 4 * M2_NT / NL rows of one head of one batch row.
// Steps past T and rows past P run with zeros (dt = 0: decay 1, u 0).  A
// state-step is three FP32 instructions (FMUL for u, FFMA for h, FFMA for
// y); the design spends little else on it:
//   * one exponential a (b, t, h) and row block, not a state: log2(e) is
//     folded into A and the decay of a step is ex2'd once when its dt is
//     staged;
//   * b_t and c_t are staged once a stage and block for all its rows and
//     read from shared memory, one 16-byte vector each a lane and step
//     (the lanes of a row group read consecutive vectors: no bank
//     conflict);
//   * a row's y is summed over the row group by a reduce-scatter: two
//     shuffles halve the four rows' partial sums to one row a lane, then
//     log2(NL) - 2 butterfly shuffles finish it (5 shuffles a step for four
//     rows at NL = 16); every lane then writes its row's y to a shared
//     tile (the lanes of a row the same value, so no branch sits in the
//     step), which the block stores coalesced once a stage;
//   * at NL = 16 (N = 64) the staged kernel is held to 96 registers, 5
//     blocks an SM, so that 640 blocks run as one wave on 132 SMs (at
//     ptxas's own choice they ran as two, 1.6x slower; PERF.md, PR 19).
// At zamba2's prefill (B = 4, T = 1100, H = 80, P = N = 64) these three
// FP32 instructions a state-step are 4.3 G, ~0.13 ms on the CUDA cores,
// against ~148 MB of bytes, ~0.044 ms: on the CUDA cores the scan is bound
// by operations, so the prefill takes the chunked path instead.

constexpr int M2_NT = 128;      // threads a block
constexpr int M2_TS = 16;       // steps a stage
constexpr int M2_DIRECT_T = 8;  // the longest T run without the stages
constexpr int SSD_Q = 64;       // steps a chunk, and rows of P a block
constexpr int SSD_MAX_N = 64;   // the states the chunked path takes

enum { M2_DIRECT = 0, M2_STAGED = 1, M2_CHUNKED = 2 };

struct M2Args {
  const float* dt;
  const void* x;
  const void* b;
  const void* c;
  const float* A;
  const float* h0;
  float* y;
  float* h_last;
  int dtype, B, T, H, P, N;
  long long dt_sb, dt_st, x_sb, x_st, x_sh, b_sb, b_st, c_sb, c_st;
  int vec, tma_x, tma_b, tma_c, tma_y;  // from the plan
};

// How a call runs: the path; on the CUDA-core paths NL lanes a row group
// (4 rows x 4 states a lane), R rows a block and 16-byte vectors for h0
// and h_last; on the chunked path SSD_Q rows a block, which of x, b, c
// come in through TMA and whether y goes out through it; and the grid (row
// blocks, heads, batch rows).
struct M2Plan {
  int path, NL, R, vec, tma_x, tma_b, tma_c, tma_y;
  unsigned gx, gy, gz;
};

M2Plan plan_mamba2(const M2Args& a) {
  M2Plan pl{};
  if (a.T <= M2_DIRECT_T)
    pl.path = M2_DIRECT;
  else if (a.dtype == 1 && a.N <= SSD_MAX_N)
    pl.path = M2_CHUNKED;
  else
    pl.path = M2_STAGED;
  if (pl.path == M2_CHUNKED) {
    // a tensor map also takes the head stride of x (unused at H = 1)
    pl.R = SSD_Q;
    pl.tma_x = tma_ok(a.x, a.x_sb, a.x_st, 2, a.B) &&
               (a.H == 1 || (a.x_sh > 0 && a.x_sh * 2 % 16 == 0));
    pl.tma_b = tma_ok(a.b, a.b_sb, a.b_st, 2, a.B);
    pl.tma_c = tma_ok(a.c, a.c_sb, a.c_st, 2, a.B);
    // y is the wrapper's contiguous (B, T, H, P) float32: rows of P * 4
    // bytes, a multiple of 16 when P % 4 == 0
    pl.tma_y = a.P % 4 == 0 && (uintptr_t)a.y % 16 == 0;
  } else {
    pl.NL = lanes_for(a.N, 4);
    if (pl.NL < 4) pl.NL = 4;
    pl.R = 4 * M2_NT / pl.NL;
    pl.vec =
        a.N % 4 == 0 && ((uintptr_t)a.h0 | (uintptr_t)a.h_last) % 16 == 0;
  }
  pl.gx = (unsigned)((a.P + pl.R - 1) / pl.R);
  pl.gy = (unsigned)a.H;
  pl.gz = (unsigned)a.B;
  return pl;
}

// Where a thread sits: lane g of its row group (states 4g .. 4g+3), the
// group's first row r0 in the block, and the row (r0 + 2 up + up2) whose
// y it ends a step with.
template <int NL>
struct M2Lane {
  int g, r0, mine;
  __device__ explicit M2Lane(int tid) {
    const int lane = tid % 32;
    g = lane % NL;
    r0 = 4 * ((tid / 32) * (32 / NL) + lane / NL);
    mine = r0 + 2 * ((g & (NL / 2)) != 0) + ((g & (NL / 4)) != 0);
  }
};

// One step of a lane: h = decay * h + dx_r * b over its 4 rows and 4
// states, then the y of the lane's row (``M2Lane::mine``), summed over
// the row group: every lane of a row ends with it.
template <int NL>
__device__ __forceinline__ float m2_step(float (&h)[4][4], float decay,
                                         const float (&dx)[4], float4 b,
                                         float4 c, int g) {
  static_assert(NL >= 4 && NL <= 32, "a row group is 4 to 32 lanes");
  float part[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    h[i][0] = fmaf(decay, h[i][0], dx[i] * b.x);
    h[i][1] = fmaf(decay, h[i][1], dx[i] * b.y);
    h[i][2] = fmaf(decay, h[i][2], dx[i] * b.z);
    h[i][3] = fmaf(decay, h[i][3], dx[i] * b.w);
    part[i] = fmaf(h[i][3], c.w, fmaf(h[i][2], c.z,
                   fmaf(h[i][1], c.y, h[i][0] * c.x)));
  }
  // rows {0, 1} stay with the lower half of the group, {2, 3} go up; then
  // one row of the pair stays with each quarter
  const bool up = (g & (NL / 2)) != 0, up2 = (g & (NL / 4)) != 0;
  float k0 = up ? part[2] : part[0], k1 = up ? part[3] : part[1];
  k0 += __shfl_xor_sync(FULL, up ? part[0] : part[2], NL / 2);
  k1 += __shfl_xor_sync(FULL, up ? part[1] : part[3], NL / 2);
  float yv = up2 ? k1 : k0;
  yv += __shfl_xor_sync(FULL, up2 ? k0 : k1, NL / 4);
#pragma unroll
  for (int off = NL / 8; off > 0; off >>= 1)
    yv += __shfl_xor_sync(FULL, yv, off);
  return yv;
}

// The lane's 4 rows' states n0 .. n0+3 of a (B, H, P, N) state tensor
// (h0, h_last, or the backward's dh_last and dh0); a.vec: every such
// tensor of the call has 16-byte aligned rows.
__device__ __forceinline__ void m2_load_h(float (&h)[4][4], const float* src,
                                          const M2Args& a, int bb, int hh,
                                          int p, int n0) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const bool live = p + i < a.P;
    const long long off =
        (((long long)bb * a.H + hh) * a.P + (live ? p + i : 0)) * a.N + n0;
    load_states<4>(h[i], src + off, n0, a.N, live, a.vec);
  }
}

__device__ __forceinline__ void m2_store_h(const float (&h)[4][4], float* dst,
                                           const M2Args& a, int bb, int hh,
                                           int p, int n0) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const bool live = p + i < a.P;
    const long long off =
        (((long long)bb * a.H + hh) * a.P + (live ? p + i : 0)) * a.N + n0;
    store_states<4>(h[i], dst + off, n0, a.N, live, a.vec);
  }
}

// ---- staged path ------------------------------------------------------------
// Every M2_TS steps the block's threads load the next stage's inputs into
// registers (dt; x of the block's R rows; b, c widened to f32 and padded to
// NP = 4 NL with zeros) while they run the current stage from shared
// memory, then store them into the other of two buffers; one barrier a
// stage.  The thread that stages a step's dt also stages its decay.  After
// the barrier the block writes the stage's y tile out, coalesced.

template <int NL>
struct M2Stage {
  static constexpr int R = 4 * M2_NT / NL;
  static constexpr int NP = 4 * NL;
  // floats: (decay, dt)[TS], x[TS][R], y[TS][R], b[TS][NP], c[TS][NP]
  static constexpr int DD = 0, X = 2 * M2_TS, Y = X + M2_TS * R,
                       BV = Y + M2_TS * R, CV = BV + M2_TS * NP,
                       SIZE = CV + M2_TS * NP;
  static constexpr int MIN_BLOCKS = NL == 16 ? 5 : 1;  // blocks an SM
  static constexpr int XE = M2_TS * R / M2_NT;   // x (and y) a thread
  static constexpr int BE = M2_TS * NP / M2_NT;  // b (and c) a thread
  static_assert(M2_TS * R % M2_NT == 0 && M2_TS * NP % M2_NT == 0,
                "a stage is whole loads of the block");
  static_assert(X % 4 == 0 && R % 4 == 0 && BV % 4 == 0 && CV % 4 == 0 &&
                    SIZE % 4 == 0,
                "x, b and c are read as 16-byte vectors");
};

template <typename TX, int NL>
__global__ void __launch_bounds__(M2_NT, M2Stage<NL>::MIN_BLOCKS)
mamba2_staged_kernel(const M2Args a) {
  using St = M2Stage<NL>;
  constexpr int R = St::R, NP = St::NP;
  __shared__ __align__(16) float sm[2][St::SIZE];
  const int tid = threadIdx.x;
  const M2Lane<NL> ln(tid);
  const int n0 = 4 * ln.g;
  const int hh = blockIdx.y, bb = blockIdx.z, p0 = blockIdx.x * R;
  const int T = a.T, N = a.N, P = a.P;
  const float A2 = __ldg(a.A + hh) * LOG2E;
  const float* dtg = a.dt + bb * a.dt_sb + hh;
  const TX* xg = static_cast<const TX*>(a.x) + bb * a.x_sb +
                 (long long)hh * a.x_sh + p0;
  const TX* bg = static_cast<const TX*>(a.b) + bb * a.b_sb;
  const TX* cg = static_cast<const TX*>(a.c) + bb * a.c_sb;
  float* yg = a.y + ((long long)bb * T * a.H + hh) * P + p0;

  float dt_r = 0.f, x_r[St::XE], b_r[St::BE], c_r[St::BE];
  auto fetch = [&](int t0) {            // the stage from t0 into registers
    dt_r = tid < M2_TS && t0 + tid < T ? __ldg(dtg + (t0 + tid) * a.dt_st)
                                       : 0.f;
#pragma unroll
    for (int i = 0; i < St::XE; ++i) {
      const int e = tid + i * M2_NT, s = e / R, rr = e % R;
      x_r[i] = t0 + s < T && p0 + rr < P ? load(xg + (t0 + s) * a.x_st + rr)
                                         : 0.f;
    }
#pragma unroll
    for (int i = 0; i < St::BE; ++i) {
      const int e = tid + i * M2_NT, s = e / NP, n = e % NP;
      const bool ok = t0 + s < T && n < N;
      b_r[i] = ok ? load(bg + (t0 + s) * a.b_st + n) : 0.f;
      c_r[i] = ok ? load(cg + (t0 + s) * a.c_st + n) : 0.f;
    }
  };
  auto put = [&](float* st) {           // the registers into a buffer
    if (tid < M2_TS)
      *reinterpret_cast<float2*>(st + St::DD + 2 * tid) =
          make_float2(hopper::ex2(dt_r * A2), dt_r);
#pragma unroll
    for (int i = 0; i < St::XE; ++i) st[St::X + tid + i * M2_NT] = x_r[i];
#pragma unroll
    for (int i = 0; i < St::BE; ++i) {
      st[St::BV + tid + i * M2_NT] = b_r[i];
      st[St::CV + tid + i * M2_NT] = c_r[i];
    }
  };

  float h[4][4];
  m2_load_h(h, a.h0, a, bb, hh, p0 + ln.r0, n0);

  const int stages = (T + M2_TS - 1) / M2_TS;
  fetch(0);
  put(sm[0]);
  __syncthreads();
  for (int k = 0; k < stages; ++k) {
    const int t0 = k * M2_TS, left = T - t0;
    float* st = sm[k & 1];
    if (k + 1 < stages) fetch(t0 + M2_TS);
    auto step = [&](int s) {
      const float2 dd = *reinterpret_cast<const float2*>(st + St::DD + 2 * s);
      const float4 xv =
          *reinterpret_cast<const float4*>(st + St::X + s * R + ln.r0);
      const float dx[4] = {dd.y * xv.x, dd.y * xv.y, dd.y * xv.z,
                           dd.y * xv.w};
      st[St::Y + s * R + ln.mine] = m2_step<NL>(
          h, dd.x, dx,
          *reinterpret_cast<const float4*>(st + St::BV + s * NP + n0),
          *reinterpret_cast<const float4*>(st + St::CV + s * NP + n0), ln.g);
    };
    if (left >= M2_TS) {
#pragma unroll
      for (int s = 0; s < M2_TS; ++s) step(s);
    } else {
#pragma unroll 1
      for (int s = 0; s < left; ++s) step(s);
    }
    if (k + 1 < stages) put(sm[(k + 1) & 1]);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < St::XE; ++i) {  // the stage's y tile, coalesced
      const int e = tid + i * M2_NT, s = e / R, rr = e % R;
      if (s < left && p0 + rr < P)
        yg[(long long)(t0 + s) * a.H * P + rr] = st[St::Y + e];
    }
  }
  m2_store_h(h, a.h_last, a, bb, hh, p0 + ln.r0, n0);
}

// ---- direct path: short T, no shared memory ----------------------------------
// Each lane reads each step's dt, its rows' x and its 4 values of b and c
// from global memory and evaluates the step's decay itself (T <=
// M2_DIRECT_T: decode is T = 1, bound by the bytes of h0 and h_last).

template <typename TX, int NL>
__global__ void __launch_bounds__(M2_NT)
mamba2_direct_kernel(const M2Args a) {
  constexpr int R = 4 * M2_NT / NL;
  const M2Lane<NL> ln(threadIdx.x);
  const int n0 = 4 * ln.g;
  const int hh = blockIdx.y, bb = blockIdx.z, p = blockIdx.x * R + ln.r0;
  const int N = a.N, P = a.P;
  const float A2 = __ldg(a.A + hh) * LOG2E;
  const float* dtg = a.dt + bb * a.dt_sb + hh;
  const TX* xg = static_cast<const TX*>(a.x) + bb * a.x_sb +
                 (long long)hh * a.x_sh;
  const TX* bg = static_cast<const TX*>(a.b) + bb * a.b_sb + n0;
  const TX* cg = static_cast<const TX*>(a.c) + bb * a.c_sb + n0;
  const int pm = blockIdx.x * R + ln.mine;       // the row whose y it writes
  const bool writer = pm < P && ln.g % (NL / 4) == 0;
  float* yg = a.y + ((long long)bb * a.T * a.H + hh) * P + (writer ? pm : 0);
  float h[4][4];
  m2_load_h(h, a.h0, a, bb, hh, p, n0);
  for (int t = 0; t < a.T; ++t) {
    const float dt = __ldg(dtg + t * a.dt_st);
    float dx[4], bv[4], cv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      dx[i] = p + i < P ? dt * load(xg + t * a.x_st + p + i) : 0.f;
      const bool ok = n0 + i < N;
      bv[i] = ok ? load(bg + t * a.b_st + i) : 0.f;
      cv[i] = ok ? load(cg + t * a.c_st + i) : 0.f;
    }
    const float yv = m2_step<NL>(h, hopper::ex2(dt * A2), dx,
                                 make_float4(bv[0], bv[1], bv[2], bv[3]),
                                 make_float4(cv[0], cv[1], cv[2], cv[3]),
                                 ln.g);
    if (writer) yg[(long long)t * a.H * P] = yv;
  }
  m2_store_h(h, a.h_last, a, bb, hh, p, n0);
}

// ---- chunked path: the SSD form on the tensor cores ---------------------------
// Chunks of Q = SSD_Q steps.  With a_k = dt_k A_h, the segment sums
// S[i, j] = sum_{k = j+1 .. i} a_k (i >= j) and L = exp(S) (0 above the
// diagonal), a chunk's output and its state passed on are
//   y      = (L o C B^T) diag(dt) X + diag(exp(S[i, -1])) C h_prev^T
//   h_next = exp(S[Q-1, -1]) h_prev + X^T diag(dt_j exp(S[Q-1, j])) B,
// where C, B (Q x N) are the chunk's c and b, X (Q x P) its x and
// S[i, -1] = sum_{k = 0 .. i} a_k.  One block a (row block of 64 rows of P,
// head, batch row): 320 at zamba2's prefill, two an SM.  It walks the
// chunks in order with the (P, N) state in registers as a wgmma
// accumulator, so no chunk state goes to device memory.  Four products a
// chunk, each a 64-row wgmma tile (m64n64k16, issued in straight-line
// code), A always from registers:
//   G  = C B^T       Q x Q x N   A = c (ldmatrix), B = b, K-major;
//   y  = C h^T       Q x N x P   A = c, B = the state's bf16 terms;
//   y += M X         Q x Q x P   A = M = L o G diag(dt), B = x, MN-major;
//   h += X^T W       P x Q x N   A = x (ldmatrix, transposed),
//                                B = W = diag(w) b, MN-major;
// G's accumulator layout is the register-A layout of M X, so M never
// leaves registers, and c's and x's fragments are read from shared memory
// once a chunk for all the terms they meet.
//
// Precision: x, b and c arrive as bf16 and are exact operands; the float32
// side of a product (M, the state h, W) is split into three bf16 terms (two
// truncations and a rounding: ~22 bits; split3), so the products are
// exact and the wgmma sums are f32.  Two terms (~15 bits) miss the scans'
// rtol 1e-4 / atol 1e-4 at zamba2's widths, on any one of the three
// products (ref.mamba2_scan_chunked_ref's emulation of the split).  So a
// chunk is 4 + 3 (12 + 12 + 12) = 40 k16 steps.  The decays
// come from direct sums (a sum of the a_k of a range, never a difference
// of two running sums, which loses ~1e3 * 2^-24 of an exponent once a sum
// reaches -1e3, the size of the tolerance): L[i, j] is the product of
// the exponentials of three such sums
// over groups of 8 steps (see Tables below); entries above the diagonal
// are 0 before they multiply G, so no inf * 0 makes a NaN.  exp is ex2
// with log2(e) folded into A.
//
// On one warpgroup the chunk was bound by the latency of its float32 work
// (the tables, M's, W's and the state's splits: ~1000 instructions a
// thread and a chunk, with one warp on each scheduler), not by the tensor
// cores, which stood idle most of it (PERF.md, PR 20).  So a block is two
// warpgroups:
//   * the helper (72 registers) loads dt one chunk ahead, builds chunk k's
//     decay tables into one of two buffers and, once the main warpgroup's
//     C h^T has read the state's terms, writes W's three terms over them;
//   * the main one (184 registers; setmaxnreg moves them) issues the TMA
//     loads of x, b and c (two ring slots, chunk k + 1 issued during k),
//     loads an operand TMA cannot take (a base or stride not a multiple of
//     16 bytes, e.g. b and c sliced at an odd column) with its threads,
//     issues G and C h^T, forms M and issues M X while the helper writes
//     W, then the state product; while that runs it stages y in the
//     slot's b and c tiles for a TMA store (or stores it from registers
//     when P % 4 != 0), then writes the state's terms for the next chunk.
// Named barriers hand the tables, the state's terms and W between them.
// Steps past T read zeros (dt = 0: decay 1), rows past P and states past N
// are zero-filled, so a ragged chunk, P or N needs no branch around a
// product.
//
// What bounds it: at zamba2's prefill the 40 k16 steps of 320 blocks x 18
// chunks are 30.2 GFLOP, 0.031 ms at 989 TFLOP/s, and the bytes (x, y,
// h0, h_last, b, c, dt) ~0.044 ms at 3.35 TB/s: the design is bound by
// bytes, 0.044 ms, against 0.129 ms for the CUDA cores' three FP32
// instructions a state-step.  The measured times are in PERF.md.

constexpr int SSD_WG = 128;                  // a warpgroup
constexpr int SSD_NT = 2 * SSD_WG;           // main and helper
// registers a thread of each (2 blocks an SM: 128 a thread on average)
constexpr int SSD_MAIN_REGS = 184, SSD_HELP_REGS = 72;
constexpr uint32_t SSD_TILE = 64 * 128;      // 64 x 64 bf16, 128-byte rows
constexpr int SSD_G = 8;                     // steps a group of the sums
// named barriers (0 is __syncthreads): tables in (helper -> main), C h^T
// done (main -> helper), W ready (helper -> main), and each warpgroup's own
enum { BAR_IN = 1, BAR_YF = 2, BAR_W = 3, BAR_MAIN = 4, BAR_HELP = 5 };

struct SsdSmem {  // byte offsets from the 1024-aligned base
  static constexpr uint32_t SLOT = 3 * SSD_TILE;                 // x, b, c
  static constexpr uint32_t SPLIT = 2 * SLOT;                    // 3 terms
  // floats: a, dt, Ein, Eout [Q]; Win [Q][G]; Mid [G][G]; Epre [G + 1],
  // Epost [G], the group totals [G] (16 each)
  static constexpr uint32_t VEC = SPLIT + 3 * SSD_TILE;
  static constexpr uint32_t NVEC = 4 * SSD_Q + SSD_Q * SSD_G + SSD_G * SSD_G
                                   + 48;
  static constexpr uint32_t BAR = VEC + 2 * NVEC * 4;   // 2 tables; full[2]
  static constexpr size_t SIZE = 1024 + BAR + 2 * sizeof(uint64_t);
};

struct M2Maps {
  CUtensorMap x, b, c, y;
};

// TMA store of a box of shared memory into a 4-D tensor (one bulk group a
// commit); wait_read: until the groups have read their shared memory
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map,
                                             const void* src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n"
      :: "l"(map), "r"(hopper::smem_u32(src)), "r"(c0), "r"(c1), "r"(c2),
         "r"(c3)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" :: "n"(N) : "memory");
}

template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" :: "n"(N) : "memory");
}

// m64n64k16 bf16, A from registers, B K-major in shared memory (hopper.cuh's
// rs_bf16_tb takes B MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,"
      "%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,"
      "%24,%25,%26,%27,%28,%29,%30,%31"
      "}, {%32,%33,%34,%35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// Four 8 x 8 bf16 matrices from shared memory (lane l gives the address of
// row l % 8 of matrix l / 8) into the wgmma register-A layout; trans:
// each transposed
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_t(uint32_t (&r)[4],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr) : "memory");
}

// descriptors of k16 step kk of a 64-row tile: K-major (k within the
// 128-byte row) and MN-major (16 rows of k a step)
__device__ __forceinline__ uint64_t kdesc(uint32_t tile, int kk) {
  return hopper::desc_sw128(tile + kk * 32, 16);
}
__device__ __forceinline__ uint64_t mndesc(uint32_t tile, int kk) {
  return hopper::desc_sw128(tile + kk * 16 * 128, SSD_TILE);
}

// the byte of 16-byte chunk ch of row r in a 128-byte swizzled tile
__device__ __forceinline__ uint32_t sw128(int r, int ch) {
  return r * 128 + ((ch ^ (r & 7)) << 4);
}

// (x, y) as three bf16x2 terms o[0] + o[1] + o[2], x in the low halves:
// the top 16 bits of x (one byte permute for the pair), the top 16 bits of
// what that leaves, then the nearest bf16 of the rest (each remainder exact
// in f32): within 2^-22 |x| of x, and one conversion a pair (three
// roundings would take three)
__device__ __forceinline__ void split3(float x, float y, uint32_t (&o)[3]) {
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const uint32_t xb = __float_as_uint(x), yb = __float_as_uint(y);
    o[k] = __byte_perm(xb, yb, 0x7632);
    x -= __uint_as_float(xb & 0xffff0000u);
    y -= __uint_as_float(yb & 0xffff0000u);
  }
  const __nv_bfloat162 v = __floats2bfloat162_rn(x, y);
  o[2] = *reinterpret_cast<const uint32_t*>(&v);
}

// A 64 x 64 bf16 tile of rows rs elements apart from src into a 128-byte
// swizzled tile by a warpgroup's threads, for an operand TMA cannot take;
// zeros at rows >= nr or columns >= nc.
__device__ __forceinline__ void fill_ssd_tile(unsigned char* dst,
                                              const __nv_bfloat16* src,
                                              long long rs, int nr, int nc,
                                              int tid) {
  const unsigned short* s = reinterpret_cast<const unsigned short*>(src);
#pragma unroll 4
  for (int i = tid; i < 64 * 32; i += SSD_WG) {   // bf16 pairs
    const int r = i / 32, c = 2 * (i % 32);
    uint32_t lo = 0, hi = 0;
    if (r < nr) {
      const unsigned short* q = s + r * rs + c;
      if (c < nc) lo = __ldg(q);
      if (c + 1 < nc) hi = __ldg(q + 1);
    }
    *reinterpret_cast<uint32_t*>(dst + sw128(r, c / 8) + (c % 8) * 2) =
        lo | (hi << 16);
  }
}

__global__ void __launch_bounds__(SSD_NT, 2)
mamba2_chunked_kernel(const __grid_constant__ M2Maps maps, const M2Args a) {
  using Sm = SsdSmem;
  using bf16 = __nv_bfloat16;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = hopper::align1024(smem_raw);
  const uint32_t base = hopper::smem_u32(sm);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + Sm::BAR);
  auto tile = [&](int slot, int which) {                  // 0 x, 1 b, 2 c
    return sm + slot * Sm::SLOT + which * SSD_TILE;
  };
  // chunk k's decay tables (buffer k % 2), from direct sums over groups
  // of SSD_G steps (all in log2 units; k in group K = k / SSD_G):
  //   Ein[k]  = 2^(sum of a over K's steps up to k),
  //   Eout[k] = 2^(sum of a over K's steps after k) * dt_k,
  //   Win[i][c] = L[i, j] dt_j for j = SSD_G (i / SSD_G) + c <= i,
  //   Mid[I][J] = 2^(sum of a over the groups strictly between J and I),
  //   Epre[I] = 2^(sum over the groups before I), Epost[J] after J,
  // so that L[i, j] dt_j = Ein[i] Mid[I][J] Eout[j] for groups J < I,
  // exp(S[i, -1]) = Epre[I] Ein[i], w_j = Eout[j] Epost[J] and the chunk's
  // decay is Epre[SSD_G]: products of exponentials of sums, never an
  // exponential of a difference
  struct Tables {
    float *a2, *dt, *ein, *eout, *win, *mid, *epre, *epost, *tot;
  };
  auto tables = [&](int k) {
    float* f = reinterpret_cast<float*>(sm + Sm::VEC) + (k & 1) * Sm::NVEC;
    Tables t;
    t.a2 = f;                       // a_k log2(e)
    t.dt = t.a2 + SSD_Q;
    t.ein = t.dt + SSD_Q;
    t.eout = t.ein + SSD_Q;
    t.win = t.eout + SSD_Q;
    t.mid = t.win + SSD_Q * SSD_G;
    t.epre = t.mid + SSD_G * SSD_G;
    t.epost = t.epre + 16;
    t.tot = t.epost + 16;           // group totals, log2 units
    return t;
  };

  const int tid = threadIdx.x;
  const int p0 = blockIdx.x * SSD_Q, hh = blockIdx.y, bb = blockIdx.z;
  const int T = a.T, P = a.P, N = a.N, H = a.H;
  const int nch = (T + SSD_Q - 1) / SSD_Q;
  const uint32_t tx = SSD_TILE * (a.tma_x + a.tma_b + a.tma_c);
  if (tid == 0) {
    hopper::mbar_init(&full[0], 1);
    hopper::mbar_init(&full[1], 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (tid >= SSD_WG) {
    // ---- helper warpgroup: dt, the decay tables, W ----
    hopper::setmaxnreg_dec<SSD_HELP_REGS>();
    const int h = tid - SSD_WG;
    const float A2 = __ldg(a.A + hh) * LOG2E;
    const float* dtg = a.dt + bb * a.dt_sb + hh;
    float dtn = h < SSD_Q && h < T ? __ldg(dtg + h * a.dt_st) : 0.f;
    for (int k = 0; k < nch; ++k) {
      const int t0 = k * SSD_Q;
      const Tables tb = tables(k);
      if (h < SSD_Q) {
        tb.dt[h] = dtn;
        tb.a2[h] = dtn * A2;
      }
      if (k + 1 < nch)
        dtn = h < SSD_Q && t0 + SSD_Q + h < T
                  ? __ldg(dtg + (t0 + SSD_Q + h) * a.dt_st)
                  : 0.f;
      hopper::named_sync(BAR_HELP, SSD_WG);
      // the sums within a group: thread h < 64 Ein[h], Eout[h] and (the
      // group's last) its total; thread 64 + i row i of Win
      {
        const int i = h & (SSD_Q - 1), K0 = i & ~(SSD_G - 1),
                  c = i & (SSD_G - 1);
        float av[SSD_G];
#pragma unroll
        for (int m = 0; m < SSD_G; m += 4) {
          const float4 v = *reinterpret_cast<const float4*>(tb.a2 + K0 + m);
          av[m] = v.x; av[m + 1] = v.y; av[m + 2] = v.z; av[m + 3] = v.w;
        }
        if (h < SSD_Q) {
          float pin = 0.f, pout = 0.f;
#pragma unroll
          for (int m = 0; m < SSD_G; ++m) {
            pin += m <= c ? av[m] : 0.f;
            pout += m > c ? av[m] : 0.f;
          }
          tb.ein[i] = hopper::ex2(pin);
          tb.eout[i] = hopper::ex2(pout) * tb.dt[i];
          if (c == SSD_G - 1) tb.tot[i / SSD_G] = pin;
        } else {
          float dv[SSD_G], win[SSD_G], sum = 0.f;
#pragma unroll
          for (int m = 0; m < SSD_G; m += 4) {
            const float4 v = *reinterpret_cast<const float4*>(tb.dt + K0 + m);
            dv[m] = v.x; dv[m + 1] = v.y; dv[m + 2] = v.z; dv[m + 3] = v.w;
          }
#pragma unroll
          for (int m = SSD_G - 1; m >= 0; --m) {  // S[i, K0 + m], m = c .. 0
            win[m] = m <= c ? hopper::ex2(sum) * dv[m] : 0.f;
            sum += m <= c ? av[m] : 0.f;
          }
#pragma unroll
          for (int m = 0; m < SSD_G; m += 4)
            *reinterpret_cast<float4*>(tb.win + i * SSD_G + m) =
                make_float4(win[m], win[m + 1], win[m + 2], win[m + 3]);
        }
      }
      hopper::named_sync(BAR_HELP, SSD_WG);
      // then over the group totals: thread 8 I + J < 64 Mid[I][J] (I > J),
      // Epre[I] (I == J), Epost[I] (J == I + 1), and two threads the
      // chunk's decay Epre[G] and Epost[G - 1] = 1
      if (h < SSD_Q) {
        const int I = h / SSD_G, J = h % SSD_G;
        const float4 u0 = *reinterpret_cast<const float4*>(tb.tot);
        const float4 u1 = *reinterpret_cast<const float4*>(tb.tot + 4);
        const float tot[SSD_G] = {u0.x, u0.y, u0.z, u0.w,
                                  u1.x, u1.y, u1.z, u1.w};
        int lo = 0, hi = 0;
        float* dst = nullptr;
        if (I > J) {
          lo = J + 1, hi = I, dst = tb.mid + SSD_G * I + J;
        } else if (I == J) {
          lo = 0, hi = I, dst = tb.epre + I;
        } else if (J == I + 1) {
          lo = J, hi = SSD_G, dst = tb.epost + I;
        } else if (I == 0 && J == 2) {
          lo = 0, hi = SSD_G, dst = tb.epre + SSD_G;
        } else if (I == 0 && J == 3) {
          lo = SSD_G, hi = SSD_G, dst = tb.epost + SSD_G - 1;
        }
        float sum = 0.f;
#pragma unroll
        for (int K = 0; K < SSD_G; ++K)
          sum += K >= lo && K < hi ? tot[K] : 0.f;
        if (dst != nullptr) *dst = hopper::ex2(sum);
      }
      hopper::named_arrive(BAR_IN, 2 * SSD_WG);   // the tables are ready
      // W = diag(w) b in three terms over the state's, once the main
      // warpgroup's C h^T has read them
      hopper::named_sync(BAR_YF, 2 * SSD_WG);
      {
        const unsigned char* bt = tile(k & 1, 1);
#pragma unroll
        for (int q4 = 0; q4 < 4; ++q4) {
          const int ch = h + SSD_WG * q4;       // 16-byte chunk, row ch / 8
          const uint4 v = *reinterpret_cast<const uint4*>(bt + ch * 16);
          const int jw = ch / 8;
          const float w = tb.eout[jw] * tb.epost[jw / SSD_G];
          const uint32_t in[4] = {v.x, v.y, v.z, v.w};
          uint32_t o[3][4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            uint32_t t3[3];
            split3(__uint_as_float(in[q] << 16) * w,
                   __uint_as_float(in[q] & 0xffff0000u) * w, t3);
#pragma unroll
            for (int k3 = 0; k3 < 3; ++k3) o[k3][q] = t3[k3];
          }
#pragma unroll
          for (int k3 = 0; k3 < 3; ++k3)
            *reinterpret_cast<uint4*>(sm + Sm::SPLIT + k3 * SSD_TILE +
                                      ch * 16) =
                make_uint4(o[k3][0], o[k3][1], o[k3][2], o[k3][3]);
        }
      }
      hopper::fence_proxy_async();
      hopper::named_arrive(BAR_W, 2 * SSD_WG);
    }
    return;
  }

  // ---- main warpgroup: the products, M, the state's terms, y ----
  hopper::setmaxnreg_inc<SSD_MAIN_REGS>();
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int r0 = 16 * warp + g;   // fragment rows r0 and r0 + 8
  const bf16* xg = static_cast<const bf16*>(a.x) + bb * a.x_sb +
                   (long long)hh * a.x_sh + p0;
  const bf16* bg = static_cast<const bf16*>(a.b) + bb * a.b_sb;
  const bf16* cg = static_cast<const bf16*>(a.c) + bb * a.c_sb;
  const bool fills = !(a.tma_x && a.tma_b && a.tma_c);

  auto issue_tma = [&](int k) {   // chunk k's TMA operands into slot k % 2
    const int s = k & 1, t0 = k * SSD_Q;
    hopper::mbar_arrive_expect_tx(&full[s], tx);
    if (a.tma_x)
      hopper::tma_load_4d(tile(s, 0), &maps.x, &full[s], p0, hh, t0, bb);
    if (a.tma_b) hopper::tma_load_3d(tile(s, 1), &maps.b, &full[s], 0, t0, bb);
    if (a.tma_c) hopper::tma_load_3d(tile(s, 2), &maps.c, &full[s], 0, t0, bb);
  };
  if (tid == 0 && tx) {     // chunks 0 and 1; chunk k + 1 is issued in k
    issue_tma(0);
    if (nch > 1) issue_tma(1);
  }

  // the state in the accumulator layout: hs[4j + e] is row
  // p0 + r0 + 8 (e >> 1), state 8j + 2 t4 + (e & 1)
  const long long hrow = ((long long)bb * H + hh) * P + p0;
  float hs[32];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = r0 + 8 * (e >> 1), n = 8 * j + 2 * t4 + (e & 1);
      hs[4 * j + e] =
          p0 + r < P && n < N ? __ldg(a.h0 + (hrow + r) * N + n) : 0.f;
    }
  // the state's three bf16 terms, K-major (rows p, states n), for C h^T
  auto put_state = [&]() {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        uint32_t o[3];
        split3(hs[4 * j + 2 * half], hs[4 * j + 2 * half + 1], o);
        const uint32_t off = sw128(r0 + 8 * half, j) + 4 * t4;
#pragma unroll
        for (int k3 = 0; k3 < 3; ++k3)
          *reinterpret_cast<uint32_t*>(sm + Sm::SPLIT + k3 * SSD_TILE +
                                       off) = o[k3];
      }
  };
  put_state();
  hopper::fence_proxy_async();

  float* yg = a.y + ((long long)bb * T * H + hh) * P + p0;
  const bool pairs = P % 2 == 0;   // y's column pairs are 8-byte aligned
  float gacc[32], y[32];
  uint32_t mf[3][4][4];            // M's terms as register A fragments
  uint32_t af[4][4];               // C's, then X^T's, A fragments
  const int lq = lane / 8, lr = lane % 8;   // ldmatrix: matrix, its row

  for (int k = 0; k < nch; ++k) {
    const int s = k & 1, t0 = k * SSD_Q;
    const Tables tb = tables(k);
    // (1) the operands TMA does not bring; the tables of chunk k
    if (fills) {
      if (!a.tma_x)
        fill_ssd_tile(tile(s, 0), xg + t0 * a.x_st, a.x_st, T - t0, P - p0,
                      tid);
      if (!a.tma_b)
        fill_ssd_tile(tile(s, 1), bg + t0 * a.b_st, a.b_st, T - t0, N, tid);
      if (!a.tma_c)
        fill_ssd_tile(tile(s, 2), cg + t0 * a.c_st, a.c_st, T - t0, N, tid);
      hopper::fence_proxy_async();
    }
    hopper::named_sync(BAR_IN, 2 * SSD_WG);
    if (tx) hopper::mbar_wait(&full[s], (k >> 1) & 1);
    const uint32_t xa = base + s * Sm::SLOT, ba = xa + SSD_TILE,
                   ca = xa + 2 * SSD_TILE, sa = base + Sm::SPLIT;

    // (2) G = C B^T and y = C h^T, C as register fragments read once for
    // all four (A from shared memory would be read again for each)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int R = 16 * warp + 8 * (lq & 1) + lr;       // row i of c
      ldmatrix_x4(af[kk], ca + sw128(R, 2 * kk + (lq >> 1)));
    }
    hopper::fence_regs(y);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) hopper::fence_regs(af[kk]);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs(gacc, af[kk], kdesc(ba, kk), kk > 0);
#pragma unroll
    for (int k3 = 0; k3 < 3; ++k3)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs(y, af[kk], kdesc(sa + k3 * SSD_TILE, kk), k3 + kk > 0);
    hopper::wgmma_commit();
    // slot s ^ 1 is free once chunk k - 1's y has been read out of it
    if (tid == 0 && k > 0) {
      if (a.tma_y) bulk_wait_read<0>();
      if (tx && k + 1 < nch) issue_tma(k + 1);
    }
    hopper::wgmma_wait<0>();
    hopper::fence_regs(gacc);
    hopper::fence_regs(y);
    hopper::named_arrive(BAR_YF, 2 * SSD_WG);   // C h^T has read the terms

    // (3) y rows scaled by exp(S[i, -1]); M = L o G diag(dt) in three terms
    // (L diag(dt) from the tables: zero above the diagonal before it
    // multiplies G); y += M X
    {
      const int I0 = r0 / SSD_G;
      const float e0 = tb.epre[I0] * tb.ein[r0],
                  e1 = tb.epre[I0 + 1] * tb.ein[r0 + 8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        y[4 * j] *= e0;
        y[4 * j + 1] *= e0;
        y[4 * j + 2] *= e1;
        y[4 * j + 3] *= e1;
      }
      float ein[2], mid[2][SSD_G];
      float2 win[2];
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const int r = r0 + 8 * h2;
        ein[h2] = tb.ein[r];
        win[h2] = *reinterpret_cast<const float2*>(tb.win + r * SSD_G +
                                                   2 * t4);
#pragma unroll
        for (int J = 0; J < SSD_G; J += 4) {
          const float4 v = *reinterpret_cast<const float4*>(
              tb.mid + SSD_G * (I0 + h2) + J);
          mid[h2][J] = v.x; mid[h2][J + 1] = v.y;
          mid[h2][J + 2] = v.z; mid[h2][J + 3] = v.w;
        }
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int rr = 0; rr < 4; ++rr) {
          const int J = 2 * kk + (rr >> 1), h2 = rr & 1, I = I0 + h2;
          const float2 eo =
              *reinterpret_cast<const float2*>(tb.eout + SSD_G * J + 2 * t4);
          const float f = J < I ? ein[h2] * mid[h2][J] : 0.f;
          const float lx = J == I ? win[h2].x : f * eo.x;
          const float ly = J == I ? win[h2].y : f * eo.y;
          uint32_t o[3];
          split3(gacc[8 * kk + 2 * rr] * lx, gacc[8 * kk + 2 * rr + 1] * ly,
                 o);
#pragma unroll
          for (int k3 = 0; k3 < 3; ++k3) mf[k3][kk][rr] = o[k3];
        }
    }
    hopper::fence_regs(y);
#pragma unroll
    for (int k3 = 0; k3 < 3; ++k3)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) hopper::fence_regs(mf[k3][kk]);
    hopper::wgmma_fence();
#pragma unroll
    for (int k3 = 0; k3 < 3; ++k3)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        hopper::Wgmma<64>::rs_bf16_tb(y, mf[k3][kk], mndesc(xa, kk), 1);
    hopper::wgmma_commit();

    // (4) h = exp(S[Q-1, -1]) h + X^T W, once the helper has written W;
    // X^T as register fragments (x transposed by ldmatrix), read once for
    // W's three terms.  C's fragments are done with: their products
    // finished before (3)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int j = 16 * kk + 8 * (lq >> 1) + lr;        // step j of x
      ldmatrix_x4_t(af[kk], xa + sw128(j, 2 * warp + (lq & 1)));
    }
    hopper::named_sync(BAR_W, 2 * SSD_WG);
    {
      const float dec = tb.epre[SSD_G];
#pragma unroll
      for (int i = 0; i < 32; ++i) hs[i] *= dec;
    }
    hopper::fence_regs(hs);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) hopper::fence_regs(af[kk]);
    hopper::wgmma_fence();
#pragma unroll
    for (int k3 = 0; k3 < 3; ++k3)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        hopper::Wgmma<64>::rs_bf16_tb(hs, af[kk],
                                      mndesc(sa + k3 * SSD_TILE, kk), 1);
    hopper::wgmma_commit();

    // (5) y out while the state product runs, once M X (the older group)
    // is done: through TMA from slot s (its b and c tiles, which nothing
    // reads now: two boxes of 32 columns, 128-byte swizzled), stored by
    // thread 0 once every thread has written its part, or from registers
    hopper::wgmma_wait<1>();
    hopper::fence_regs(y);
    if (a.tma_y) {
      unsigned char* st = tile(s, 1);
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int r = r0 + 8 * half;
          const uint32_t off = (j >> 2) * SSD_TILE +
                               sw128(r, 2 * (j & 3) + (t4 >> 1)) +
                               (t4 & 1) * 8;
          *reinterpret_cast<float2*>(st + off) =
              make_float2(y[4 * j + 2 * half], y[4 * j + 2 * half + 1]);
        }
      hopper::fence_proxy_async();
      hopper::named_sync(BAR_MAIN, SSD_WG);
      if (tid == 0) {
        tma_store_4d(&maps.y, st, p0, hh, t0, bb);
        if (p0 + 32 < P)
          tma_store_4d(&maps.y, st + SSD_TILE, p0 + 32, hh, t0, bb);
        bulk_commit();
      }
    } else {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int tt = t0 + r0 + 8 * half;
        if (tt >= T) continue;
        float* row = yg + (long long)tt * H * P;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int p = 8 * j + 2 * t4;
          const float v0 = y[4 * j + 2 * half], v1 = y[4 * j + 2 * half + 1];
          if (pairs && p0 + p + 1 < P) {
            *reinterpret_cast<float2*>(row + p) = make_float2(v0, v1);
          } else {
            if (p0 + p < P) row[p] = v0;
            if (p0 + p + 1 < P) row[p + 1] = v1;
          }
        }
      }
    }

    // (6) the state's terms for the next chunk, once every warp's state
    // product is done with W
    hopper::wgmma_wait<0>();
    hopper::fence_regs(hs);
    hopper::named_sync(BAR_MAIN, SSD_WG);
    put_state();
    hopper::fence_proxy_async();
  }

#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = r0 + 8 * (e >> 1), n = 8 * j + 2 * t4 + (e & 1);
      if (p0 + r < P && n < N) a.h_last[(hrow + r) * N + n] = hs[4 * j + e];
    }
  if (tid == 0 && a.tma_y) bulk_wait<0>();
}

// x (B, T, H, P) as a 4-D map (P, H, T, B) and b or c (B, T, N) as a 3-D
// map (N, T, B), boxes of 64 x 64 bf16 (one head, one batch row), 128-byte
// swizzled; a stride of a size-1 dim is not used and is given packed
bool map_ssd_x(CUtensorMap* m, const M2Args& a) {
  const uint64_t dims[4] = {(uint64_t)a.P, (uint64_t)a.H, (uint64_t)a.T,
                            (uint64_t)a.B};
  const uint64_t sh = a.H == 1 ? (uint64_t)(a.P + 7) / 8 * 8 : a.x_sh;
  const uint64_t sb = a.B == 1 ? (uint64_t)a.x_st * a.T : a.x_sb;
  const uint64_t strides[3] = {2 * sh, 2 * (uint64_t)a.x_st, 2 * sb};
  const uint32_t box[4] = {64, 1, 64, 1};
  return hopper_host::make_map(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, a.x,
                               dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

bool map_ssd_bc(CUtensorMap* m, const void* p, long long sb, long long st,
                const M2Args& a) {
  const uint64_t dims[3] = {(uint64_t)a.N, (uint64_t)a.T, (uint64_t)a.B};
  const uint64_t bs = a.B == 1 ? (uint64_t)st * a.T : (uint64_t)sb;
  const uint64_t strides[2] = {2 * (uint64_t)st, 2 * bs};
  const uint32_t box[3] = {64, 64, 1};
  return hopper_host::make_map(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, p,
                               dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

// y (B, T, H, P) float32, contiguous, as a 4-D map (P, H, T, B), boxes of
// 32 columns (128 bytes, swizzled) by one head by 64 steps
bool map_ssd_y(CUtensorMap* m, const M2Args& a) {
  const uint64_t dims[4] = {(uint64_t)a.P, (uint64_t)a.H, (uint64_t)a.T,
                            (uint64_t)a.B};
  const uint64_t row = 4ull * a.P;
  const uint64_t strides[3] = {row, row * a.H, row * a.H * a.T};
  const uint32_t box[4] = {32, 1, 64, 1};
  return hopper_host::make_map(m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, a.y,
                               dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

cudaError_t launch_chunked(const M2Args& a, const M2Plan& pl,
                           cudaStream_t st) {
  M2Maps maps;
  memset(&maps, 0, sizeof maps);
  if ((pl.tma_y && !map_ssd_y(&maps.y, a)) ||
      (pl.tma_x && !map_ssd_x(&maps.x, a)) ||
      (pl.tma_b && !map_ssd_bc(&maps.b, a.b, a.b_sb, a.b_st, a)) ||
      (pl.tma_c && !map_ssd_bc(&maps.c, a.c, a.c_sb, a.c_st, a)))
    return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      mamba2_chunked_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SsdSmem::SIZE);
  if (e != cudaSuccess) return e;
  mamba2_chunked_kernel<<<dim3(pl.gx, pl.gy, pl.gz), SSD_NT, SsdSmem::SIZE,
                          st>>>(maps, a);
  return cudaGetLastError();
}

template <typename TX, int NL>
cudaError_t launch_m2(const M2Args& a, const M2Plan& pl, cudaStream_t st) {
  const dim3 grid(pl.gx, pl.gy, pl.gz);
  if (pl.path == M2_DIRECT)
    mamba2_direct_kernel<TX, NL><<<grid, M2_NT, 0, st>>>(a);
  else
    mamba2_staged_kernel<TX, NL><<<grid, M2_NT, 0, st>>>(a);
  return cudaGetLastError();
}

template <typename TX>
cudaError_t dispatch_m2(const M2Args& a, const M2Plan& pl, cudaStream_t st) {
  if (pl.path == M2_CHUNKED)
    return sizeof(TX) == 2 ? launch_chunked(a, pl, st) : cudaErrorInvalidValue;
  switch (pl.NL) {
    case 4: return launch_m2<TX, 4>(a, pl, st);
    case 8: return launch_m2<TX, 8>(a, pl, st);
    case 16: return launch_m2<TX, 16>(a, pl, st);
    case 32: return launch_m2<TX, 32>(a, pl, st);
  }
  return cudaErrorInvalidValue;
}

// the arguments both Mamba-2 C entry points take, checked
bool m2_args(M2Args* a, const float* dt, const void* x, const void* b,
             const void* c, const float* A, const float* h0, float* y,
             float* h_last, int dtype, int B, int T, int H, int P, int N,
             long long dt_sb, long long dt_st, long long x_sb, long long x_st,
             long long x_sh, long long b_sb, long long b_st, long long c_sb,
             long long c_st) {
  if (B <= 0 || T <= 0 || H <= 0 || P <= 0 || N <= 0 || N > MAX_N ||
      B > 65535 || H > 65535 || (dtype != 0 && dtype != 1))
    return false;
  *a = M2Args{dt, x, b, c, A, h0, y, h_last, dtype, B, T, H, P, N,
              dt_sb, dt_st, x_sb, x_st, x_sh, b_sb, b_st, c_sb, c_st,
              0, 0, 0, 0, 0};
  return true;
}


// ---- mamba2_scan_bwd: the backward of the Mamba-2 form ----------------------
// Stands in for jax.grad of repro/models/ssm.py::fused_ssm_scan as
// mamba2_block drives it (make_chunk / emit_chunk, the chunk body under
// jax.checkpoint, so the reference too recomputes its states).  From the
// forward's operands, dy (B, T, H, P) and dh_last (B, H, P, N), both f32,
// it gives, with a_t = dt_t A_h, decay_t = exp(a_t) and g the state's
// gradient walked from t = T - 1 down (g_t = decay_{t+1} g_{t+1} +
// dy_t c_t^T, starting from dh_last):
//   dx_t = dt_t (g_t b_t)            dc_t = sum_{h,p} dy_t h_t
//   db_t = sum_h dt_t (x_t^T g_t)    da_t = decay_t <g_t, h_{t-1}>
//   ddt_t = A_h da_t + <g_t, x_t b_t^T>,  dA_h = sum_{b,t} dt_t da_t,
//   dh0 = decay_0 g_0
// (ref.mamba2_scan_bwd_ref, step by step).  Two forms, chosen from the
// shape and dtype as the forward's paths are (plan_mamba2_bwd):
//   * chunked (bf16 x, b, c, N <= 64, T > 8; zamba2's training): the SSD
//     form's backward on the tensor cores, below at
//     mamba2_bwd_walk_kernel and mamba2_bwd_tile_kernel;
//   * CUDA cores (float32, N > 64 or T <= 8), this section's kernel.
// What bounds the function: it reads dt, x, b, c, A, h0, dy, dh_last and
// writes their gradients once (at zamba2's training shape, B=4, T=2048,
// H=80, P=N=64, bf16, 0.36 GB, 0.108 ms at 3.35 TB/s), and its least
// work, the chunked form's products differentiated, is 32 GFLOP (0.065 ms
// at the TF32 rate).  The chunked form's own floor is its bytes: the
// function's, the walks' second reads of x and dy, and its scratch (h_in
// and dh_out, f32, written by the walks and read by the tiles, 0.67 GB,
// and the partial sums), 1.38 GB, 0.41 ms at zamba2's shape, over its
// bf16 products (112 k16 steps a (chunk, head) tile and 12 a chunk of
// each walk, 0.18 ms at 989 TFLOP/s); measured times are in PERF.md.
//
// The CUDA-core form: the reverse walk needs each h_t in reverse order;
// they are recomputed, never recovered from h_t by
// dividing by the decay (which underflows to 0: dt A = -1000 is a test
// case), in three levels:
//   1. a forward pass over T stores the state at every BW_Q-step chunk
//      boundary in device memory (cb);
//   2. walking the chunks in reverse, a chunk is run forward again from
//      its boundary, storing the state at every BW_SC-step sub-chunk
//      boundary (sb, a block's own slots, small enough to stay in L2);
//   3. walking its sub-chunks in reverse, a sub-chunk is run forward from
//      its boundary into shared memory (h_{t0-1} .. h_{t0+SC-1}), then
//      walked in reverse with g in registers.
// Blocks and lanes are the CUDA-core forward's (M2Lane: a lane holds a
// 4 x 4 tile of rows and states, one block a row block, head and batch
// row), and every state slot a thread writes (cb, sb, the shared history)
// is read back only by that thread.  A sub-chunk's inputs (dt and its
// decay, x, dy, b, c) are staged in shared memory by the whole block, the
// loads of its BW_SC steps in flight together, into one of two buffers;
// they are fetched into registers one sub-chunk ahead (with the next
// sub-chunk's entry state), so the loads run under the current
// sub-chunk's work, and a sub-chunk costs one or two barriers.  The step
// loop is FMAs, shared-memory traffic and one 5-shuffle chain: the other
// partial sums go to shared memory and are summed after the sub-chunk.
// BW_SC = 4 keeps the history and the partial sums (~72 KB at N <= 64)
// to three blocks an SM.  Reading each step's inputs from device memory in
// the step, and reducing every sum by shuffles in the step, ran 3x slower
// (the forms timed are in PERF.md).
//
// b and c are shared by every head, and da_t and <g, x b^T> are sums over
// a head's rows: each reverse step leaves its lanes' partial sums in shared
// memory (da and <g, x b^T> summed over the warp first, with shuffles),
// and after the sub-chunk the block sums them in a fixed order, writing dx
// and, per (b, t, head, row block), the partial sums of db, dc, da and
// <g, x b^T> to device memory; a second kernel sums db and dc over (head,
// row block) and a third ddt and dA, each in a fixed order.  There are no
// float atomics: two calls are bit-identical.
//
// Every state-step runs on the CUDA cores: three forward steps (one a
// level) and the reverse step, ~13 FP32 instructions (2.7 G state-steps
// at zamba2's training shape, ~1.04 ms at the issue rate), plus its
// scratch traffic (~0.9 GB); it measured 6.24 ms there (PERF.md, PR 21),
// which is why bf16 calls take the chunked form.

constexpr int BW_Q = 64;                 // steps a chunk (level 1)
constexpr int BW_SC = 4;                 // steps a sub-chunk (level 2)
constexpr int BW_SUB = BW_Q / BW_SC;
constexpr int BW_TILE = 16 * M2_NT;      // floats of a block's state slot

struct M2Bwd {
  M2Args f;               // the forward's operands (y, h_last unused)
  const float* dy;        // (B, T, H, P) f32, contiguous
  const float* dh_last;   // (B, H, P, N) f32, contiguous
  float* ddt;             // (B, T, H) f32
  void* dx;               // (B, T, H, P), x's dtype, contiguous
  void* db;               // (B, T, N), b's dtype, contiguous
  void* dc;
  float* dA;              // (H,)
  float* dh0;             // (B, H, P, N) f32
  float* cb;              // scratch of the CUDA-core form: chunk states
  float* sb;              // and sub-chunk states
  float* hin;             // scratch of the chunked form: the state entering
  float* dhout;           // and the gradient leaving every chunk (B, K, H,
                          // P, N); of both, the partial sums of db, dc
  float* dbh;             // (B, T, parts, N), parts H RB or head groups RB
  float* dch;
  float* dah;             // and of da and ddt's direct terms (B, T, H, RB)
  float* xgbh;
  int NL, R, RB, nchunks, heads, parts;
};

// the chunked form's blocks and shared memory (its kernels are below)
constexpr int CB_NT = 128;              // one warpgroup a block
// heads a tile block walks: 20 makes zamba2's 80 heads 4 groups, 512
// blocks at two an SM (tools/mamba2_scan_baseline.py --heads times others)
constexpr int CB_HEADS = 20;

struct WalkSmem {   // byte offsets from the 1024-aligned base
  // two b or c tiles; two chunks of x (rows of 64 bf16) or dy (64 f32),
  // each row padded by 16 bytes so that the A fragments' reads down a
  // column meet no bank twice; then floats a2, dt, the scales [Q] and E
  static constexpr int UROW2 = 2 * SSD_Q + 16, UROW4 = 4 * SSD_Q + 16;
  static constexpr uint32_t V = 0, U = 2 * SSD_TILE, UBUF = SSD_Q * UROW4,
                            VEC = U + 2 * UBUF;
  static constexpr size_t SIZE = 1024 + VEC + (3 * SSD_Q + 4) * 4;
};

struct CbSmem {     // byte offsets from the 1024-aligned base
  // b, c, x; dY's and dh_out's (later dG^T's) three terms; the block's
  // dB and dC^T, f32, each thread's 32 elements at [i][thread]
  static constexpr uint32_t TB = 0, TC = SSD_TILE, TX = 2 * SSD_TILE,
                            SY = 3 * SSD_TILE, SD = 6 * SSD_TILE,
                            ACB = 9 * SSD_TILE, ACC = ACB + 32 * CB_NT * 4,
                            VEC = ACC + 32 * CB_NT * 4;
  // floats: the tables a2, dt, ein, eout [Q], win [Q][G], mid [G][G],
  // epre, epost, tot [16 each]; then the head's sums: the rectangle's and
  // r's column sums a warp [4][Q] each, r, ew v, w v, K's row sums, the
  // suffix sums of r and the prefix sums of w v [Q], <dh_out, h_in> [4]
  static constexpr uint32_t NTAB = 4 * SSD_Q + SSD_Q * SSD_G + SSD_G * SSD_G
                                   + 48;
  static constexpr uint32_t NRED = 14 * SSD_Q + 4;
  static constexpr size_t SIZE = 1024 + VEC + (NTAB + NRED) * 4;
};
static_assert(2 * (CbSmem::SIZE + 1024) <= 233472,
              "two tile blocks an SM");

enum { M2B_CUDACORE = 0, M2B_CHUNKED = 1 };

// How a backward call runs: the path; on the CUDA-core path NL lanes a row
// group, R rows a block, RB row blocks a head, chunks of BW_Q steps; on the
// chunked path 64 rows of P a block, RB row blocks, chunks of SSD_Q steps
// and `heads` heads a tile block; the main kernel's shared memory and the
// scratch the call needs, in floats.
struct M2BwdPlan {
  int path, NL, R, RB, nchunks, heads;
  long long smem, scratch;
};

M2BwdPlan plan_mamba2_bwd(int B, int T, int H, int P, int N, int dtype) {
  M2BwdPlan pl{};
  pl.nchunks = (T + BW_Q - 1) / BW_Q;
  if (dtype == 1 && N <= SSD_MAX_N && T > M2_DIRECT_T) {
    pl.path = M2B_CHUNKED;
    pl.R = SSD_Q;
    pl.RB = (P + SSD_Q - 1) / SSD_Q;
    pl.heads = CB_HEADS;
    pl.smem = CbSmem::SIZE;
    const long long groups = (H + CB_HEADS - 1) / CB_HEADS;
    pl.scratch = 2ll * B * pl.nchunks * H * P * N +
                 2ll * B * T * groups * pl.RB * N + 2ll * B * T * H * pl.RB;
    return pl;
  }
  pl.path = M2B_CUDACORE;
  pl.NL = lanes_for(N, 4);
  if (pl.NL < 4) pl.NL = 4;
  pl.R = 4 * M2_NT / pl.NL;
  pl.RB = (P + pl.R - 1) / pl.R;
  // the history (BW_SC + 1 slots), two sub-chunks' staged inputs and the
  // reverse steps' partial sums (BwStage below: a step's NL (R + 4) of
  // g b, 2 R NP = 8 M2_NT of x^T g and dy^T h, 8 of the warps' sums)
  pl.smem = 4ll * ((BW_SC + 1) * BW_TILE +
                   2 * (2 * BW_SC + 2 * BW_SC * (4 * M2_NT / pl.NL) +
                        2 * BW_SC * 4 * pl.NL) +
                   BW_SC * (4 * M2_NT + 4 * pl.NL + 8 * M2_NT + 8));
  const long long blocks = (long long)B * H * pl.RB;
  const long long rows = (long long)B * T * H * pl.RB;
  pl.scratch = blocks * (pl.nchunks + BW_SUB) * BW_TILE + rows * (2 * N + 2);
  return pl;
}

// A block's state slot (16 floats a thread, as 4 float4 at [i][thread]);
// plain loads, not __ldg: the thread itself wrote it in this launch
__device__ __forceinline__ void slot_store(float* s, const float (&h)[4][4]) {
  float4* q = reinterpret_cast<float4*>(s) + threadIdx.x;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    q[i * M2_NT] = make_float4(h[i][0], h[i][1], h[i][2], h[i][3]);
}

__device__ __forceinline__ void slot_load(float (&h)[4][4], const float* s) {
  const float4* q = reinterpret_cast<const float4*>(s) + threadIdx.x;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 v = q[i * M2_NT];
    h[i][0] = v.x; h[i][1] = v.y; h[i][2] = v.z; h[i][3] = v.w;
  }
}

__device__ __forceinline__ void store_as(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// A sub-chunk's inputs, staged in shared memory by the whole block (the
// loads of its BW_SC steps in flight together, coalesced): dt and its
// decay, x and dy of the block's R rows (as f32), b and c padded to NP =
// 4 NL states with zeros.  Steps past T read dt = 0 (decay 1) and zeros,
// so a step runs unguarded and leaves g and h as they were.  Then the
// reverse steps' partial sums, summed after the sub-chunk: each lane's
// g b of its 4 rows (GB, [step][lane of the row group][row], rows padded
// to R + 4 so that neither the lanes' 16-byte stores nor the sums' reads
// down a row meet in a bank), its rows' x^T g and dy^T h over its 4
// states (BC, [step][row group][db | dc]), and each warp's <g, h_{t-1}>
// and <g, x b^T> (DA, [step][warp][2]).
template <int NL>
struct BwStage {
  static constexpr int R = 4 * M2_NT / NL, NP = 4 * NL;
  static constexpr int DT = 0, DEC = BW_SC, X = 2 * BW_SC,
                       DY = X + BW_SC * R, BV = DY + BW_SC * R,
                       CV = BV + BW_SC * NP, SIZE = CV + BW_SC * NP;
  // x (and dy), b (and c) a thread, the last load guarded where the
  // stage is not whole loads of the block
  static constexpr int XE = (BW_SC * R + M2_NT - 1) / M2_NT;
  static constexpr int BE = (BW_SC * NP + M2_NT - 1) / M2_NT;
  static constexpr int RP = R + 4;               // a padded GB row
  static constexpr int GB = 0, BC = GB + BW_SC * NL * RP,
                       DA = BC + BW_SC * (R / 4) * 2 * NP,
                       RED = DA + BW_SC * 4 * 2;
  static_assert(X % 4 == 0 && R % 4 == 0 && NP % 4 == 0 && BC % 4 == 0,
                "x, dy, b, c and the partial sums move as 16-byte vectors");
  static_assert(BW_SC <= M2_NT, "a thread stages each step's dt");
};

template <int NL>
constexpr long long bw_smem_bytes() {
  using S = BwStage<NL>;
  return 4ll * ((BW_SC + 1) * BW_TILE + 2 * S::SIZE + S::RED);
}

template <typename TX, int NL>
__global__ void __launch_bounds__(M2_NT)
mamba2_bwd_kernel(const M2Bwd a) {
  using S = BwStage<NL>;
  constexpr int R = S::R, NP = S::NP, RG = R / 4;
  extern __shared__ __align__(16) float bw_smem[];
  float* hist = bw_smem;                        // BW_SC + 1 state slots
  float* stage = hist + (BW_SC + 1) * BW_TILE;  // two sub-chunks' inputs
  float* red = stage + 2 * S::SIZE;             // the partial sums
  const M2Args& f = a.f;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const M2Lane<NL> ln(tid);
  const int n0 = 4 * ln.g, rg = ln.r0 / 4;
  const int rb = blockIdx.x, hh = blockIdx.y, bb = blockIdx.z;
  const int p0 = rb * R, p = p0 + ln.r0, T = f.T, N = f.N, P = f.P, H = f.H;
  const long long blk = ((long long)bb * H + hh) * a.RB + rb;
  float* cb = a.cb + blk * a.nchunks * BW_TILE;
  float* sb = a.sb + blk * BW_SUB * BW_TILE;
  const float A2 = __ldg(f.A + hh) * LOG2E;
  const float* dtg = f.dt + bb * f.dt_sb + hh;
  const TX* xg = static_cast<const TX*>(f.x) + bb * f.x_sb +
                 (long long)hh * f.x_sh + p0;
  const TX* bg = static_cast<const TX*>(f.b) + bb * f.b_sb;
  const TX* cg = static_cast<const TX*>(f.c) + bb * f.c_sb;
  const long long trow = (long long)H * P;      // dy's and dx's time stride
  const float* dyg =
      a.dy + (long long)bb * T * trow + (long long)hh * P + p0;
  TX* dxg = static_cast<TX*>(a.dx) + (long long)bb * T * trow +
            (long long)hh * P + p0;

  // the inputs of steps t0 .. t0 + BW_SC - 1 (dy and c only for the
  // reverse walk) into registers, fetched one sub-chunk ahead so that the
  // loads run under the current sub-chunk's work; put stages them
  float rdt = 0.f, rx[S::XE], rdy[S::XE], rbv[S::BE], rcv[S::BE];
  auto fetch = [&](int t0, bool reverse) {
    if (tid < BW_SC)
      rdt = t0 + tid < T ? __ldg(dtg + (t0 + tid) * f.dt_st) : 0.f;
#pragma unroll
    for (int i = 0; i < S::XE; ++i) {
      const int e = tid + i * M2_NT, s = e / R, r = e % R;
      const bool ok = e < BW_SC * R && t0 + s < T && p0 + r < P;
      rx[i] = ok ? load(xg + (t0 + s) * f.x_st + r) : 0.f;
      rdy[i] = ok && reverse ? __ldg(dyg + (t0 + s) * trow + r) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < S::BE; ++i) {
      const int e = tid + i * M2_NT, s = e / NP, n = e % NP;
      const bool ok = e < BW_SC * NP && t0 + s < T && n < N;
      rbv[i] = ok ? load(bg + (t0 + s) * f.b_st + n) : 0.f;
      rcv[i] = ok && reverse ? load(cg + (t0 + s) * f.c_st + n) : 0.f;
    }
  };
  auto put = [&](float* st) {
    if (tid < BW_SC) {
      st[S::DT + tid] = rdt;
      st[S::DEC + tid] = hopper::ex2(rdt * A2);
    }
#pragma unroll
    for (int i = 0; i < S::XE; ++i) {
      const int e = tid + i * M2_NT;
      if (e < BW_SC * R) {
        st[S::X + e] = rx[i];
        st[S::DY + e] = rdy[i];
      }
    }
#pragma unroll
    for (int i = 0; i < S::BE; ++i) {
      const int e = tid + i * M2_NT;
      if (e < BW_SC * NP) {
        st[S::BV + e] = rbv[i];
        st[S::CV + e] = rcv[i];
      }
    }
  };
  // the sub-chunks in the order they run: chunk k's forward sub-chunks
  // (all but its last, from the chunk state), then its sub-chunks in
  // reverse; a chunk of one sub-chunk has only the reverse one
  auto nsub_of = [&](int k) {
    return min(BW_SUB, (T - k * BW_Q + BW_SC - 1) / BW_SC);
  };
  auto fetch_chunk = [&](int k) {        // the first sub-chunk chunk k runs
    fetch(k * BW_Q, nsub_of(k) == 1);
  };
  // h = decay_t h + (dt_t x_t) b_t^T for the staged steps; with `keep`
  // each state into the history (slot s + 1 after step s)
  auto forward = [&](float (&h)[4][4], const float* st, bool keep) {
#pragma unroll
    for (int s = 0; s < BW_SC; ++s) {
      const float dt = st[S::DT + s], dec = st[S::DEC + s];
      const float4 xv =
          *reinterpret_cast<const float4*>(st + S::X + s * R + ln.r0);
      const float4 bv =
          *reinterpret_cast<const float4*>(st + S::BV + s * NP + n0);
      const float dx[4] = {dt * xv.x, dt * xv.y, dt * xv.z, dt * xv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        h[i][0] = fmaf(dec, h[i][0], dx[i] * bv.x);
        h[i][1] = fmaf(dec, h[i][1], dx[i] * bv.y);
        h[i][2] = fmaf(dec, h[i][2], dx[i] * bv.z);
        h[i][3] = fmaf(dec, h[i][3], dx[i] * bv.w);
      }
      if (keep) slot_store(hist + (s + 1) * BW_TILE, h);
    }
  };

  // 1. the state entering every chunk
  float h[4][4], g[4][4];
  m2_load_h(h, f.h0, f, bb, hh, p, n0);
  int buf = 0;
  const int nfwd = (a.nchunks - 1) * BW_SUB;   // sub-chunks before the last
  if (nfwd > 0)
    fetch(0, false);
  else
    fetch_chunk(0);
  for (int i = 0; i < nfwd; ++i, buf ^= 1) {
    if (i % BW_SUB == 0) slot_store(cb + (i / BW_SUB) * BW_TILE, h);
    float* st = stage + buf * S::SIZE;
    put(st);
    __syncthreads();
    if (i + 1 < nfwd)
      fetch((i + 1) * BW_SC, false);
    else
      fetch_chunk(a.nchunks - 1);
    forward(h, st, false);
  }
  slot_store(cb + (a.nchunks - 1) * BW_TILE, h);

  m2_load_h(g, a.dh_last, f, bb, hh, p, n0);
  for (int k = a.nchunks - 1; k >= 0; --k) {
    // 2. the state entering every sub-chunk of chunk k
    const int c0 = k * BW_Q, nsub = nsub_of(k);
    slot_load(h, cb + k * BW_TILE);
    for (int j = 0; j + 1 < nsub; ++j, buf ^= 1) {
      slot_store(sb + j * BW_TILE, h);
      float* st = stage + buf * S::SIZE;
      put(st);
      __syncthreads();
      if (j + 2 < nsub)
        fetch(c0 + (j + 1) * BW_SC, false);
      else
        fetch(c0 + (nsub - 1) * BW_SC, true);
      forward(h, st, false);
    }
    // h now enters the last sub-chunk; each earlier one's entry state is
    // loaded one sub-chunk ahead, with its inputs
    float hn[4][4];
    for (int j = nsub - 1; j >= 0; --j, buf ^= 1) {
      // 3. the sub-chunk's states into the history (slot s is h_{t0+s-1}),
      // then the reverse walk over it
      const int t0 = c0 + j * BW_SC, steps = min(BW_SC, T - t0);
      float* st = stage + buf * S::SIZE;
      if (j < nsub - 1) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) h[i][jj] = hn[i][jj];
      }
      put(st);
      slot_store(hist, h);
      __syncthreads();
      if (j > 0) {
        fetch(t0 - BW_SC, true);
        slot_load(hn, sb + (j - 1) * BW_TILE);
      } else if (k > 0) {
        fetch_chunk(k - 1);
      }
      forward(h, st, true);
#pragma unroll
      for (int s = BW_SC - 1; s >= 0; --s) {
        const float dec = st[S::DEC + s];
        const float4 x4 =
            *reinterpret_cast<const float4*>(st + S::X + s * R + ln.r0);
        const float4 dy4 =
            *reinterpret_cast<const float4*>(st + S::DY + s * R + ln.r0);
        const float4 b4 =
            *reinterpret_cast<const float4*>(st + S::BV + s * NP + n0);
        const float4 c4 =
            *reinterpret_cast<const float4*>(st + S::CV + s * NP + n0);
        const float xv[4] = {x4.x, x4.y, x4.z, x4.w};
        const float dyv[4] = {dy4.x, dy4.y, dy4.z, dy4.w};
        const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
        const float cv[4] = {c4.x, c4.y, c4.z, c4.w};
        float hp[4][4], hc[4][4];
        slot_load(hp, hist + s * BW_TILE);
        slot_load(hc, hist + (s + 1) * BW_TILE);
        float gb[4], dbp[4] = {0.f, 0.f, 0.f, 0.f};
        float dcp[4] = {0.f, 0.f, 0.f, 0.f}, dap = 0.f, xgb = 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
            g[i][jj] = fmaf(dyv[i], cv[jj], g[i][jj]);          // g_t
          gb[i] = fmaf(g[i][3], bv[3], fmaf(g[i][2], bv[2],
                  fmaf(g[i][1], bv[1], g[i][0] * bv[0])));
          xgb = fmaf(xv[i], gb[i], xgb);
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            dbp[jj] = fmaf(xv[i], g[i][jj], dbp[jj]);
            dcp[jj] = fmaf(dyv[i], hc[i][jj], dcp[jj]);
            dap = fmaf(g[i][jj], hp[i][jj], dap);
          }
        }
        // the partial sums, summed after the sub-chunk; da and <g, x b^T>
        // over the warp first, reduce-scattered (lanes 0 and 16 end with
        // them)
        *reinterpret_cast<float4*>(red + S::GB + (s * NL + ln.g) * S::RP +
                                   ln.r0) =
            make_float4(gb[0], gb[1], gb[2], gb[3]);
        float* bcs = red + S::BC + (s * RG + rg) * 2 * NP + n0;
        *reinterpret_cast<float4*>(bcs) =
            make_float4(dbp[0], dbp[1], dbp[2], dbp[3]);
        *reinterpret_cast<float4*>(bcs + NP) =
            make_float4(dcp[0], dcp[1], dcp[2], dcp[3]);
        const bool hi16 = (lane & 16) != 0;
        float w = (hi16 ? xgb : dap) +
                  __shfl_xor_sync(FULL, hi16 ? dap : xgb, 16);
#pragma unroll
        for (int off = 8; off > 0; off >>= 1)
          w += __shfl_xor_sync(FULL, w, off);
        if (lane % 16 == 0) red[S::DA + (s * 4 + warp) * 2 + lane / 16] = w;
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) g[i][jj] *= dec;   // d_t g_t
      }
      __syncthreads();
      // the sub-chunk's partial sums, each in a fixed order: dx a row (over
      // the row group's lanes), db and dc a state (over the row groups),
      // da and <g, x b^T> (over the warps)
      for (int e = tid; e < steps * R; e += M2_NT) {
        const int s = e / R, r = e % R;
        const float* v = red + S::GB + s * NL * S::RP + r;
        float sum = 0.f;
#pragma unroll
        for (int q = 0; q < NL; ++q) sum += v[q * S::RP];
        if (p0 + r < P)
          store_as(dxg + (t0 + s) * trow + r, st[S::DT + s] * sum);
      }
      for (int e = tid; e < steps * 2 * NP; e += M2_NT) {
        const int s = e / (2 * NP), v = e % (2 * NP), n = v % NP;
        const float* q = red + S::BC + s * RG * 2 * NP + v;
        float sum = 0.f;
#pragma unroll
        for (int r = 0; r < RG; ++r) sum += q[r * 2 * NP];
        const long long row =
            (((long long)bb * T + t0 + s) * H + hh) * a.RB + rb;
        if (n < N) {
          if (v < NP)
            a.dbh[row * N + n] = st[S::DT + s] * sum;
          else
            a.dch[row * N + n] = sum;
        }
      }
      if (tid < 2 * steps) {
        const int s = tid / 2, which = tid % 2;
        const float* q = red + S::DA + s * 8 + which;
        const float sum = q[0] + q[2] + q[4] + q[6];
        const long long row =
            (((long long)bb * T + t0 + s) * H + hh) * a.RB + rb;
        if (which == 0)
          a.dah[row] = st[S::DEC + s] * sum;
        else
          a.xgbh[row] = sum;
      }
    }
  }
  m2_store_h(g, a.dh0, f, bb, hh, p, n0);       // decay_0 g_0
}

// db, dc (B, T, N): each the sum of its `parts` partial sums (over (head,
// row block), or (head group, row block) on the chunked path), in order;
// one thread a (b, t, n)
template <typename TX>
__global__ void __launch_bounds__(256) mamba2_bwd_bc_kernel(const M2Bwd a) {
  const M2Args& f = a.f;
  const long long e = (long long)blockIdx.x * 256 + threadIdx.x;
  if (e >= (long long)f.B * f.T * f.N) return;
  const int n = (int)(e % f.N), parts = a.parts;
  const long long base = e / f.N * parts * f.N + n;
  float sb = 0.f, sc = 0.f;
  for (int k = 0; k < parts; ++k) {
    sb += a.dbh[base + (long long)k * f.N];
    sc += a.dch[base + (long long)k * f.N];
  }
  store_as(static_cast<TX*>(a.db) + e, sb);
  store_as(static_cast<TX*>(a.dc) + e, sc);
}

// ddt (B, T, H) = A da + <g, x b^T>, each summed over the row blocks in
// order; one thread a (b, t, h)
__global__ void __launch_bounds__(256) mamba2_bwd_dt_kernel(const M2Bwd a) {
  const M2Args& f = a.f;
  const long long e = (long long)blockIdx.x * 256 + threadIdx.x;
  if (e >= (long long)f.B * f.T * f.H) return;
  float da = 0.f, xg = 0.f;
  for (int r = 0; r < a.RB; ++r) {
    da += a.dah[e * a.RB + r];
    xg += a.xgbh[e * a.RB + r];
  }
  a.ddt[e] = fmaf(__ldg(f.A + e % f.H), da, xg);
}

// dA_h = sum over (b, t) of dt da: one block a head, a strided sum a
// thread and a tree over the block, both in a fixed order
__global__ void __launch_bounds__(256) mamba2_bwd_A_kernel(const M2Bwd a) {
  const M2Args& f = a.f;
  __shared__ float part[256];
  const int hh = blockIdx.x;
  float s = 0.f;
  for (long long e = threadIdx.x; e < (long long)f.B * f.T; e += 256) {
    const int b = (int)(e / f.T), t = (int)(e % f.T);
    const long long row = ((long long)b * f.T + t) * f.H + hh;
    float da = 0.f;
    for (int r = 0; r < a.RB; ++r) da += a.dah[row * a.RB + r];
    s = fmaf(__ldg(f.dt + b * f.dt_sb + t * f.dt_st + hh), da, s);
  }
  part[threadIdx.x] = s;
  __syncthreads();
  for (int w = 128; w > 0; w >>= 1) {
    if (threadIdx.x < w) part[threadIdx.x] += part[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) a.dA[hh] = part[0];
}

// ---- the chunked (SSD) backward on the tensor cores -------------------------
// Three kernels and the three sums above.  With mamba2_chunked_kernel's
// notation a chunk's forward is y = M X + diag(e) C h_in^T and h_out =
// E h_in + X^T diag(w) B (M = L o C B^T o dt_j, e_i = exp(S[i, -1]),
// w_j = dt_j ew_j, ew_j = exp(S[Q-1, j]), E = e_{Q-1}); its backward
// (ref.mamba2_scan_chunked_bwd_ref, stage by stage):
//   mamba2_bwd_walk_kernel<0> and <1>, one block a (row block, head, batch
//   row), walking the chunks with the (P, N) state in a wgmma accumulator
//   and storing it, f32, at every chunk's boundary:
//     <0> forwards  h_in[k]   (h_in[k+1] = E h_in[k] + (diag(w) X)^T B),
//     <1> backwards dh_out[k] (dh_out[k-1] = E dh_out[k] + (diag(e) dY)^T
//         C), and dh0, the walk's last value;
//   each chunk one product, A = the f32 side in three bf16 terms from
//   registers, B = b or c (MN-major), 12 k16 steps; the next chunk's x or
//   dy and b or c come in through cp.async meanwhile.  Two kernels, not one
//   with a branch on the direction: a wgmma under a runtime branch
//   serializes (PERF.md, PR 13), and the direction as a constant keeps the
//   offsets out of registers;
//   mamba2_bwd_tile_kernel, one block a (chunk, group of CB_HEADS heads,
//   row block, batch row), every chunk in parallel: per head, in rows j
//   (steps) against columns i unless named,
//     G^T = B C^T, dM^T = X dY^T; dG^T = dM^T o L^T o dt_j,
//     M^T = L^T o G^T o dt_j, K^T = dM^T o L^T o G^T (its row sums are
//     ddt's direct term of M);
//     the rectangle sum_{i >= k, j < k} (K^T dt_j)[j, i] of the log-decay
//     gradient, as direct sums on the CUDA cores: in each row the sums
//     from column k on (a lane's pair, its quad's later lanes by shuffles,
//     the later n8 blocks), then the rows j < k of each column;
//     dX = diag(w) (B dh_out^T) + M^T dY, stored;
//     dB += diag(w) (X dh_out) + dG^T C (v_j = <B_j, (X dh_out)_j>);
//     dC^T += (h_in^T dY^T) diag(e) + B^T dG^T (rows n, columns i; r_i =
//       e_i <C_i, (dY h_in)_i> from the first product's columns), h_in^T
//       from registers and dG^T's terms through shared memory;
//     da_k = the rectangle + sum_{i >= k} r_i + sum_{j < k} w_j v_j
//       + E <dh_out, h_in>, and ddt's direct terms sum_i K[i, k] +
//       ew_k v_k, per (b, t, head, row block) as the CUDA-core form
//       stores them (dah, xgbh), so mamba2_bwd_dt_kernel and
//       mamba2_bwd_A_kernel finish ddt and dA;
//   dB and dC^T of the block's heads sum in shared memory (each thread its
//   own elements, in head order), and reach device memory per (b, t, head
//   group, row block); mamba2_bwd_bc_kernel sums them in order.  No float
//   atomics: two calls are bit-identical.
// Precision: x, b, c are bf16 and exact operands; a float32 operand is
// three bf16 terms (split3); where both sides are float32 (M^T dY, h_in^T
// dY^T) both are split and the six pairs of terms (i, j), i + j < 3, are
// summed (the three dropped are below 2^-21 of the product).  Two terms
// miss the card's limits (tests/test_torch_scan_bwd.py).  The decays are
// products of exponentials of direct sums (the forward's tables), never of
// differences.  Steps past T, rows past P and states past N are zeros.
// Every wgmma is issued in straight-line code and retired (wait 0) before
// its accumulator is read; nothing is in flight across a loop's back edge.
// Registers: the tile kernel's products and their A fragments need most of
// a thread's 255; the loop-invariant offsets the compiler would hoist out
// of the head (and chunk) loops spilled, so each iteration derives the
// thread's place afresh from an opaque copy of its index (PERF.md, PR 22).


// A 64 x 64 bf16 tile (rows rs elements apart) into a 128-byte swizzled
// tile: 16-byte loads where the base, the stride and the columns allow,
// else fill_ssd_tile's element loads; zeros past nr rows and nc columns.

// a pair's three bf16 terms into three swizzled tiles, at (r, c)
__device__ __forceinline__ void put_split3(unsigned char* dst, int r, int c,
                                           float2 v) {
  uint32_t o[3];
  split3(v.x, v.y, o);
  const uint32_t off = sw128(r, c / 8) + (c % 8) * 2;
#pragma unroll
  for (int k3 = 0; k3 < 3; ++k3)
    *reinterpret_cast<uint32_t*>(dst + k3 * SSD_TILE + off) = o[k3];
}

// the six pairs (a, b) of bf16 terms with a + b < 3 of a product of two
// float32 sides: (0, 0), (0, 1), (0, 2), (1, 0), (1, 1), (2, 0)
__device__ constexpr int pair_a(int pq) {
  return pq < 3 ? 0 : pq < 5 ? 1 : 2;
}
__device__ constexpr int pair_b(int pq) {
  return pq < 3 ? pq : pq < 5 ? pq - 3 : 0;
}

__device__ __forceinline__ bool pairs_ok(const float* p, long long rs) {
  return ((reinterpret_cast<uintptr_t>(p) | (uintptr_t)(rs * 4)) & 7) == 0;
}

// A thread's 16 column pairs of a 64 x 64 float32 block (pair q: row
// (tid + 128 q) / 32, columns 2 ((tid + 128 q) % 32) + {0, 1}; zeros past
// nr rows and nc columns), loads only and no branch between a load and
// the next, so that a caller has several blocks' loads in flight at once;
// put_f32_block then writes their three bf16 terms.
__device__ __forceinline__ void load_f32_block(float2 (&v)[16],
                                               const float* src, long long rs,
                                               int nr, int nc, int tid) {
  if (nc >= 64 && pairs_ok(src, rs)) {
#pragma unroll
    for (int q = 0; q < 16; ++q) {
      const int i = tid + CB_NT * q, r = i / 32, c = 2 * (i % 32);
      v[q] = r < nr ? __ldg(reinterpret_cast<const float2*>(src + r * rs + c))
                    : make_float2(0.f, 0.f);
    }
  } else {
#pragma unroll
    for (int q = 0; q < 16; ++q) {
      const int i = tid + CB_NT * q, r = i / 32, c = 2 * (i % 32);
      v[q].x = r < nr && c < nc ? __ldg(src + r * rs + c) : 0.f;
      v[q].y = r < nr && c + 1 < nc ? __ldg(src + r * rs + c + 1) : 0.f;
    }
  }
}

__device__ __forceinline__ void put_f32_block(unsigned char* dst,
                                              const float2 (&v)[16], int tid) {
#pragma unroll
  for (int q = 0; q < 16; ++q) {
    const int i = tid + CB_NT * q;
    put_split3(dst, i / 32, 2 * (i % 32), v[q]);
  }
}

// a bf16 tile's 16-byte loads (fill_bf16_tile's vector path), loads only
__device__ __forceinline__ bool bf16_vec_ok(const __nv_bfloat16* src,
                                            long long rs, int nc) {
  return nc >= 64 &&
         ((reinterpret_cast<uintptr_t>(src) | (uintptr_t)(rs * 2)) & 15) == 0;
}

__device__ __forceinline__ void load_bf16_tile(uint4 (&v)[4],
                                               const __nv_bfloat16* src,
                                               long long rs, int nr, int tid) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int i = tid + CB_NT * q, r = i / 8;
    v[q] = r < nr ? __ldg(reinterpret_cast<const uint4*>(src + r * rs) + i % 8)
                  : make_uint4(0u, 0u, 0u, 0u);
  }
}

__device__ __forceinline__ void put_bf16_tile(unsigned char* dst,
                                              const uint4 (&v)[4], int tid) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int i = tid + CB_NT * q;
    *reinterpret_cast<uint4*>(dst + sw128(i / 8, i % 8)) = v[q];
  }
}

// a bf16 tile's 16-byte rows through cp.async (no registers; zeros past nr
// rows), committed as one group: bf16_vec_ok's tiles only
__device__ __forceinline__ void async_bf16_tile(unsigned char* dst,
                                                const __nv_bfloat16* src,
                                                long long rs, int nr,
                                                int tid) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int i = tid + CB_NT * q, r = i / 8;
    const __nv_bfloat16* g = src + (r < nr ? r : 0) * rs + 8 * (i % 8);
    asm volatile(
        "cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
        :: "r"(hopper::smem_u32(dst + sw128(r, i % 8))), "l"(g),
           "r"(r < nr ? 16 : 0)
        : "memory");
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// a whole bf16 tile: 16-byte loads where the base, the stride and the
// columns allow, else fill_ssd_tile's element loads
__device__ __forceinline__ void fill_bf16_tile(unsigned char* dst,
                                               const __nv_bfloat16* src,
                                               long long rs, int nr, int nc,
                                               int tid) {
  if (bf16_vec_ok(src, rs, nc)) {
    uint4 v[4];
    load_bf16_tile(v, src, rs, nr, tid);
    put_bf16_tile(dst, v, tid);
  } else {
    fill_ssd_tile(dst, src, rs, nr, nc, tid);
  }
}

// the state accumulator (rows p0 + r0 + 8 half, states 8 j + 2 t4 + e) to
// a (P, N) float32 block
__device__ __forceinline__ void store_state(float* dst, const float (&s)[32],
                                            int p0, int r0, int t4, int P,
                                            int N) {
  const bool pairs = N % 2 == 0;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int p = p0 + r0 + 8 * half;
    if (p >= P) continue;
    float* row = dst + (long long)p * N;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = 8 * j + 2 * t4;
      const float v0 = s[4 * j + 2 * half], v1 = s[4 * j + 2 * half + 1];
      if (pairs && n + 1 < N) {
        *reinterpret_cast<float2*>(row + n) = make_float2(v0, v1);
      } else {
        if (n < N) row[n] = v0;
        if (n + 1 < N) row[n + 1] = v1;
      }
    }
  }
}

template <int DIR>
__global__ void __launch_bounds__(CB_NT, 3)
mamba2_bwd_walk_kernel(const M2Bwd a) {
  constexpr bool dir = DIR != 0;
  using Sm = WalkSmem;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = hopper::align1024(smem_raw);
  const uint32_t base = hopper::smem_u32(sm);
  float* a2s = reinterpret_cast<float*>(sm + Sm::VEC);
  float* dts = a2s + SSD_Q;
  float* scs = dts + SSD_Q;          // w_s (forwards) or e_s (backwards)
  float* Es = scs + SSD_Q;
  const M2Args& f = a.f;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int t4 = lane % 4, r0 = 16 * warp + lane / 4;
  const int p0 = blockIdx.x * SSD_Q;
  const int hh = blockIdx.y, bb = blockIdx.z;
  const int T = f.T, P = f.P, N = f.N, H = f.H, K = a.nchunks;
  const int nx = P - p0;
  const float A2 = __ldg(f.A + hh) * LOG2E;
  const float* dtg = f.dt + bb * f.dt_sb + hh;
  const long long trow = (long long)H * P;
  // the chunk's x (forwards, bf16) or dy (backwards, f32): rows of steps,
  // 64 columns of P, as bytes
  const char* ug =
      dir ? reinterpret_cast<const char*>(a.dy + (long long)bb * T * trow +
                                          (long long)hh * P + p0)
          : reinterpret_cast<const char*>(
                static_cast<const __nv_bfloat16*>(f.x) + bb * f.x_sb +
                (long long)hh * f.x_sh + p0);
  const long long ust = dir ? 4 * trow : 2 * f.x_st;   // bytes a step
  constexpr int esz = dir ? 4 : 2, urow = dir ? Sm::UROW4 : Sm::UROW2;
  const __nv_bfloat16* vg =
      static_cast<const __nv_bfloat16*>(dir ? f.c : f.b) +
      bb * (dir ? f.c_sb : f.b_sb);
  const long long vst = dir ? f.c_st : f.b_st;
  float* slots = (dir ? a.dhout : a.hin) + (long long)bb * K * H * P * N +
                 (long long)hh * P * N;
  auto chunk_of = [&](int it) { return dir ? K - 1 - it : it; };

  // a chunk's x or dy into a U buffer (rows of urow bytes) and its b or c
  // into a V tile, one chunk ahead: cp.async where the base and stride
  // allow (waited for before the barrier that hands the chunk over), else
  // element loads; zeros past T and P
  const bool uvec = nx >= 64 &&
                    ((reinterpret_cast<uintptr_t>(ug) | (uintptr_t)ust) & 15)
                        == 0;
  const bool vvec = bf16_vec_ok(vg, vst, N);
  auto fill = [&](int buf, int k, int tid) {
    const int t0 = k * SSD_Q, nr = T - t0;
    unsigned char* ud = sm + Sm::U + buf * Sm::UBUF;
    const char* us = ug + t0 * ust;
    if (uvec) {
      const int per = 4 * esz;                // 16-byte pieces a row
#pragma unroll 4
      for (int i = tid; i < SSD_Q * per; i += CB_NT) {
        const int r = i / per, c = i % per;
        asm volatile(
            "cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
            :: "r"(hopper::smem_u32(ud + r * urow + 16 * c)),
               "l"(us + (r < nr ? r : 0) * ust + 16 * c), "r"(r < nr ? 16 : 0)
            : "memory");
      }
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    } else {
      for (int i = tid; i < SSD_Q * SSD_Q; i += CB_NT) {
        const int r = i / SSD_Q, c = i % SSD_Q;
        const bool ok = r < nr && c < nx;
        const char* src = us + r * ust + (long long)c * esz;
        if constexpr (dir)
          *reinterpret_cast<float*>(ud + r * urow + 4 * c) =
              ok ? __ldg(reinterpret_cast<const float*>(src)) : 0.f;
        else
          *reinterpret_cast<unsigned short*>(ud + r * urow + 2 * c) =
              ok ? __ldg(reinterpret_cast<const unsigned short*>(src))
                 : (unsigned short)0;
      }
    }
    unsigned char* vd = sm + Sm::V + buf * SSD_TILE;
    if (vvec) {
      async_bf16_tile(vd, vg + (long long)t0 * vst, vst, nr, tid);
    } else {
      fill_ssd_tile(vd, vg + (long long)t0 * vst, vst, nr, N, tid);
      hopper::fence_proxy_async();
    }
  };
  auto load_dt = [&](int k) {
    const int t = k * SSD_Q + tid;
    return tid < SSD_Q && t < T ? __ldg(dtg + (long long)t * f.dt_st) : 0.f;
  };

  float acc[32];
  {
    const float* init = (dir ? a.dh_last : f.h0) +
                        ((long long)bb * H + hh) * P * N;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = p0 + r0 + 8 * (e >> 1), n = 8 * j + 2 * t4 + (e & 1);
        acc[4 * j + e] = p < P && n < N ? __ldg(init + (long long)p * N + n)
                                        : 0.f;
      }
  }
  float dtv = load_dt(chunk_of(0));
  fill(0, chunk_of(0), tid);
  for (int it = 0; it < K; ++it) {
    const int k = chunk_of(it), s = it & 1;
    // the thread's place, derived afresh each chunk from an opaque copy of
    // its index, so that the compiler keeps no loop-invariant offsets
    // across the chunks
    int tl = threadIdx.x;
    asm volatile("" : "+r"(tl));
    const int t4 = tl % 4, r0 = 16 * (tl / 32) + tl % 32 / 4;
    if (tid < SSD_Q) {
      dts[tid] = dtv;
      a2s[tid] = dtv * A2;
    }
    if (it + 1 < K) dtv = load_dt(chunk_of(it + 1));
    async_wait_all();                          // chunk it has landed
    hopper::fence_proxy_async();
    __syncthreads();
    // the scales, each a direct sum (four chains): w_s = dt_s 2^(sum of a
    // over the steps after s) forwards, e_s = 2^(sum up to s) backwards; E
    if (tid <= SSD_Q) {
      float s4[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int m = 0; m < SSD_Q; m += 4) {
        const float4 q = *reinterpret_cast<const float4*>(a2s + m);
        const float v[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const bool in = tid == SSD_Q || (dir ? m + i <= tid : m + i > tid);
          s4[i] += in ? v[i] : 0.f;
        }
      }
      const float sum = (s4[0] + s4[1]) + (s4[2] + s4[3]);
      if (tid < SSD_Q)
        scs[tid] = dir ? hopper::ex2(sum) : hopper::ex2(sum) * dts[tid];
      else
        *Es = hopper::ex2(sum);
    }
    __syncthreads();
    // the A fragments (rows p, k = steps): split3 of scale_s U[s][p]
    uint32_t fr[3][4][4];
    {
      const unsigned char* ub = sm + Sm::U + s * Sm::UBUF;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int rr = 0; rr < 4; ++rr) {
          const int s0 = 16 * kk + 8 * (rr >> 1) + 2 * t4;
          const int p = r0 + 8 * (rr & 1);
          float v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const unsigned char* ad = ub + (s0 + e) * urow + p * esz;
            if constexpr (dir)
              v[e] = *reinterpret_cast<const float*>(ad);
            else
              v[e] = __uint_as_float(
                  (uint32_t)*reinterpret_cast<const unsigned short*>(ad)
                  << 16);
          }
          uint32_t o[3];
          split3(scs[s0] * v[0], scs[s0 + 1] * v[1], o);
#pragma unroll
          for (int k3 = 0; k3 < 3; ++k3) fr[k3][kk][rr] = o[k3];
        }
    }
    if (it + 1 < K) fill(s ^ 1, chunk_of(it + 1), tl);   // in flight
    store_state(slots + (long long)k * H * P * N, acc, p0, r0, t4, P, N);
    const float E = *Es;
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] *= E;
    hopper::fence_regs(acc);
#pragma unroll
    for (int k3 = 0; k3 < 3; ++k3)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) hopper::fence_regs(fr[k3][kk]);
    hopper::wgmma_fence();
    const uint32_t vt = base + Sm::V + s * SSD_TILE;
#pragma unroll
    for (int k3 = 0; k3 < 3; ++k3)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        hopper::Wgmma<64>::rs_bf16_tb(acc, fr[k3][kk], mndesc(vt, kk), 1);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
  }
  if (dir)
    store_state(a.dh0 + ((long long)bb * H + hh) * P * N, acc, p0, r0, t4,
                P, N);
}

__global__ void __launch_bounds__(CB_NT, 2)
mamba2_bwd_tile_kernel(const M2Bwd a) {
  using Sm = CbSmem;
  using bf16 = __nv_bfloat16;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = hopper::align1024(smem_raw);
  const uint32_t base = hopper::smem_u32(sm);
  float* a2 = reinterpret_cast<float*>(sm + Sm::VEC);
  float* dts = a2 + SSD_Q;
  float* ein = dts + SSD_Q;
  float* eout = ein + SSD_Q;
  float* win = eout + SSD_Q;
  float* mid = win + SSD_Q * SSD_G;
  float* epre = mid + SSD_G * SSD_G;
  float* epost = epre + 16;
  float* tot = epost + 16;
  float* zp = tot + 16;                 // [4][Q]
  float* rsp = zp + 4 * SSD_Q;          // [4][Q]: r_i / e_i, a warp's rows
  float* rsum = rsp + 4 * SSD_Q;        // r_i
  float* evs = rsum + SSD_Q;            // ew_j v_j
  float* wvs = evs + SSD_Q;             // w_j v_j
  float* kds = wvs + SSD_Q;             // K's row sums
  float* scan = kds + SSD_Q;            // [2][Q]: sum_{i >= k} r_i,
                                        // sum_{j < k} w_j v_j
  float* c0s = scan + 2 * SSD_Q;        // [4]
  const M2Args& f = a.f;
  const int tid = threadIdx.x;
  const int T = f.T, P = f.P, N = f.N, H = f.H, K = a.nchunks;
  const int kc = blockIdx.x, t0 = kc * SSD_Q, bb = blockIdx.z;
  const int groups = (H + a.heads - 1) / a.heads;
  const int rb = blockIdx.y / groups, grp = blockIdx.y % groups;
  const int p0 = rb * SSD_Q, hfirst = grp * a.heads;
  const int nh = min(a.heads, H - hfirst), nr = T - t0, nx = P - p0;
  const bf16* xg = static_cast<const bf16*>(f.x) + bb * f.x_sb +
                   (long long)t0 * f.x_st + p0;
  const long long trow = (long long)H * P;
  const float* dyg = a.dy + ((long long)bb * T + t0) * trow + p0;
  bf16* dxg = static_cast<bf16*>(a.dx) + ((long long)bb * T + t0) * trow + p0;
  const uint32_t tb = base + Sm::TB, tc = base + Sm::TC, tx = base + Sm::TX,
                 sy = base + Sm::SY, sd = base + Sm::SD;
  float* accB = reinterpret_cast<float*>(sm + Sm::ACB) + tid;  // [i][thread]
  float* accC = reinterpret_cast<float*>(sm + Sm::ACC) + tid;

  // the chunk's b and c, shared by the heads
  fill_bf16_tile(sm + Sm::TB, static_cast<const bf16*>(f.b) + bb * f.b_sb +
                                  (long long)t0 * f.b_st,
                 f.b_st, nr, N, tid);
  fill_bf16_tile(sm + Sm::TC, static_cast<const bf16*>(f.c) + bb * f.c_sb +
                                  (long long)t0 * f.c_st,
                 f.c_st, nr, N, tid);
#pragma unroll
  for (int i = 0; i < 32; ++i) accB[CB_NT * i] = accC[CB_NT * i] = 0.f;
  // acc index 4 jb + 2 h2 + e: row r0 + 8 h2, column 8 jb + 2 t4 + e; an
  // A fragment's register rr of k16 step kk: acc 8 kk + 2 rr (+1)

  for (int q = 0; q < nh; ++q) {
    const int hh = hfirst + q;
    // the thread's place, derived afresh each head from an opaque copy of
    // its index, so that the compiler keeps no loop-invariant offsets
    // across the heads (they would take the registers the products need)
    int tl = threadIdx.x;
    asm volatile("" : "+r"(tl));
    const int warp = tl / 32, lane = tl % 32;
    const int g = lane / 4, t4 = lane % 4, r0 = 16 * warp + g;
    const int lq = lane / 8, lr = lane % 8;
    const int R = 16 * warp + 8 * (lq & 1) + lr;   // ldmatrix row, non-trans
    const float A = __ldg(f.A + hh);
    const float* hin = a.hin + (((long long)bb * K + kc) * H + hh) * P * N +
                       (long long)p0 * N;
    // (1) dt, x, dY's and dh_out's terms: every load in flight together
    // before the stores
    {
      const bf16* xh = xg + (long long)hh * f.x_sh;
      const bool xvec = bf16_vec_ok(xh, f.x_st, nx);
      uint4 xv[4];
      float2 yv[16], dv[16];
      float d = 0.f;
      if (tl < SSD_Q && t0 + tl < T)
        d = __ldg(f.dt + bb * f.dt_sb + (long long)(t0 + tl) * f.dt_st + hh);
      if (xvec) load_bf16_tile(xv, xh, f.x_st, nr, tl);
      load_f32_block(yv, dyg + (long long)hh * P, trow, nr, nx, tl);
      load_f32_block(dv, a.dhout + (hin - a.hin), N, nx, N, tl);
      if (tid < SSD_Q) {
        dts[tid] = d;
        a2[tid] = d * A * LOG2E;
      }
      if (xvec)
        put_bf16_tile(sm + Sm::TX, xv, tl);
      else
        fill_ssd_tile(sm + Sm::TX, xh, f.x_st, nr, nx, tl);
      put_f32_block(sm + Sm::SY, yv, tl);
      put_f32_block(sm + Sm::SD, dv, tl);
    }
    hopper::fence_proxy_async();
    __syncthreads();
    // (2) the decay tables, as mamba2_chunked_kernel's helper builds them
    // but without dt: ein, eout, tot, win, then mid, epre, epost
    {
      const int i = tid & (SSD_Q - 1), K0 = i & ~(SSD_G - 1),
                c = i & (SSD_G - 1);
      float av[SSD_G];
#pragma unroll
      for (int m = 0; m < SSD_G; ++m) av[m] = a2[K0 + m];
      if (tid < SSD_Q) {
        float pin = 0.f, pout = 0.f;
#pragma unroll
        for (int m = 0; m < SSD_G; ++m) {
          pin += m <= c ? av[m] : 0.f;
          pout += m > c ? av[m] : 0.f;
        }
        ein[i] = hopper::ex2(pin);
        eout[i] = hopper::ex2(pout);
        if (c == SSD_G - 1) tot[i / SSD_G] = pin;
      } else {
        float sum = 0.f;
#pragma unroll
        for (int m = SSD_G - 1; m >= 0; --m) {
          win[i * SSD_G + m] = m <= c ? hopper::ex2(sum) : 0.f;
          sum += m <= c ? av[m] : 0.f;
        }
      }
    }
    __syncthreads();
    if (tid < SSD_Q) {
      const int I = tid / SSD_G, J = tid % SSD_G;
      int lo = 0, hi = 0;
      float* dst = nullptr;
      if (I > J) {
        lo = J + 1, hi = I, dst = mid + SSD_G * I + J;
      } else if (I == J) {
        lo = 0, hi = I, dst = epre + I;
      } else if (J == I + 1) {
        lo = J, hi = SSD_G, dst = epost + I;
      } else if (I == 0 && J == 2) {
        lo = 0, hi = SSD_G, dst = epre + SSD_G;
      } else if (I == 0 && J == 3) {
        lo = SSD_G, hi = SSD_G, dst = epost + SSD_G - 1;
      }
      float sum = 0.f;
#pragma unroll
      for (int Kg = 0; Kg < SSD_G; ++Kg)
        sum += Kg >= lo && Kg < hi ? tot[Kg] : 0.f;
      if (dst != nullptr) *dst = hopper::ex2(sum);
    }
    __syncthreads();
    const float E = epre[SSD_G];
    float dtj[2], ewj[2], wj[2], erow[2];
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int j = r0 + 8 * h2;
      dtj[h2] = dts[j];
      ewj[h2] = eout[j] * epost[j / SSD_G];
      wj[h2] = dtj[h2] * ewj[h2];
      erow[h2] = epre[j / SSD_G] * ein[j];
    }
    // L[i, j] for row j = r0 + 8 h2 (group 2 warp + h2, j % 8 = g) and
    // column i = 8 jb + 2 t4 + e: ein[i] mid[jb][J] eout[j] for jb > J,
    // win[i][g] in j's own group, 0 before it
    auto Lt = [&](int h2, int jb, int e) {
      const int J = 2 * warp + h2, i = 8 * jb + 2 * t4 + e;
      return jb > J    ? ein[i] * mid[SSD_G * jb + J] * eout[r0 + 8 * h2]
             : jb == J ? win[i * SSD_G + g]
                       : 0.f;
    };

    // (3) G^T = B C^T and dM^T = X dY^T
    float gt[32], dm[32];
    {
      uint32_t af[4][4], xf[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        ldmatrix_x4(af[kk], tb + sw128(R, 2 * kk + (lq >> 1)));
        ldmatrix_x4(xf[kk], tx + sw128(R, 2 * kk + (lq >> 1)));
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        hopper::fence_regs(af[kk]);
        hopper::fence_regs(xf[kk]);
      }
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs(gt, af[kk], kdesc(tc, kk), kk > 0);
#pragma unroll
      for (int k3 = 0; k3 < 3; ++k3)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_rs(dm, xf[kk], kdesc(sy + k3 * SSD_TILE, kk), k3 + kk > 0);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
    }
    hopper::fence_regs(gt);
    hopper::fence_regs(dm);

    // (4) per element, with L once: M^T = L o G^T o dt_j over G^T, dG^T =
    // dM^T o L o dt_j over dM^T, K^T = dM^T o L o G^T (its row sums), and
    // R^T = K^T dt_j = dM^T o M^T
    float rt[32];
    {
      float kd[2] = {0.f, 0.f};
#pragma unroll
      for (int jb = 0; jb < 8; ++jb)
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int ix = 4 * jb + 2 * h2 + e;
            const float L = Lt(h2, jb, e), lg = L * gt[ix];
            kd[h2] = fmaf(dm[ix], lg, kd[h2]);
            gt[ix] = lg * dtj[h2];
            rt[ix] = dm[ix] * gt[ix];
            dm[ix] *= L * dtj[h2];
          }
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        kd[h2] += __shfl_xor_sync(FULL, kd[h2], 1);
        kd[h2] += __shfl_xor_sync(FULL, kd[h2], 2);
        if (t4 == 0) kds[r0 + 8 * h2] = kd[h2];
      }
    }

    // (5) the rectangle sum_{i >= k, j < k} R^T[j, i]: in each row j the
    // sums S_j(k) = sum_{i >= k} R^T[j, i] (the thread's pair, then the
    // later threads of its quad and the later n8 blocks, each a direct
    // sum), then the rows j < k of each column k, summed over the warp
    {
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        float tail[8], blk[8];           // the quad's sums after this lane
#pragma unroll
        for (int jb = 0; jb < 8; ++jb) {   // and each n8 block's total
          const float pr = rt[4 * jb + 2 * h2] + rt[4 * jb + 2 * h2 + 1];
          float incl = pr;               // this lane's and the later ones
          float v = __shfl_down_sync(FULL, incl, 1, 4);
          incl += t4 < 3 ? v : 0.f;
          v = __shfl_down_sync(FULL, incl, 2, 4);
          incl += t4 < 2 ? v : 0.f;
          v = __shfl_down_sync(FULL, incl, 1, 4);
          tail[jb] = t4 < 3 ? v : 0.f;
          blk[jb] = __shfl_sync(FULL, incl, 0, 4);
        }
        float later = 0.f;               // the blocks after jb
#pragma unroll
        for (int jb = 7; jb >= 0; --jb) {
          const float a1 = rt[4 * jb + 2 * h2 + 1];
          rt[4 * jb + 2 * h2 + 1] = a1 + (tail[jb] + later);
          rt[4 * jb + 2 * h2] += a1 + (tail[jb] + later);
          later += blk[jb];
        }
      }
#pragma unroll
      for (int jb = 0; jb < 8; ++jb)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * jb + 2 * t4 + e;
          float v = (r0 < col ? rt[4 * jb + e] : 0.f) +
                    (r0 + 8 < col ? rt[4 * jb + 2 + e] : 0.f);
          v += __shfl_xor_sync(FULL, v, 4);
          v += __shfl_xor_sync(FULL, v, 8);
          v += __shfl_xor_sync(FULL, v, 16);
          if (g == 0) zp[warp * SSD_Q + col] = v;
        }
    }

    // (6) dX = diag(w) (B dh_out^T) + M^T dY
    {
      uint32_t mf[3][4][4];              // M^T's three terms
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int rr = 0; rr < 4; ++rr) {
          const int i0 = 8 * kk + 2 * rr;
          uint32_t o[3];
          split3(gt[i0], gt[i0 + 1], o);
#pragma unroll
          for (int k3 = 0; k3 < 3; ++k3) mf[k3][kk][rr] = o[k3];
        }
      float dx[32];
      uint32_t bf[4][4];                 // B's fragments again (rows j)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        ldmatrix_x4(bf[kk], tb + sw128(R, 2 * kk + (lq >> 1)));
        hopper::fence_regs(bf[kk]);
      }
      hopper::wgmma_fence();
#pragma unroll
      for (int k3 = 0; k3 < 3; ++k3)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_rs(dx, bf[kk], kdesc(sd + k3 * SSD_TILE, kk), k3 + kk > 0);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(dx);
#pragma unroll
      for (int i = 0; i < 32; ++i) dx[i] *= wj[(i >> 1) & 1];
      hopper::fence_regs(dx);
#pragma unroll
      for (int k3 = 0; k3 < 3; ++k3)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) hopper::fence_regs(mf[k3][kk]);
      hopper::wgmma_fence();
#pragma unroll
      for (int pq = 0; pq < 6; ++pq)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          hopper::Wgmma<64>::rs_bf16_tb(
              dx, mf[pair_a(pq)][kk], mndesc(sy + pair_b(pq) * SSD_TILE, kk),
              1);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(dx);
      bf16* out = dxg + (long long)hh * P;
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const int j = r0 + 8 * h2;
        if (j >= nr) continue;
        bf16* row = out + (long long)j * trow;
#pragma unroll
        for (int jb = 0; jb < 8; ++jb) {
          const int p = 8 * jb + 2 * t4;
          const float v0 = dx[4 * jb + 2 * h2], v1 = dx[4 * jb + 2 * h2 + 1];
          if (P % 2 == 0 && p + 1 < nx) {
            *reinterpret_cast<__nv_bfloat162*>(row + p) =
                __floats2bfloat162_rn(v0, v1);
          } else {
            if (p < nx) row[p] = __float2bfloat16(v0);
            if (p + 1 < nx) row[p + 1] = __float2bfloat16(v1);
          }
        }
      }
    }

    // (7) dB += diag(w) (X dh_out) + dG^T C, summed over the heads in
    // shared memory; v_j = <B_j, (X dh_out)_j>; <dh_out, h_in>; dG^T's
    // terms over dh_out's, for (8); h_in^T's loads for (8) under the first
    // product
    float hraw[32];
    {
      float tmp[32];
      uint32_t xf[4][4];                 // X's fragments again (rows j)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        ldmatrix_x4(xf[kk], tx + sw128(R, 2 * kk + (lq >> 1)));
        hopper::fence_regs(xf[kk]);
      }
      hopper::wgmma_fence();
#pragma unroll
      for (int k3 = 0; k3 < 3; ++k3)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          hopper::Wgmma<64>::rs_bf16_tb(tmp, xf[kk],
                                        mndesc(sd + k3 * SSD_TILE, kk),
                                        k3 + kk > 0);
      hopper::wgmma_commit();
      // h_in^T as this thread's A-fragment values (rows n, k = p)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int rr = 0; rr < 4; ++rr)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int n = r0 + 8 * (rr & 1);
            const int pp = 16 * kk + 8 * (rr >> 1) + 2 * t4 + e;
            hraw[8 * kk + 2 * rr + e] =
                n < N && pp < nx ? __ldg(hin + (long long)pp * N + n) : 0.f;
          }
      uint32_t gf[3][4][4];              // dG^T's three terms
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int rr = 0; rr < 4; ++rr) {
          const int i0 = 8 * kk + 2 * rr;
          uint32_t o[3];
          split3(dm[i0], dm[i0 + 1], o);
#pragma unroll
          for (int k3 = 0; k3 < 3; ++k3) gf[k3][kk][rr] = o[k3];
        }
      // <dh_out, h_in> over this thread's h_in^T elements (n, p), dh_out
      // from its three terms, before dG^T's terms replace them
      {
        float dot = 0.f;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int rr = 0; rr < 4; ++rr)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int n = r0 + 8 * (rr & 1);
              const int pp = 16 * kk + 8 * (rr >> 1) + 2 * t4 + e;
              const uint32_t off = sw128(pp, n / 8) + (n % 8) * 2;
              float d = 0.f;
#pragma unroll
              for (int k3 = 0; k3 < 3; ++k3)
                d += __uint_as_float(
                    (uint32_t)*reinterpret_cast<const unsigned short*>(
                        sm + Sm::SD + k3 * SSD_TILE + off)
                    << 16);
              dot = fmaf(hraw[8 * kk + 2 * rr + e], d, dot);
            }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          dot += __shfl_xor_sync(FULL, dot, off);
        if (lane == 0) c0s[warp] = dot;
      }
      hopper::wgmma_wait<0>();
      hopper::fence_regs(tmp);
      float vp[2] = {0.f, 0.f};
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2)
#pragma unroll
        for (int jb = 0; jb < 8; ++jb) {
          const uint32_t bw = *reinterpret_cast<const uint32_t*>(
              sm + Sm::TB + sw128(r0 + 8 * h2, jb) + 4 * t4);
          const int ix = 4 * jb + 2 * h2;
          vp[h2] = fmaf(tmp[ix], __uint_as_float(bw << 16),
                        fmaf(tmp[ix + 1], __uint_as_float(bw & 0xffff0000u),
                             vp[h2]));
          tmp[ix] *= wj[h2];
          tmp[ix + 1] *= wj[h2];
        }
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        vp[h2] += __shfl_xor_sync(FULL, vp[h2], 1);
        vp[h2] += __shfl_xor_sync(FULL, vp[h2], 2);
        if (t4 == 0) {
          evs[r0 + 8 * h2] = ewj[h2] * vp[h2];
          wvs[r0 + 8 * h2] = wj[h2] * vp[h2];
        }
      }
      __syncthreads();                 // every warp's products read dh_out
#pragma unroll
      for (int k3 = 0; k3 < 3; ++k3)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int rr = 0; rr < 4; ++rr)
            *reinterpret_cast<uint32_t*>(
                sm + Sm::SD + k3 * SSD_TILE +
                sw128(r0 + 8 * (rr & 1), 2 * kk + (rr >> 1)) + 4 * t4) =
                gf[k3][kk][rr];
      hopper::fence_proxy_async();
      hopper::fence_regs(tmp);
#pragma unroll
      for (int k3 = 0; k3 < 3; ++k3)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) hopper::fence_regs(gf[k3][kk]);
      hopper::wgmma_fence();
#pragma unroll
      for (int k3 = 0; k3 < 3; ++k3)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          hopper::Wgmma<64>::rs_bf16_tb(tmp, gf[k3][kk], mndesc(tc, kk), 1);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(tmp);
#pragma unroll
      for (int i = 0; i < 32; ++i) accB[CB_NT * i] += tmp[i];
    }
    __syncthreads();                   // dG^T's terms written by every warp

    // (8) dC^T += (h_in^T dY^T) diag(e) + B^T dG^T (rows n, columns i),
    // summed over the heads in shared memory; r_i = e_i <C_i, (dY h_in)_i>
    // from the first product's columns
    {
      uint32_t hf[3][4][4];              // h_in^T's three terms
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int rr = 0; rr < 4; ++rr) {
          const int i0 = 8 * kk + 2 * rr;
          uint32_t o[3];
          split3(hraw[i0], hraw[i0 + 1], o);
#pragma unroll
          for (int k3 = 0; k3 < 3; ++k3) hf[k3][kk][rr] = o[k3];
        }
      float tmp[32];
#pragma unroll
      for (int k3 = 0; k3 < 3; ++k3)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) hopper::fence_regs(hf[k3][kk]);
      hopper::wgmma_fence();
#pragma unroll
      for (int pq = 0; pq < 6; ++pq)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_rs(tmp, hf[pair_a(pq)][kk],
                   kdesc(sy + pair_b(pq) * SSD_TILE, kk), pq + kk > 0);
      hopper::wgmma_commit();
      uint32_t btf[4][4];                // B^T's fragments (rows n, k = j)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        ldmatrix_x4_t(btf[kk], tb + sw128(16 * kk + 8 * (lq >> 1) + lr,
                                          2 * warp + (lq & 1)));
      hopper::wgmma_wait<0>();
      hopper::fence_regs(tmp);
      // the columns' sums of C^T o tmp over the warp's rows n, and e_i
#pragma unroll
      for (int jb = 0; jb < 8; ++jb)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 8 * jb + 2 * t4 + e;
          float v = 0.f;
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2) {
            const int n = r0 + 8 * h2;
            const uint16_t cw = *reinterpret_cast<const uint16_t*>(
                sm + Sm::TC + sw128(i, n / 8) + (n % 8) * 2);
            v = fmaf(tmp[4 * jb + 2 * h2 + e],
                     __uint_as_float((uint32_t)cw << 16), v);
          }
          v += __shfl_xor_sync(FULL, v, 4);
          v += __shfl_xor_sync(FULL, v, 8);
          v += __shfl_xor_sync(FULL, v, 16);
          if (g == 0) rsp[warp * SSD_Q + i] = v;
          const float ei = epre[jb] * ein[i];
          tmp[4 * jb + e] *= ei;
          tmp[4 * jb + 2 + e] *= ei;
        }
      hopper::fence_regs(tmp);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) hopper::fence_regs(btf[kk]);
      hopper::wgmma_fence();
#pragma unroll
      for (int k3 = 0; k3 < 3; ++k3)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          hopper::Wgmma<64>::rs_bf16_tb(tmp, btf[kk],
                                        mndesc(sd + k3 * SSD_TILE, kk), 1);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(tmp);
#pragma unroll
      for (int i = 0; i < 32; ++i) accC[CB_NT * i] += tmp[i];
    }
    __syncthreads();                   // the head's sums in shared memory

    // (9) da and ddt's direct terms of step k, each sum in a fixed order:
    // r_i over the warps; thread k the suffix sum of r from k, thread
    // 64 + k the prefix sum of w v before k (four chains each); then thread
    // k the step's total
    if (tid < SSD_Q)
      rsum[tid] = epre[tid / SSD_G] * ein[tid] *
                  (rsp[tid] + rsp[SSD_Q + tid] + rsp[2 * SSD_Q + tid] +
                   rsp[3 * SSD_Q + tid]);
    __syncthreads();
    {
      const int k = tid & (SSD_Q - 1);
      const bool suffix = tid < SSD_Q;
      const float* src = suffix ? rsum : wvs;
      float s4[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int m = 0; m < SSD_Q; m += 4) {
        const float4 v = *reinterpret_cast<const float4*>(src + m);
        const float vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
          s4[i] += (suffix ? m + i >= k : m + i < k) ? vv[i] : 0.f;
      }
      scan[tid] = (s4[0] + s4[1]) + (s4[2] + s4[3]);
    }
    __syncthreads();
    if (tid < SSD_Q && tid < nr) {
      const int k = tid;
      const float da = (zp[k] + zp[SSD_Q + k] + zp[2 * SSD_Q + k] +
                        zp[3 * SSD_Q + k]) +
                       scan[k] + scan[SSD_Q + k] +
                       E * (c0s[0] + c0s[1] + c0s[2] + c0s[3]);
      const long long row =
          (((long long)bb * T + t0 + k) * H + hh) * a.RB + rb;
      a.dah[row] = da;
      a.xgbh[row] = kds[k] + evs[k];
    }
    __syncthreads();                   // before the next head's loads
  }

  // the block's part of db (rows j, columns n) and dc (dC^T: rows n,
  // columns i), per (b, t, head group, row block)
  const int t4 = tid % 4, r0 = 16 * (tid / 32) + tid % 32 / 4;
  const long long prow = (long long)a.parts * N;
  float* dbp = a.dbh + ((long long)bb * T + t0) * prow + blockIdx.y * N;
  float* dcp = a.dch + ((long long)bb * T + t0) * prow + blockIdx.y * N;
#pragma unroll
  for (int jb = 0; jb < 8; ++jb)
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int ix = 4 * jb + 2 * h2 + e;
        const int r = r0 + 8 * h2, cl = 8 * jb + 2 * t4 + e;
        if (r < nr && cl < N) dbp[r * prow + cl] = accB[CB_NT * ix];
        if (cl < nr && r < N) dcp[cl * prow + r] = accC[CB_NT * ix];
      }
}

template <typename TX, int NL>
cudaError_t launch_m2_bwd_main(const M2Bwd& a, const M2BwdPlan& pl,
                               cudaStream_t st) {
  if (pl.smem != bw_smem_bytes<NL>()) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      mamba2_bwd_kernel<TX, NL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)pl.smem);
  if (e != cudaSuccess) return e;
  mamba2_bwd_kernel<TX, NL>
      <<<dim3(pl.RB, a.f.H, a.f.B), M2_NT, pl.smem, st>>>(a);
  return cudaGetLastError();
}

// the three sums that finish db, dc, ddt and dA, on either path
template <typename TX>
cudaError_t launch_m2_bwd_sums(const M2Bwd& a, cudaStream_t st) {
  const M2Args& f = a.f;
  const long long bcn = (long long)f.B * f.T * f.N;
  const long long btn = (long long)f.B * f.T * f.H;
  mamba2_bwd_bc_kernel<TX><<<(unsigned)((bcn + 255) / 256), 256, 0, st>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  mamba2_bwd_dt_kernel<<<(unsigned)((btn + 255) / 256), 256, 0, st>>>(a);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  mamba2_bwd_A_kernel<<<f.H, 256, 0, st>>>(a);
  return cudaGetLastError();
}

template <typename TX>
cudaError_t launch_m2_bwd(const M2Bwd& a, const M2BwdPlan& pl,
                          cudaStream_t st) {
  cudaError_t e = cudaErrorInvalidValue;
  switch (pl.NL) {
    case 4: e = launch_m2_bwd_main<TX, 4>(a, pl, st); break;
    case 8: e = launch_m2_bwd_main<TX, 8>(a, pl, st); break;
    case 16: e = launch_m2_bwd_main<TX, 16>(a, pl, st); break;
    case 32: e = launch_m2_bwd_main<TX, 32>(a, pl, st); break;
  }
  if (e != cudaSuccess) return e;
  return launch_m2_bwd_sums<TX>(a, st);
}

cudaError_t launch_m2_bwd_chunked(const M2Bwd& a, const M2BwdPlan& pl,
                                  cudaStream_t st) {
  if (pl.smem != (long long)CbSmem::SIZE) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      mamba2_bwd_walk_kernel<0>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)WalkSmem::SIZE);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(mamba2_bwd_walk_kernel<1>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)WalkSmem::SIZE);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(mamba2_bwd_tile_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)CbSmem::SIZE);
  if (e != cudaSuccess) return e;
  const M2Args& f = a.f;
  const dim3 wg(pl.RB, f.H, f.B);
  mamba2_bwd_walk_kernel<0><<<wg, CB_NT, WalkSmem::SIZE, st>>>(a);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  mamba2_bwd_walk_kernel<1><<<wg, CB_NT, WalkSmem::SIZE, st>>>(a);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const unsigned groups = (unsigned)((f.H + pl.heads - 1) / pl.heads);
  mamba2_bwd_tile_kernel<<<dim3(pl.nchunks, groups * pl.RB, f.B), CB_NT,
                           CbSmem::SIZE, st>>>(a);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  return launch_m2_bwd_sums<__nv_bfloat16>(a, st);
}

// ---- selective_scan_bwd: the backward of the Mamba-1 form -------------------
// Stands in for jax.grad of repro/models/ssm.py::fused_ssm_scan as
// mamba1_block drives it (make_chunk / emit_chunk, the chunk body under
// jax.checkpoint, so the reference too recomputes its states).  From
// selective_scan_fwd's operands, dy (B, T, D) and dh_last (B, D, N), both
// f32, it gives, with a_t = dt_t A (one value a (channel, state)),
// decay_t = exp(a_t) and g the state's gradient walked from t = T - 1 down
// (g_t = decay_{t+1} g_{t+1} + dy_t c_t, starting from dh_last):
//   dx_t = dt_t sum_n g_t b_t          dc_t = sum_d dy_t h_t
//   db_t = sum_d dt_t x_t g_t          da_t = decay_t g_t h_{t-1}
//   ddt_t = sum_n A da_t + x_t sum_n g_t b_t,  dA = sum_{b,t} dt_t da_t,
//   dh0 = decay_0 g_0
// (ref.selective_scan_bwd_ref, step by step).  The decay is one value a
// (channel, state), not a scalar a head, so the Mamba-2 form's chunked
// (SSD) backward on the tensor cores does not apply: this is a reverse-time
// walk on the CUDA cores in selective_scan_fwd's lane layout, P lanes a
// channel, each holding S = 8 of its N states in registers (P =
// next_pow2(N / 8)), one block a channel block of SB_NT / P channels and
// a batch row.
//
// The walk needs h_{t-1} and h_t in reverse order.  They are recomputed,
// never recovered by dividing by the decay (which underflows to 0: dt A =
// -1000 is a test case), in three levels, each a forward pass with the
// forward kernel's arithmetic (ex2 of dt A log2 e, one fma a state-step):
//   1. over chunks 0 .. n-2 of Q steps, storing the state entering each in
//      device memory (cb: a block's own slots, each read back only by the
//      thread that wrote it, into shared memory by cp.async one chunk
//      before it is needed);
//   2. walking the chunks in reverse, over a chunk from its entering state,
//      keeping the state entering each SB_SC-step sub-chunk in shared
//      memory (a thread's own slots);
//   3. walking the sub-chunks in reverse, over a sub-chunk from its slot,
//      keeping each step's state and decay in registers; then the reverse
//      steps over them, with g in registers.
// The inputs come through a ring of whole-chunk stages in shared memory
// (dt, x, dy of the block's channels [Q][CH]; b, c over NP = S P states
// [Q][NP], widened to f32, zeros past N), in the order the walk takes the
// chunks: 0 .. n-2 for level 1 (dt, x, b), then n-1 .. 0 (all five).  One
// staged chunk serves levels 2 and 3 and the reverse steps: nothing is
// fetched twice and no register holds a load in flight.  There is no
// producer warp (160 threads a block would fit three blocks an SM, not
// four): thread 0 issues a chunk's TMA loads (cp.async.bulk.tensor) under
// the stage's full mbarrier, DEPTH - 1 chunks ahead; an operand whose
// base or strides TMA cannot take (16-byte aligned base, batch and time
// strides multiples of 16 bytes) is loaded into the same place by the
// block's threads with plain loads.  The block meets once a chunk, at one
// __syncthreads after the chunk's full barrier, which also frees the
// stage the chunk before it used: the next loads go there.  Steps past T
// and channels past D read zeros (TMA's fill, or the threads'; dt = 0:
// decay 1, u 0, no gradient), so every step runs unguarded.
//
// Sums.  dx and ddt sum over a channel's N states, which its P lanes hold
// (log2 P xor shuffles).  db and dc sum over all D channels: each reverse
// step reduce-scatters a lane's 2 S terms over the warp's channels with
// xor shuffles (15 a step at P = 2, each lane left with one sum; the first
// round, db's term of a state against dc's, inside the step term by term,
// so that the 2 S terms are never live together); the warps' sums of a
// chunk go to shared memory, and after the next chunk's barrier the block
// adds its warps in a fixed order, writes one partial sum a (b, t, channel
// block) to device memory and frees them for the chunk (an mbarrier the
// warps wait on before their first sum of the next); a second kernel adds
// the channel blocks in a fixed order.  dA is summed over t in registers
// and written a batch row; a third kernel adds the rows in order.  There
// are no float atomics: two calls are bit-identical.  (A transpose of the
// terms through shared memory, 16 loads and adds a lane a step in place of
// the shuffles, ran slower: it moves twice the bytes through the shared
// memory pipe; PERF.md.)
//
// What bounds the function at falcon-mamba-7b's training shape (B=4,
// T=2048, D=8192, N=16, bf16 x, b, c): it reads dt, x, dy, b, c, A, h0,
// dh_last and writes their gradients once, ~1.08 GB, 0.32 ms at 3.35 TB/s;
// its B T D N = 1.07 G exponentials take 0.26 ms on the special-function
// units.  This design evaluates each exponential once a level: level 1 on
// (n-1)/n of the steps, level 2 on (Q - SB_SC)/Q of them, level 3 on all,
// 2.74 times at Q = 16 (0.70 ms on those units).  The call has only B D P
// lanes of work (65536 at that shape, ~15.5 warps an SM): SB_MINB = 4 caps
// the registers at 128 so that its 512 blocks run as one wave, and the
// ring is as deep as four blocks' shared memory allows (two stages of 16
// steps at N = 16: the level-1 states of 8-step chunks would take 0.27 GB
// more scratch).  The forms timed (benchmarks/selective_scan_bwd_sweep.py)
// are in PERF.md.

constexpr int SB_Q = 16;                  // steps a chunk: a ring stage
constexpr int SB_SC = 4;                  // steps a sub-chunk (level 3)
constexpr int SB_DEPTH = 3;               // ring stages, at most
constexpr int SB_MINB = 4;                // blocks an SM (caps the registers)
constexpr int SB_NT = 128;                // threads a block
constexpr int SB_NW = SB_NT / 32;
constexpr int SB_S = 8;                   // states a lane
constexpr int SB_TILE = SB_S * SB_NT;     // floats of a block's state slot
constexpr long long SM_SMEM = 233472;     // an SM's shared memory, bytes
constexpr float LN2 = 0.6931471805599453f;
static_assert(SB_Q % (2 * SB_SC) == 0, "a chunk is whole sub-chunks");

struct SelBwd {
  SelArgs f;              // the forward's operands (y, h_last unused)
  const float* dy;        // (B, T, D) f32, contiguous
  const float* dh_last;   // (B, D, N) f32, contiguous
  float* ddt;             // (B, T, D) f32
  void* dx;               // (B, T, D), x's dtype, contiguous
  void* db;               // (B, T, N), b's dtype, contiguous
  void* dc;
  float* dA;              // (D, N)
  float* dh0;             // (B, D, N)
  float* cb;              // scratch: the chunk states, a block's slots
  float* dAp;             // dA's partial sums a batch row (B, D, N)
  float* dbp;             // db's and dc's partial sums a channel block
  float* dcp;             // (B, T, NB, N)
  int NB, nchunks;
  int tma_dt, tma_x, tma_dy, tma_b, tma_c;   // from the plan
};

struct SelBwdMaps {
  CUtensorMap dt, x, dy, b, c;
};

// The main kernel's shared memory, in bytes from a 128-byte boundary: the
// ring's DEPTH stages of Q steps, each dt, x, dy [Q][CH] and b, c [Q][NP]
// (as loaded when bf16, then widened to f32); the state slots (two
// chunk-entry slots, then one a sub-chunk between the first and the last);
// a chunk's warp sums of db and dc ([Q][warp][O]); the full barriers and
// the one that frees the warp sums.  Q is SB_Q, or half of it (not below
// 8) where even a two-stage ring of SB_Q steps would not let SB_MINB
// blocks share an SM (1 KB of it reserved a block); DEPTH is the deepest
// ring up to SB_DEPTH (at least 2) that does.
template <typename TX, int P>
struct SbLayout {
  static constexpr int CH = SB_NT / P, NP = SB_S * P, O = 2 * NP;
  static constexpr int XB = (int)sizeof(TX);
  static constexpr long long stage(int q) {
    return (long long)q * (CH * (8 + XB) + NP * (XB == 2 ? 12 : 8));
  }
  static constexpr long long bytes(int q, int d) {
    const int slots = q / SB_SC > 2 ? q / SB_SC : 2;
    return 128 + d * stage(q) + 4ll * SB_TILE * slots +
           4ll * q * SB_NW * O + 8 * (SB_DEPTH + 1);
  }
  static constexpr bool fits(int q, int d) {
    return SB_MINB * (bytes(q, d) + 1024) <= SM_SMEM;
  }
  static constexpr int Q = fits(SB_Q, 2) || SB_Q < 16 ? SB_Q : SB_Q / 2;
  static constexpr int pick(int d) {
    return d <= 2 || fits(Q, d) ? d : pick(d - 1);
  }
  static constexpr int DEPTH = pick(SB_DEPTH);
  static constexpr int SUBS = Q / SB_SC;               // sub-chunks a chunk
  static constexpr int NSLOT = SUBS > 2 ? SUBS : 2;
  static constexpr uint32_t DT_BYTES = Q * CH * 4;    // dt's, and dy's
  static constexpr uint32_t X_BYTES = Q * CH * XB;
  static constexpr uint32_t BC_BYTES = Q * NP * XB;   // b's, and c's
  static constexpr int RAW = XB == 2 ? (int)BC_BYTES : 0;
  static constexpr int DT = 0, X = DT_BYTES, DY = X + X_BYTES,
                       BR = DY + DT_BYTES, CR = BR + RAW, BF = CR + RAW,
                       CF = BF + Q * NP * 4, STAGE = CF + Q * NP * 4;
  static constexpr int REDSZ = Q * SB_NW * O;          // floats
  static constexpr int SLOTS = DEPTH * STAGE,
                       RED = SLOTS + 4 * NSLOT * SB_TILE,
                       BAR = RED + 4 * REDSZ;
  static constexpr long long SMEM = bytes(Q, DEPTH);
  static_assert(STAGE == stage(Q) && BAR + 8 * (SB_DEPTH + 1) + 128 == SMEM,
                "the layout is what bytes() counts");
  static_assert(X % 128 == 0 && DY % 128 == 0 && BR % 128 == 0 &&
                    CR % 128 == 0 && BF % 128 == 0 && CF % 128 == 0 &&
                    STAGE % 128 == 0,
                "TMA destinations stay 128-byte aligned");
  static_assert(SB_DEPTH >= 2, "the ring loads a chunk ahead");
};

// How a backward call runs: S states a lane, P lanes a channel, CH
// channels a block, NB channel blocks, chunks of Q steps, the ring's
// depth, the main kernel's shared memory (bytes), the scratch the call
// needs (floats), and which of dt, x, dy, b, c come in through TMA.
struct SelBwdPlan {
  int S, P, CH, NB, Q, nchunks, depth;
  long long smem, scratch;
  int tma_dt, tma_x, tma_dy, tma_b, tma_c;
};

template <typename TX>
bool sel_bwd_layout(int P, int* q, int* depth, long long* smem) {
#define SB_LAYOUT(P_)                   \
  case P_:                              \
    *q = SbLayout<TX, P_>::Q;           \
    *depth = SbLayout<TX, P_>::DEPTH;   \
    *smem = SbLayout<TX, P_>::SMEM;     \
    return true;
  switch (P) { SB_LAYOUT(1) SB_LAYOUT(2) SB_LAYOUT(4) SB_LAYOUT(8)
               SB_LAYOUT(16) }
#undef SB_LAYOUT
  return false;
}

// dy: the wrapper's contiguous (B, T, D) f32 (its base decides TMA)
SelBwdPlan plan_selective_bwd(const SelArgs& f, const float* dy,
                              int itemsize) {
  SelBwdPlan pl{};
  pl.S = SB_S;
  pl.P = lanes_for(f.N, SB_S);
  pl.CH = SB_NT / pl.P;
  pl.NB = (f.D + pl.CH - 1) / pl.CH;
  if (itemsize == 2)
    sel_bwd_layout<__nv_bfloat16>(pl.P, &pl.Q, &pl.depth, &pl.smem);
  else
    sel_bwd_layout<float>(pl.P, &pl.Q, &pl.depth, &pl.smem);
  pl.nchunks = (f.T + pl.Q - 1) / pl.Q;
  pl.scratch = (long long)f.B * pl.NB * pl.nchunks * SB_TILE +
               (long long)f.B * f.D * f.N + 2ll * f.B * f.T * pl.NB * f.N;
  pl.tma_dt = tma_ok(f.dt, f.dt_sb, f.dt_st, 4, f.B);
  pl.tma_x = tma_ok(f.x, f.x_sb, f.x_st, itemsize, f.B);
  pl.tma_dy = tma_ok(dy, (long long)f.T * f.D, f.D, 4, f.B);
  pl.tma_b = tma_ok(f.b, f.b_sb, f.b_st, itemsize, f.B);
  pl.tma_c = tma_ok(f.c, f.c_sb, f.c_st, itemsize, f.B);
  return pl;
}

// A thread's 8 states in a state slot, as 2 float4 at [i][thread]; plain
// accesses, not __ldg: the thread itself wrote the slot in this launch
__device__ __forceinline__ void slot8_store(float* s, const float (&h)[8]) {
  float4* q = reinterpret_cast<float4*>(s) + threadIdx.x;
  q[0] = make_float4(h[0], h[1], h[2], h[3]);
  q[SB_NT] = make_float4(h[4], h[5], h[6], h[7]);
}

__device__ __forceinline__ void slot8_load(float (&h)[8], const float* s) {
  const float4* q = reinterpret_cast<const float4*>(s) + threadIdx.x;
  const float4 u = q[0], w = q[SB_NT];
  h[0] = u.x; h[1] = u.y; h[2] = u.z; h[3] = u.w;
  h[4] = w.x; h[5] = w.y; h[6] = w.z; h[7] = w.w;
}

// a thread's slot from device memory into shared memory, asynchronously
// (cp.async, 16 bytes at a time through L2); cp_async_wait waits for it
__device__ __forceinline__ void slot8_prefetch(float* dst, const float* src) {
  const float4* s = reinterpret_cast<const float4*>(src) + threadIdx.x;
  float4* d = reinterpret_cast<float4*>(dst) + threadIdx.x;
#pragma unroll
  for (int i = 0; i < 2; ++i)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     hopper::smem_u32(d + i * SB_NT)),
                 "l"(s + i * SB_NT)
                 : "memory");
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// hopper::mbar_wait, except that a wait far longer than any load takes
// (2^22 polls) traps: a launch error the wrapper reports, not a hang
__device__ __forceinline__ void sb_wait(uint64_t* bar, uint32_t parity) {
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

__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void smem_read8(float (&v)[8], const float* p) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  const float4 w = *reinterpret_cast<const float4*>(p + 4);
  v[0] = u.x; v[1] = u.y; v[2] = u.z; v[3] = u.w;
  v[4] = w.x; v[5] = w.y; v[6] = w.z; v[7] = w.w;
}

// Steps t0 .. t0 + Q - 1 of W columns of a (T, *) operand (rows `st`
// elements apart, src at its first column; `cols` of the W real) into
// dst [Q][W] by the block's threads, for an operand TMA cannot take;
// zeros past T and past `cols`.  The loads of a thread are in flight
// together.
template <int Q, int W, typename TD, typename TS>
__device__ __forceinline__ void sb_fill(TD* dst, const TS* src, long long st,
                                        int t0, int T, int cols) {
  constexpr int E = (Q * W + SB_NT - 1) / SB_NT;
  TS v[E];
#pragma unroll
  for (int i = 0; i < E; ++i) {
    const int e = threadIdx.x + i * SB_NT, s = e / W, c = e % W;
    v[i] = e < Q * W && t0 + s < T && c < cols ? src[(t0 + s) * st + c]
                                               : TS(0.f);
  }
#pragma unroll
  for (int i = 0; i < E; ++i) {
    const int e = threadIdx.x + i * SB_NT;
    if (e < Q * W) {
      if constexpr (sizeof(TD) == 4)
        dst[e] = to_f(v[i]);
      else
        dst[e] = v[i];
    }
  }
}

// b or c of a chunk as TMA loaded it (bf16) into its f32 place
template <int Q, int NP>
__device__ __forceinline__ void sb_widen(float* dst,
                                         const __nv_bfloat16* src) {
#pragma unroll
  for (int e = threadIdx.x; e < Q * NP; e += SB_NT)
    dst[e] = __bfloat162float(src[e]);
}

// One reduce-scatter round over the lanes that differ in bit M: a lane
// keeps the upper HALF of its values if its bit is set, else the lower,
// adding its partner's; `off` tracks which of the step's 2 S terms the
// kept ones are.
template <int HALF>
__device__ __forceinline__ void rs_round(float (&v)[SB_S], int lane, int M,
                                         int& off) {
  const bool hi = (lane & M) != 0;
#pragma unroll
  for (int i = 0; i < HALF; ++i) {
    const float send = hi ? v[i] : v[i + HALF];
    const float keep = hi ? v[i + HALF] : v[i];
    v[i] = keep + __shfl_xor_sync(FULL, send, M);
  }
  if (hi) off += HALF;
}

// A reverse step's db and dc terms summed over the warp's 32 / P channels
// (lane bits log2 P .. 4) into dst[db | dc][NP]: the first round (bit 16,
// db's term of state j against dc's) is taken in the step itself, term by
// term, leaving v the S sums a lane kept and `off` = S where it kept dc's;
// the other rounds here.  Each sum is written once.
template <int P>
__device__ __forceinline__ void channel_sums(float (&v)[SB_S], float* dst,
                                             int lane, int q, int off) {
  if constexpr (P <= 8) rs_round<4>(v, lane, 8, off);
  if constexpr (P <= 4) rs_round<2>(v, lane, 4, off);
  if constexpr (P <= 2) rs_round<1>(v, lane, 2, off);
  if constexpr (P == 1) {        // the last channel bit: both lanes add
    v[0] += __shfl_xor_sync(FULL, v[0], 1);
    if (lane & 1) return;
  }
  constexpr int KEEP = P >= 16 ? 8 : P == 8 ? 4 : P == 4 ? 2 : 1;
#pragma unroll
  for (int i = 0; i < KEEP; ++i) {
    const int k = off + i;
    dst[(k / SB_S) * SB_S * P + q * SB_S + k % SB_S] = v[i];
  }
}

// Where a thread sits: lane q of channel cl (states n0 = q S ..) of
// channel block cblk, batch row bb.  Made from opaque copies of threadIdx
// and blockIdx at the top of every chunk, so that ptxas derives the
// addresses again there rather than hoisting them out of the walk and
// spilling them (as mamba2_bwd_tile_kernel does).
template <int P>
struct SbPlace {
  int tid, lane, warp, cl, q, n0, cblk, bb, d0;
  __device__ __forceinline__ SbPlace() {
    int t = threadIdx.x, x = blockIdx.x, y = blockIdx.y;
    asm volatile("" : "+r"(t), "+r"(x), "+r"(y));
    tid = t;
    lane = t % 32;
    warp = t / 32;
    cl = t / P;
    q = t % P;
    n0 = q * SB_S;
    cblk = x;
    bb = y;
    d0 = x * (SB_NT / P);
  }
};

template <typename TX, int P>
__global__ void __launch_bounds__(SB_NT, SB_MINB)
selective_bwd_kernel(const __grid_constant__ SelBwdMaps maps,
                     const SelBwd a) {
  using L = SbLayout<TX, P>;
  using Pl = SbPlace<P>;
  constexpr int S = SB_S, CH = L::CH, NP = L::NP, O = L::O, SC = SB_SC,
                Q = L::Q, DEPTH = L::DEPTH;
  extern __shared__ unsigned char sel_bwd_smem[];
  unsigned char* sm =
      sel_bwd_smem +
      ((128u - (hopper::smem_u32(sel_bwd_smem) & 127u)) & 127u);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::BAR);
  uint64_t* red_free = full + SB_DEPTH;     // the warp sums flushed
  float* slots = reinterpret_cast<float*>(sm + L::SLOTS);
  float* red = reinterpret_cast<float*>(sm + L::RED);
  const SelArgs& f = a.f;
  const int T = f.T, D = f.D, N = f.N, nch = a.nchunks;
  const int items = 2 * nch - 1;      // chunks 0 .. n-2, then n-1 .. 0

  auto chunk_of = [&](int i) { return i < nch - 1 ? i : 2 * nch - 2 - i; };
  // the thread's first state of channel d in a (B, D, N) tensor
  auto state_off = [&](const Pl& pc) {
    const int d = pc.d0 + pc.cl;
    return ((long long)pc.bb * D + (d < D ? d : 0)) * N + pc.n0;
  };
  // item i's inputs into its stage: one thread's TMA loads under the
  // stage's full barrier, the block's threads for the operands TMA cannot
  // take; dy and c only for the reverse walk
  auto issue = [&](int i, const Pl& pc) {
    unsigned char* st = sm + (i % DEPTH) * L::STAGE;
    const int t0 = chunk_of(i) * Q, d0 = pc.d0, bb = pc.bb;
    const bool rev = i >= nch - 1;
    constexpr int BT = sizeof(TX) == 2 ? L::BR : L::BF;   // TMA's b, c
    constexpr int CT = sizeof(TX) == 2 ? L::CR : L::CF;
    if (pc.tid == 0) {
      uint64_t* bar = &full[i % DEPTH];
      const uint32_t bytes = (a.tma_dt ? L::DT_BYTES : 0) +
                             (a.tma_x ? L::X_BYTES : 0) +
                             (a.tma_b ? L::BC_BYTES : 0) +
                             (rev && a.tma_dy ? L::DT_BYTES : 0) +
                             (rev && a.tma_c ? L::BC_BYTES : 0);
      if (bytes == 0) {
        hopper::mbar_arrive(bar);
      } else {
        hopper::mbar_arrive_expect_tx(bar, bytes);
        if (a.tma_dt)
          hopper::tma_load_3d(st + L::DT, &maps.dt, bar, d0, t0, bb);
        if (a.tma_x) hopper::tma_load_3d(st + L::X, &maps.x, bar, d0, t0, bb);
        if (a.tma_b) hopper::tma_load_3d(st + BT, &maps.b, bar, 0, t0, bb);
        if (rev && a.tma_dy)
          hopper::tma_load_3d(st + L::DY, &maps.dy, bar, d0, t0, bb);
        if (rev && a.tma_c)
          hopper::tma_load_3d(st + CT, &maps.c, bar, 0, t0, bb);
      }
    }
    if (!a.tma_dt)
      sb_fill<Q, CH>(reinterpret_cast<float*>(st + L::DT),
                     f.dt + bb * f.dt_sb + d0, f.dt_st, t0, T, D - d0);
    if (!a.tma_x)
      sb_fill<Q, CH>(reinterpret_cast<TX*>(st + L::X),
                     static_cast<const TX*>(f.x) + bb * f.x_sb + d0, f.x_st,
                     t0, T, D - d0);
    if (!a.tma_b)
      sb_fill<Q, NP>(reinterpret_cast<float*>(st + L::BF),
                     static_cast<const TX*>(f.b) + bb * f.b_sb, f.b_st, t0,
                     T, N);
    if (rev && !a.tma_dy)
      sb_fill<Q, CH>(reinterpret_cast<float*>(st + L::DY),
                     a.dy + (long long)bb * T * D + d0, (long long)D, t0, T,
                     D - d0);
    if (rev && !a.tma_c)
      sb_fill<Q, NP>(reinterpret_cast<float*>(st + L::CF),
                     static_cast<const TX*>(f.c) + bb * f.c_sb, f.c_st, t0,
                     T, N);
  };
  // the block's partial sums of db and dc over chunk k's steps (its warps'
  // sums, added in a fixed order), then red is free again
  auto flush = [&](int k, const Pl& pc) {
    const int t0 = k * Q, steps = min(Q, T - t0);
    for (int e = pc.tid; e < steps * O; e += SB_NT) {
      const int s = e / O, o = e % O, n = o % NP;
      const float* w = red + s * SB_NW * O + o;
      float sum = 0.f;
#pragma unroll
      for (int k2 = 0; k2 < SB_NW; ++k2) sum += w[k2 * O];
      if (n < N) {
        const long long row =
            ((long long)pc.bb * T + t0 + s) * a.NB + pc.cblk;
        (o < NP ? a.dbp : a.dcp)[row * N + n] = sum;
      }
    }
    __syncwarp();
    if (pc.lane == 0) hopper::mbar_arrive(red_free);
  };
  // h = decay_t h + (dt_t x_t) b_t over staged steps s0 .. s0 + SC - 1
  auto forward = [&](float (&hh)[S], const float (&A2)[S],
                     const unsigned char* st, int s0, const Pl& pc) {
    const float* sdt = reinterpret_cast<const float*>(st + L::DT) + pc.cl;
    const TX* sx = reinterpret_cast<const TX*>(st + L::X) + pc.cl;
    const float* sbv = reinterpret_cast<const float*>(st + L::BF) + pc.n0;
#pragma unroll
    for (int u = 0; u < SC; ++u) {
      const int s = s0 + u;
      const float dt = sdt[s * CH];
      const float dx = dt * to_f(sx[s * CH]);
      float bv[S];
      smem_read8(bv, sbv + s * NP);
#pragma unroll
      for (int j = 0; j < S; ++j)
        hh[j] = fmaf(hopper::ex2(dt * A2[j]), hh[j], dx * bv[j]);
    }
  };

  float A2[S], h[S], g[S], dAr[S];
  {
    const Pl pc;
    const bool live = pc.d0 + pc.cl < D;
    const int dl = live ? pc.d0 + pc.cl : 0;
    load_states<S>(A2, f.A + (long long)dl * N + pc.n0, pc.n0, N, live,
                   f.vec);
#pragma unroll
    for (int j = 0; j < S; ++j) A2[j] *= LOG2E;
    load_states<S>(h, f.h0 + state_off(pc), pc.n0, N, live, f.vec);
    if (pc.tid == 0) {
      for (int k = 0; k < DEPTH; ++k) hopper::mbar_init(&full[k], 1);
      hopper::mbar_init(red_free, SB_NW);
      hopper::mbar_fence_init();
    }
    __syncthreads();
    for (int i = 0; i + 1 < DEPTH && i < items; ++i) issue(i, pc);
  }
  for (int i = 0; i < items; ++i) {
    const Pl pc;
    const int k = chunk_of(i);
    const bool rev = i >= nch - 1;
    const unsigned char* st = sm + (i % DEPTH) * L::STAGE;
    float* cb = a.cb + ((long long)pc.bb * a.NB + pc.cblk) * nch * SB_TILE;
    sb_wait(&full[i % DEPTH], (i / DEPTH) & 1);
    if constexpr (sizeof(TX) == 2) {
      unsigned char* sw = sm + (i % DEPTH) * L::STAGE;
      if (a.tma_b)
        sb_widen<Q, NP>(reinterpret_cast<float*>(sw + L::BF),
                        reinterpret_cast<const __nv_bfloat16*>(sw + L::BR));
      if (rev && a.tma_c)
        sb_widen<Q, NP>(reinterpret_cast<float*>(sw + L::CF),
                        reinterpret_cast<const __nv_bfloat16*>(sw + L::CR));
    }
    // the block's one meeting a chunk: this chunk's stage is whole, the
    // last chunk's stage is free and its warp sums are in
    __syncthreads();
    if (i + DEPTH - 1 < items) issue(i + DEPTH - 1, pc);
    if (i >= nch) flush(chunk_of(i - 1), pc);
    if (!rev) {
      // 1. the state entering chunk k, then the chunk
      slot8_store(cb + k * SB_TILE, h);
      for (int j = 0; j < L::SUBS; ++j) forward(h, A2, st, j * SC, pc);
      continue;
    }
    // the state entering chunk k: h itself for the last chunk, else the
    // slot prefetched during the chunk after it; chunk k - 1's next
    const int t0 = k * Q, nsub = min(L::SUBS, (T - t0 + SC - 1) / SC);
    float* entry = slots + (k & 1) * SB_TILE;
    float* mid = slots + 2 * SB_TILE;     // sub-chunks 1 .. SUBS - 2
    if (k == nch - 1) {
      const bool live = pc.d0 + pc.cl < D;
      load_states<S>(g, a.dh_last + state_off(pc), pc.n0, N, live, f.vec);
#pragma unroll
      for (int j = 0; j < S; ++j) dAr[j] = 0.f;
      slot8_store(entry, h);
    } else {
      cp_async_wait();
      slot8_load(h, entry);
    }
    if (k > 0) slot8_prefetch(slots + ((k - 1) & 1) * SB_TILE,
                              cb + (k - 1) * SB_TILE);
    // 2. the state entering every sub-chunk of chunk k
    for (int j = 0; j + 1 < nsub; ++j) {
      if (j > 0) slot8_store(mid + (j - 1) * SB_TILE, h);
      forward(h, A2, st, j * SC, pc);
    }
    // the last chunk's warp sums are out of red before any goes in
    if (i >= nch) sb_wait(red_free, (i - nch) & 1);
    for (int j = nsub - 1; j >= 0; --j) {
      // 3. the sub-chunk's states and decays into registers (hs[s] is
      // h_{t0+s-1}), then the reverse walk over them
      const Pl pw;
      const float* sdt = reinterpret_cast<const float*>(st + L::DT) + pw.cl;
      const TX* sx = reinterpret_cast<const TX*>(st + L::X) + pw.cl;
      const float* sdy = reinterpret_cast<const float*>(st + L::DY) + pw.cl;
      const float* sbv = reinterpret_cast<const float*>(st + L::BF) + pw.n0;
      const float* scv = reinterpret_cast<const float*>(st + L::CF) + pw.n0;
      if (j < nsub - 1) slot8_load(h, j == 0 ? entry : mid + (j - 1) * SB_TILE);
      float hs[SC + 1][S], dec[SC][S];
#pragma unroll
      for (int jj = 0; jj < S; ++jj) hs[0][jj] = h[jj];
#pragma unroll
      for (int u = 0; u < SC; ++u) {
        const int s = j * SC + u;
        const float dt = sdt[s * CH];
        const float dx = dt * to_f(sx[s * CH]);
        float bv[S];
        smem_read8(bv, sbv + s * NP);
#pragma unroll
        for (int jj = 0; jj < S; ++jj) {
          dec[u][jj] = hopper::ex2(dt * A2[jj]);
          hs[u + 1][jj] = fmaf(dec[u][jj], hs[u][jj], dx * bv[jj]);
        }
      }
      const bool hi = (pw.lane & 16) != 0;
#pragma unroll
      for (int u = SC - 1; u >= 0; --u) {
        const int s = j * SC + u;
        const float dt = sdt[s * CH];
        const float xv = to_f(sx[s * CH]);
        const float dyv = sdy[s * CH];
        const float dtx = dt * xv;
        float bv[S], cv[S], v[S];
        smem_read8(bv, sbv + s * NP);
        smem_read8(cv, scv + s * NP);
        float gb = 0.f, ada = 0.f;     // <g_t, b_t> and <A log2 e, da_t>
#pragma unroll
        for (int jj = 0; jj < S; ++jj) {
          g[jj] = fmaf(dyv, cv[jj], g[jj]);                 // g_t
          gb = fmaf(g[jj], bv[jj], gb);
          const float da = dec[u][jj] * g[jj] * hs[u][jj];
          ada = fmaf(A2[jj], da, ada);
          dAr[jj] = fmaf(dt, da, dAr[jj]);
          // db's and dc's terms, the first round of their sums over the
          // warp's channels at once: the lane keeps dc's if bit 16 is set
          const float tb = dtx * g[jj], tc = dyv * hs[u + 1][jj];
          v[jj] = (hi ? tc : tb) + __shfl_xor_sync(FULL, hi ? tb : tc, 16);
          g[jj] *= dec[u][jj];                               // decay_t g_t
        }
#pragma unroll
        for (int o = P / 2; o > 0; o >>= 1) {
          gb += __shfl_xor_sync(FULL, gb, o);
          ada += __shfl_xor_sync(FULL, ada, o);
        }
        const int t = t0 + s, d = pw.d0 + pw.cl;
        if (d < D && pw.q == 0 && t < T) {
          const long long row = ((long long)pw.bb * T + t) * D + d;
          store_as(static_cast<TX*>(a.dx) + row, dt * gb);
          a.ddt[row] = fmaf(LN2, ada, xv * gb);
        }
        channel_sums<P>(v, red + (s * SB_NW + pw.warp) * O, pw.lane, pw.q,
                        hi ? S : 0);
      }
    }
  }
  __syncthreads();
  const Pl pc;
  flush(0, pc);
  const bool live = pc.d0 + pc.cl < D;
  store_states<S>(g, a.dh0 + state_off(pc), pc.n0, N, live, f.vec);
  store_states<S>(dAr, a.dAp + state_off(pc), pc.n0, N, live, f.vec);
}

// db, dc (B, T, N): each the sum of its NB channel blocks' partial sums,
// in order; one thread a (b, t, n)
template <typename TX>
__global__ void __launch_bounds__(256) selective_bwd_bc_kernel(const SelBwd a) {
  const SelArgs& f = a.f;
  const long long e = (long long)blockIdx.x * 256 + threadIdx.x;
  if (e >= (long long)f.B * f.T * f.N) return;
  const long long base = e / f.N * a.NB * f.N + e % f.N;
  float sb = 0.f, sc = 0.f;
  for (int k = 0; k < a.NB; ++k) {
    sb += a.dbp[base + (long long)k * f.N];
    sc += a.dcp[base + (long long)k * f.N];
  }
  store_as(static_cast<TX*>(a.db) + e, sb);
  store_as(static_cast<TX*>(a.dc) + e, sc);
}

// dA (D, N): the batch rows' partial sums, in order; one thread a (d, n)
__global__ void __launch_bounds__(256) selective_bwd_A_kernel(const SelBwd a) {
  const SelArgs& f = a.f;
  const long long e = (long long)blockIdx.x * 256 + threadIdx.x;
  const long long dn = (long long)f.D * f.N;
  if (e >= dn) return;
  float s = 0.f;
  for (int b = 0; b < f.B; ++b) s += a.dAp[b * dn + e];
  a.dA[e] = s;
}

template <typename TX, int P>
cudaError_t launch_sel_bwd(const SelBwd& a, const SelBwdPlan& pl,
                           cudaStream_t st) {
  using L = SbLayout<TX, P>;
  if (pl.smem != L::SMEM || pl.depth != L::DEPTH || pl.Q != L::Q)
    return cudaErrorInvalidValue;
  const SelArgs& f = a.f;
  SelBwdMaps maps;
  memset(&maps, 0, sizeof maps);
  const auto f32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  const auto tx_type = sizeof(TX) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                       : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  const int xb = (int)sizeof(TX);
  if ((a.tma_dt && !map_operand(&maps.dt, f32, 4, f.dt, f.B, f.T, f.D,
                                f.dt_sb, f.dt_st, L::CH, L::Q)) ||
      (a.tma_x && !map_operand(&maps.x, tx_type, xb, f.x, f.B, f.T, f.D,
                               f.x_sb, f.x_st, L::CH, L::Q)) ||
      (a.tma_dy && !map_operand(&maps.dy, f32, 4, a.dy, f.B, f.T, f.D,
                                (long long)f.T * f.D, f.D, L::CH, L::Q)) ||
      (a.tma_b && !map_operand(&maps.b, tx_type, xb, f.b, f.B, f.T, f.N,
                               f.b_sb, f.b_st, L::NP, L::Q)) ||
      (a.tma_c && !map_operand(&maps.c, tx_type, xb, f.c, f.B, f.T, f.N,
                               f.c_sb, f.c_st, L::NP, L::Q)))
    return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      selective_bwd_kernel<TX, P>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::SMEM);
  if (e != cudaSuccess) return e;
  selective_bwd_kernel<TX, P>
      <<<dim3(pl.NB, f.B), SB_NT, L::SMEM, st>>>(maps, a);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const long long btn = (long long)f.B * f.T * f.N;
  const long long dn = (long long)f.D * f.N;
  selective_bwd_bc_kernel<TX>
      <<<(unsigned)((btn + 255) / 256), 256, 0, st>>>(a);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  selective_bwd_A_kernel<<<(unsigned)((dn + 255) / 256), 256, 0, st>>>(a);
  return cudaGetLastError();
}

template <typename TX>
cudaError_t dispatch_sel_bwd(const SelBwd& a, const SelBwdPlan& pl,
                             cudaStream_t st) {
  switch (pl.P) {
    case 1: return launch_sel_bwd<TX, 1>(a, pl, st);
    case 2: return launch_sel_bwd<TX, 2>(a, pl, st);
    case 4: return launch_sel_bwd<TX, 4>(a, pl, st);
    case 8: return launch_sel_bwd<TX, 8>(a, pl, st);
    case 16: return launch_sel_bwd<TX, 16>(a, pl, st);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Returns a cudaError_t (0 on success).  N <= 128.
int mamba_scan_fwd(const float* decay, const float* u, const float* c,
                   float* y, int B, int T, int D, int N, void* stream) {
  if (B <= 0 || T <= 0 || D <= 0 || N <= 0 || N > MAX_N)
    return (int)cudaErrorInvalidValue;
  const int P = lanes_for(N, SA);
  const bool vec = N % 4 == 0 &&
                   ((uintptr_t)decay | (uintptr_t)u | (uintptr_t)c) % 16 == 0;
  auto s = static_cast<cudaStream_t>(stream);
  const unsigned grid = (unsigned)(((long long)B * D * P + NT - 1) / NT);
  if (vec)
    mamba_scan_kernel<true><<<grid, NT, 0, s>>>(decay, u, c, y, B, T, D, N, P);
  else
    mamba_scan_kernel<false><<<grid, NT, 0, s>>>(decay, u, c, y, B, T, D, N,
                                                 P);
  return (int)cudaGetLastError();
}

// x, b, c: dtype 0 float32, 1 bfloat16, all alike; strides in elements,
// unit stride along the last axis.  Returns a cudaError_t (0 on success).
int selective_scan_fwd(const float* dt, const void* x, const void* b,
                       const void* c, const float* A, const float* h0,
                       float* y, float* h_last, int dtype, int B, int T, int D,
                       int N, long long dt_sb, long long dt_st, long long x_sb,
                       long long x_st, long long b_sb, long long b_st,
                       long long c_sb, long long c_st, void* stream) {
  SelArgs a;
  int itemsize;
  if (!sel_args(&a, dt, x, b, c, A, h0, y, h_last, dtype, B, T, D, N, dt_sb,
                dt_st, x_sb, x_st, b_sb, b_st, c_sb, c_st, &itemsize))
    return (int)cudaErrorInvalidValue;
  const SelPlan pl = plan_selective(a, itemsize);
  a.vec = pl.vec;
  a.tma_dt = pl.tma_dt;
  a.tma_x = pl.tma_x;
  auto s = static_cast<cudaStream_t>(stream);
  return (int)(dtype == 0 ? dispatch_sel<float>(a, pl, s)
                          : dispatch_sel<__nv_bfloat16>(a, pl, s));
}

// The plan selective_scan_fwd makes for these arguments, into out[0..8]:
// S, P, CH, direct, tma_dt, tma_x, vec, grid x, grid y.  Launches nothing.
int selective_scan_plan(const float* dt, const void* x, const void* b,
                        const void* c, const float* A, const float* h0,
                        float* y, float* h_last, int dtype, int B, int T,
                        int D, int N, long long dt_sb, long long dt_st,
                        long long x_sb, long long x_st, long long b_sb,
                        long long b_st, long long c_sb, long long c_st,
                        int* out) {
  SelArgs a;
  int itemsize;
  if (!sel_args(&a, dt, x, b, c, A, h0, y, h_last, dtype, B, T, D, N, dt_sb,
                dt_st, x_sb, x_st, b_sb, b_st, c_sb, c_st, &itemsize))
    return (int)cudaErrorInvalidValue;
  const SelPlan pl = plan_selective(a, itemsize);
  const int v[9] = {pl.S, pl.P, pl.CH, pl.direct, pl.tma_dt, pl.tma_x,
                    pl.vec, (int)pl.gx, (int)pl.gy};
  for (int i = 0; i < 9; ++i) out[i] = v[i];
  return 0;
}

// The Mamba-2 form.  dt (B, T, H) f32; x (B, T, H, P), b and c (B, T, N)
// in dtype 0 float32 or 1 bfloat16, all alike; A (H,) f32; h0 and h_last
// (B, H, P, N) f32 contiguous; y (B, T, H, P) f32 contiguous.  Strides in
// elements, unit stride along the last axis of dt, x, b, c.  Returns a
// cudaError_t (0 on success).  N <= 128.
int mamba2_scan_fwd(const float* dt, const void* x, const void* b,
                    const void* c, const float* A, const float* h0, float* y,
                    float* h_last, int dtype, int B, int T, int H, int P,
                    int N, long long dt_sb, long long dt_st, long long x_sb,
                    long long x_st, long long x_sh, long long b_sb,
                    long long b_st, long long c_sb, long long c_st,
                    void* stream) {
  M2Args a;
  if (!m2_args(&a, dt, x, b, c, A, h0, y, h_last, dtype, B, T, H, P, N,
               dt_sb, dt_st, x_sb, x_st, x_sh, b_sb, b_st, c_sb, c_st))
    return (int)cudaErrorInvalidValue;
  const M2Plan pl = plan_mamba2(a);
  a.vec = pl.vec;
  a.tma_x = pl.tma_x;
  a.tma_b = pl.tma_b;
  a.tma_c = pl.tma_c;
  a.tma_y = pl.tma_y;
  auto s = static_cast<cudaStream_t>(stream);
  return (int)(dtype == 0 ? dispatch_m2<float>(a, pl, s)
                          : dispatch_m2<__nv_bfloat16>(a, pl, s));
}

// The plan mamba2_scan_fwd makes for these arguments, into out[0..10]:
// path (0 direct, 1 staged, 2 chunked), NL, R, vec, tma_x, tma_b, tma_c,
// tma_y, grid x, y, z.  Launches nothing.
int mamba2_scan_plan(const float* dt, const void* x, const void* b,
                     const void* c, const float* A, const float* h0, float* y,
                     float* h_last, int dtype, int B, int T, int H, int P,
                     int N, long long dt_sb, long long dt_st, long long x_sb,
                     long long x_st, long long x_sh, long long b_sb,
                     long long b_st, long long c_sb, long long c_st,
                     int* out) {
  M2Args a;
  if (!m2_args(&a, dt, x, b, c, A, h0, y, h_last, dtype, B, T, H, P, N,
               dt_sb, dt_st, x_sb, x_st, x_sh, b_sb, b_st, c_sb, c_st))
    return (int)cudaErrorInvalidValue;
  const M2Plan pl = plan_mamba2(a);
  const int v[11] = {pl.path,  pl.NL,    pl.R,       pl.vec,
                     pl.tma_x,  pl.tma_b, pl.tma_c,   pl.tma_y,
                     (int)pl.gx, (int)pl.gy, (int)pl.gz};
  for (int i = 0; i < 11; ++i) out[i] = v[i];
  return 0;
}

// The Mamba-2 form's backward.  dt, x, b, c, A, h0 and the strides as
// mamba2_scan_fwd takes them; dy (B, T, H, P) and dh_last (B, H, P, N)
// f32; out: ddt (B, T, H) f32, dx (B, T, H, P) in x's dtype, db and dc
// (B, T, N) in b's, dA (H,) f32 and dh0 (B, H, P, N) f32; all of these
// contiguous; scratch: scratch_floats f32, at least the plan's.  Four
// launches on the stream (six on the chunked path); returns a
// cudaError_t (0 on success).
int mamba2_scan_bwd(const float* dt, const void* x, const void* b,
                    const void* c, const float* A, const float* h0,
                    const float* dy, const float* dh_last, float* ddt,
                    void* dx, void* db, void* dc, float* dA, float* dh0,
                    float* scratch, long long scratch_floats, int dtype,
                    int B, int T, int H, int P, int N, long long dt_sb,
                    long long dt_st, long long x_sb, long long x_st,
                    long long x_sh, long long b_sb, long long b_st,
                    long long c_sb, long long c_st, void* stream) {
  M2Bwd a{};
  if (!m2_args(&a.f, dt, x, b, c, A, h0, nullptr, nullptr, dtype, B, T, H,
               P, N, dt_sb, dt_st, x_sb, x_st, x_sh, b_sb, b_st, c_sb, c_st))
    return (int)cudaErrorInvalidValue;
  const M2BwdPlan pl = plan_mamba2_bwd(B, T, H, P, N, dtype);
  if (scratch_floats < pl.scratch) return (int)cudaErrorInvalidValue;
  a.f.vec = N % 4 == 0 &&
            ((uintptr_t)h0 | (uintptr_t)dh_last | (uintptr_t)dh0) % 16 == 0;
  a.dy = dy;
  a.dh_last = dh_last;
  a.ddt = ddt;
  a.dx = dx;
  a.db = db;
  a.dc = dc;
  a.dA = dA;
  a.dh0 = dh0;
  a.NL = pl.NL;
  a.R = pl.R;
  a.RB = pl.RB;
  a.nchunks = pl.nchunks;
  a.heads = pl.heads;
  const long long rows = (long long)B * T * H * pl.RB;
  float* sums;                  // the partial sums of db and dc, then da's
  if (pl.path == M2B_CHUNKED) {
    const long long states = (long long)B * pl.nchunks * H * P * N;
    a.parts = (H + pl.heads - 1) / pl.heads * pl.RB;
    a.hin = scratch;
    a.dhout = scratch + states;
    sums = scratch + 2 * states;
  } else {
    const long long blocks = (long long)B * H * pl.RB;
    a.parts = H * pl.RB;
    a.cb = scratch;
    a.sb = a.cb + blocks * pl.nchunks * BW_TILE;
    sums = a.sb + blocks * BW_SUB * BW_TILE;
  }
  a.dbh = sums;
  a.dch = a.dbh + (long long)B * T * a.parts * N;
  a.dah = a.dch + (long long)B * T * a.parts * N;
  a.xgbh = a.dah + rows;
  auto s = static_cast<cudaStream_t>(stream);
  if (pl.path == M2B_CHUNKED) return (int)launch_m2_bwd_chunked(a, pl, s);
  return (int)(dtype == 0 ? launch_m2_bwd<float>(a, pl, s)
                          : launch_m2_bwd<__nv_bfloat16>(a, pl, s));
}

// The plan mamba2_scan_bwd makes for a (B, T, H, P, N) call with x, b, c
// in dtype (0 float32, 1 bfloat16), into out[0..7]: path (0 CUDA cores,
// 1 chunked), NL, R, RB, chunks, shared memory bytes, scratch floats,
// heads a tile block.  Launches nothing; returns 0, or
// cudaErrorInvalidValue for a shape the kernel does not take.
int mamba2_scan_bwd_plan(int B, int T, int H, int P, int N, int dtype,
                         long long* out) {
  if (B <= 0 || T <= 0 || H <= 0 || P <= 0 || N <= 0 || N > MAX_N ||
      B > 65535 || H > 65535 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const M2BwdPlan pl = plan_mamba2_bwd(B, T, H, P, N, dtype);
  const long long v[8] = {pl.path, pl.NL, pl.R, pl.RB, pl.nchunks, pl.smem,
                          pl.scratch, pl.heads};
  for (int i = 0; i < 8; ++i) out[i] = v[i];
  return 0;
}

// The Mamba-1 form's backward.  dt, x, b, c, A, h0 and the strides as
// selective_scan_fwd takes them; dy (B, T, D) and dh_last (B, D, N) f32;
// out: ddt (B, T, D) f32, dx (B, T, D) in x's dtype, db and dc (B, T, N)
// in b's, dA (D, N) f32 and dh0 (B, D, N) f32; all of these contiguous;
// scratch: scratch_floats f32, at least the plan's.  Three launches on the
// stream; returns a cudaError_t (0 on success).  N <= 128.
int selective_scan_bwd(const float* dt, const void* x, const void* b,
                       const void* c, const float* A, const float* h0,
                       const float* dy, const float* dh_last, float* ddt,
                       void* dx, void* db, void* dc, float* dA, float* dh0,
                       float* scratch, long long scratch_floats, int dtype,
                       int B, int T, int D, int N, long long dt_sb,
                       long long dt_st, long long x_sb, long long x_st,
                       long long b_sb, long long b_st, long long c_sb,
                       long long c_st, void* stream) {
  SelBwd a{};
  int itemsize;
  if (!sel_args(&a.f, dt, x, b, c, A, h0, nullptr, nullptr, dtype, B, T, D,
                N, dt_sb, dt_st, x_sb, x_st, b_sb, b_st, c_sb, c_st,
                &itemsize))
    return (int)cudaErrorInvalidValue;
  const SelBwdPlan pl = plan_selective_bwd(a.f, dy, itemsize);
  if (scratch_floats < pl.scratch) return (int)cudaErrorInvalidValue;
  a.tma_dt = pl.tma_dt;
  a.tma_x = pl.tma_x;
  a.tma_dy = pl.tma_dy;
  a.tma_b = pl.tma_b;
  a.tma_c = pl.tma_c;
  a.dy = dy;
  a.dh_last = dh_last;
  a.ddt = ddt;
  a.dx = dx;
  a.db = db;
  a.dc = dc;
  a.dA = dA;
  a.dh0 = dh0;
  a.NB = pl.NB;
  a.nchunks = pl.nchunks;
  a.cb = scratch;
  a.dAp = a.cb + (long long)B * pl.NB * pl.nchunks * SB_TILE;
  a.dbp = a.dAp + (long long)B * D * N;
  a.dcp = a.dbp + (long long)B * T * pl.NB * N;
  a.f.vec = N % 4 == 0 && ((uintptr_t)A | (uintptr_t)h0 |
                           (uintptr_t)dh_last | (uintptr_t)dh0 |
                           (uintptr_t)a.dAp) % 16 == 0;
  auto s = static_cast<cudaStream_t>(stream);
  return (int)(dtype == 0 ? dispatch_sel_bwd<float>(a, pl, s)
                          : dispatch_sel_bwd<__nv_bfloat16>(a, pl, s));
}

// The plan selective_scan_bwd makes for these operands (dt, x, b, c and
// their strides as it takes them, dy the (B, T, D) f32 it gets), into
// out[0..13]: S, P, CH, channel blocks, steps a chunk, chunks, ring
// depth, shared memory bytes, scratch floats, then 1 where TMA loads dt,
// x, dy, b, c (0 where the block's threads do).  Launches nothing;
// returns 0, or cudaErrorInvalidValue for a shape the kernel does not
// take.
int selective_scan_bwd_plan(const float* dt, const void* x, const void* b,
                            const void* c, const float* dy, int dtype, int B,
                            int T, int D, int N, long long dt_sb,
                            long long dt_st, long long x_sb, long long x_st,
                            long long b_sb, long long b_st, long long c_sb,
                            long long c_st, long long* out) {
  SelArgs f;
  int itemsize;
  if (!sel_args(&f, dt, x, b, c, nullptr, nullptr, nullptr, nullptr, dtype,
                B, T, D, N, dt_sb, dt_st, x_sb, x_st, b_sb, b_st, c_sb, c_st,
                &itemsize))
    return (int)cudaErrorInvalidValue;
  const SelBwdPlan pl = plan_selective_bwd(f, dy, itemsize);
  const long long v[14] = {pl.S,      pl.P,       pl.CH,    pl.NB,
                           pl.Q,      pl.nchunks, pl.depth, pl.smem,
                           pl.scratch, pl.tma_dt, pl.tma_x, pl.tma_dy,
                           pl.tma_b,  pl.tma_c};
  for (int i = 0; i < 14; ++i) out[i] = v[i];
  return 0;
}

const char* ms_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
