// Selective scans (the Mamba-1 and Mamba-2 recurrences) for NVIDIA Hopper
// (sm_90a), CUDA C++ with a plain C interface (loaded through ctypes by kernels/mamba_scan.py).
//
// Replaces repro/kernels/mamba_scan.py::mamba_scan, the Pallas TPU kernel:
//   h_t = decay_t * h_{t-1} + u_t,  y_t = sum_n h_t[:, n] * c_t[n],  h_{-1} = 0
// over decay, u (B, T, D, N), c (B, T, N), all float32, y (B, T, D) float32.
// Three C entry points (and two that report a call's plan):
//   * mamba_scan_fwd: the TPU kernel's contract, any T (no time block bt);
//   * selective_scan_fwd: the fused Mamba-1 form the model calls, as
//     repro/models/ssm.py::mamba1_block's make_chunk/emit_chunk compute it:
//     decay = exp(dt * A), u = (dt * x) * b, built in registers step by step,
//     from h0, returning y and the last state.  It reads dt (B, T, D) f32,
//     x (B, T, D) and b, c (B, T, N) in f32 or bf16, A (D, N) f32 and
//     h0 (B, D, N) f32, and writes y (B, T, D) f32 and h_last (B, D, N) f32;
//     the (B, T, D, N) decay and u are never stored.  It and mamba_scan_fwd
//     share one recurrence core (recur below);
//   * mamba2_scan_fwd: the Mamba-2 form, as repro/models/ssm.py::mamba2_block
//     computes it: a scalar decay exp(dt * A_h) a head, u = (dt * x) * b over
//     a head's (P, N) state, b and c shared by all heads, from h0, returning
//     y (B, T, H, P) and h_last (B, H, P, N).  Its design is at its code
//     below ("mamba2_scan").
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
// plan_selective below makes these choices; kernels/mamba_scan.py mirrors it
// for the tests.  Neither kernel uses the tensor cores; the measured times
// are in PERF.md.

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
// TS steps by one batch row, no swizzle.
bool map_operand(CUtensorMap* map, CUtensorMapDataType type, int itemsize,
                 const void* base, int B, int T, int D, long long sb,
                 long long st, uint32_t ch) {
  const uint64_t dims[3] = {(uint64_t)D, (uint64_t)T, (uint64_t)B};
  const uint64_t bstride = B == 1 ? st * T : sb;   // unused when B == 1
  const uint64_t strides[2] = {(uint64_t)(st * itemsize),
                               bstride * itemsize};
  const uint32_t box[3] = {ch, (uint32_t)TS, 1};
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
// batch row.  A lane holds a 4 x 4 tile of a head's state: rows
// r0 .. r0+3 and states n0 .. n0+3, so the 4 values of b_t and of c_t it
// reads a step serve 16 state-steps.  NL = max(4, next_pow2(N / 4)) lanes
// (a "row group") cover N for the same 4 rows, and a block of M2_NT threads
// holds R = 4 * M2_NT / NL rows of one head of one batch row: zamba2's head
// (P = 64, N = 64: NL = 16, R = 32) takes two blocks, its serving prefill
// (B = 4, H = 80) 640.  Steps past T and rows past P run with zeros
// (dt = 0: decay 1, u 0).
//
// What bounds it: at zamba2's serving prefill (B = 4, T = 1100, H = 80,
// P = N = 64) a state-step is three FP32 instructions (FMUL for u, FFMA for
// h, FFMA for y), 4.3 G in all, ~0.13 ms on the CUDA cores, against ~148 MB
// (x bf16, y f32, h0 and h_last), ~0.044 ms: it is bound by operations.  The
// design spends those three and little else on a state-step:
//   * one exponential a (b, t, h) and row block, not a state: log2(e) is
//     folded into A and the decay of a step is ex2'd once when its dt is
//     staged (zamba2: 2 row blocks a head, 0.7 M ex2 a prefill, where
//     selective_scan_fwd over broadcast inputs would take 1.44 G);
//   * b_t and c_t are loaded once a stage and block for all its rows and
//     read from shared memory, one 16-byte vector each a lane and step
//     (the lanes of a row group read consecutive vectors: no bank
//     conflict).  Shared-memory traffic, not arithmetic, bounded the first
//     design, one row and 16 states a lane: 8 vector loads a step, half of
//     them in conflict, 0.89-1.29 ms at this shape (a diagnostic sweep);
//   * a row's y is summed over the row group by a reduce-scatter: two
//     shuffles halve the four rows' partial sums to one row a lane, then
//     log2(NL) - 2 butterfly shuffles finish it (5 shuffles a step for four
//     rows at NL = 16); every lane then writes its row's y to a shared
//     tile (the lanes of a row the same value, so no branch sits in the
//     step), which the block stores coalesced once a stage;
//   * at NL = 16 (N = 64, zamba2's) the staged kernel is held to 96
//     registers, 5 blocks an SM, so zamba2's 640 blocks run as one wave
//     on 132 SMs: at ptxas's own choice (168 registers, 3 blocks) or at 4
//     blocks (128) they ran as two and took 0.79-0.81 ms against 0.49 (a
//     diagnostic sweep; 6 or 7 blocks spill more and gain nothing).
//     ptxas spills 12 bytes there.  The other row-group widths, which no
//     served model runs, spilled 52-212 bytes under that cap and keep
//     ptxas's choice.
// The tensor cores are not used: the chunked (SSD) form that would put the
// work on them is a later redesign.

constexpr int M2_NT = 128;      // threads a block
constexpr int M2_TS = 16;       // steps a stage
constexpr int M2_DIRECT_T = 8;  // the longest T run without the stages

struct M2Args {
  const float* dt;
  const void* x;
  const void* b;
  const void* c;
  const float* A;
  const float* h0;
  float* y;
  float* h_last;
  int B, T, H, P, N;
  long long dt_sb, dt_st, x_sb, x_st, x_sh, b_sb, b_st, c_sb, c_st;
  int vec;                      // from the plan
};

// How a call runs: NL lanes a row group (4 rows x 4 states a lane), R
// rows a block, the direct path or the stages, 16-byte vectors for h0 and
// h_last, and the grid (row blocks, heads, batch rows).
struct M2Plan {
  int NL, R, direct, vec;
  unsigned gx, gy, gz;
};

M2Plan plan_mamba2(const M2Args& a) {
  M2Plan pl{};
  pl.NL = lanes_for(a.N, 4);
  if (pl.NL < 4) pl.NL = 4;
  pl.R = 4 * M2_NT / pl.NL;
  pl.direct = a.T <= M2_DIRECT_T;
  pl.vec = a.N % 4 == 0 && ((uintptr_t)a.h0 | (uintptr_t)a.h_last) % 16 == 0;
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

// The lane's 4 rows' h0 (or h_last) states n0 .. n0+3.
__device__ __forceinline__ void m2_load_h(float (&h)[4][4], const M2Args& a,
                                          int bb, int hh, int p, int n0) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const bool live = p + i < a.P;
    const long long off =
        (((long long)bb * a.H + hh) * a.P + (live ? p + i : 0)) * a.N + n0;
    load_states<4>(h[i], a.h0 + off, n0, a.N, live, a.vec);
  }
}

__device__ __forceinline__ void m2_store_h(const float (&h)[4][4],
                                           const M2Args& a, int bb, int hh,
                                           int p, int n0) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const bool live = p + i < a.P;
    const long long off =
        (((long long)bb * a.H + hh) * a.P + (live ? p + i : 0)) * a.N + n0;
    store_states<4>(h[i], a.h_last + off, n0, a.N, live, a.vec);
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
  m2_load_h(h, a, bb, hh, p0 + ln.r0, n0);

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
  m2_store_h(h, a, bb, hh, p0 + ln.r0, n0);
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
  m2_load_h(h, a, bb, hh, p, n0);
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
  m2_store_h(h, a, bb, hh, p, n0);
}

template <typename TX, int NL>
cudaError_t launch_m2(const M2Args& a, const M2Plan& pl, cudaStream_t st) {
  const dim3 grid(pl.gx, pl.gy, pl.gz);
  if (pl.direct)
    mamba2_direct_kernel<TX, NL><<<grid, M2_NT, 0, st>>>(a);
  else
    mamba2_staged_kernel<TX, NL><<<grid, M2_NT, 0, st>>>(a);
  return cudaGetLastError();
}

template <typename TX>
cudaError_t dispatch_m2(const M2Args& a, const M2Plan& pl, cudaStream_t st) {
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
  *a = M2Args{dt, x, b, c, A, h0, y, h_last, B, T, H, P, N, dt_sb, dt_st,
              x_sb, x_st, x_sh, b_sb, b_st, c_sb, c_st, 0};
  return true;
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
  auto s = static_cast<cudaStream_t>(stream);
  return (int)(dtype == 0 ? dispatch_m2<float>(a, pl, s)
                          : dispatch_m2<__nv_bfloat16>(a, pl, s));
}

// The plan mamba2_scan_fwd makes for these arguments, into out[0..6]: NL,
// R, direct, vec, grid x, y, z.  Launches nothing.
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
  const int v[7] = {pl.NL, pl.R, pl.direct, pl.vec, (int)pl.gx, (int)pl.gy,
                    (int)pl.gz};
  for (int i = 0; i < 7; ++i) out[i] = v[i];
  return 0;
}

const char* ms_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
