// Selective scan (the Mamba-1 recurrence) for NVIDIA Hopper (sm_90a), CUDA
// C++ with a plain C interface (loaded through ctypes by kernels/mamba_scan.py).
//
// Replaces repro/kernels/mamba_scan.py::mamba_scan, the Pallas TPU kernel:
//   h_t = decay_t * h_{t-1} + u_t,  y_t = sum_n h_t[:, n] * c_t[n],  h_{-1} = 0
// over decay, u (B, T, D, N), c (B, T, N), all float32, y (B, T, D) float32.
// Two C entry points share one recurrence core (recur below):
//   * mamba_scan_fwd: the TPU kernel's contract, any T (no time block bt);
//   * selective_scan_fwd: the fused Mamba-1 form the model calls, as
//     repro/models/ssm.py::mamba1_block's make_chunk/emit_chunk compute it:
//     decay = exp(dt * A), u = (dt * x) * b, built in registers step by step,
//     from h0, returning y and the last state.  It reads dt (B, T, D) f32,
//     x (B, T, D) and b, c (B, T, N) in f32 or bf16, A (D, N) f32 and
//     h0 (B, D, N) f32, and writes y (B, T, D) f32 and h_last (B, D, N) f32;
//     the (B, T, D, N) decay and u are never stored.
//
// Differences from the TPU kernel, none of which change the result beyond
// float32 rounding order: the TPU walks time blocks of bt steps on a
// sequential grid axis and carries the (D, N) state in VMEM scratch.  Blocks
// on Hopper run in parallel and in no order, so the time loop lives inside
// the thread: P = next_pow2(ceil(N / S)) neighbouring lanes own one (b, d)
// channel, each holding S of its N states in registers for the whole
// sequence, and y_t is the lanes' partial sums reduced with warp shuffles.
// There is no T % bt requirement.
//
// What bounds it on this card: mamba_scan_fwd moves 8 * B*T*D*N bytes of
// decay and u and does 2 flops per byte pair: memory-bound (1.107 GB, 0.33 ms
// at 3.35 TB/s for B=1, T=1024, D=8192, N=16).  It keeps S = 4, so that even
// B=1 gives enough lanes to keep every SM loading, and each lane loads the
// inputs of U steps ahead of their use (registers).  selective_scan_fwd reads
// only ~10 bytes per (b, t, d) but evaluates B*T*D*N expf: the special-
// function units bound it (577 M exp, ~0.14 ms at the serving prefill shape).
// It keeps S = min(16, N): a channel's dt and x are loaded once, not once a
// lane, and b, c, shared by every channel of a batch row, are staged in
// shared memory once a block, a chunk of U steps ahead, and read as
// broadcasts.  expf, not __expf, so the result meets the float32 tolerance.
// Neither uses the tensor cores; the measured times are in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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
// One lane holds S = min(16, N) states of its channel, so that the per-step
// inputs dt and x of a channel are loaded once, and b, c (shared by all the
// channels of a batch row) are staged in shared memory once per block and
// read as broadcasts.  Each step evaluates S expf per lane.

struct SelArgs {
  const float* dt;
  const void* x;
  const void* b;
  const void* c;
  const float* A;
  const float* h0;
  float* y;
  float* h_last;
  int B, T, D, N, P;
  long long dt_sb, dt_st, x_sb, x_st, b_sb, b_st, c_sb, c_st;
};

constexpr int BC_PER_THREAD = (U * MAX_N + NT - 1) / NT;

template <typename TX, int S>
__global__ void __launch_bounds__(NT) selective_scan_kernel(const SelArgs a) {
  __shared__ float sb[2][U][MAX_N];
  __shared__ float sc[2][U][MAX_N];
  const int T = a.T, N = a.N, P = a.P;
  const int bb = blockIdx.y;                       // batch row
  const int gid = blockIdx.x * NT + threadIdx.x;
  const int d = gid / P;
  const bool live = d < a.D;
  const int n0 = (gid % P) * S;
  const bool lead = live && gid % P == 0;
  const float* dtp = a.dt + bb * a.dt_sb + (live ? d : 0);
  const TX* xp = static_cast<const TX*>(a.x) + bb * a.x_sb + (live ? d : 0);
  const TX* bp = static_cast<const TX*>(a.b) + bb * a.b_sb;
  const TX* cp = static_cast<const TX*>(a.c) + bb * a.c_sb;
  const long long hoff = ((long long)bb * a.D + d) * N + n0;

  float h[S], Aj[S];
#pragma unroll
  for (int j = 0; j < S; ++j) {
    const bool okj = live && n0 + j < N;
    h[j] = okj ? a.h0[hoff + j] : 0.f;
    Aj[j] = okj ? __ldg(a.A + (long long)d * N + n0 + j) : 0.f;
  }

  // the inputs of steps t0 .. t0+U-1 into registers; a step past T, or a
  // missing channel, gets dt = 0 and b = c = 0: decay 1, u 0, no output
  float ndt[U], nx[U], nb[BC_PER_THREAD], nc[BC_PER_THREAD];
  auto fetch = [&](int t0) {
#pragma unroll
    for (int s = 0; s < U; ++s) {
      const bool ok = live && t0 + s < T;
      ndt[s] = ok ? __ldg(dtp + (t0 + s) * a.dt_st) : 0.f;
      nx[s] = ok ? load(xp + (t0 + s) * a.x_st) : 0.f;
    }
#pragma unroll
    for (int e = 0; e < BC_PER_THREAD; ++e) {
      const int i = threadIdx.x + e * NT;        // (step, state) of the chunk
      const int s = i / N, n = i % N;
      const bool ok = i < U * N && t0 + s < T;
      nb[e] = ok ? load(bp + (t0 + s) * a.b_st + n) : 0.f;
      nc[e] = ok ? load(cp + (t0 + s) * a.c_st + n) : 0.f;
    }
  };
  auto stage = [&](int buf) {
#pragma unroll
    for (int e = 0; e < BC_PER_THREAD; ++e) {
      const int i = threadIdx.x + e * NT;
      if (i < U * N) {
        sb[buf][i / N][i % N] = nb[e];
        sc[buf][i / N][i % N] = nc[e];
      }
    }
  };

  float* yp = a.y + (long long)bb * T * a.D + d;
  float cdt[U], cx[U];
  fetch(0);
  stage(0);
  __syncthreads();
  for (int t0 = 0, buf = 0; t0 < T; t0 += U, buf ^= 1) {
#pragma unroll
    for (int s = 0; s < U; ++s) {
      cdt[s] = ndt[s];
      cx[s] = nx[s];
    }
    const bool more = t0 + U < T;
    if (more) fetch(t0 + U);
#pragma unroll
    for (int s = 0; s < U; ++s) {
      const float dx = cdt[s] * cx[s];
      float decay[S], uu[S], cc[S];
#pragma unroll
      for (int j = 0; j < S; ++j) {
        const bool okj = n0 + j < N;
        decay[j] = expf(cdt[s] * Aj[j]);
        uu[j] = dx * (okj ? sb[buf][s][n0 + j] : 0.f);
        cc[j] = okj ? sc[buf][s][n0 + j] : 0.f;
      }
      const float yv = recur<S>(h, decay, uu, cc, P);
      if (lead && t0 + s < T) yp[(long long)(t0 + s) * a.D] = yv;
    }
    if (more) stage(buf ^ 1);  // that buffer's last reads ended at the sync
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < S; ++j)
    if (live && n0 + j < N) a.h_last[hoff + j] = h[j];
}

template <typename TX>
cudaError_t launch_selective(const SelArgs& args, cudaStream_t s) {
  SelArgs a = args;
  const int S = a.N > 8 ? 16 : a.N > 4 ? 8 : 4;
  a.P = lanes_for(a.N, S);
  const dim3 grid((unsigned)((a.D * (long long)a.P + NT - 1) / NT),
                  (unsigned)a.B);
  if (S == 16)
    selective_scan_kernel<TX, 16><<<grid, NT, 0, s>>>(a);
  else if (S == 8)
    selective_scan_kernel<TX, 8><<<grid, NT, 0, s>>>(a);
  else
    selective_scan_kernel<TX, 4><<<grid, NT, 0, s>>>(a);
  return cudaGetLastError();
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
  if (B <= 0 || T <= 0 || D <= 0 || N <= 0 || N > MAX_N || B > 65535)
    return (int)cudaErrorInvalidValue;
  const SelArgs a{dt, x, b, c, A, h0, y, h_last, B, T, D, N, 0,
                  dt_sb, dt_st, x_sb, x_st, b_sb, b_st, c_sb, c_st};
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_selective<float>(a, s);
  if (dtype == 1) return (int)launch_selective<__nv_bfloat16>(a, s);
  return (int)cudaErrorInvalidValue;
}

const char* ms_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
