// Mamba2 SSD chunked scan for Hopper (sm_90a): the selective state-space
// recurrence of one Mamba2 layer over a whole sequence, per (batch, head).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/ssd_scan/kernel.py::ssd_scan_fwd
//   (pl.pallas_call at :102, body _ssd_kernel at :25).
//
// Function (the reference's, ref.py::ssd_reference): per head h with decay
// A_h < 0 and per position t,
//   state_t = exp(dt_t * A_h) * state_{t-1} + dt_t * x_t B_t^T   ([P, N])
//   y_t     = state_t C_t                                        ([P])
// from the initial state (zeros, or `h0` when given). Like the TPU kernel it
// works a tile of positions at a time: with cs = cumsum(dt * A) inside the
// tile,
//   W[t, s] = (C_t . B_s) exp(cs_t - cs_s) dt_s      for s <= t, else 0
//   y_t     = sum_s W[t, s] x_s + exp(cs_t) (C_t . state_in)
//   state  <- state_in exp(cs_T) + sum_s x_s^T B_s exp(cs_T - cs_s) dt_s
// all in f32; y is written in x's dtype and the final state in f32.
//
// The tile is kT = 64 positions whatever the caller's `chunk` (the TPU
// kernel's grid step): the recurrence is the same function for any tile,
// and the tiles differ only in rounding. 64 keeps the shared memory of a
// block within two blocks per SM at N = 64 and within one at N = 128, where
// the reference's chunk of 128 with f32 x, B, C, a [128, 128] W and the
// state would not fit the 227 KB that a block may use.
//
// Layouts, all contiguous: x, y [B, L, H, P]; dt [B, L, H] f32; A [H] f32;
// Bm, Cm [B, L, N] in x's dtype; h0, state [B, H, P, N] f32. P, N <= 128.
//
// Bound: bytes, at the path's shapes. The kernel must read x, B, C and dt
// and write y and the state once: at B = 2, L = 2048, H = 112, P = N = 64
// in bf16 that is 58.7 MB each for x and y, 1.0 MB (B, C), 1.8 MB (dt) and
// 3.7 MB (state), 124 MB in all, 0.037 ms at 3.35 TB/s. Its arithmetic,
// 2 L (T N + T P / 2 + 2 P N) flops per (batch, head) at the reference's
// chunk T = 128, is 1.9e10 at that shape, 0.019 ms at the bf16 tensor-core
// rate. (B and C are shared across heads and are read once per head here.)
//
// Design (simple first): one block of 256 threads per (batch, head) walks
// the tiles in order and keeps the [P, N] state in shared memory, as the
// TPU kernel keeps it in VMEM scratch across its sequential grid axis. A
// tile's x, B and C are converted to f32 into shared memory (each row
// padded by one float, so 16-strided reads fall in distinct banks); W, y
// and the state update are f32 FMA loops in which each thread owns a
// register tile of 4 x 4..8 (W, y) or 4..8 x 4..8 (state) entries, reading
// one row of each operand per step of the sum. The cumulative sum is taken
// by one thread in position order. Still simple: B * H blocks (224 at the
// server shape) fill 132 SMs under two waves, and no tensor core is used;
// splitting the sequence over blocks (the chunk states are independent
// until the inter-chunk pass) and tensor-core tiles on bf16 x, B, C are
// later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kT = 64;         // positions per tile
constexpr int kThreads = 256;
constexpr int kMaxPN = 128;    // P and N up to this

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

size_t smem_floats(int P, int N) {
  return (size_t)2 * kT * (N + 1)      // B, C
         + (size_t)kT * (P + 1)        // x
         + (size_t)kT * (kT + 1)       // W
         + (size_t)P * (N + 1)         // state
         + 3 * kT;                     // cs, dt, decay-to-end * dt
}

// JP, JN: the 16-strided columns of P and N that a thread owns (4 for
// P, N <= 64, else 8)
template <typename T, int JP, int JN>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const T* __restrict__ Bm,
                const T* __restrict__ Cm, const float* __restrict__ h0,
                T* __restrict__ y, float* __restrict__ state, int L, int H,
                int P, int N) {
  extern __shared__ float smem[];
  const int PN = N + 1, PP = P + 1, PT = kT + 1;
  float* sB = smem;             // [kT][N + 1]
  float* sC = sB + kT * PN;     // [kT][N + 1]
  float* sX = sC + kT * PN;     // [kT][P + 1]
  float* sW = sX + kT * PP;     // [kT][kT + 1]
  float* sH = sW + kT * PT;     // [P][N + 1]
  float* sCs = sH + P * PN;     // [kT]
  float* sDt = sCs + kT;        // [kT]
  float* sWs = sDt + kT;        // [kT]

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const float a = A[h];
  const long long bh = (long long)b * H + h;

  for (int i = tid; i < P * N; i += kThreads)
    sH[(i / N) * PN + i % N] = h0 ? h0[bh * P * N + i] : 0.f;

  for (int t0 = 0; t0 < L; t0 += kT) {
    const int nt = min(kT, L - t0);
    __syncthreads();  // the previous tile is done with shared memory
    const long long row0 = (long long)b * L + t0;  // (batch, position) row
    for (int i = tid; i < kT; i += kThreads)
      sDt[i] = i < nt ? dt[(row0 + i) * H + h] : 0.f;
    for (int i = tid; i < kT * P; i += kThreads) {
      const int t = i / P, p = i % P;
      sX[t * PP + p] = t < nt ? to_f32(x[((row0 + t) * H + h) * P + p]) : 0.f;
    }
    for (int i = tid; i < kT * N; i += kThreads) {
      const int t = i / N, n = i % N;
      const bool ok = t < nt;
      sB[t * PN + n] = ok ? to_f32(Bm[(row0 + t) * N + n]) : 0.f;
      sC[t * PN + n] = ok ? to_f32(Cm[(row0 + t) * N + n]) : 0.f;
    }
    __syncthreads();
    if (tid == 0) {  // inclusive cumsum of dt * A, in position order
      float c = 0.f;
      for (int t = 0; t < kT; ++t) {
        c += sDt[t] * a;
        sCs[t] = c;
      }
    }
    __syncthreads();
    const float cs_end = sCs[kT - 1];  // padded positions have dt = 0
    for (int i = tid; i < kT; i += kThreads)
      sWs[i] = expf(cs_end - sCs[i]) * sDt[i];
    // Each thread owns a 4 x (up to 8) tile of W, y and the state, with
    // rows ty + 16 i and columns tx + 16 j: per step of the inner sum it
    // reads 4 + 4..8 values from shared memory for 16..64 FMAs, and the
    // 16-strided columns fall in distinct banks.
    const int ty = tid >> 4, tx = tid & 15;
    {  // W[t, s] = (C_t . B_s) exp(cs_t - cs_s) dt_s on s <= t
      float w[4][4] = {};
      for (int n = 0; n < N; ++n) {
        float c[4], bb[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) c[i] = sC[(ty + 16 * i) * PN + n];
#pragma unroll
        for (int j = 0; j < 4; ++j) bb[j] = sB[(tx + 16 * j) * PN + n];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) w[i][j] += c[i] * bb[j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int s2 = tx + 16 * j;
          sW[t * PT + s2] =
              s2 <= t ? w[i][j] * expf(sCs[t] - sCs[s2]) * sDt[s2] : 0.f;
        }
      }
    }
    __syncthreads();
    {  // y_t = sum_s W[t, s] x_s + exp(cs_t) (C_t . state_in)
      float acc[4][JP] = {}, ch[4][JP] = {};
      for (int s2 = 0; s2 <= min(nt - 1, ty + 48); ++s2) {
        float w[4], xv[JP];
#pragma unroll
        for (int i = 0; i < 4; ++i) w[i] = sW[(ty + 16 * i) * PT + s2];
#pragma unroll
        for (int j = 0; j < JP; ++j) xv[j] = sX[s2 * PP + min(tx + 16 * j, P - 1)];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < JP; ++j) acc[i][j] += w[i] * xv[j];
      }
      for (int n = 0; n < N; ++n) {
        float c[4], hv[JP];
#pragma unroll
        for (int i = 0; i < 4; ++i) c[i] = sC[(ty + 16 * i) * PN + n];
#pragma unroll
        for (int j = 0; j < JP; ++j) hv[j] = sH[min(tx + 16 * j, P - 1) * PN + n];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < JP; ++j) ch[i][j] += c[i] * hv[j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = ty + 16 * i;
        if (t >= nt) continue;
        const float e = expf(sCs[t]);
#pragma unroll
        for (int j = 0; j < JP; ++j) {
          const int p = tx + 16 * j;
          if (p < P)
            y[((row0 + t) * H + h) * P + p] = from_f32<T>(acc[i][j] + e * ch[i][j]);
        }
      }
    }
    __syncthreads();  // every y read the entering state
    {  // state <- state_in exp(cs_T) + sum_s x_s^T (B_s exp(cs_T - cs_s) dt_s)
      const float total = expf(cs_end);
      float u[JP][JN] = {};
      for (int s2 = 0; s2 < nt; ++s2) {
        const float ws = sWs[s2];
        float xv[JP], bw[JN];
#pragma unroll
        for (int i = 0; i < JP; ++i) xv[i] = sX[s2 * PP + min(ty + 16 * i, P - 1)];
#pragma unroll
        for (int j = 0; j < JN; ++j) bw[j] = sB[s2 * PN + min(tx + 16 * j, N - 1)] * ws;
#pragma unroll
        for (int i = 0; i < JP; ++i)
#pragma unroll
          for (int j = 0; j < JN; ++j) u[i][j] += xv[i] * bw[j];
      }
#pragma unroll
      for (int i = 0; i < JP; ++i) {
        const int p = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < JN; ++j) {
          const int n = tx + 16 * j;
          if (p < P && n < N) sH[p * PN + n] = sH[p * PN + n] * total + u[i][j];
        }
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < P * N; i += kThreads)
    state[bh * P * N + i] = sH[(i / N) * PN + i % N];
}

template <typename T, int JP, int JN>
cudaError_t launch_tiles(const void* x, const float* dt, const float* A,
                         const void* Bm, const void* Cm, const float* h0,
                         void* y, float* state, int B, int L, int H, int P,
                         int N, cudaStream_t st) {
  const size_t bytes = smem_floats(P, N) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      ssd_scan_kernel<T, JP, JN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (e != cudaSuccess) return e;
  const dim3 grid(H, B);
  ssd_scan_kernel<T, JP, JN><<<grid, kThreads, bytes, st>>>(
      (const T*)x, dt, A, (const T*)Bm, (const T*)Cm, h0, (T*)y, state, L, H,
      P, N);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* x, const float* dt, const float* A,
                   const void* Bm, const void* Cm, const float* h0, void* y,
                   float* state, int B, int L, int H, int P, int N,
                   cudaStream_t st) {
  const bool wide_p = P > 64, wide_n = N > 64;
  if (!wide_p && !wide_n)
    return launch_tiles<T, 4, 4>(x, dt, A, Bm, Cm, h0, y, state, B, L, H, P, N, st);
  if (!wide_p)
    return launch_tiles<T, 4, 8>(x, dt, A, Bm, Cm, h0, y, state, B, L, H, P, N, st);
  if (!wide_n)
    return launch_tiles<T, 8, 4>(x, dt, A, Bm, Cm, h0, y, state, B, L, H, P, N, st);
  return launch_tiles<T, 8, 8>(x, dt, A, Bm, Cm, h0, y, state, B, L, H, P, N, st);
}

}  // namespace

// Plain C entry point (bound with ctypes). dtype (of x, Bm, Cm, y):
// 0 = float32, 1 = bfloat16. h0 may be null (zero initial state). The
// caller validates shapes and contiguity; returns cudaGetLastError() after
// the launch.
extern "C" int repro_ssd_scan(int dtype, const void* x, const void* dt,
                              const void* A, const void* Bm, const void* Cm,
                              const void* h0, void* y, void* state, int B,
                              int L, int H, int P, int N, void* stream) {
  if (B <= 0 || L <= 0 || H <= 0 || P <= 0 || N <= 0 || P > kMaxPN ||
      N > kMaxPN)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const float* dtf = (const float*)dt;
  const float* Af = (const float*)A;
  const float* h0f = (const float*)h0;
  float* sf = (float*)state;
  if (dtype == 0)
    return (int)launch<float>(x, dtf, Af, Bm, Cm, h0f, y, sf, B, L, H, P, N, st);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(x, dtf, Af, Bm, Cm, h0f, y, sf, B, L, H,
                                      P, N, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* repro_ssd_scan_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
