// Mamba2 SSD chunked scan for Hopper (sm_90a): the selective state-space
// recurrence of one Mamba2 layer over a whole sequence.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/ssd_scan/kernel.py::ssd_scan_fwd (:86)
//   (pl.pallas_call at :102, body _ssd_kernel at :24).
//
// Function (the reference's, ref.py::ssd_chunked): per head h with decay
// A_h < 0 and per position t,
//   state_t = exp(dt_t * A_h) * state_{t-1} + dt_t * x_t B_t^T   ([P, N])
//   y_t     = state_t C_t                                        ([P])
// from the initial state (zeros, or `h0` when given). B and C are shared
// by the heads (n_groups = 1). Both paths work a chunk of positions at a
// time: with cs = cumsum(dt * A) inside the chunk,
//   W[t, s] = (C_t . B_s) exp(cs_t - cs_s) dt_s      for s <= t, else 0
//   y_t     = sum_s W[t, s] x_s + exp(cs_t) (C_t . state_in)
//   state  <- state_in exp(cs_T) + sum_s x_s^T B_s exp(cs_T - cs_s) dt_s
// with f32 sums; y is written in x's dtype and the final state in f32.
// The chunks differ from the caller's `chunk` only in rounding: the
// recurrence is the same function for any chunk.
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
// rate.
//
// Two paths, chosen by the wrapper's plan (ops.py::scan_plan):
//  * bf16 with P and N multiples of 16 (every main path): chunk-parallel on
//    the tensor cores, in one launch. A block of two warpgroups takes one
//    chunk of T = 128 positions of one batch row for a group of G heads (G
//    from the plan: 4 at P = N = 64), so the server shape runs 896 blocks
//    where a block per (batch, head) gave 224, and each block's local work
//    is independent of the other chunks. One thread loads the chunk's C and
//    B tiles ([T, N], loaded once for the G heads) and each head's x tile
//    ([T, P]) with TMA (the [B, S, H, D] maps of hopper.cuh, boxes 64 wide
//    with the 128-byte swizzle; columns past P or N and rows past L arrive
//    as zeros). The cumulative sum of dt * A is a warp scan per head (not
//    one thread). The products are wgmma with f32 sums:
//      - S_c^T = (B * w)^T x, w_s = exp(cs_T - cs_s) dt_s: the chunk's
//        state contribution, the only quantity that crosses chunks, so it
//        is kept at f32 accuracy: B * w is split into a bf16 high and a
//        bf16 low part (read from the B tile transposed with ldmatrix, in
//        registers as the A operand) and both products go into one
//        accumulator; x is exact in bf16;
//      - C B^T [T, T] once per block, shared by the G heads (the FMA path
//        recomputed it per head), m64n128k16 from shared memory;
//      - y = exp(cs_t) C h_in^T + W x: C h_in^T with h_in split into high
//        and low bf16 halves in shared memory, then, in the same
//        accumulator scaled by exp(cs_t), W x with W (C B^T masked and
//        decayed in registers, rounded to bf16) as the register A operand
//        and x read transposed, the way flash_attention.cu runs P V.
//    The chunk chain: a block takes its chunk index from an atomic ticket
//    per (batch row, head group), so the block of chunk c - 1 has always
//    started before the block of chunk c and a wait cannot deadlock (the
//    argument of a decoupled look-back); the grid is ordered chunk-major,
//    so a chunk's predecessor starts a fraction of a wave earlier. After
//    its S_c products the block waits for its predecessor's flag, reads
//    the entering states h_in of its G heads from a two-slot ring of f32
//    [P, N] states per (batch, head) in L2, each kept in the order of the
//    accumulator fragments, so that a warp moves 512 contiguous bytes
//    at a time (7.3 MB at the server shape;
//    chunk c + 2 overwrites a slot only after chunk c + 1 read chunk c's
//    state from the other one, and chunk c + 1 published only after
//    reading its own), publishes h_out = h_in exp(cs_T) + S_c in the
//    reference's order, and only then runs C B^T and y, so the chain
//    carries nothing but the state pass. Chunk 0 reads h0 or zeros; the
//    last chunk writes the final state and resets the group's ticket and
//    flag, so the counters stay at zero between launches. Every sum runs in
//    a fixed order: two launches on the same inputs are bit-equal.
//  * otherwise (f32, the lm-parity configs, exact to 2e-5; bf16 with P or N
//    not a multiple of 16): f32 FMA on the CUDA cores. One block of 256
//    threads per (batch, head) walks tiles of kT = 64 positions in order
//    and keeps the [P, N] state in shared memory, as the TPU kernel keeps
//    it in VMEM scratch across its sequential grid axis; each thread owns a
//    register tile of W, y or the state.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "../../common/csrc/hopper.cuh"

namespace {

// ---------------------------------------------------------------------------
// f32, and bf16 off the tensor-core shapes: FMA on the CUDA cores
// ---------------------------------------------------------------------------

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
                int P, int N, unsigned long long* launched) {
  hopper::count_launch(launched);
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
                         int N, unsigned long long* launched, cudaStream_t st) {
  const size_t bytes = smem_floats(P, N) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      ssd_scan_kernel<T, JP, JN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (e != cudaSuccess) return e;
  const dim3 grid(H, B);
  ssd_scan_kernel<T, JP, JN><<<grid, kThreads, bytes, st>>>(
      (const T*)x, dt, A, (const T*)Bm, (const T*)Cm, h0, (T*)y, state, L, H,
      P, N, launched);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* x, const float* dt, const float* A,
                   const void* Bm, const void* Cm, const float* h0, void* y,
                   float* state, int B, int L, int H, int P, int N,
                   unsigned long long* launched, cudaStream_t st) {
  const bool wide_p = P > 64, wide_n = N > 64;
  if (!wide_p && !wide_n)
    return launch_tiles<T, 4, 4>(x, dt, A, Bm, Cm, h0, y, state, B, L, H, P, N,
                                 launched, st);
  if (!wide_p)
    return launch_tiles<T, 4, 8>(x, dt, A, Bm, Cm, h0, y, state, B, L, H, P, N,
                                 launched, st);
  if (!wide_n)
    return launch_tiles<T, 8, 4>(x, dt, A, Bm, Cm, h0, y, state, B, L, H, P, N,
                                 launched, st);
  return launch_tiles<T, 8, 8>(x, dt, A, Bm, Cm, h0, y, state, B, L, H, P, N,
                                 launched, st);
}

// ---------------------------------------------------------------------------
// bf16: chunk-parallel on the tensor cores (wgmma), TMA, chunk chain in L2
// ---------------------------------------------------------------------------

constexpr int kTc = 128;         // positions per chunk
constexpr int kTcThreads = 256;  // two warpgroups
constexpr float kLog2e = 1.4426950408889634f;

// PP, NP: P and N padded to whole 64-column (128-byte) blocks; G heads per
// block. Shared memory, from a 1024-byte aligned base: the C and B tiles
// [NP / 64][T][64], the x tiles [G][PP / 64][T][64], h_in's high and low
// halves [G][2][PP / 64][NP][64] (MN-major for C h_in^T, so that a thread
// writes the pair of columns it holds as one 4-byte store), then f32 dt,
// cs * log2(e), w and exp(cs) per head [G][T], exp(cs_T) [G], the ticket
// and the barriers (the C and B tiles, then each head's x tile, so that a
// head's products start when its own tile is in). ops.py::scan_plan
// computes the same bytes.
template <int PP, int NP, int G>
struct TcCfg {
  static constexpr int kPB = PP / 64, kNB = NP / 64;
  static constexpr int kUnits = G * kNB;  // S_c products: (head, 64 rows of N)
  static constexpr int kUnitsPerWg = (kUnits + 1) / 2;
  static constexpr uint32_t kCBytes = kTc * NP * 2;  // the C or the B tile
  static constexpr uint32_t kXBytes = kTc * PP * 2;  // one head's x tile
  static constexpr uint32_t kHBytes = PP * NP * 2;   // one half of one h_in
  static constexpr uint32_t kC = 0, kB = kCBytes, kX = 2 * kCBytes;
  static constexpr uint32_t kH = kX + G * kXBytes;
  static constexpr uint32_t kF = kH + 2 * G * kHBytes;
  static constexpr uint32_t kMisc = kF + 4 * G * kTc * 4;
  static constexpr uint32_t kBar = kMisc + 24;  // after exp(cs_T) [<= 4], ticket
  static constexpr uint32_t kSmem = kBar + 8 * (1 + G) + 1024;  // + alignment slack
  static_assert(PP % 64 == 0 && NP % 64 == 0 && PP <= 128 && NP <= 128, "blocks");
  static_assert(G <= 4 && kUnitsPerWg * kPB <= 2, "S_c registers");
  static_assert(kSmem <= 232448, "shared memory of one block");
};

__device__ __forceinline__ int ld_acquire_gpu(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release_gpu(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// (a, b) = hi + lo with hi and lo bf16 pairs: about 16 bits of each value
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(a - __low2float(h), b - __high2float(h));
}

// byte offset of element (row, col) in a tile of 128-byte rows [rows][64]
// with the 128-byte swizzle (16-byte chunk index ^= row % 8)
__device__ __forceinline__ uint32_t sw128_offset(int row, int col) {
  return row * 128 + ((((col >> 3) ^ row) & 7) << 4) + (col & 7) * 2;
}

// Per-warpgroup S_c^T products: unit u = (head u / kNB, state rows
// [64 (u % kNB), +64)); warpgroup wg takes units wg, wg + 2, ...
template <class C>
__device__ __forceinline__ void tc_state_products(
    float (&sacc)[C::kUnitsPerWg][C::kPB][32], uint32_t base, const float* sW,
    uint32_t x_full, int wg, int wi, int lane) {
  const int c4 = lane & 3;
#pragma unroll
  for (int j = 0; j < C::kUnitsPerWg; ++j) {
    const int u = 2 * j + wg;
    if (u >= C::kUnits) continue;  // warp-uniform: wg is
    const int h = u / C::kNB, nt = u % C::kNB;
    // A = (B * w)^T [n, s] for n in this warp's 16 rows: lane i addresses
    // row s = 16 kk + 8 (i / 16) + i % 8, columns n0 + 8 ((i / 8) % 2)
    const int mj = lane >> 3;
    const int n_in = 16 * wi + 8 * (mj & 1);
    const uint32_t btile = base + C::kB + nt * kTc * 128;
    uint32_t fh[kTc / 16][4], fl[kTc / 16][4];
#pragma unroll
    for (int kk = 0; kk < kTc / 16; ++kk) {
      const int s = 16 * kk + 8 * (mj >> 1) + (lane & 7);
      uint32_t r[4];
      hopper::ldmatrix_x4_trans(btile + sw128_offset(s, n_in), r);
      const float2 wa = *reinterpret_cast<const float2*>(sW + h * kTc + 16 * kk + 2 * c4);
      const float2 wb = *reinterpret_cast<const float2*>(sW + h * kTc + 16 * kk + 8 + 2 * c4);
#pragma unroll
      for (int q = 0; q < 4; ++q) {  // r[q] holds positions s0, s0 + 1
        const float2 w = (q >> 1) ? wb : wa;
        const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(&r[q]);
        split_bf16(__low2float(v) * w.x, __high2float(v) * w.y, fh[kk][q], fl[kk][q]);
      }
    }
#pragma unroll
    for (int pb = 0; pb < C::kPB; ++pb) {
#pragma unroll
      for (int i = 0; i < 32; ++i) sacc[j][pb][i] = 0.f;
      hopper::fence_regs(sacc[j][pb]);
    }
    hopper::mbar_wait(x_full + 8 * h, 0);  // this head's x tile
    hopper::wgmma_fence();
#pragma unroll
    for (int pb = 0; pb < C::kPB; ++pb) {
      const uint32_t xt = base + C::kX + (h * C::kPB + pb) * kTc * 128;
#pragma unroll
      for (int kk = 0; kk < kTc / 16; ++kk) {
        const uint64_t db = hopper::sw128_desc(xt + kk * 16 * 128, kTc * 128, 1024);
        hopper::wgmma_rs_64x64_tb(sacc[j][pb], fh[kk][0], fh[kk][1], fh[kk][2],
                                  fh[kk][3], db, 1);
        hopper::wgmma_rs_64x64_tb(sacc[j][pb], fl[kk][0], fl[kk][1], fl[kk][2],
                                  fl[kk][3], db, 1);
      }
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
#pragma unroll
    for (int pb = 0; pb < C::kPB; ++pb) hopper::fence_regs(sacc[j][pb]);
  }
}

template <int PP, int NP, int G>
__global__ void __launch_bounds__(kTcThreads, 1)
ssd_scan_tc_kernel(const __grid_constant__ CUtensorMap xmap,
                   const __grid_constant__ CUtensorMap bmap,
                   const __grid_constant__ CUtensorMap cmap,
                   const float* __restrict__ dt, const float* __restrict__ A,
                   const float* __restrict__ h0, __nv_bfloat16* __restrict__ y,
                   float* __restrict__ state, float* __restrict__ ring,
                   int* __restrict__ counters, int L, int H, int P, int N,
                   int nchunks, int ngroups, unsigned long long* launched) {
  hopper::count_launch(launched);
  using C = TcCfg<PP, NP, G>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = hopper::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw);
  float* sDt = reinterpret_cast<float*>(gbase + C::kF);  // [G][T]
  float* sCs2 = sDt + G * kTc;   // cs * log2(e)
  float* sW = sCs2 + G * kTc;    // exp(cs_T - cs_s) dt_s
  float* sE = sW + G * kTc;      // exp(cs_t)
  float* sD = reinterpret_cast<float*>(gbase + C::kMisc);  // exp(cs_T) [G]
  int* sTicket = reinterpret_cast<int*>(gbase + C::kMisc + 16);
  const uint32_t bar = base + C::kBar;  // the C and B tiles
  const uint32_t x_full = bar + 8;      // + 8 h: head h's x tile

  const int tid = threadIdx.x;
  const int warp = hopper::warp_uniform_index();
  const int lane = tid & 31;
  const int wg = warp >> 2, wi = warp & 3, c4 = lane & 3;
  // chunk-major grid: block i serves group i % groups, (batch row, heads)
  const int grp = blockIdx.x % (gridDim.x / nchunks);
  const int b = grp / ngroups, hb = (grp % ngroups) * G;
  int* ticket = counters + 2 * grp;
  int* flag = ticket + 1;  // chunks of the group whose h_out is published

  if (tid == 0) {
    *sTicket = atomicAdd(ticket, 1);
    hopper::mbar_init(bar, 1);
    for (int h = 0; h < G; ++h) hopper::mbar_init(x_full + 8 * h, 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();
  const int c = *sTicket;  // this block's chunk
  const int t0 = c * kTc;
  if (tid == 0) {
    hopper::mbar_expect_tx(bar, 2 * C::kCBytes);
#pragma unroll
    for (int kb = 0; kb < C::kNB; ++kb) {
      hopper::tma_load_4d(base + C::kC + kb * kTc * 128, &cmap, bar, kb * 64, 0, t0, b);
      hopper::tma_load_4d(base + C::kB + kb * kTc * 128, &bmap, bar, kb * 64, 0, t0, b);
    }
#pragma unroll
    for (int h = 0; h < G; ++h) {
      hopper::mbar_expect_tx(x_full + 8 * h, C::kXBytes);
#pragma unroll
      for (int pb = 0; pb < C::kPB; ++pb)
        hopper::tma_load_4d(base + C::kX + (h * C::kPB + pb) * kTc * 128, &xmap,
                            x_full + 8 * h, pb * 64, hb + h, t0, b);
    }
  }
  for (int i = tid; i < G * kTc; i += kTcThreads) {  // dt, 0 past L
    const int t = i / G, h = i % G;
    sDt[h * kTc + t] = t0 + t < L ? dt[((long long)b * L + t0 + t) * H + hb + h] : 0.f;
  }
  __syncthreads();
  if (warp < G) {  // cs = cumsum(dt * A): one warp per head, 4 positions a lane
    const int h = warp;
    const float a = A[hb + h];
    float v[4], s = 0.f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      s += sDt[h * kTc + 4 * lane + k] * a;
      v[k] = s;
    }
    float incl = s;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float n = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += n;
    }
    const float excl = incl - s;
    const float cs_end = __shfl_sync(0xffffffffu, excl + v[3], 31);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int t = h * kTc + 4 * lane + k;
      const float cs = excl + v[k];
      sCs2[t] = cs * kLog2e;
      sW[t] = expf(cs_end - cs) * sDt[t];
      sE[t] = expf(cs);
    }
    if (lane == 0) sD[h] = expf(cs_end);
  }
  __syncthreads();
  hopper::mbar_wait(bar, 0);

  // the chunk's state contributions, before the wait
  float sacc[C::kUnitsPerWg][C::kPB][32];
  tc_state_products<C>(sacc, base, sW, x_full, wg, wi, lane);

  // the chain: wait for chunk c - 1, publish h_out, keep h_in for y
  if (tid == 0 && c > 0) {
    long long spins = 0;
    while (ld_acquire_gpu(flag) < c) {
      if (++spins > (1ll << 22)) __trap();  // a lost predecessor: fail, never hang
    }
  }
  __syncthreads();
  const int g8 = lane >> 2;
  // The ring keeps each state in the accumulator's fragment order: slot
  // [NP / 64][PP / 64][8][128 threads][4], so that a thread of chunk c + 1
  // reads, as eight 16-byte loads, exactly what the same thread of chunk c
  // wrote (the same unit falls to the same warpgroup), and a warp's load
  // is 512 contiguous bytes; h0 and the final state are [P, N]. Every load
  // comes first, all in flight at once.
  float hv[C::kUnitsPerWg][C::kPB][32];
#pragma unroll
  for (int j = 0; j < C::kUnitsPerWg; ++j) {
    const int u = 2 * j + wg;
    if (u >= C::kUnits) continue;
    const int h = u / C::kNB, nt = u % C::kNB;
    const long long bh = (long long)b * H + hb + h;
#pragma unroll
    for (int pb = 0; pb < C::kPB; ++pb) {
      if (c > 0) {
        const float4* src = reinterpret_cast<const float4*>(
                                ring + (bh * 2 + ((c + 1) & 1)) * (PP * NP)) +
                            (nt * C::kPB + pb) * 8 * 128 + (tid & 127);
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const float4 v = __ldcg(src + q * 128);
          hv[j][pb][4 * q] = v.x;
          hv[j][pb][4 * q + 1] = v.y;
          hv[j][pb][4 * q + 2] = v.z;
          hv[j][pb][4 * q + 3] = v.w;
        }
      } else {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int n = nt * 64 + 16 * wi + g8 + 8 * ((i >> 1) & 1);  // row of S_c^T
          const int p = pb * 64 + 8 * (i >> 2) + 2 * c4 + (i & 1);
          hv[j][pb][i] = h0 != nullptr && n < N && p < P
                             ? h0[bh * P * N + (long long)p * N + n] : 0.f;
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < C::kUnitsPerWg; ++j) {
    const int u = 2 * j + wg;
    if (u >= C::kUnits) continue;
    const int h = u / C::kNB, nt = u % C::kNB;
    const long long bh = (long long)b * H + hb + h;
    const float decay = sD[h];
#pragma unroll
    for (int pb = 0; pb < C::kPB; ++pb) {
      float ho[32];
#pragma unroll
      for (int i = 0; i < 32; ++i)
        ho[i] = __fadd_rn(__fmul_rn(hv[j][pb][i], decay), sacc[j][pb][i]);
      if (c + 1 < nchunks) {
        float4* dst = reinterpret_cast<float4*>(ring + (bh * 2 + (c & 1)) * (PP * NP)) +
                      (nt * C::kPB + pb) * 8 * 128 + (tid & 127);
#pragma unroll
        for (int q = 0; q < 8; ++q)
          dst[q * 128] = make_float4(ho[4 * q], ho[4 * q + 1], ho[4 * q + 2], ho[4 * q + 3]);
      } else {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int n = nt * 64 + 16 * wi + g8 + 8 * ((i >> 1) & 1);
          const int p = pb * 64 + 8 * (i >> 2) + 2 * c4 + (i & 1);
          if (n < N && p < P) state[bh * P * N + (long long)p * N + n] = ho[i];
        }
      }
    }
  }
  __threadfence();  // h_out before the flag
  __syncthreads();
  if (tid == 0) {
    if (c + 1 < nchunks) {
      st_release_gpu(flag, c + 1);
    } else {  // every block of the group has its ticket and is past its wait
      *flag = 0;
      *ticket = 0;
    }
  }
#pragma unroll
  for (int j = 0; j < C::kUnitsPerWg; ++j) {
    const int u = 2 * j + wg;
    if (u >= C::kUnits) continue;
    const int h = u / C::kNB, nt = u % C::kNB;
    unsigned char* hhi = gbase + C::kH + h * 2 * C::kHBytes;  // [PP / 64][NP][64]
#pragma unroll
    for (int pb = 0; pb < C::kPB; ++pb) {
#pragma unroll
      for (int i = 0; i < 32; i += 2) {  // columns p, p + 1 of row n
        const int n = nt * 64 + 16 * wi + g8 + 8 * ((i >> 1) & 1);
        const uint32_t off =
            pb * NP * 128 + sw128_offset(n, 8 * (i >> 2) + 2 * c4);
        uint32_t hi, lo;
        split_bf16(hv[j][pb][i], hv[j][pb][i + 1], hi, lo);
        *reinterpret_cast<uint32_t*>(hhi + off) = hi;
        *reinterpret_cast<uint32_t*>(hhi + C::kHBytes + off) = lo;
      }
    }
  }
  hopper::fence_proxy_async();  // h_in's halves before the wgmma read them
  __syncthreads();

  // C B^T of this warpgroup's 64 rows, once for the G heads
  float sc[2][32];
#pragma unroll
  for (int nb = 0; nb < 2; ++nb) {
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[nb][i] = 0.f;
    hopper::fence_regs(sc[nb]);
  }
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < NP / 16; ++kk) {
    const uint32_t off = (kk >> 2) * kTc * 128 + (kk & 3) * 32;
    const uint64_t da = hopper::sw128_desc(base + C::kC + off + wg * 64 * 128, 16, 1024);
    const uint64_t db = hopper::sw128_desc(base + C::kB + off, 16, 1024);
    hopper::wgmma_ss_64x128(sc[0], sc[1], da, db, 1);
  }
  hopper::wgmma_commit();
  hopper::wgmma_wait<0>();
#pragma unroll
  for (int nb = 0; nb < 2; ++nb) hopper::fence_regs(sc[nb]);

  const int r0 = 64 * wg + 16 * wi + g8;  // this thread's rows r0, r0 + 8
  for (int h = 0; h < G; ++h) {
    const float* cs2 = sCs2 + h * kTc;
    const float* dth = sDt + h * kTc;
    const float e0 = sE[h * kTc + r0], e1 = sE[h * kTc + r0 + 8];
    const uint32_t hhi = base + C::kH + h * 2 * C::kHBytes;
    uint32_t pf[kTc / 16][4];
#pragma unroll
    for (int pb = 0; pb < C::kPB; ++pb) {
      // acc = C h_in^T (high, then low half) for columns [64 pb, +64)
      float acc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] = 0.f;
      hopper::fence_regs(acc);
      hopper::wgmma_fence();
#pragma unroll
      for (int half = 0; half < 2; ++half) {
#pragma unroll
        for (int kk = 0; kk < NP / 16; ++kk) {
          const uint64_t da = hopper::sw128_desc(
              base + C::kC + (kk >> 2) * kTc * 128 + wg * 64 * 128 + (kk & 3) * 32, 16,
              1024);
          const uint64_t db = hopper::sw128_desc(
              hhi + half * C::kHBytes + pb * NP * 128 + kk * 16 * 128, NP * 128, 1024);
          hopper::wgmma_ss_64x64_tb(acc, da, db, 1);
        }
      }
      hopper::wgmma_commit();
      if (pb == 0) {
        // while it runs: W = C B^T exp(cs_t - cs_s) dt_s on s <= t, rounded
        // to bf16 into the A-operand layout of W x
        const float ct0 = cs2[r0], ct1 = cs2[r0 + 8];
#pragma unroll
        for (int nb = 0; nb < 2; ++nb) {
#pragma unroll
          for (int kq = 0; kq < 4; ++kq) {
#pragma unroll
            for (int a = 0; a < 4; ++a) {
              const int i = 8 * kq + 2 * a;
              const int s = 64 * nb + 16 * kq + 8 * (a >> 1) + 2 * c4;
              const int t = r0 + 8 * (a & 1);
              const float ct = (a & 1) ? ct1 : ct0;
              const float2 css = *reinterpret_cast<const float2*>(cs2 + s);
              const float2 dts = *reinterpret_cast<const float2*>(dth + s);
              const float w0 =
                  s <= t ? sc[nb][i] * dts.x * hopper::exp2_approx(ct - css.x) : 0.f;
              const float w1 = s + 1 <= t
                                   ? sc[nb][i + 1] * dts.y * hopper::exp2_approx(ct - css.y)
                                   : 0.f;
              pf[4 * nb + kq][a] = pack_bf16(w0, w1);
            }
          }
        }
      }
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] *= ((i >> 1) & 1) ? e1 : e0;
      hopper::fence_regs(acc);
#pragma unroll
      for (int kk = 0; kk < kTc / 16; ++kk) hopper::fence_regs(pf[kk]);
      hopper::mbar_wait(x_full + 8 * h, 0);  // in since phase A, for most heads
      hopper::wgmma_fence();
      const uint32_t xt = base + C::kX + (h * C::kPB + pb) * kTc * 128;
#pragma unroll
      for (int kk = 0; kk < kTc / 16; ++kk) {
        const uint64_t db = hopper::sw128_desc(xt + kk * 16 * 128, kTc * 128, 1024);
        hopper::wgmma_rs_64x64_tb(acc, pf[kk][0], pf[kk][1], pf[kk][2], pf[kk][3], db, 1);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
#pragma unroll
      for (int kk = 0; kk < kTc / 16; ++kk) hopper::fence_regs(pf[kk]);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int t = t0 + r0 + 8 * half;
        if (t >= L) continue;
        __nv_bfloat16* row = y + (((long long)b * L + t) * H + hb + h) * P;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int p = pb * 64 + 8 * j + 2 * c4;
          if (p < P)
            *reinterpret_cast<uint32_t*>(row + p) =
                pack_bf16(acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
        }
      }
    }
  }
}

// tensor-map failures are reported past the CUDA runtime's error codes
constexpr int kErrTensorMap = 100000;

template <int PP, int NP, int G>
int launch_tc_cfg(const void* x, const float* dt, const float* A, const void* Bm,
                  const void* Cm, const float* h0, void* y, float* state, float* ring,
                  int* counters, int B, int L, int H, int P, int N,
                  unsigned long long* launched, cudaStream_t st) {
  using C = TcCfg<PP, NP, G>;
  if (H % G != 0) return (int)cudaErrorInvalidValue;
  CUtensorMap xm, bm, cm;
  const long long LH = (long long)L * H;
  int rc = hopper::encode_bshd_map(&xm, x, B, L, H, P, LH * P, (long long)H * P, P, kTc);
  if (rc == 0)
    rc = hopper::encode_bshd_map(&bm, Bm, B, L, 1, N, (long long)L * N, N, N, kTc);
  if (rc == 0)
    rc = hopper::encode_bshd_map(&cm, Cm, B, L, 1, N, (long long)L * N, N, N, kTc);
  if (rc != 0) return kErrTensorMap + (rc < 0 ? 0 : rc);
  cudaError_t e = cudaFuncSetAttribute(ssd_scan_tc_kernel<PP, NP, G>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)C::kSmem);
  if (e != cudaSuccess) return (int)e;
  const int nchunks = (L + kTc - 1) / kTc, ngroups = H / G;
  ssd_scan_tc_kernel<PP, NP, G><<<B * ngroups * nchunks, kTcThreads, C::kSmem, st>>>(
      xm, bm, cm, dt, A, h0, (__nv_bfloat16*)y, state, ring, counters, L, H, P, N,
      nchunks, ngroups, launched);
  return (int)cudaGetLastError();
}

int launch_tc(int G, const void* x, const float* dt, const float* A, const void* Bm,
              const void* Cm, const float* h0, void* y, float* state, float* ring,
              int* counters, int B, int L, int H, int P, int N,
              unsigned long long* launched, cudaStream_t st) {
  if (P % 16 || N % 16 || ring == nullptr || counters == nullptr)
    return (int)cudaErrorInvalidValue;
  const int pp = P > 64 ? 128 : 64, np = N > 64 ? 128 : 64;
#define REPRO_SSD_CFG(PPV, NPV, GV)                                                  \
  if (pp == PPV && np == NPV && G == GV)                                             \
    return launch_tc_cfg<PPV, NPV, GV>(x, dt, A, Bm, Cm, h0, y, state, ring, counters, \
                                       B, L, H, P, N, launched, st);
  REPRO_SSD_CFG(64, 64, 1)
  REPRO_SSD_CFG(64, 64, 2)
  REPRO_SSD_CFG(64, 64, 4)
  REPRO_SSD_CFG(64, 128, 1)
  REPRO_SSD_CFG(64, 128, 2)
  REPRO_SSD_CFG(128, 64, 1)
  REPRO_SSD_CFG(128, 64, 2)
  REPRO_SSD_CFG(128, 128, 1)
#undef REPRO_SSD_CFG
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry point (bound with ctypes). dtype (of x, Bm, Cm, y):
// 0 = float32, 1 = bfloat16. tc: 1 takes the bf16 tensor-core path with G
// heads per block (ops.py::scan_plan), with `ring` the f32 [B, H, 2, PP NP]
// hand-off states (P and N padded to whole 64-column blocks, in fragment
// order) and `counters` the int32 [2 B H / G] tickets and flags,
// zero on entry and left at zero; 0 takes the FMA path (ring, counters
// unused). h0 may be null (zero initial state). launched: the uint64 that
// the launch adds one to on the card (may be null). The caller validates
// shapes, contiguity and alignment; returns 0, cudaGetLastError() after
// the launch, or an error of its own.
extern "C" int repro_ssd_scan(int dtype, int tc, int G, const void* x, const void* dt,
                              const void* A, const void* Bm, const void* Cm,
                              const void* h0, void* y, void* state, void* ring,
                              void* counters, int B, int L, int H, int P, int N,
                              void* launched, void* stream) {
  if (B <= 0 || L <= 0 || H <= 0 || P <= 0 || N <= 0 || P > kMaxPN ||
      N > kMaxPN)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const float* dtf = (const float*)dt;
  const float* Af = (const float*)A;
  const float* h0f = (const float*)h0;
  float* sf = (float*)state;
  unsigned long long* n = (unsigned long long*)launched;
  if (tc)
    return dtype == 1 ? launch_tc(G, x, dtf, Af, Bm, Cm, h0f, y, sf, (float*)ring,
                                  (int*)counters, B, L, H, P, N, n, st)
                      : (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)launch<float>(x, dtf, Af, Bm, Cm, h0f, y, sf, B, L, H, P, N, n, st);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(x, dtf, Af, Bm, Cm, h0f, y, sf, B, L, H,
                                      P, N, n, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* repro_ssd_scan_error_string(int code) {
  if (code >= kErrTensorMap)
    return "cuTensorMapEncodeTiled refused a tensor map (CUresult = code - 100000)";
  return cudaGetErrorString((cudaError_t)code);
}
