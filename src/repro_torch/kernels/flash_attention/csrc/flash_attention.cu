// Flash attention for Hopper (sm_90a): the forward of causal /
// sliding-window grouped-query self-attention over whole sequences, with an
// online softmax, as the training forward runs it.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention/kernel.py::flash_attention_fwd
//   (pl.pallas_call at :136, body _flash_kernel at :29).
//
// Function (_flash_kernel's): query row i of head h attends key row j of
// kv head h / G (G = Hq / Hkv) iff j < Sk and, when causal, j <= i and,
// when window > 0, i - j < window. Scores q.k * (1/sqrt(D)) in f32; a
// running max m, sum l and accumulator acc in f32 across key tiles; masked
// probabilities are exactly 0; a row with no visible key outputs 0 (the
// plain version, mha_reference, averages over the masked keys instead);
// the output is cast to q's dtype. Key tiles that no row of the query tile
// can see are skipped, as the TPU kernel skips its blocks with pl.when.
//
// Layouts: q [B, Sq, Hq, D], k and v [B, Sk, Hkv, D] read in place through
// their (batch, row, head) strides with a unit stride over D, so nothing is
// transposed (the reference wrapper transposes to [B, H, S, D]); out
// [B, Sq, Hq, D] contiguous. The wrapper checks D % 8 == 0, D <= 256 and
// 16-byte aligned rows.
//
// Bound: operations, at the path's shape (B = 2, H = 32, S = 2048,
// D = 112, bf16, causal). The visible (i, j) pairs are S (S + 1) / 2 per
// head, each 4 D flops (q.k and p.v): 6.0e10 flops, 0.061 ms at the bf16
// tensor-core rate of 989 TFLOP/s; the bytes (q, k, v and out once, 117 MB)
// take 0.035 ms at 3.35 TB/s.
//
// Design (simple first). One block of 256 threads per (query tile of 64
// rows, query head, batch row); the kernel walks the key tiles of 64 rows
// that the tile can see. Two paths:
//  * bf16 (the training path): the tiles stay bf16 in shared memory and the
//    two products, S = Q K^T and O += P V, run on the tensor cores through
//    WMMA (16x16x16 bf16 fragments, f32 accumulators; D is zero-padded to a
//    multiple of 16). S goes through shared memory in f32; four threads
//    share a query row for the masks and the online softmax, write the
//    row's probabilities as bf16 (as the plain version casts its
//    probabilities to v's dtype) and rescale the row of the f32 output
//    tile, which lives in shared memory between the products (103 KB at
//    D = 112, 195 KB at D = 256, opted in with cudaFuncSetAttribute).
//  * f32 (exact to 2e-5; the tensor cores would round through TF32): the
//    same walk in f32 FMA on the CUDA cores, each thread scoring 16 keys of
//    its row and accumulating a quarter of the row's D outputs in
//    registers.
// Still simple: WMMA rather than wgmma, no TMA or cp.async staging, no
// overlap of loads with the products, and the f32 output tile makes a
// round trip through shared memory per key tile; those are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

namespace {

namespace wmma = nvcuda::wmma;

constexpr int kBq = 64;   // query rows per block
constexpr int kBk = 64;   // key rows per tile
constexpr int kThreads = 256;  // 4 per query row
constexpr int kVec = 8;   // elements per 16-byte bf16 load (two f32 loads)
constexpr int kMaxD = 256;
constexpr int kAcc = kMaxD / 4;  // output columns per thread

__device__ __forceinline__ void load8(const float* p, float (&o)[kVec]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}

// ---------------------------------------------------------------------------
// f32: CUDA cores
// ---------------------------------------------------------------------------

// rows [r0, r0 + 64) of an f32 [.., S, .., D] tensor (row stride s_r, base
// at the head) into s[64][D + 1]; rows at or past S are zeros
__device__ __forceinline__ void load_tile(float* s, const float* base, int r0,
                                          int S, long long s_r, int D,
                                          int tid) {
  const int segs = D / kVec;
  for (int i = tid; i < kBk * segs; i += kThreads) {
    const int r = i / segs, d0 = (i % segs) * kVec;
    float v[kVec];
    if (r0 + r < S) {
      load8(base + (long long)(r0 + r) * s_r + d0, v);
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e) v[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < kVec; ++e) s[r * (D + 1) + d0 + e] = v[e];
  }
}

__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ out, int Sq,
                       int Sk, int Hq, int group, int D, int causal,
                       int window, float scale, long long qs_b, long long qs_s,
                       long long qs_h, long long ks_b, long long ks_s,
                       long long ks_h, long long vs_b, long long vs_s,
                       long long vs_h) {
  extern __shared__ float smem[];
  const int DP = D + 1, PP = kBk + 1;
  float* sQ = smem;             // [kBq][D + 1]
  float* sK = sQ + kBq * DP;    // [kBk][D + 1]
  float* sV = sK + kBk * DP;    // [kBk][D + 1]
  float* sP = sV + kBk * DP;    // [kBq][kBk + 1]

  const int q0 = blockIdx.x * kBq;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / group;
  const int tid = threadIdx.x;
  const int r = tid >> 2;  // query row of the tile
  const int c4 = tid & 3;  // this thread's quarter of keys / columns
  const int qpos = q0 + r;

  load_tile(sQ, q + (long long)b * qs_b + (long long)h * qs_h, q0, Sq, qs_s,
            D, tid);
  const float* kb = k + (long long)b * ks_b + (long long)kh * ks_h;
  const float* vb = v + (long long)b * vs_b + (long long)kh * vs_h;

  float acc[kAcc];
#pragma unroll
  for (int j = 0; j < kAcc; ++j) acc[j] = 0.f;
  float m = -INFINITY, l = 0.f;

  // keys any row of this tile can see: [k_lo, k_hi)
  int k_hi = Sk;
  if (causal) k_hi = min(k_hi, q0 + kBq);
  int k_lo = 0;
  if (window > 0) k_lo = max(0, q0 - window + 1);
  for (int k0 = (k_lo / kBk) * kBk; k0 < k_hi; k0 += kBk) {
    __syncthreads();  // the previous tile is done with sK, sV, sP
    load_tile(sK, kb, k0, Sk, ks_s, D, tid);
    load_tile(sV, vb, k0, Sk, vs_s, D, tid);
    __syncthreads();

    float s[kBk / 4];
    float tmax = -INFINITY;
#pragma unroll
    for (int j = 0; j < kBk / 4; ++j) {
      const int c = c4 + 4 * j;
      const int kpos = k0 + c;
      const bool ok = kpos < Sk && (!causal || kpos <= qpos) &&
                      (window <= 0 || qpos - kpos < window);
      float t = -INFINITY;
      if (ok) {
        float dot = 0.f;
        for (int d = 0; d < D; ++d) dot += sQ[r * DP + d] * sK[c * DP + d];
        t = dot * scale;
      }
      s[j] = t;
      tmax = fmaxf(tmax, t);
    }
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
    const float m_new = fmaxf(m, tmax);
    // m_new == -inf: nothing visible yet (acc and l are 0 and stay so)
    const float alpha = m_new == -INFINITY ? 1.f : expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < kBk / 4; ++j) {
      const float p = s[j] == -INFINITY ? 0.f : expf(s[j] - m_new);
      sP[r * PP + c4 + 4 * j] = p;
      psum += p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l = l * alpha + psum;
    m = m_new;
#pragma unroll
    for (int j = 0; j < kAcc; ++j) acc[j] *= alpha;
    __syncthreads();  // the row's probabilities are in sP
    for (int c = 0; c < kBk; ++c) {
      const float p = sP[r * PP + c];
#pragma unroll
      for (int j = 0; j < kAcc; ++j) {
        const int d = c4 + 4 * j;
        if (d < D) acc[j] += p * sV[c * DP + d];
      }
    }
  }

  if (qpos < Sq) {
    const float inv = 1.f / (l == 0.f ? 1.f : l);
    float* o = out + (((long long)b * Sq + qpos) * Hq + h) * D;
#pragma unroll
    for (int j = 0; j < kAcc; ++j) {
      const int d = c4 + 4 * j;
      if (d < D) o[d] = acc[j] * inv;
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (WMMA)
// ---------------------------------------------------------------------------

struct TcLayout {  // shared-memory layout of the bf16 kernel, in bytes
  int dp, ldq, lds, ldp, ldo;
  size_t q, k, v, s, p, o, total;
};

__host__ __device__ inline size_t align128(size_t x) { return (x + 127) & ~(size_t)127; }

__host__ __device__ inline TcLayout tc_layout(int D) {
  TcLayout t;
  t.dp = (D + 15) / 16 * 16;  // D padded to whole 16-wide fragments
  t.ldq = t.dp + 8;           // bf16 row pitch of Q, K, V (multiple of 8)
  t.lds = kBk + 4;            // f32 row pitch of S (multiple of 4)
  t.ldp = kBk + 8;            // bf16 row pitch of P
  t.ldo = t.dp + 4;           // f32 row pitch of O
  size_t off = 0;
  t.q = off; off = align128(off + (size_t)kBq * t.ldq * 2);
  t.k = off; off = align128(off + (size_t)kBk * t.ldq * 2);
  t.v = off; off = align128(off + (size_t)kBk * t.ldq * 2);
  t.s = off; off = align128(off + (size_t)kBq * t.lds * 4);
  t.p = off; off = align128(off + (size_t)kBq * t.ldp * 2);
  t.o = off; off = align128(off + (size_t)kBq * t.ldo * 4);
  t.total = off;
  return t;
}

// rows [r0, r0 + 64) of a bf16 [.., S, .., D] tensor into s[64][ld] as bf16,
// zeros past S and in the padding columns [D, dp)
__device__ __forceinline__ void load_tile_bf16(__nv_bfloat16* s, int ld, int dp,
                                               const __nv_bfloat16* base, int r0,
                                               int S, long long s_r, int D,
                                               int tid) {
  const int segs = dp / kVec;
  for (int i = tid; i < kBk * segs; i += kThreads) {
    const int r = i / segs, d0 = (i % segs) * kVec;
    uint4 u = make_uint4(0, 0, 0, 0);
    if (r0 + r < S && d0 < D)
      u = *reinterpret_cast<const uint4*>(base + (long long)(r0 + r) * s_r + d0);
    *reinterpret_cast<uint4*>(s + r * ld + d0) = u;
  }
}

__global__ void __launch_bounds__(kThreads)
flash_attention_tc_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          __nv_bfloat16* __restrict__ out, int Sq, int Sk,
                          int Hq, int group, int D, int causal, int window,
                          float scale, long long qs_b, long long qs_s,
                          long long qs_h, long long ks_b, long long ks_s,
                          long long ks_h, long long vs_b, long long vs_s,
                          long long vs_h) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const TcLayout t = tc_layout(D);
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw + t.q);
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem_raw + t.k);
  __nv_bfloat16* sV = reinterpret_cast<__nv_bfloat16*>(smem_raw + t.v);
  float* sS = reinterpret_cast<float*>(smem_raw + t.s);
  __nv_bfloat16* sP = reinterpret_cast<__nv_bfloat16*>(smem_raw + t.p);
  float* sO = reinterpret_cast<float*>(smem_raw + t.o);

  const int q0 = blockIdx.x * kBq;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / group;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int r = tid >> 2;  // query row of the tile (softmax, rescale)
  const int c4 = tid & 3;
  const int qpos = q0 + r;
  const int nd = t.dp / 16;  // 16-wide column blocks of D

  load_tile_bf16(sQ, t.ldq, t.dp, q + (long long)b * qs_b + (long long)h * qs_h,
                 q0, Sq, qs_s, D, tid);
  for (int i = tid; i < kBq * t.ldo; i += kThreads) sO[i] = 0.f;
  const __nv_bfloat16* kb = k + (long long)b * ks_b + (long long)kh * ks_h;
  const __nv_bfloat16* vb = v + (long long)b * vs_b + (long long)kh * vs_h;
  float m = -INFINITY, l = 0.f;

  int k_hi = Sk;
  if (causal) k_hi = min(k_hi, q0 + kBq);
  int k_lo = 0;
  if (window > 0) k_lo = max(0, q0 - window + 1);
  for (int k0 = (k_lo / kBk) * kBk; k0 < k_hi; k0 += kBk) {
    __syncthreads();  // the previous tile is done with sK, sV, sP, sO
    load_tile_bf16(sK, t.ldq, t.dp, kb, k0, Sk, ks_s, D, tid);
    load_tile_bf16(sV, t.ldq, t.dp, vb, k0, Sk, vs_s, D, tid);
    __syncthreads();

    // S = Q K^T: 4 x 4 fragments of 16 x 16, two per warp
    {
      const int rb = warp >> 1;
#pragma unroll
      for (int f = 0; f < 2; ++f) {
        const int cb = (warp & 1) * 2 + f;
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
        wmma::fill_fragment(acc, 0.f);
        for (int kk = 0; kk < nd; ++kk) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> bk;
          wmma::load_matrix_sync(a, sQ + rb * 16 * t.ldq + kk * 16, t.ldq);
          wmma::load_matrix_sync(bk, sK + cb * 16 * t.ldq + kk * 16, t.ldq);
          wmma::mma_sync(acc, a, bk, acc);
        }
        wmma::store_matrix_sync(sS + rb * 16 * t.lds + cb * 16, acc, t.lds,
                                wmma::mem_row_major);
      }
    }
    __syncthreads();

    // masks and the online softmax: four threads per row, 16 keys each
    float s[kBk / 4];
    float tmax = -INFINITY;
#pragma unroll
    for (int j = 0; j < kBk / 4; ++j) {
      const int c = c4 + 4 * j;
      const int kpos = k0 + c;
      const bool ok = kpos < Sk && (!causal || kpos <= qpos) &&
                      (window <= 0 || qpos - kpos < window);
      s[j] = ok ? sS[r * t.lds + c] * scale : -INFINITY;
      tmax = fmaxf(tmax, s[j]);
    }
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
    const float m_new = fmaxf(m, tmax);
    const float alpha = m_new == -INFINITY ? 1.f : expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < kBk / 4; ++j) {
      const float p = s[j] == -INFINITY ? 0.f : expf(s[j] - m_new);
      const __nv_bfloat16 pb = __float2bfloat16_rn(p);
      sP[r * t.ldp + c4 + 4 * j] = pb;
      psum += __bfloat162float(pb);  // l sums what the product weighs
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l = l * alpha + psum;
    m = m_new;
    for (int d = c4; d < t.dp; d += 4) sO[r * t.ldo + d] *= alpha;
    __syncthreads();

    // O += P V: 4 x nd fragments of 16 x 16, round robin over the warps
    for (int f = warp; f < 4 * nd; f += kThreads / 32) {
      const int rb = f / nd, cb = f % nd;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      float* o = sO + rb * 16 * t.ldo + cb * 16;
      wmma::load_matrix_sync(acc, o, t.ldo, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < kBk / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bv;
        wmma::load_matrix_sync(a, sP + rb * 16 * t.ldp + kk * 16, t.ldp);
        wmma::load_matrix_sync(bv, sV + kk * 16 * t.ldq + cb * 16, t.ldq);
        wmma::mma_sync(acc, a, bv, acc);
      }
      wmma::store_matrix_sync(o, acc, t.ldo, wmma::mem_row_major);
    }
  }
  __syncthreads();
  if (qpos < Sq) {
    const float inv = 1.f / (l == 0.f ? 1.f : l);
    __nv_bfloat16* o = out + (((long long)b * Sq + qpos) * Hq + h) * D;
    for (int d = c4; d < D; d += 4) o[d] = __float2bfloat16_rn(sO[r * t.ldo + d] * inv);
  }
}

cudaError_t launch_tc(const void* q, const void* k, const void* v, void* out,
                      int B, int Sq, int Sk, int Hq, int Hkv, int D, int causal,
                      int window, const long long* st, cudaStream_t stream) {
  const size_t bytes = tc_layout(D).total;
  cudaError_t e = cudaFuncSetAttribute(
      flash_attention_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (e != cudaSuccess) return e;
  const float scale = (float)(1.0 / sqrt((double)D));
  const dim3 grid((Sq + kBq - 1) / kBq, Hq, B);
  flash_attention_tc_kernel<<<grid, kThreads, bytes, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (__nv_bfloat16*)out, Sq, Sk, Hq, Hq / Hkv, D, causal, window, scale,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8]);
  return cudaGetLastError();
}

cudaError_t launch_f32(const void* q, const void* k, const void* v, void* out,
                       int B, int Sq, int Sk, int Hq, int Hkv, int D, int causal,
                       int window, const long long* st, cudaStream_t stream) {
  const size_t bytes =
      ((size_t)(kBq + 2 * kBk) * (D + 1) + (size_t)kBq * (kBk + 1)) *
      sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      flash_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (e != cudaSuccess) return e;
  const float scale = (float)(1.0 / sqrt((double)D));
  const dim3 grid((Sq + kBq - 1) / kBq, Hq, B);
  flash_attention_kernel<<<grid, kThreads, bytes, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)out, Sq, Sk, Hq,
      Hq / Hkv, D, causal, window, scale, st[0], st[1], st[2], st[3], st[4],
      st[5], st[6], st[7], st[8]);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes). dtype: 0 = float32, 1 =
// bfloat16. strides: the (batch, row, head) strides of q, k and v, nine
// values in elements. The caller validates shapes and alignment; returns
// cudaGetLastError() after the launch.
extern "C" int repro_flash_attention(int dtype, const void* q, const void* k,
                                     const void* v, void* out, int B, int Sq,
                                     int Sk, int Hq, int Hkv, int D,
                                     int causal, int window,
                                     const long long* strides, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || Hkv <= 0 || Hq % Hkv != 0 || D <= 0 ||
      D > kMaxD || D % kVec != 0 || window < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)launch_f32(q, k, v, out, B, Sq, Sk, Hq, Hkv, D, causal,
                           window, strides, st);
  if (dtype == 1)
    return (int)launch_tc(q, k, v, out, B, Sq, Sk, Hq, Hkv, D, causal, window,
                          strides, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* repro_flash_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
