// Flash-decode for Hopper (sm_90a): single-query attention over a padded
// KV cache, one query token per batch row (serving slot).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_decode/kernel.py::flash_decode_fwd
//   (pl.pallas_call at :125, body _decode_kernel at :38).
//
// Function (exactly _decode_kernel's):
//   slot j of row b is visible iff j < kv_valid[b] and, when window > 0,
//   j > q_offset[b] - window; scale = 1/sqrt(D); running max m, sum l and
//   accumulator acc in f32; masked probabilities are exactly 0; a row with
//   no visible slot outputs 0; the output is cast to q's dtype.
//
// Layouts: q [B, 1, Hq, D] contiguous; k, v [B, cap, Hkv, D] read in place
// through (batch, row, head) strides with a unit stride over D, so the
// cache is never transposed (the reference wrapper transposes the whole
// cache per layer per step); out [B, 1, Hq, D] contiguous. Query head
// h = kv_head * G + g, G = Hq / Hkv (GQA). The wrapper checks D % 8 == 0,
// D <= 256, G in {1, 2, 4, 8}, 16-byte aligned rows.
//
// Bound: the kernel must read the K and V rows that are visible, once.
// At 8 slots, cap 512 (all rows live), Hkv 8, D 256 in bf16 that is
// 8 * 512 * 8 * 256 * 2 B * 2 = 16.8 MB per layer call, about 5 us at the
// H100's 3.35 TB/s; its arithmetic (4 * G * D flops per visible row and kv
// head) is two orders of magnitude below the card's rate, so it is bytes
// that bound it.
//
// Design against that bound: one block per (kv head, batch row) holds all
// G query heads of that kv head, so every visible K/V row is read from
// device memory exactly once and reused for the G heads from registers.
// Only the visible rows [lo, hi) are walked: rows past kv_valid and left
// of the window are never touched (the TPU kernel skips such splits with
// pl.when), and since masked slots are never visited their probability is
// exactly 0 by construction. The visible rows are cut into one contiguous
// run per warp; a lane owns 8 consecutive elements of D (one 16-byte load
// per bf16 row), a warp keeps R rows' loads in flight, scores them with a
// warp reduction and updates its own online softmax (m, l, acc) in
// registers. The warps' partials are then merged in a fixed order through
// shared memory, so the result is deterministic.
// Still simple: B * Hkv blocks (32 at 4 slots x 8 kv heads) leave most of
// the 132 SMs idle; splitting the KV axis across blocks and TMA staging
// are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kVec = 8;           // elements of D per lane
constexpr int kMaxD = 32 * kVec;  // 256

__device__ __forceinline__ void load8(const float* p, float (&o)[kVec]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&o)[kVec]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T, int G>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, T* __restrict__ out,
                    const int* __restrict__ kv_valid,
                    const int* __restrict__ q_offset, int Hq, int D, int cap,
                    int window, float scale, long long s_b, long long s_r,
                    long long s_h) {
  constexpr int R = G >= 8 ? 2 : 4;  // cache rows in flight per warp step
  const int kh = blockIdx.x;
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int d0 = lane * kVec;
  const bool has_d = d0 < D;

  __shared__ float m_s[kWarps][G];
  __shared__ float l_s[kWarps][G];
  __shared__ float o_s[G][kMaxD];

  for (int i = threadIdx.x; i < G * kMaxD; i += kThreads) (&o_s[0][0])[i] = 0.f;

  // this lane's slice of the G query heads of kv head kh
  float qr[G][kVec];
  const T* qb = q + ((long long)b * Hq + (long long)kh * G) * D;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (has_d) {
      load8(qb + (long long)g * D + d0, qr[g]);
    } else {
#pragma unroll
      for (int i = 0; i < kVec; ++i) qr[g][i] = 0.f;
    }
  }

  // visible rows [lo, hi), one contiguous run per warp
  const int hi = min(kv_valid[b], cap);
  const int lo = window > 0 ? max(0, q_offset[b] - window + 1) : 0;
  const int per = (max(hi - lo, 0) + kWarps - 1) / kWarps;
  const int j0 = lo + warp * per;
  const int j1 = min(hi, j0 + per);

  float m[G], l[G], acc[G][kVec];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < kVec; ++i) acc[g][i] = 0.f;
  }

  const T* kb = k + (long long)b * s_b + (long long)kh * s_h + d0;
  const T* vb = v + (long long)b * s_b + (long long)kh * s_h + d0;
  for (int j = j0; j < j1; j += R) {
    float kr[R][kVec], vr[R][kVec];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (has_d && j + r < j1) {
        load8(kb + (long long)(j + r) * s_r, kr[r]);
        load8(vb + (long long)(j + r) * s_r, vr[r]);
      } else {
#pragma unroll
        for (int i = 0; i < kVec; ++i) kr[r][i] = vr[r][i] = 0.f;
      }
    }
    float s[R][G];
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float t = 0.f;
#pragma unroll
        for (int i = 0; i < kVec; ++i) t += qr[g][i] * kr[r][i];
        s[r][g] = warp_sum(t) * scale;
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float mx = m[g];
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (j + r < j1) mx = fmaxf(mx, s[r][g]);
      const float alpha = expf(m[g] - mx);  // 0 on the warp's first step
      float p[R];
      float psum = 0.f;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        p[r] = j + r < j1 ? expf(s[r][g] - mx) : 0.f;
        psum += p[r];
      }
      l[g] = l[g] * alpha + psum;
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        float a = acc[g][i] * alpha;
#pragma unroll
        for (int r = 0; r < R; ++r) a += p[r] * vr[r][i];
        acc[g][i] = a;
      }
      m[g] = mx;
    }
  }

  // merge the warps' partials (fixed order: deterministic)
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      m_s[warp][g] = m[g];
      l_s[warp][g] = l[g];
    }
  }
  __syncthreads();
  float w_scale[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    float mx = -INFINITY;
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, m_s[w][g]);
    w_scale[g] = m[g] == -INFINITY ? 0.f : expf(m[g] - mx);
  }
  for (int w = 0; w < kWarps; ++w) {
    if (warp == w && has_d) {
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int i = 0; i < kVec; ++i) o_s[g][d0 + i] += acc[g][i] * w_scale[g];
    }
    __syncthreads();
  }
  T* ob = out + ((long long)b * Hq + (long long)kh * G) * D;
  for (int idx = threadIdx.x; idx < G * D; idx += kThreads) {
    const int g = idx / D;
    float mx = -INFINITY;
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, m_s[w][g]);
    float denom = 0.f;
    for (int w = 0; w < kWarps; ++w)
      if (m_s[w][g] != -INFINITY) denom += l_s[w][g] * expf(m_s[w][g] - mx);
    ob[idx] = from_f32<T>(o_s[g][idx % D] / (denom == 0.f ? 1.f : denom));
  }
}

template <typename T>
cudaError_t launch(int G, const void* q, const void* k, const void* v,
                   void* out, const int* kv_valid, const int* q_offset, int B,
                   int Hq, int Hkv, int D, int cap, int window,
                   long long s_b, long long s_r, long long s_h,
                   cudaStream_t st) {
  const dim3 grid(Hkv, B);
  const float scale = (float)(1.0 / sqrt((double)D));
  const T* qt = (const T*)q;
  const T* kt = (const T*)k;
  const T* vt = (const T*)v;
  T* ot = (T*)out;
#define REPRO_FD_LAUNCH(GG)                                                  \
  flash_decode_kernel<T, GG><<<grid, kThreads, 0, st>>>(                     \
      qt, kt, vt, ot, kv_valid, q_offset, Hq, D, cap, window, scale, s_b,    \
      s_r, s_h)
  switch (G) {
    case 1: REPRO_FD_LAUNCH(1); break;
    case 2: REPRO_FD_LAUNCH(2); break;
    case 4: REPRO_FD_LAUNCH(4); break;
    case 8: REPRO_FD_LAUNCH(8); break;
    default: return cudaErrorInvalidValue;
  }
#undef REPRO_FD_LAUNCH
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes). dtype: 0 = float32, 1 = bfloat16.
// The caller validates shapes and alignment; returns cudaGetLastError()
// after the launch.
extern "C" int repro_flash_decode(int dtype, const void* q, const void* k,
                                  const void* v, void* out,
                                  const void* kv_valid, const void* q_offset,
                                  int B, int Hq, int Hkv, int D, int cap,
                                  int window, long long s_b, long long s_r,
                                  long long s_h, void* stream) {
  if (B <= 0 || Hkv <= 0 || Hq % Hkv != 0 || D <= 0 || D > kMaxD ||
      D % kVec != 0 || cap <= 0 || window < 0)
    return (int)cudaErrorInvalidValue;
  const int G = Hq / Hkv;
  const int* kvv = (const int*)kv_valid;
  const int* qo = (const int*)q_offset;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)launch<float>(G, q, k, v, out, kvv, qo, B, Hq, Hkv, D, cap,
                              window, s_b, s_r, s_h, st);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(G, q, k, v, out, kvv, qo, B, Hq, Hkv, D,
                                      cap, window, s_b, s_r, s_h, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
