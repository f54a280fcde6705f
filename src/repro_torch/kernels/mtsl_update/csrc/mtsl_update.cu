// Fused MTSL parameter update for Hopper (sm_90a): p <- p - eta * g, in
// place, with one step size per row of the leaf.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/mtsl_update/kernel.py::mtsl_update_fwd
//   (pl.pallas_call at :42, body _update_kernel at :18).
//
// Function (exactly _update_kernel's, per row): the leaf of n elements is
// viewed as [R, n / R]; element i of row r = i / (n / R) becomes
//   cast_to_p_dtype(f32(p[i]) - eta[r] * f32(g[i])).
// R = 1 is the TPU kernel's scalar eta. A stacked tower leaf [M, ...]
// passes R = M, one step size per client (lr * c_m * part_m): the
// per-client learning rate and the participation freeze fold into eta.
// The product is rounded before the subtraction (__fmul_rn, __fsub_rn):
// nvcc would otherwise contract `p - eta * g` into one FMA, which differs
// from the plain version (ref.py) by up to ~4e-6 at eta ~ 10. With explicit
// rounding the kernel equals the plain version bit for bit, in f32 and in
// bf16 (round to nearest even, __float2bfloat16_rn).
//
// Bound: bytes. Each element reads p and g and writes p once: 12 bytes per
// f32 element, 6 per bf16 element, against 2 flops; at 3.35 TB/s a 2^26
// element f32 leaf needs 0.24 ms. The design: a grid-stride loop in which
// each thread moves 16 bytes of p and of g per iteration (one uint4 load
// each: 4 f32 or 8 bf16 elements) where both pointers are 16-byte aligned
// and no vector straddles two rows, and a scalar loop for the tail (or for
// the whole leaf otherwise). The step sizes stay on the device (no host
// copy per launch). The TPU kernel's flatten-and-pad to [rows, 128] is not
// needed: the tail is masked by the loop bound.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T>
__device__ __forceinline__ T step(T p, T g, float eta) {
  return from_f32<T>(__fsub_rn(to_f32(p), __fmul_rn(eta, to_f32(g))));
}

// vec_end: elements [0, vec_end) go through 16-byte vectors (a multiple of
// the vector width, 0 when the vector path is off); [vec_end, n) scalar.
template <typename T>
__global__ void __launch_bounds__(256)
    mtsl_update_kernel(T* __restrict__ p, const T* __restrict__ g,
                       const float* __restrict__ eta, long long n,
                       long long row_len, long long vec_end) {
  constexpr int kVec = 16 / sizeof(T);
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  uint4* pv = reinterpret_cast<uint4*>(p);
  const uint4* gv = reinterpret_cast<const uint4*>(g);
  for (long long v = tid; v < vec_end / kVec; v += stride) {
    const float e = __ldg(eta + (v * kVec) / row_len);
    uint4 pw = pv[v];
    const uint4 gw = __ldg(gv + v);
    T* pe = reinterpret_cast<T*>(&pw);
    const T* ge = reinterpret_cast<const T*>(&gw);
#pragma unroll
    for (int k = 0; k < kVec; ++k) pe[k] = step(pe[k], ge[k], e);
    pv[v] = pw;
  }
  for (long long i = vec_end + tid; i < n; i += stride)
    p[i] = step(p[i], g[i], __ldg(eta + i / row_len));
}

template <typename T>
cudaError_t launch(void* p, const void* g, const float* eta, long long n,
                   long long rows, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const long long row_len = n / rows;
  const bool aligned = ((uintptr_t)p % 16 == 0) && ((uintptr_t)g % 16 == 0);
  const bool vector = aligned && (rows == 1 || row_len % kVec == 0);
  const long long vec_end = vector ? (n / kVec) * kVec : 0;
  const long long work = vec_end / kVec + (n - vec_end);
  const int threads = 256;
  long long blocks = (work + threads - 1) / threads;
  if (blocks > 4096) blocks = 4096;  // grid-stride beyond 16 blocks per SM
  if (blocks < 1) blocks = 1;
  mtsl_update_kernel<T><<<(unsigned)blocks, threads, 0, stream>>>(
      (T*)p, (const T*)g, eta, n, row_len, vec_end);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. p is updated in place; g has p's
// dtype and n elements; eta holds `rows` f32 step sizes on the device and
// rows divides n. The caller validates dtypes, shapes and contiguity;
// returns cudaGetLastError() after the launch.
extern "C" int repro_mtsl_update(int dtype, void* p, const void* g,
                                 const void* eta, long long n, long long rows,
                                 void* stream) {
  if (n <= 0 || rows <= 0 || n % rows) return (int)cudaErrorInvalidValue;
  const float* e = (const float*)eta;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0: return (int)launch<float>(p, g, e, n, rows, s);
    case 1: return (int)launch<__nv_bfloat16>(p, g, e, n, rows, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* repro_mtsl_update_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
