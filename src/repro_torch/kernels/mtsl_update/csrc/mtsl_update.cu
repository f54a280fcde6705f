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
// element f32 leaf needs 0.24 ms.
//
// The round's whole tree in one launch: a launch per leaf costs the host a
// wrapper call and a launch per leaf (1,146 a round at zamba2-7b's width,
// 17 at paper-resnet16's), and the mtsl rounds are host-bound. The host
// builds a table of leaf descriptors for each call (p, g, the step sizes,
// n, row length, first piece, dtype, vector flag) and copies it to the
// card; a single leaf is a table of one row. The blocks walk fixed pieces
// of kPiece elements of the concatenated leaves, each finding its leaf by a
// binary search over the first pieces. Within a piece each thread moves 16
// bytes of p and of g per iteration (one uint4 load each: 4 f32 or 8 bf16
// elements) where the leaf's bases are 16-byte aligned and no vector
// straddles two rows, and the rest goes through a scalar loop. f32 and
// bf16 leaves share a launch through the dtype code. The step sizes stay
// on the device. The TPU kernel's flatten-and-pad to [rows, 128] is not
// needed: each piece's tail is masked by its bound.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

constexpr int kPiece = 8192;  // elements per piece of a leaf (a multiple of
                              // every vector width, so pieces stay aligned)
constexpr int kMultiThreads = 256;

// one leaf of a multi-tensor launch, as the host's int64 table row
struct LeafDesc {
  long long p, g, eta, n, row_len, piece0, dtype, vector;
};

template <typename T>
__device__ __forceinline__ void update_piece(const LeafDesc& d, long long i0,
                                             long long i1) {
  constexpr int kVec = 16 / sizeof(T);
  T* p = reinterpret_cast<T*>(d.p);
  const T* g = reinterpret_cast<const T*>(d.g);
  const float* eta = reinterpret_cast<const float*>(d.eta);
  const long long vec_end = d.vector ? (d.n / kVec) * kVec : 0;
  const long long v_hi = min(i1, vec_end);
  uint4* pv = reinterpret_cast<uint4*>(p);
  const uint4* gv = reinterpret_cast<const uint4*>(g);
  for (long long i = i0 + threadIdx.x * kVec; i < v_hi; i += kMultiThreads * kVec) {
    const float e = __ldg(eta + i / d.row_len);
    uint4 pw = pv[i / kVec];
    const uint4 gw = __ldg(gv + i / kVec);
    T* pe = reinterpret_cast<T*>(&pw);
    const T* ge = reinterpret_cast<const T*>(&gw);
#pragma unroll
    for (int k = 0; k < kVec; ++k) pe[k] = step(pe[k], ge[k], e);
    pv[i / kVec] = pw;
  }
  for (long long i = max(i0, vec_end) + threadIdx.x; i < i1; i += kMultiThreads)
    p[i] = step(p[i], g[i], __ldg(eta + i / d.row_len));
}

__global__ void __launch_bounds__(kMultiThreads)
    mtsl_update_multi_kernel(const LeafDesc* __restrict__ leaves, int nleaves,
                             long long pieces) {
  for (long long q = blockIdx.x; q < pieces; q += gridDim.x) {
    int lo = 0, hi = nleaves - 1;  // the last leaf whose first piece <= q
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (__ldg(&leaves[mid].piece0) <= q) lo = mid; else hi = mid - 1;
    }
    const LeafDesc d = leaves[lo];
    const long long i0 = (q - d.piece0) * kPiece;
    const long long i1 = min(d.n, i0 + kPiece);
    if (d.dtype == 0)
      update_piece<float>(d, i0, i1);
    else
      update_piece<__nv_bfloat16>(d, i0, i1);
  }
}

}  // namespace

// Every leaf of `table` (nleaves rows of LeafDesc on the device, nonempty
// leaves in order, piece0 their first piece, `pieces` the total) in one
// launch. Per leaf: p is updated in place; g has p's dtype (0 = float32,
// 1 = bfloat16) and n elements; eta holds n / row_len f32 step sizes. The caller builds and validates the table (ops.py::leaf_table);
// returns cudaGetLastError() after the launch.
extern "C" int repro_mtsl_update_multi(const void* table, int nleaves,
                                       long long pieces, void* stream) {
  if (table == nullptr || nleaves <= 0 || pieces <= 0)
    return (int)cudaErrorInvalidValue;
  long long blocks = pieces < 132 * 16 ? pieces : 132 * 16;
  mtsl_update_multi_kernel<<<(unsigned)blocks, kMultiThreads, 0,
                             (cudaStream_t)stream>>>(
      (const LeafDesc*)table, nleaves, pieces);
  return (int)cudaGetLastError();
}

extern "C" const char* repro_mtsl_update_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
