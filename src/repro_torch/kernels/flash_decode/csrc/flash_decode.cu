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
// At 8 slots, cap 4096 (rows 1..4096 live), Hkv 8, D 256 in bf16 that is
// about 34 MB, 0.010-0.020 ms at the H100's 3.35 TB/s; its arithmetic
// (4 G D flops per visible row and kv head) is two orders of magnitude
// below the card's rate, so it is bytes that bound it.
//
// Design against that bound, per dtype:
//  * bf16 (the serving path): split-KV in one launch. The grid is
//    (splits, Hkv, B): split s is the fixed run of cache rows
//    [64 s, 64 s + 64), splits = ceil(cap / 64) from the buffer's capacity
//    alone, so the wrapper never reads kv_valid on the host. A block whose
//    split holds no visible row does no work. Otherwise one warp issues an
//    async bulk copy (cp.async.bulk) per visible K and V row (one
//    contiguous piece of D * 2 bytes each) into shared memory, in chunks of
//    16 rows that each complete on an mbarrier, so the whole split is in
//    flight at once. Eight warps score rows as their chunk lands (two rows
//    a warp at a time, all G heads from one read of each row, the 2 G
//    warp reductions interleaved), then take the split's max,
//    probabilities and sum per head, and a thread per (column pair, half
//    of the rows) accumulates p V for every head. The split's partial
//    (acc[G][D], m, l in f32) goes to a scratch buffer; the last block of
//    each (row, kv head) to finish, found by an atomic counter after a
//    __threadfence, merges the visible splits, writes the output and
//    resets its counter to 0. Every sum runs in a fixed order over the
//    visible rows and the fixed split boundaries, so a row's output does
//    not depend on cap, B, the slot or the other rows, and two launches
//    are bit-equal.
//  * f32 (exact to 2e-5): one block per (kv head, batch row) walks only the
//    visible rows [lo, hi), one contiguous run per warp; a lane owns 8
//    consecutive elements of D, a warp keeps R rows' loads in flight,
//    scores them with a warp reduction and updates its own online softmax
//    (m, l, acc) in registers; the warps' partials are merged in a fixed
//    order through shared memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "../../common/csrc/hopper.cuh"

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
                    long long s_h, unsigned long long* launched) {
  hopper::count_launch(launched);
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

// ---------------------------------------------------------------------------
// bf16: split-KV, one launch, async bulk copies
// ---------------------------------------------------------------------------

constexpr int kSplit = 64;      // cache rows per split, at [s kSplit, (s+1) kSplit)
constexpr int kSplitWarps = 8;
constexpr int kSplitThreads = 32 * kSplitWarps;
constexpr int kChunkRows = 16;  // rows per mbarrier
constexpr int kChunks = kSplit / kChunkRows;
constexpr int kHalf = kSplitThreads / 2;  // threads per half of the rows (p V)

template <int G>
__global__ void __launch_bounds__(kSplitThreads)
flash_decode_split_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          __nv_bfloat16* __restrict__ out,
                          const int* __restrict__ kv_valid,
                          const int* __restrict__ q_offset,
                          float* __restrict__ part, int* __restrict__ counter,
                          int Hq, int Hkv, int D, int cap, int window,
                          int splits, float scale, long long s_b, long long s_r,
                          long long s_h, unsigned long long* launched) {
  hopper::count_launch(launched);
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [kSplit][D]
  __nv_bfloat16* sV = sK + kSplit * D;                             // [kSplit][D]
  float* s_acc = reinterpret_cast<float*>(smem_raw);  // [G][D], once K is read
  __shared__ __align__(8) uint64_t bars[kChunks];
  __shared__ float s_p[G][kSplit];  // scores, then probabilities
  __shared__ float s_m[G], s_l[G];
  __shared__ int s_last;

  const int sp = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int half = tid / kHalf, pi = tid % kHalf;  // p V: a column pair, half the rows
  const int hi = min(kv_valid[b], cap);
  const int lo = window > 0 ? max(0, q_offset[b] - window + 1) : 0;
  // visible rows of this split: [j0, j0 + n)
  const int j0 = max(lo, sp * kSplit);
  const int n = min(hi, (sp + 1) * kSplit) - j0;
  const int stride_p = D + 2;  // a partial per head: acc[D], m, l
  float* pbase = part + ((long long)b * Hkv + kh) * splits * G * stride_p;

  if (n > 0) {
    const uint32_t bar0 = hopper::smem_u32(&bars[0]);
    if (tid == 0) {
      for (int c = 0; c < kChunks; ++c) hopper::mbar_init(bar0 + 8 * c, 1);
      hopper::mbar_fence_init();
    }
    __syncthreads();
    if (warp == 0) {
      // every visible K and V row is one contiguous piece of D * 2 bytes
      const uint32_t row_bytes = (uint32_t)D * 2;
      if (lane < kChunks) {
        const int rows = min(max(n - lane * kChunkRows, 0), kChunkRows);
        if (rows > 0) hopper::mbar_expect_tx(bar0 + 8 * lane, 2 * rows * row_bytes);
      }
      __syncwarp();
      const long long off = (long long)b * s_b + (long long)kh * s_h;
      for (int i = lane; i < 2 * n; i += 32) {
        const int r = i >> 1;
        const __nv_bfloat16* src = ((i & 1) ? v : k) + off + (long long)(j0 + r) * s_r;
        __nv_bfloat16* dst = ((i & 1) ? sV : sK) + r * D;
        hopper::bulk_load(hopper::smem_u32(dst), src, row_bytes,
                          bar0 + 8 * (r / kChunkRows));
      }
    }

    // scores: warp w takes rows w and w + 8 of each 16-row chunk as it
    // lands, 8 elements of D per lane, the 2 G dot products reduced together
    const int d0 = lane * kVec;
    const bool has_d = d0 < D;
    float qr[G][kVec];
    const __nv_bfloat16* qb = q + ((long long)b * Hq + (long long)kh * G) * D;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (has_d) {
        load8(qb + (long long)g * D + d0, qr[g]);
      } else {
#pragma unroll
        for (int i = 0; i < kVec; ++i) qr[g][i] = 0.f;
      }
    }
    for (int c = 0; c < kChunks; ++c) {
      const int ra = c * kChunkRows + warp, rb = ra + kSplitWarps;
      if (ra >= n) break;
      hopper::mbar_wait(bar0 + 8 * c, 0);
      float ka[kVec], kb[kVec];
#pragma unroll
      for (int i = 0; i < kVec; ++i) ka[i] = kb[i] = 0.f;
      if (has_d) load8(sK + ra * D + d0, ka);
      if (has_d && rb < n) load8(sK + rb * D + d0, kb);
      float ta[G], tb[G];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        ta[g] = tb[g] = 0.f;
#pragma unroll
        for (int i = 0; i < kVec; ++i) {
          ta[g] += qr[g][i] * ka[i];
          tb[g] += qr[g][i] * kb[i];
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
        for (int g = 0; g < G; ++g) {
          ta[g] += __shfl_xor_sync(0xffffffffu, ta[g], o);
          tb[g] += __shfl_xor_sync(0xffffffffu, tb[g], o);
        }
      }
      if (lane == 0) {
#pragma unroll
        for (int g = 0; g < G; ++g) {
          s_p[g][ra] = ta[g] * scale;
          if (rb < n) s_p[g][rb] = tb[g] * scale;
        }
      }
    }
    __syncthreads();

    // the split's softmax per head: max, probabilities, sum (fixed order)
    for (int g = warp; g < G; g += kSplitWarps) {
      float mx = -INFINITY;
      for (int r = lane; r < n; r += 32) mx = fmaxf(mx, s_p[g][r]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      float l = 0.f;
      for (int r = lane; r < n; r += 32) {
        const float p = expf(s_p[g][r] - mx);
        s_p[g][r] = p;
        l += p;
      }
      l = warp_sum(l);
      if (lane == 0) {
        s_m[g] = mx;
        s_l[g] = l;
      }
    }
    for (int c = 0; c < kChunks; ++c)
      if (c * kChunkRows < n) hopper::mbar_wait(bar0 + 8 * c, 0);
    __syncthreads();

    // acc[g][d] = sum over the split's rows of p[g][r] V[r][d]: a thread per
    // column pair and half of the rows, every head; the halves are added in
    // a fixed order
    float acc[G][2];
#pragma unroll
    for (int g = 0; g < G; ++g) acc[g][0] = acc[g][1] = 0.f;
    if (2 * pi < D) {
      const int r1 = min(n, (half + 1) * (kSplit / 2));
#pragma unroll 4
      for (int r = half * (kSplit / 2); r < r1; ++r) {
        const float2 vv = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(sV + r * D + 2 * pi));
#pragma unroll
        for (int g = 0; g < G; ++g) {
          acc[g][0] += s_p[g][r] * vv.x;
          acc[g][1] += s_p[g][r] * vv.y;
        }
      }
      if (half == 1) {
#pragma unroll
        for (int g = 0; g < G; ++g)
          *reinterpret_cast<float2*>(s_acc + g * D + 2 * pi) =
              make_float2(acc[g][0], acc[g][1]);
      }
    }
    __syncthreads();
    if (half == 0 && 2 * pi < D) {
      float* pb = pbase + (long long)sp * G * stride_p;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float2 o = *reinterpret_cast<const float2*>(s_acc + g * D + 2 * pi);
        *reinterpret_cast<float2*>(pb + g * stride_p + 2 * pi) =
            make_float2(acc[g][0] + o.x, acc[g][1] + o.y);
      }
    }
    if (tid < G) {
      float* pb = pbase + (long long)sp * G * stride_p + tid * stride_p;
      pb[D] = s_m[tid];
      pb[D + 1] = s_l[tid];
    }
  }

  // the last block of this (row, kv head) to finish merges the partials
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(&counter[b * Hkv + kh], 1) == splits - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();

  // visible splits [sp_lo, sp_hi), merged in a fixed order: per head a warp
  // takes the max and the sum (lane i sums splits sp_lo + i + 32 j in order,
  // then a fixed shuffle tree), and each half of the threads sums half of
  // the splits, the halves added in order
  const int sp_lo = lo / kSplit;
  const int sp_hi = hi > lo ? (hi - 1) / kSplit + 1 : sp_lo;
  for (int g = warp; g < G; g += kSplitWarps) {
    float mx = -INFINITY;
    for (int s = sp_lo + lane; s < sp_hi; s += 32)
      mx = fmaxf(mx, __ldcg(pbase + ((long long)s * G + g) * stride_p + D));
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float l = 0.f;
    for (int s = sp_lo + lane; s < sp_hi; s += 32) {
      const float* pb = pbase + ((long long)s * G + g) * stride_p;
      l += __ldcg(pb + D + 1) * expf(__ldcg(pb + D) - mx);
    }
    l = warp_sum(l);
    if (lane == 0) {
      s_m[g] = mx;
      s_l[g] = l;
    }
  }
  __syncthreads();
  const int sp_mid = sp_lo + (sp_hi - sp_lo + 1) / 2;
  float acc[G][2];
#pragma unroll
  for (int g = 0; g < G; ++g) acc[g][0] = acc[g][1] = 0.f;
  if (2 * pi < D) {
    const int s1 = half ? sp_hi : sp_mid;
#pragma unroll 4
    for (int s = half ? sp_mid : sp_lo; s < s1; ++s) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float* pb = pbase + ((long long)s * G + g) * stride_p;
        const float w = expf(__ldcg(pb + D) - s_m[g]);
        const float2 a = __ldcg(reinterpret_cast<const float2*>(pb + 2 * pi));
        acc[g][0] += w * a.x;
        acc[g][1] += w * a.y;
      }
    }
    if (half == 1) {
#pragma unroll
      for (int g = 0; g < G; ++g)
        *reinterpret_cast<float2*>(s_acc + g * D + 2 * pi) =
            make_float2(acc[g][0], acc[g][1]);
    }
  }
  __syncthreads();
  if (half == 0 && 2 * pi < D) {
    __nv_bfloat16* ob = out + ((long long)b * Hq + (long long)kh * G) * D;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float2 o = *reinterpret_cast<const float2*>(s_acc + g * D + 2 * pi);
      const float inv = s_l[g] == 0.f ? 0.f : 1.f / s_l[g];  // nothing visible: 0
      *reinterpret_cast<__nv_bfloat162*>(ob + (long long)g * D + 2 * pi) =
          __floats2bfloat162_rn((acc[g][0] + o.x) * inv, (acc[g][1] + o.y) * inv);
    }
  }
  if (tid == 0) counter[b * Hkv + kh] = 0;  // left at zero for the next launch
}

cudaError_t launch_f32(int G, const void* q, const void* k, const void* v,
                       void* out, const int* kv_valid, const int* q_offset,
                       int B, int Hq, int Hkv, int D, int cap, int window,
                       long long s_b, long long s_r, long long s_h,
                       unsigned long long* launched, cudaStream_t st) {
  const dim3 grid(Hkv, B);
  const float scale = (float)(1.0 / sqrt((double)D));
  const float* qt = (const float*)q;
  const float* kt = (const float*)k;
  const float* vt = (const float*)v;
  float* ot = (float*)out;
#define REPRO_FD_LAUNCH(GG)                                                  \
  flash_decode_kernel<float, GG><<<grid, kThreads, 0, st>>>(                 \
      qt, kt, vt, ot, kv_valid, q_offset, Hq, D, cap, window, scale, s_b,    \
      s_r, s_h, launched)
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

template <int G>
cudaError_t launch_split_g(const void* q, const void* k, const void* v,
                           void* out, const int* kv_valid, const int* q_offset,
                           float* part, int* counter, int B, int Hq, int Hkv,
                           int D, int cap, int window, int splits, long long s_b,
                           long long s_r, long long s_h,
                           unsigned long long* launched, cudaStream_t st) {
  const int smem = 2 * kSplit * D * 2;  // K and V rows of one split
  const cudaError_t e = cudaFuncSetAttribute(
      flash_decode_split_kernel<G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(splits, Hkv, B);
  const float scale = (float)(1.0 / sqrt((double)D));
  flash_decode_split_kernel<G><<<grid, kSplitThreads, smem, st>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (__nv_bfloat16*)out, kv_valid, q_offset, part, counter, Hq, Hkv, D, cap,
      window, splits, scale, s_b, s_r, s_h, launched);
  return cudaGetLastError();
}

cudaError_t launch_bf16(int G, const void* q, const void* k, const void* v,
                        void* out, const int* kv_valid, const int* q_offset,
                        float* part, int* counter, int B, int Hq, int Hkv, int D,
                        int cap, int window, int splits, long long s_b,
                        long long s_r, long long s_h,
                        unsigned long long* launched, cudaStream_t st) {
  if (part == nullptr || counter == nullptr || splits <= 0 ||
      (long long)splits * kSplit < cap)
    return cudaErrorInvalidValue;
#define REPRO_FD_SPLIT(GG)                                                    \
  return launch_split_g<GG>(q, k, v, out, kv_valid, q_offset, part, counter, \
                            B, Hq, Hkv, D, cap, window, splits, s_b, s_r, s_h, \
                            launched, st)
  switch (G) {
    case 1: REPRO_FD_SPLIT(1);
    case 2: REPRO_FD_SPLIT(2);
    case 4: REPRO_FD_SPLIT(4);
    case 8: REPRO_FD_SPLIT(8);
    default: return cudaErrorInvalidValue;
  }
#undef REPRO_FD_SPLIT
}

}  // namespace

// Plain C entry point (bound with ctypes). dtype: 0 = float32, 1 = bfloat16.
// bf16 only: part is the f32 scratch of the splits' partials, [B, Hkv,
// splits, G, D + 2]; counter the int32 [B * Hkv] counters, zero on entry and
// left at zero; splits = ceil(cap / 64) (ops.py::split_plan). launched: the
// uint64 that the launch adds one to on the card (may be null). The caller
// validates shapes and alignment; returns cudaGetLastError() after the
// launch.
extern "C" int repro_flash_decode(int dtype, const void* q, const void* k,
                                  const void* v, void* out,
                                  const void* kv_valid, const void* q_offset,
                                  void* part, void* counter, int splits,
                                  int B, int Hq, int Hkv, int D, int cap,
                                  int window, long long s_b, long long s_r,
                                  long long s_h, void* launched, void* stream) {
  if (B <= 0 || Hkv <= 0 || Hq % Hkv != 0 || D <= 0 || D > kMaxD ||
      D % kVec != 0 || cap <= 0 || window < 0)
    return (int)cudaErrorInvalidValue;
  const int G = Hq / Hkv;
  const int* kvv = (const int*)kv_valid;
  const int* qo = (const int*)q_offset;
  cudaStream_t st = (cudaStream_t)stream;
  unsigned long long* n = (unsigned long long*)launched;
  if (dtype == 0)
    return (int)launch_f32(G, q, k, v, out, kvv, qo, B, Hq, Hkv, D, cap, window,
                           s_b, s_r, s_h, n, st);
  if (dtype == 1)
    return (int)launch_bf16(G, q, k, v, out, kvv, qo, (float*)part,
                            (int*)counter, B, Hq, Hkv, D, cap, window, splits,
                            s_b, s_r, s_h, n, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
