// Flash attention for Hopper (sm_90a): the forward of grouped-query
// attention over whole sequences, with an online softmax, as the training
// forward runs it: causal / sliding-window self-attention, non-causal
// self-attention (encoder blocks) and cross attention (keys of length Sk
// from another sequence).
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
// Two paths:
//  * bf16 (the training path), built for the tensor cores' rate. One block
//    of 384 threads per (head, batch row, query tile of 128 rows): two
//    consumer warpgroups of 64 query rows each and a producer warpgroup,
//    which hands its registers to the consumers (setmaxnreg: 24 and 240 a
//    thread). One thread of the producer loads Q once and then K and V
//    tiles of BK rows into a two-stage ring with TMA (one 4-D tensor map
//    per operand over the strided [B, S, H, D] view, boxes 64 columns wide
//    with the 128-byte swizzle; the ragged S edge and the columns past D
//    arrive as zeros), each on an mbarrier; the consumers free K and V
//    stages through two more. S = Q K^T is wgmma m64n128k16 (m64n64k16 at
//    BK = 64) with both operands in shared memory, DP / 16 k-steps in
//    straight-line code (the columns past D are TMA's zeros and add 0; a
//    loop over ceil(D / 16) steps measured slower: 0.1838 against 0.1787 ms
//    at zamba2's shape, chip_smoke.py's k2 phase on an H100).
//    The masks (only on tiles that cross the diagonal, the window edge or
//    Sk) and the online softmax (exp2, log2(e) folded into the scale) run
//    on the accumulator fragment in registers, each row's max and sum a
//    shuffle across 4 lanes. The probabilities are rounded to bf16 (as the
//    plain version casts them to v's dtype; l sums them before rounding)
//    straight into the A-operand layout, and O += P V is wgmma m64n64k16
//    (per 64-column block of D; one m64n128k16 over two blocks measured
//    slower) with A from registers and V read transposed from shared
//    memory: O stays in registers for the whole walk. Each step issues tile
//    t's S and tile t - 1's P V and runs tile t's softmax while that P V is
//    in flight (two sets of P registers), and the two warpgroups take turns
//    to issue their S (two named barriers), so the tensor cores work under
//    the softmax. The heaviest causal query tiles are launched first. Tiles
//    per D (D padded to whole 64-column blocks, DP): BK = 128 key rows up
//    to DP = 128 (zamba2's D = 112, whisper-tiny's 64), 64 above (there
//    O's registers grow with DP), chosen by the wrapper
//    (ops.py::tile_config). ptxas pipelines the
//    wgmma only if no branch around one looks divergent (the warp index is
//    broadcast, every mbarrier wait loops inside its PTX, tiles no row sees
//    are masked rather than skipped) and no register of one in flight is
//    touched (fence_operands), so its report must show no "wgmma ...
//    serialized" line for the path's instantiation.
//  * f32 (exact to 2e-5; the tensor cores would round through TF32): a
//    block of 256 threads per (query tile of 64 rows, head, batch row)
//    walks key tiles of 64 rows in f32 FMA on the CUDA cores, each thread
//    scoring 16 keys of its row and accumulating a quarter of the row's D
//    outputs in registers.
// Not yet: the grid is not persistent (a block's prologue and epilogue do
// not overlap another tile's products). At DP = 64 (whisper-tiny's D = 64)
// ptxas still serialises the products (it reports C7513: an instruction
// that is not a wgmma defines an input register of one in flight, and the
// SASS waits after every wgmma); the straight-line S and the 128-key tiles
// took its encoder's shape from 0.1519 to 0.1298 ms all the same (k2
// phase), and fencing the other set of P registers serialised every
// instantiation instead.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "../../common/csrc/hopper.cuh"

namespace {

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
// bf16: tensor cores (wgmma), TMA, warp-specialised
// ---------------------------------------------------------------------------

// Tiles per padded head dim DP (D rounded up to 64, whole 128-byte rows)
// and key rows per tile BK; the wrapper (ops.py::tile_config) picks them.
template <int DP, int BK>
struct TcCfg {
  static constexpr int kWg = 2;                    // consumer warpgroups
  static constexpr int kBq = 64 * kWg;             // query rows per block
  static constexpr int kStages = 2;  // K/V ring depth (3 measured no faster)
  static constexpr int kThreads = 128 * (kWg + 1);  // + a producer warpgroup
  // registers per thread after the hand-over: 168 at launch (64K / 384),
  // the producer warpgroup drops to 24 and the consumers take 240
  static constexpr int kProducerRegs = 24, kConsumerRegs = 240;
  static constexpr int kChunks = DP / 64;          // 64-column blocks of D
  static constexpr uint32_t kQBytes = kBq * DP * 2;
  static constexpr uint32_t kTileBytes = BK * DP * 2;  // one K or V tile
  static constexpr uint32_t kK = kQBytes;              // offsets from the base
  static constexpr uint32_t kV = kK + kStages * kTileBytes;
  static constexpr uint32_t kBar = kV + kStages * kTileBytes;
  // barriers: q_full, k_full[kStages], v_full[kStages], k_empty[kStages],
  // v_empty[kStages]; 1024 bytes of slack to align the base for the
  // 128-byte swizzle
  static constexpr uint32_t kSmem = kBar + 8 * (1 + 4 * kStages) + 1024;
  static_assert(DP % 64 == 0 && BK % 64 == 0, "whole 64-wide blocks");
  static_assert(kSmem <= 232448, "shared memory of one block");
};

// What the softmax of a consumer thread needs to know of its rows.
struct Rows {
  int r0, c4, w_lo, w_hi, Sk, causal, window;
  float scale_log2;
};

// S = Q K^T of tile t (keys from (t_lo + t) BK), issued in this
// warpgroup's turn: the two warpgroups alternate, so that one's softmax
// runs under the other's products
template <class C, int BK>
__device__ __forceinline__ void tc_issue_s(float (&sc)[BK / 64][32], uint32_t qa,
                                           uint32_t sK, uint32_t k_full, int t,
                                           int t_lo, int wg, int ntiles) {
  const int s = t % C::kStages, u = t / C::kStages;
  hopper::mbar_wait(k_full + 8 * s, u & 1);
#pragma unroll
  for (int nb = 0; nb < BK / 64; ++nb) {
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[nb][i] = 0.f;
    hopper::fence_regs(sc[nb]);
  }
  hopper::named_bar_sync(1 + wg, 256);
  hopper::wgmma_fence();
  const uint32_t kt = sK + s * C::kTileBytes;
#pragma unroll
  for (int kk = 0; kk < C::kChunks * 4; ++kk) {  // DP / 16 k16 steps
    const uint32_t off = (kk & 3) * 32;  // 16 columns = 32 bytes
    const uint64_t da =
        hopper::sw128_desc(qa + (kk >> 2) * C::kBq * 128 + off, 16, 1024);
    const uint32_t kb = kt + (kk >> 2) * BK * 128 + off;
    if constexpr (BK == 128) {  // all 128 keys in one product
      hopper::wgmma_ss_64x128(sc[0], sc[1], da, hopper::sw128_desc(kb, 16, 1024),
                              kk > 0);
    } else {
#pragma unroll
      for (int nb = 0; nb < BK / 64; ++nb)
        hopper::wgmma_ss_64x64(sc[nb], da,
                               hopper::sw128_desc(kb + nb * 64 * 128, 16, 1024),
                               kk > 0);
    }
  }
  hopper::wgmma_commit();
  if (wg == 0 || t + 1 < ntiles) hopper::named_bar_arrive(2 - wg, 256);
}

// O += P V of tile t: P from registers, V [BK, DP] row-major read
// transposed. O and P are pinned (fence_operands) before the S product
// that precedes this one is issued: an instruction that defines them
// while a wgmma is in flight would make ptxas serialise the wgmma
template <class C, int BK>
__device__ __forceinline__ void tc_issue_pv(float (&o)[C::kChunks][32],
                                            uint32_t (&pf)[BK / 16][4],
                                            uint32_t sV, uint32_t v_full, int t) {
  const int s = t % C::kStages, u = t / C::kStages;
  hopper::mbar_wait(v_full + 8 * s, u & 1);
  hopper::wgmma_fence();
  const uint32_t vt = sV + s * C::kTileBytes;
#pragma unroll
  for (int c = 0; c < C::kChunks; ++c) {
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t db =
          hopper::sw128_desc(vt + c * BK * 128 + kk * 16 * 128, BK * 128, 1024);
      hopper::wgmma_rs_64x64_tb(o[c], pf[kk][0], pf[kk][1], pf[kk][2], pf[kk][3],
                                db, 1);
    }
  }
  hopper::wgmma_commit();
}

// The masks (only on a tile that crosses an edge of what the warpgroup's
// rows see; a tile that none of them sees is computed all the same and
// masked whole, since a product in a branch that is not uniform across the
// block would make ptxas serialise every wgmma) and the online softmax of
// the score tile of keys [k0, k0 + BK), in the log2 domain:
// p = 2^(q.k / sqrt(D) log2(e) - m). The probabilities are rounded to bf16
// into the A-operand layout of P V; l sums them in f32, before rounding,
// as the plain version normalises before it casts.
template <int BK>
__device__ __forceinline__ void tc_softmax(float (&sc)[BK / 64][32],
                                           uint32_t (&pf)[BK / 16][4],
                                           float& m0, float& m1, float& l0,
                                           float& l1, float& alpha0,
                                           float& alpha1, const Rows& w, int k0) {
  const bool full = k0 + BK <= w.Sk && (!w.causal || k0 + BK - 1 <= w.w_lo) &&
                    (w.window <= 0 || w.w_hi - k0 < w.window);
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int nb = 0; nb < BK / 64; ++nb) {
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      float x = sc[nb][i];
      if (!full) {
        const int row = w.r0 + 8 * ((i >> 1) & 1);
        const int col = k0 + nb * 64 + 8 * (i >> 2) + 2 * w.c4 + (i & 1);
        const bool ok = col < w.Sk && (!w.causal || col <= row) &&
                        (w.window <= 0 || row - col < w.window);
        x = ok ? x : -INFINITY;
        sc[nb][i] = x;
      }
      if ((i >> 1) & 1) mx1 = fmaxf(mx1, x); else mx0 = fmaxf(mx0, x);
    }
  }
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
  }
  const float mn0 = fmaxf(m0, mx0 * w.scale_log2);
  const float mn1 = fmaxf(m1, mx1 * w.scale_log2);
  // a row that has seen nothing yet keeps m = -inf: subtract 0 then, so
  // that 2^(-inf - 0) = 0 and never NaN
  const float b0 = mn0 == -INFINITY ? 0.f : mn0;
  const float b1 = mn1 == -INFINITY ? 0.f : mn1;
  alpha0 = hopper::exp2_approx(m0 - b0);
  alpha1 = hopper::exp2_approx(m1 - b1);
  float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
  for (int nb = 0; nb < BK / 64; ++nb) {
#pragma unroll
    for (int kq = 0; kq < 4; ++kq) {
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = 8 * kq + 2 * a;
        const float bb = (a & 1) ? b1 : b0;
        const float e0 = hopper::exp2_approx(fmaf(sc[nb][i], w.scale_log2, -bb));
        const float e1 = hopper::exp2_approx(fmaf(sc[nb][i + 1], w.scale_log2, -bb));
        const __nv_bfloat162 p = __floats2bfloat162_rn(e0, e1);
        if (a & 1) rs1 += e0 + e1; else rs0 += e0 + e1;
        pf[4 * nb + kq][a] = *reinterpret_cast<const uint32_t*>(&p);
      }
    }
  }
  l0 = l0 * alpha0 + rs0;
  l1 = l1 * alpha1 + rs1;
  m0 = mn0;
  m1 = mn1;
}

template <int NC, int BK>
__device__ __forceinline__ void fence_operands(float (&o)[NC][32],
                                               uint32_t (&pf)[BK / 16][4]) {
#pragma unroll
  for (int c = 0; c < NC; ++c) hopper::fence_regs(o[c]);
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) hopper::fence_regs(pf[kk]);
}

template <int BK>
__device__ __forceinline__ void tc_copy_p(uint32_t (&dst)[BK / 16][4],
                                          const uint32_t (&src)[BK / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
    for (int a = 0; a < 4; ++a) dst[kk][a] = src[kk][a];
}

template <int DP, int BK>
__global__ void __launch_bounds__(TcCfg<DP, BK>::kThreads, 1)
flash_attention_tc_kernel(const __grid_constant__ CUtensorMap qmap,
                          const __grid_constant__ CUtensorMap kmap,
                          const __grid_constant__ CUtensorMap vmap,
                          __nv_bfloat16* __restrict__ out, int Sq, int Sk,
                          int Hq, int group, int D, int causal, int window,
                          float scale_log2) {
  using C = TcCfg<DP, BK>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (hopper::smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base, sK = base + C::kK, sV = base + C::kV;
  const uint32_t q_full = base + C::kBar;
  const uint32_t k_full = q_full + 8;                  // + 8 s
  const uint32_t v_full = k_full + 8 * C::kStages;     // + 8 s
  const uint32_t k_empty = v_full + 8 * C::kStages;    // + 8 s
  const uint32_t v_empty = k_empty + 8 * C::kStages;   // + 8 s

  // the heaviest causal query tiles first, so that the tail is short
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * C::kBq;
  const int kh = h / group;
  const int warp = hopper::warp_uniform_index();
  const int lane = threadIdx.x & 31;

  // key tiles any row of this block can see: [t_lo, t_lo + ntiles)
  int k_hi = Sk;
  if (causal) k_hi = min(k_hi, q0 + C::kBq);
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_lo = k_lo / BK;
  const int ntiles = max(0, (k_hi + BK - 1) / BK - t_lo);

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < C::kStages; ++s) {
      hopper::mbar_init(k_full + 8 * s, 1);
      hopper::mbar_init(v_full + 8 * s, 1);
      hopper::mbar_init(k_empty + 8 * s, C::kWg);
      hopper::mbar_init(v_empty + 8 * s, C::kWg);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (warp >= 4 * C::kWg) {
    // producer: Q once, then K and V tiles through the ring; one thread
    // issues every copy
    hopper::setmaxnreg_dec<C::kProducerRegs>();
    if (warp == 4 * C::kWg && lane == 0) {
      hopper::mbar_expect_tx(q_full, C::kQBytes);
#pragma unroll
      for (int c = 0; c < C::kChunks; ++c)
        hopper::tma_load_4d(sQ + c * C::kBq * 128, &qmap, q_full, c * 64, h, q0, b);
      for (int t = 0; t < ntiles; ++t) {
        const int s = t % C::kStages, u = t / C::kStages;
        const int k0 = (t_lo + t) * BK;
        const uint32_t kt = sK + s * C::kTileBytes, vt = sV + s * C::kTileBytes;
        if (u > 0) hopper::mbar_wait(k_empty + 8 * s, (u - 1) & 1);
        hopper::mbar_expect_tx(k_full + 8 * s, C::kTileBytes);
#pragma unroll
        for (int c = 0; c < C::kChunks; ++c)
          hopper::tma_load_4d(kt + c * BK * 128, &kmap, k_full + 8 * s, c * 64, kh,
                              k0, b);
        if (u > 0) hopper::mbar_wait(v_empty + 8 * s, (u - 1) & 1);
        hopper::mbar_expect_tx(v_full + 8 * s, C::kTileBytes);
#pragma unroll
        for (int c = 0; c < C::kChunks; ++c)
          hopper::tma_load_4d(vt + c * BK * 128, &vmap, v_full + 8 * s, c * 64, kh,
                              k0, b);
      }
    }
  } else {
    // consumers: warpgroup wg owns query rows [w_lo, w_lo + 64); this thread
    // holds rows r0 and r0 + 8 of each accumulator
    hopper::setmaxnreg_inc<C::kConsumerRegs>();
    const int wg = warp >> 2;
    const int c4 = lane & 3;
    const int w_lo = q0 + 64 * wg, w_hi = w_lo + 63;
    const int r0 = w_lo + 16 * (warp & 3) + (lane >> 2);
    const uint32_t qa = sQ + wg * 64 * 128;

    float o[C::kChunks][32];
#pragma unroll
    for (int c = 0; c < C::kChunks; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[c][i] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

    hopper::mbar_wait(q_full, 0);
    // turns: warpgroup 0 issues tile t's S after warpgroup 1 issued tile
    // t - 1's (named barrier 1), warpgroup 1 after warpgroup 0 issued tile
    // t's (barrier 2); warpgroup 1 opens the first turn
    if (wg == 1 && ntiles > 0) hopper::named_bar_arrive(1, 256);
    // Step t issues S of tile t and P V of tile t - 1, then runs tile t's
    // softmax while that P V is in flight, so that the tensor cores work
    // under the softmax; P of the tile in flight and of the next one take
    // two register sets. The first S and the last P V are peeled off the
    // loop: ptxas pipelines the wgmma only in straight-line code.
    uint32_t pf_prev[BK / 16][4], pf_cur[BK / 16][4];
    float sc[BK / 64][32];
    float alpha0, alpha1;
    const Rows rows{r0, c4, w_lo, w_hi, Sk, causal, window, scale_log2};
    if (ntiles > 0) {
      tc_issue_s<C, BK>(sc, qa, sK, k_full, 0, t_lo, wg, ntiles);
      hopper::wgmma_wait<0>();
#pragma unroll
      for (int nb = 0; nb < BK / 64; ++nb) hopper::fence_regs(sc[nb]);
      if ((threadIdx.x & 127) == 0) hopper::mbar_arrive(k_empty);
      tc_softmax<BK>(sc, pf_cur, m0, m1, l0, l1, alpha0, alpha1, rows,
                     t_lo * BK);
      tc_copy_p<BK>(pf_prev, pf_cur);
      for (int t = 1; t < ntiles; ++t) {
        const int s = t % C::kStages, sp = (t - 1) % C::kStages;
        fence_operands<C::kChunks, BK>(o, pf_prev);
        tc_issue_s<C, BK>(sc, qa, sK, k_full, t, t_lo, wg, ntiles);
        tc_issue_pv<C, BK>(o, pf_prev, sV, v_full, t - 1);
        hopper::wgmma_wait<1>();  // S of tile t
#pragma unroll
        for (int nb = 0; nb < BK / 64; ++nb) hopper::fence_regs(sc[nb]);
        if ((threadIdx.x & 127) == 0) hopper::mbar_arrive(k_empty + 8 * s);
        tc_softmax<BK>(sc, pf_cur, m0, m1, l0, l1, alpha0, alpha1, rows,
                       (t_lo + t) * BK);
        hopper::wgmma_wait<0>();  // P V of tile t - 1
        // O and P of tile t - 1 stay live (the wgmma read them up to here),
        // so that the softmax above cannot be given their registers
        fence_operands<C::kChunks, BK>(o, pf_prev);
        if ((threadIdx.x & 127) == 0) hopper::mbar_arrive(v_empty + 8 * sp);
        // O moves to tile t's max once tile t - 1's product is in it
#pragma unroll
        for (int c = 0; c < C::kChunks; ++c)
#pragma unroll
          for (int i = 0; i < 32; ++i) o[c][i] *= ((i >> 1) & 1) ? alpha1 : alpha0;
        tc_copy_p<BK>(pf_prev, pf_cur);
      }
      fence_operands<C::kChunks, BK>(o, pf_prev);
      tc_issue_pv<C, BK>(o, pf_prev, sV, v_full, ntiles - 1);
      hopper::wgmma_wait<0>();
#pragma unroll
      for (int c = 0; c < C::kChunks; ++c) hopper::fence_regs(o[c]);
    }

    // the 4 lanes of a row hold parts of its sum
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const float inv0 = l0 == 0.f ? 0.f : 1.f / l0;  // no visible key: 0
    const float inv1 = l1 == 0.f ? 0.f : 1.f / l1;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = r0 + 8 * half;
      if (row >= Sq) continue;
      const float inv = half ? inv1 : inv0;
      __nv_bfloat16* orow = out + (((long long)b * Sq + row) * Hq + h) * D;
#pragma unroll
      for (int c = 0; c < C::kChunks; ++c) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = c * 64 + 8 * j + 2 * c4;
          if (col < D)
            *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(
                o[c][4 * j + 2 * half] * inv, o[c][4 * j + 2 * half + 1] * inv);
        }
      }
    }
  }
}

// tensor-map failures are reported past the CUDA runtime's error codes
constexpr int kErrTensorMap = 100000;

template <int DP, int BK>
int launch_tc_cfg(const void* q, const void* k, const void* v, void* out, int B,
                  int Sq, int Sk, int Hq, int Hkv, int D, int causal, int window,
                  const long long* st, cudaStream_t stream) {
  using C = TcCfg<DP, BK>;
  CUtensorMap qm, km, vm;
  int rc = hopper::encode_bshd_map(&qm, q, B, Sq, Hq, D, st[0], st[1], st[2], C::kBq);
  if (rc == 0) rc = hopper::encode_bshd_map(&km, k, B, Sk, Hkv, D, st[3], st[4], st[5], BK);
  if (rc == 0) rc = hopper::encode_bshd_map(&vm, v, B, Sk, Hkv, D, st[6], st[7], st[8], BK);
  if (rc != 0) return kErrTensorMap + (rc < 0 ? 0 : rc);
  cudaError_t e = cudaFuncSetAttribute(flash_attention_tc_kernel<DP, BK>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)C::kSmem);
  if (e != cudaSuccess) return (int)e;
  const float scale_log2 = (float)(1.0 / sqrt((double)D)) * 1.4426950408889634f;
  const dim3 grid(Hq, B, (Sq + C::kBq - 1) / C::kBq);
  flash_attention_tc_kernel<DP, BK><<<grid, C::kThreads, C::kSmem, stream>>>(
      qm, km, vm, (__nv_bfloat16*)out, Sq, Sk, Hq, Hq / Hkv, D, causal, window,
      scale_log2);
  return (int)cudaGetLastError();
}

int launch_tc(int dp, int bk, const void* q, const void* k, const void* v,
              void* out, int B, int Sq, int Sk, int Hq, int Hkv, int D,
              int causal, int window, const long long* st, cudaStream_t stream) {
  if (D > dp || dp - D >= 64) return (int)cudaErrorInvalidValue;
#define REPRO_FA_CFG(DPV, BKV)                                                \
  if (dp == DPV && bk == BKV)                                                 \
    return launch_tc_cfg<DPV, BKV>(q, k, v, out, B, Sq, Sk, Hq, Hkv, D, causal, \
                                   window, st, stream);
  REPRO_FA_CFG(64, 128)
  REPRO_FA_CFG(128, 128)
  REPRO_FA_CFG(192, 64)
  REPRO_FA_CFG(256, 64)
#undef REPRO_FA_CFG
  return (int)cudaErrorInvalidValue;
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
// values in elements. dp, bk: the bf16 path's tiles (ops.py::tile_config;
// ignored for f32). The caller validates shapes and alignment; returns 0,
// cudaGetLastError() after the launch, or an error of its own.
extern "C" int repro_flash_attention(int dtype, const void* q, const void* k,
                                     const void* v, void* out, int B, int Sq,
                                     int Sk, int Hq, int Hkv, int D,
                                     int causal, int window,
                                     const long long* strides, int dp, int bk,
                                     void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || Hkv <= 0 || Hq % Hkv != 0 || D <= 0 ||
      D > kMaxD || D % kVec != 0 || window < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)launch_f32(q, k, v, out, B, Sq, Sk, Hq, Hkv, D, causal,
                           window, strides, st);
  if (dtype == 1)
    return launch_tc(dp, bk, q, k, v, out, B, Sq, Sk, Hq, Hkv, D, causal,
                     window, strides, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* repro_flash_attention_error_string(int code) {
  if (code >= kErrTensorMap)
    return "cuTensorMapEncodeTiled refused a tensor map (CUresult = code - 100000)";
  return cudaGetErrorString((cudaError_t)code);
}
