// WKV6 recurrence (K8) for Hopper (sm_90a), with a plain C interface for
// ctypes.
//
//   K8 (wkv6_forward) replaces
//     src/repro/kernels/rwkv6_scan/rwkv6_scan.py: _wkv6_kernel
//     the RWKV-6 recurrence per (batch, head).  It reads the model's layout
//     in place: r, k, v (B, S, H, hd) as float32 or bfloat16 (the model's
//     type), w (B, S, H, hd) float32, u float32 (H, hd) (or one row per
//     batch entry), the initial state (B, H, hd, hd) float32; out y
//     (B, S, H, hd) and the final state (B, H, hd, hd), float32.  The
//     reference's (BH, S, hd) layout is the case B = BH, H = 1.
//
// What it computes, as the Pallas kernel does, step by step:
//   y_t[j] = sum_i r_t[i] * (S[i][j] + u[i] * k_t[i] * v_t[j])
//   S[i][j] <- w_t[i] * S[i][j] + k_t[i] * v_t[j]
// The decay scales the state's rows i (the k index); y_t reads the state
// from before step t's update.  bf16 inputs are widened to float32 as they
// land (exact); every product and sum is float32.  Two rewritings, exact in
// real arithmetic, cut the work per state element:
//   * the bonus factors out: y_t[j] = sum_i r_t[i] S[i][j] + v_t[j] a_t,
//     a_t = sum_i r_t[i] u[i] k_t[i], once a step;
//   * steps go in pairs (t = 1, 2) over the state S before step 1:
//       y_1 = r_1 . S,   y_2 = (r_2 w_1) . S + c v_1,  c = r_2 . k_1,
//       S <- (w_1 w_2) S + (k_1 w_2) v_1^T + k_2 v_2^T,
//     5 instructions per state element per pair (2 FMAs for y, a product
//     and 2 FMAs for S), where stepping one at a time costs 6 and the
//     Pallas form 8.  The decays are multiplied, never divided, so nothing
//     can overflow; a step past S (the ragged last tile) becomes w = 1,
//     r = k = v = 0, which leaves the state as it was.
//
// What bounds it at the main path's shape (rwkv6-1.6b prefill: B 4, H 32,
// S 2,048, hd 64; r, k, v bf16): r, k, v read as bf16 and w, y as float32
// are 14 bytes an element, 239 MB, 0.071 ms at 3.35 TB/s.  The flops the
// recurrence cannot avoid are 4 per state element per step (an FMA for
// r . S and an FMA for the rank-one update; the decay's product is one per
// element per group of steps, so it vanishes as the group grows): 4.4
// GFLOP, 0.065 ms at the CUDA cores' 67 TFLOP/s float32 peak.  The pairs
// below spend 4.5 per step, 0.073 ms.  So bytes bound it, with operations
// close behind (float32 inputs, 20 bytes an element, 0.10 ms by bytes).
// And the steps of one (b, h) depend on each other: one CTA walks a whole
// sequence, and there are only B * H = 128 CTAs for 132 SMs, so each SM
// has one CTA's instruction stream to keep issuing; that, not either
// bound, is what the design below works against.
//
// What the design does about it: one CTA per (b, h), of step warps that
// only run the recurrence and helper warps that feed them and drain them.
//   * step warps keep the state in registers: thread (rg, cg) holds rows
//     rg * R .. + R - 1 and columns cg * C .. + C - 1 (Tiling; 8 x 4 at
//     hd 64, 128 threads).  Per pair it loads its rows' 5 pair vectors and
//     its columns' v_1, v_2 from shared memory (12 LDS.128), runs 160 FP
//     instructions and stores 2 partial y rows; the next pair's loads are
//     issued before this pair's stores (two register sets taking turns), so
//     their latency hides behind the FMAs.  No barrier between pairs;
//   * helper warps (kHelpWarps) do the rest, one tile behind and one ahead
//     of the step warps: one thread issues TMA loads (4-D tensor maps over
//     (hd, H, S, B); a tile of P steps of one (b, h) per input) into a
//     ring of ST stages, each completing on its mbarrier; the helpers
//     widen tile n + 1 into a work buffer (the pair vectors r_1, r_2 w_1,
//     w_1 w_2, k_1 w_2, k_2, v, a_t and c, one warp a pair, sums by
//     shuffles) and sum tile n - 1's partials into y (row groups in a fixed
//     order, then + v_t a_t, then + v_1 c on a pair's second step; float4
//     stores, contiguous in (B, S, H, hd)), while the step warps run tile
//     n, so that work overlaps the steps instead of running between tiles.
//     Two work buffers and two partial buffers take turns, so one CTA
//     barrier a tile orders it all (and one helper barrier between a
//     reduction's last read of a work buffer and the widening that
//     overwrites it).
//   * shared memory at hd 64: bf16, 32-step tiles, 2 stages: 40 KB of ring,
//     2 x 28.2 KB of work, 2 x 64 KB of partials, 229,904 bytes in all;
//     float32, 16-step tiles, 4 stages: 160,096 bytes.  wkv6_config reports
//     the built figures.
// The tensor maps come from cuTensorMapEncodeTiled, reached through
// cudaGetDriverEntryPoint (no -lcuda at link time).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kF32 = 0;  // dtype codes of r, k, v
constexpr int kBF16 = 1;
constexpr int kMaxSmem = 232448;

template <int kDtype>
struct In;
template <>
struct In<kF32> {
  using T = float;
  static constexpr CUtensorMapDataType kMap = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
};
template <>
struct In<kBF16> {
  using T = __nv_bfloat16;
  static constexpr CUtensorMapDataType kMap =
      CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
};

// Per head width and input type: state rows x columns a step thread keeps,
// steps per tile, ring stages, helper warps.  At hd 64 a 32-step tile of
// float32 inputs would not fit beside two partial buffers.
template <int kDtype, int HD>
struct Tiling;
template <int kDtype>
struct Tiling<kDtype, 16> {
  static constexpr int R = 2, C = 2, P = 16, ST = 4, HW = 4;
};
template <int kDtype>
struct Tiling<kDtype, 32> {
  static constexpr int R = 4, C = 2, P = 16, ST = 4, HW = 4;
};
template <>
struct Tiling<kBF16, 64> {
  static constexpr int R = 8, C = 4, P = 32, ST = 2, HW = 8;
};
template <>
struct Tiling<kF32, 64> {
  static constexpr int R = 8, C = 4, P = 16, ST = 4, HW = 8;
};

template <int kDtype, int HD>
struct Cfg {
  using T = typename In<kDtype>::T;
  using Tl = Tiling<kDtype, HD>;
  static constexpr int R = Tl::R, C = Tl::C, P = Tl::P, ST = Tl::ST;
  static constexpr int kStepThreads = HD * HD / (R * C);
  static constexpr int kHelpWarps = Tl::HW;
  static constexpr int kHelpThreads = 32 * kHelpWarps;
  static constexpr int kThreads = kStepThreads + kHelpThreads;
  static constexpr int kColGroups = HD / C;
  static constexpr int kRowGroups = HD / R;
  static constexpr int kInBytes = P * HD * static_cast<int>(sizeof(T));
  static constexpr int kStageBytes = 3 * kInBytes + P * HD * 4;  // r k v w
  // work buffer: the pair vectors (r1, r2 w1, w1 w2, k1 w2, k2), each
  // (P / 2, HD); v (P, HD); a (P); c (P / 2)
  static constexpr int kPairRows = (P / 2) * HD;
  static constexpr int kWorkFloats = 5 * kPairRows + P * HD + P + P / 2;
  static constexpr int kPartFloats = P * kRowGroups * HD;
  static constexpr size_t kWorkOff = static_cast<size_t>(ST) * kStageBytes;
  static constexpr size_t kPartOff = kWorkOff + 2 * kWorkFloats * 4;
  static constexpr size_t kBarOff = kPartOff + 2 * kPartFloats * 4;
  // 128 bytes of slack to align the ring for TMA, then the ring, two work
  // buffers, two partial buffers and one mbarrier per stage
  static constexpr size_t kSmem = 128 + kBarOff + 8 * ST;
  static_assert(kStepThreads % 32 == 0 && kThreads <= 1024, "threads");
  static_assert(kStageBytes % 128 == 0 && kInBytes % 128 == 0, "TMA align");
  static_assert(kWorkFloats % 4 == 0, "float4 alignment of work buffers");
  static_assert(P % (2 * kHelpWarps) == 0 && P % 4 == 0, "tile steps");
  static_assert(kSmem <= kMaxSmem, "shared memory");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// Wait for the completion of the barrier's phase of this parity.  A tile
// that never lands (a bad tensor map) traps, as a launch error, instead of
// hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t spins = 0;; ++spins) {
    if (spins == (1u << 26)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
  }
}

// One box of a 4-D tensor map (coordinates innermost first) into shared
// memory, completing on bar.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// N consecutive floats of shared memory, as float4 / float2 where N allows.
template <int N>
__device__ __forceinline__ void load_vec(float* dst, const float* src) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int a = 0; a < N; a += 4) {
      const float4 x = *reinterpret_cast<const float4*>(src + a);
      dst[a] = x.x;
      dst[a + 1] = x.y;
      dst[a + 2] = x.z;
      dst[a + 3] = x.w;
    }
  } else if constexpr (N % 2 == 0) {
#pragma unroll
    for (int a = 0; a < N; a += 2) {
      const float2 x = *reinterpret_cast<const float2*>(src + a);
      dst[a] = x.x;
      dst[a + 1] = x.y;
    }
  } else {
#pragma unroll
    for (int a = 0; a < N; ++a) dst[a] = src[a];
  }
}

template <int N>
__device__ __forceinline__ void store_vec(float* dst, const float* src) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int a = 0; a < N; a += 4)
      *reinterpret_cast<float4*>(dst + a) =
          make_float4(src[a], src[a + 1], src[a + 2], src[a + 3]);
  } else if constexpr (N % 2 == 0) {
#pragma unroll
    for (int a = 0; a < N; a += 2)
      *reinterpret_cast<float2*>(dst + a) = make_float2(src[a], src[a + 1]);
  } else {
#pragma unroll
    for (int a = 0; a < N; ++a) dst[a] = src[a];
  }
}

// E consecutive inputs widened to float32 (exact for bf16).
template <int E>
__device__ __forceinline__ void load_in(float* dst, const float* src) {
  load_vec<E>(dst, src);
}
template <int E>
__device__ __forceinline__ void load_in(float* dst, const __nv_bfloat16* src) {
  if constexpr (E % 2 == 0) {
#pragma unroll
    for (int m = 0; m < E; m += 2) {
      const float2 x = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(src + m));
      dst[m] = x.x;
      dst[m + 1] = x.y;
    }
  } else {
#pragma unroll
    for (int m = 0; m < E; ++m) dst[m] = __bfloat162float(src[m]);
  }
}

// One step pair's inputs for a step thread: for steps t (1) and t + 1 (2),
// r1, r2 * w1, w1 * w2, k1 * w2 and k2 of its R rows, and v1, v2 of its C
// columns.
template <int R, int C>
struct PairIn {
  float r1[R], r2[R], w[R], k1[R], k2[R], v1[C], v2[C];
};

template <int kDtype, int HD>
__global__ void __launch_bounds__(Cfg<kDtype, HD>::kThreads, 1)
wkv6_kernel(const __grid_constant__ CUtensorMap tm_r,
            const __grid_constant__ CUtensorMap tm_k,
            const __grid_constant__ CUtensorMap tm_v,
            const __grid_constant__ CUtensorMap tm_w,
            const float* __restrict__ u, const float* __restrict__ s0,
            float* __restrict__ y, float* __restrict__ s_out, int heads,
            int seq_len, int u_per_batch) {
  using G = Cfg<kDtype, HD>;
  using T = typename G::T;
  constexpr int R = G::R, C = G::C, P = G::P, ST = G::ST;
  constexpr int kRG = G::kRowGroups;
  constexpr int kPairRows = G::kPairRows;
  // widening: E elements a lane, kLanes lanes of a warp per step
  constexpr int E = HD >= 32 ? HD / 32 : 1;
  constexpr int kLanes = HD / E;

  // pointers stay derived from the __shared__ array, so the compiler
  // emits shared-memory loads (LDS), not generic ones
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* const base =
      smem_raw + ((128u - (smem_u32(smem_raw) & 127u)) & 127u);
  float* const work0 = reinterpret_cast<float*>(base + G::kWorkOff);
  float* const part0 = reinterpret_cast<float*>(base + G::kPartOff);
  const uint32_t ring = smem_u32(base);
  const uint32_t bars = smem_u32(base + G::kBarOff);

  const int bh = blockIdx.x;
  const int b = bh / heads;
  const int h = bh % heads;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const bool helper = tid >= G::kStepThreads;
  const int htid = tid - G::kStepThreads;  // helper thread index
  const bool producer = htid == 0;
  const int n_tiles = (seq_len + P - 1) / P;

  // tile n of r, k, v, w into stage n % ST
  auto issue = [&](int n) {
    const uint32_t bar = bars + 8 * (n % ST);
    const uint32_t dst = ring + (n % ST) * G::kStageBytes;
    mbar_expect_tx(bar, G::kStageBytes);
    tma_load(dst, &tm_r, bar, 0, h, n * P, b);
    tma_load(dst + G::kInBytes, &tm_k, bar, 0, h, n * P, b);
    tma_load(dst + 2 * G::kInBytes, &tm_v, bar, 0, h, n * P, b);
    tma_load(dst + 3 * G::kInBytes, &tm_w, bar, 0, h, n * P, b);
  };
  // tile n into the stage that widen(n - ST) read, once a CTA barrier
  // has followed that read
  auto refill = [&](int n) {
    if (producer && n < n_tiles) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      issue(n);
    }
  };

  // Helpers: wait for tile n and widen it into work buffer n % 2, one warp
  // a step pair: the pair vectors, v, a_t of each step and the pair's c.
  auto widen = [&](int n, const float (&ue)[E]) {
    const int len = min(P, seq_len - n * P);
    float* const wb = work0 + (n & 1) * G::kWorkFloats;
    float* const wv = wb + 5 * kPairRows;
    float* const wa = wv + P * HD;
    float* const wc = wa + P;
    mbar_wait(bars + 8 * (n % ST), (n / ST) & 1);
    const uint8_t* stage = base + (n % ST) * G::kStageBytes;
    const T* sr = reinterpret_cast<const T*>(stage);
    const T* sk = reinterpret_cast<const T*>(stage + G::kInBytes);
    const T* sv = reinterpret_cast<const T*>(stage + 2 * G::kInBytes);
    const float* sw = reinterpret_cast<const float*>(stage + 3 * G::kInBytes);
#pragma unroll
    for (int m0 = 0; m0 < P / 2 / G::kHelpWarps; ++m0) {
      const int q = htid / 32 + m0 * G::kHelpWarps;  // step pair
      float sums[3] = {0.f, 0.f, 0.f};               // a_1, a_2, c
      if (lane < kLanes) {
        float rr[2][E], kk[2][E], vv[2][E], wd[2][E];
#pragma unroll
        for (int s2 = 0; s2 < 2; ++s2) {
          const int t = 2 * q + s2;
          const int e = t * HD + lane * E;
          load_in<E>(rr[s2], sr + e);
          load_in<E>(kk[s2], sk + e);
          load_in<E>(vv[s2], sv + e);
          load_vec<E>(wd[s2], sw + e);
          if (t >= len) {  // past S: a step that leaves the state as it was
#pragma unroll
            for (int m = 0; m < E; ++m) {
              rr[s2][m] = kk[s2][m] = vv[s2][m] = 0.f;
              wd[s2][m] = 1.f;
            }
          }
          store_vec<E>(wv + e, vv[s2]);
#pragma unroll
          for (int m = 0; m < E; ++m)
            sums[s2] = fmaf(rr[s2][m] * ue[m], kk[s2][m], sums[s2]);
        }
        float x[5][E];
#pragma unroll
        for (int m = 0; m < E; ++m) {
          x[0][m] = rr[0][m];
          x[1][m] = rr[1][m] * wd[0][m];
          x[2][m] = wd[0][m] * wd[1][m];
          x[3][m] = kk[0][m] * wd[1][m];
          x[4][m] = kk[1][m];
          sums[2] = fmaf(rr[1][m], kk[0][m], sums[2]);
        }
        const int e = q * HD + lane * E;
#pragma unroll
        for (int j = 0; j < 5; ++j) store_vec<E>(wb + j * kPairRows + e, x[j]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
        for (int j = 0; j < 3; ++j)
          sums[j] += __shfl_xor_sync(0xffffffffu, sums[j], off);
      }
      if (lane == 0) {
        wa[2 * q] = sums[0];
        wa[2 * q + 1] = sums[1];
        wc[q] = sums[2];
      }
    }
  };

  // Helpers: y of tile n = its row groups' partials summed in group order,
  // + v_t a_t, and on a pair's second step + v_1 c.
  auto reduce = [&](int n) {
    const int len = min(P, seq_len - n * P);
    const float* const wv = work0 + (n & 1) * G::kWorkFloats + 5 * kPairRows;
    const float* const wa = wv + P * HD;
    const float* const wc = wa + P;
    const float* const part = part0 + (n & 1) * G::kPartFloats;
    constexpr int kQuads = HD / 4;
    constexpr int kPer =
        (P * kQuads + G::kHelpThreads - 1) / G::kHelpThreads;
#pragma unroll
    for (int m0 = 0; m0 < kPer; ++m0) {
      const int idx = htid + m0 * G::kHelpThreads;
      if (idx >= len * kQuads) break;
      const int t = idx / kQuads;
      const int c = (idx % kQuads) * 4;
      const float* p = part + t * kRG * HD + c;
      float4 sum = *reinterpret_cast<const float4*>(p);
#pragma unroll
      for (int g = 1; g < kRG; ++g) {
        const float4 q = *reinterpret_cast<const float4*>(p + g * HD);
        sum.x += q.x;
        sum.y += q.y;
        sum.z += q.z;
        sum.w += q.w;
      }
      const float a = wa[t];
      const float4 vq = *reinterpret_cast<const float4*>(wv + t * HD + c);
      sum.x = fmaf(vq.x, a, sum.x);
      sum.y = fmaf(vq.y, a, sum.y);
      sum.z = fmaf(vq.z, a, sum.z);
      sum.w = fmaf(vq.w, a, sum.w);
      if (t & 1) {
        const float cc = wc[t / 2];
        const float4 vp =
            *reinterpret_cast<const float4*>(wv + (t - 1) * HD + c);
        sum.x = fmaf(vp.x, cc, sum.x);
        sum.y = fmaf(vp.y, cc, sum.y);
        sum.z = fmaf(vp.z, cc, sum.z);
        sum.w = fmaf(vp.w, cc, sum.w);
      }
      const size_t row =
          (static_cast<size_t>(b) * seq_len + n * P + t) * heads + h;
      *reinterpret_cast<float4*>(y + row * HD + c) = sum;
    }
  };

  if (producer) {
    for (int s = 0; s < ST; ++s) mbar_init(bars + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (producer)
    for (int n = 0; n < ST && n < n_tiles; ++n) issue(n);

  if (helper) {
    const float* urow =
        u + static_cast<size_t>(u_per_batch ? bh : h) * HD + lane * E;
    float ue[E];
#pragma unroll
    for (int m = 0; m < E; ++m) ue[m] = lane < kLanes ? urow[m] : 0.f;
    widen(0, ue);
    __syncthreads();
    refill(ST);
    for (int n = 0; n < n_tiles; ++n) {
      // while the step warps run tile n
      if (n > 0) reduce(n - 1);
      // every helper is past reduce(n - 1)'s reads of work buffer n + 1
      asm volatile("bar.sync 1, %0;\n" ::"n"(G::kHelpThreads) : "memory");
      if (n + 1 < n_tiles) widen(n + 1, ue);
      __syncthreads();
      refill(n + 1 + ST);
    }
    reduce(n_tiles - 1);
    return;
  }

  // Step warps: thread (rg, cg) keeps rows i0 .. i0 + R - 1 and columns
  // j0 .. j0 + C - 1 of the state in registers.
  const int rg = tid / G::kColGroups;
  const int i0 = rg * R;
  const int j0 = (tid % G::kColGroups) * C;
  const size_t st_off = static_cast<size_t>(bh) * HD * HD;
  float st[R][C];
#pragma unroll
  for (int a = 0; a < R; ++a)
    load_vec<C>(st[a], s0 + st_off + static_cast<size_t>(i0 + a) * HD + j0);
  __syncthreads();  // tile 0 widened

  for (int n = 0; n < n_tiles; ++n) {
    const float* const wb = work0 + (n & 1) * G::kWorkFloats;
    const float* const wv = wb + 5 * kPairRows;
    float* const prow = part0 + (n & 1) * G::kPartFloats + rg * HD + j0;
    auto load_pair = [&](PairIn<R, C>& in, int q) {
      const float* row = wb + q * HD + i0;
      load_vec<R>(in.r1, row);
      load_vec<R>(in.r2, row + kPairRows);
      load_vec<R>(in.w, row + 2 * kPairRows);
      load_vec<R>(in.k1, row + 3 * kPairRows);
      load_vec<R>(in.k2, row + 4 * kPairRows);
      load_vec<C>(in.v1, wv + 2 * q * HD + j0);
      load_vec<C>(in.v2, wv + (2 * q + 1) * HD + j0);
    };
    // y_1 = r1 . S and the r2 w1 . S part of y_2, then S <- (w1 w2) S +
    // (k1 w2) v1 + k2 v2; the partial y rows of the pair go to shared memory
    auto run_pair = [&](const PairIn<R, C>& in, int q) {
      float acc1[C], acc2[C];
#pragma unroll
      for (int c = 0; c < C; ++c) acc1[c] = acc2[c] = 0.f;
#pragma unroll
      for (int a = 0; a < R; ++a) {
#pragma unroll
        for (int c = 0; c < C; ++c) {
          acc1[c] = fmaf(in.r1[a], st[a][c], acc1[c]);
          acc2[c] = fmaf(in.r2[a], st[a][c], acc2[c]);
          const float kv = fmaf(in.k1[a], in.v1[c], in.k2[a] * in.v2[c]);
          st[a][c] = fmaf(in.w[a], st[a][c], kv);
        }
      }
      store_vec<C>(prow + 2 * q * kRG * HD, acc1);
      store_vec<C>(prow + (2 * q + 1) * kRG * HD, acc2);
    };
    // the pairs, no barrier between them; pair q + 1's loads go out before
    // pair q's stores
    PairIn<R, C> in0, in1;
    load_pair(in0, 0);
#pragma unroll 1
    for (int q = 0; q < P / 2; q += 2) {
      load_pair(in1, q + 1);
      run_pair(in0, q);
      // past the tile's end this reads other shared buffers, unused
      load_pair(in0, q + 2);
      run_pair(in1, q + 1);
    }
    __syncthreads();  // partials of tile n written; tile n + 1 widened
  }

#pragma unroll
  for (int a = 0; a < R; ++a)
    store_vec<C>(s_out + st_off + static_cast<size_t>(i0 + a) * HD + j0,
                 st[a]);
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime's entry
// point query, so the library needs no -lcuda.
int encode_fn(EncodeTiled* fn) {
  static EncodeTiled cached = nullptr;
  if (!cached) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &found);
#endif
    if (e != cudaSuccess) return static_cast<int>(e);
    if (found != cudaDriverEntryPointSuccess || !p)
      return static_cast<int>(cudaErrorNotSupported);
    cached = reinterpret_cast<EncodeTiled>(p);
  }
  *fn = cached;
  return 0;
}

// A (hd, heads, seq, batch) tensor map of a contiguous (B, S, H, hd)
// tensor, with boxes of one (b, h)'s `steps` rows; rows past S read as
// zeros.
int make_map(CUtensorMap* map, EncodeTiled encode, CUtensorMapDataType type,
             int elem_bytes, const void* ptr, int hd, int heads, int seq,
             int batch, int steps) {
  const cuuint64_t dims[4] = {
      static_cast<cuuint64_t>(hd), static_cast<cuuint64_t>(heads),
      static_cast<cuuint64_t>(seq), static_cast<cuuint64_t>(batch)};
  const cuuint64_t row = static_cast<cuuint64_t>(hd) * elem_bytes;
  const cuuint64_t strides[3] = {row, row * heads, row * heads * seq};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(hd), 1,
                             static_cast<cuuint32_t>(steps), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r =
      encode(map, type, 4, const_cast<void*>(ptr), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}


template <int kDtype, int HD>
int launch(const void* r, const void* k, const void* v, const void* w,
           const float* u, const float* s0, float* y, float* s_out, int batch,
           int seq_len, int heads, int u_per_batch, cudaStream_t stream) {
  using G = Cfg<kDtype, HD>;
  EncodeTiled encode;
  int err = encode_fn(&encode);
  if (err) return err;
  constexpr int eb = static_cast<int>(sizeof(typename G::T));
  constexpr CUtensorMapDataType type = In<kDtype>::kMap;
  CUtensorMap mr, mk, mv, mw;
  if ((err = make_map(&mr, encode, type, eb, r, HD, heads, seq_len, batch,
                      G::P)))
    return err;
  if ((err = make_map(&mk, encode, type, eb, k, HD, heads, seq_len, batch,
                      G::P)))
    return err;
  if ((err = make_map(&mv, encode, type, eb, v, HD, heads, seq_len, batch,
                      G::P)))
    return err;
  if ((err = make_map(&mw, encode, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, w, HD,
                      heads, seq_len, batch, G::P)))
    return err;
  cudaError_t e = cudaFuncSetAttribute(
      wkv6_kernel<kDtype, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(G::kSmem));
  if (e != cudaSuccess) return static_cast<int>(e);
  wkv6_kernel<kDtype, HD><<<static_cast<unsigned>(batch * heads),
                            G::kThreads, G::kSmem, stream>>>(
      mr, mk, mv, mw, u, s0, y, s_out, heads, seq_len, u_per_batch);
  return static_cast<int>(cudaGetLastError());
}

template <int kDtype>
int launch_dtype(int hd, const void* r, const void* k, const void* v,
                 const void* w, const float* u, const float* s0, float* y,
                 float* s_out, int batch, int seq_len, int heads,
                 int u_per_batch, cudaStream_t st) {
  switch (hd) {
    case 16:
      return launch<kDtype, 16>(r, k, v, w, u, s0, y, s_out, batch, seq_len,
                                heads, u_per_batch, st);
    case 32:
      return launch<kDtype, 32>(r, k, v, w, u, s0, y, s_out, batch, seq_len,
                                heads, u_per_batch, st);
    case 64:
      return launch<kDtype, 64>(r, k, v, w, u, s0, y, s_out, batch, seq_len,
                                heads, u_per_batch, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int kDtype, int HD>
void config(int* out) {
  using G = Cfg<kDtype, HD>;
  out[0] = G::P;
  out[1] = G::ST;
  out[2] = G::kStepThreads;
  out[3] = G::kHelpThreads;
  out[4] = G::R;
  out[5] = G::C;
  out[6] = G::kStageBytes;
  out[7] = static_cast<int>(G::kSmem);
}

template <int kDtype>
int config_dtype(int hd, int* out) {
  switch (hd) {
    case 16:
      config<kDtype, 16>(out);
      return 0;
    case 32:
      config<kDtype, 32>(out);
      return 0;
    case 64:
      config<kDtype, 64>(out);
      return 0;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// K8.  r, k, v (batch, seq_len, heads, hd) of dtype 0 = float32 or 1 =
// bfloat16; w, y (batch, seq_len, heads, hd) float32; u float32, (heads,
// hd), or (batch * heads, hd) when u_per_batch is non-zero; s0, s_out
// (batch, heads, hd, hd) float32; all contiguous and 16-byte aligned; hd in
// {16, 32, 64}; seq_len >= 1.
int wkv6_forward(const void* r, const void* k, const void* v, const void* w,
                 const void* u, const void* s0, void* y, void* s_out,
                 int batch, int seq_len, int heads, int hd, int dtype,
                 int u_per_batch, void* stream) {
  if (batch <= 0 || seq_len <= 0 || heads <= 0 ||
      static_cast<long long>(batch) * heads > 0x7FFFFFFF)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* uf = static_cast<const float*>(u);
  const float* sf = static_cast<const float*>(s0);
  float* yf = static_cast<float*>(y);
  float* of = static_cast<float*>(s_out);
  if (dtype == kF32)
    return launch_dtype<kF32>(hd, r, k, v, w, uf, sf, yf, of, batch, seq_len,
                              heads, u_per_batch, st);
  if (dtype == kBF16)
    return launch_dtype<kBF16>(hd, r, k, v, w, uf, sf, yf, of, batch,
                               seq_len, heads, u_per_batch, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The built configuration for head width hd and r, k, v of dtype (0
// float32, 1 bf16): out[8] = steps per tile, ring stages, step threads,
// helper threads, state rows and columns per step thread, bytes of one ring
// stage, dynamic shared memory bytes.
int wkv6_config(int hd, int dtype, int* out) {
  if (dtype == kF32) return config_dtype<kF32>(hd, out);
  if (dtype == kBF16) return config_dtype<kBF16>(hd, out);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* wkv6_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
