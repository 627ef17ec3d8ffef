// Flash attention forward (K7) for Hopper (sm_90a), with a plain C
// interface for ctypes.
//
//   K7 (fa_forward) replaces
//     src/repro/kernels/flash_attention/flash_attention.py: _flash_kernel
//     causal (optionally sliding-window) attention with an online softmax
//     over key/value tiles; q (BH, S, hd), k and v (BH / n_rep, T, hd),
//     float32 or bfloat16, computed in float32, the output in the input's
//     type.  Query head bh reads key/value head bh / n_rep (grouped-query
//     attention without repeating the KV heads in memory).
//
// What it computes, exactly as the Pallas kernel does:
//   * query row r and key column c count from 0 in q and in k (the kernel's
//     LEFT-aligned rule; the jnp oracle right-aligns when T != S, so the two
//     agree only at S == T, which is all the model passes).  The pair is
//     kept iff c < T, and r >= c when causal, and r - c < window when a
//     window is given;
//   * a dropped score is the finite -1e30, which is also the running max's
//     initial value.  A row whose first visited tile is wholly masked for it
//     takes p = exp(0) = 1 there; the next tile with a real score rescales
//     that away with alpha = exp(-1e30 - m) = 0.  (-INFINITY would give
//     (-inf) - (-inf) = NaN instead.)  The output is acc / max(l, 1e-30),
//     and 0 for a row that keeps no key at all (its running max is still
//     -1e30: S >= T + window, or window <= 0).  The Pallas kernel returns
//     the mean of V over the masked tiles it visited there, which depends
//     on its tiling; with the 0 every route and the plain version agree;
//   * a tile the row block cannot reach (k0 > q0 + BQ - 1 when causal,
//     q0 - (k0 + BK - 1) >= window with a window) is skipped whole;
//   * the ragged edge (S or T not a multiple of the tile) is masked here:
//     rows past S are not stored, columns past T read as zero keys and
//     values and are dropped.  (The interpret-mode Pallas kernel reads NaN
//     padding there and returns NaN rows; this kernel returns what the
//     oracle does.)
//
// What bounds it at the main path's shape (qwen3-4b prefill: BH = 4 x 32 =
// 128, 8 KV heads, S = T = 2,048, hd = 128, bf16, causal): 2 products of
// 2 * BH * hd * S(S+1)/2 flops = 137 GFLOP, 0.14 ms at the tensor cores'
// 989 TFLOP/s bf16 peak, against q, k, v and o moved once (0.17 GB with
// the KV heads read unrepeated), 0.05 ms at 3.35 TB/s: compute-bound.
//
// Two routes, chosen by the inputs' type (not a fallback: each type has
// exactly one):
//
// bfloat16: the tensor cores (flash_tc_kernel).  A CTA owns 128 query rows
// of one head: two consumer warpgroups of 64 rows each and a producer
// warpgroup, whose registers go to the consumers (setmaxnreg
// kProducerRegs / kConsumerRegs).
// One producer thread issues TMA loads (3-D tensor maps over (hd, rows,
// heads), so a head's ragged edge reads zeros, not the next head's rows)
// of Q once and of K / V tiles of 128 rows into a ring of 3 stages guarded
// by full / empty mbarriers.  Tiles land 128-byte swizzled (64-byte at
// hd 32); a row of 256 bytes (hd 128) is two 64-column boxes, and the
// wgmma descriptors step through them.  Each consumer warpgroup, per tile:
//   1. S = Q K^T with wgmma.m64n128k16 (A and B K-major from shared
//      memory), float32 accumulators in registers;
//   2. the online softmax on the accumulator fragment: masks (only tiles
//      that the diagonal, the window or the ragged edge cross pay for
//      them), a row's max over the quad of lanes that hold it, l summing
//      the float32 p per thread (the quad's shares are added once at the
//      end), O rescaled by alpha in registers.  Scores stay unscaled: a
//      dropped one is -1e30 and so is the running max's start, and
//      scale * log2(e) multiplies the differences inside exp2, so a
//      dropped score gives exp2(0) = 1 against a max of -1e30 and 0
//      against a real one, as the Pallas kernel's scaled -1e30 does;
//   3. O += P V as two wgmma.m64n{hd}k16 with A from registers: p_hi =
//      bf16(p), then p_lo = bf16(p - p_hi).  Rounding p once to bf16 puts
//      outputs near zero off the float32 plain version by more than 2e-5;
//      the split keeps p to ~2^-16 of itself at 1.5x the tensor-core work
//      (the floor becomes 0.21 ms).  The accumulator's register layout is
//      the A fragment's, pair for pair, so P never goes through shared
//      memory.  V is read as an MN-major B (transpose bit).
// The products overlap the softmax two ways: a warpgroup issues tile i's
// S together with tile i - 1's P V and runs tile i's softmax while P V is
// in flight (it releases tile i - 1's stage after), and the two
// warpgroups take turns to issue (named barriers), so one's softmax runs
// under the other's products.  The epilogue divides by max(l, 1e-30),
// rounds to bf16 and stores the rows below S.  CTAs are numbered so that
// the longest causal rows start first.  Tiles: BQ = 128 (2 x 64), BK =
// 128, 3 stages (a warpgroup holds tile i's K and tile i - 1's V while
// the third stage loads), Cfg<D>::kSmem bytes of shared memory;
// fa_tc_config reports these constants as built.  The
// tensor maps come from cuTensorMapEncodeTiled, reached through
// cudaGetDriverEntryPoint (no -lcuda at link time).
//
// float32: the CUDA cores (flash_fwd_kernel), since TF32 products would
// break float32's 2e-5.  A CTA of 256 threads owns one (bh, 64-row query
// tile) and walks the 64-row key/value tiles in order; Q, K, V and P are
// staged in shared memory and every product is a float32 FMA.  A thread
// owns 4 query rows: their running max, sum and (4 x hd/16) accumulator
// stay in registers, and the row max and sum reduce across the 16 threads
// sharing the rows with warp shuffles.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kDefaultSmem = 48 * 1024;

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kBQ = 64;         // query rows per CTA
constexpr int kBK = 64;         // key / value rows per tile
constexpr int kThreads = 256;   // 16 x 16
constexpr int kTM = kBQ / 16;   // query rows per thread
constexpr int kTN = kBK / 16;   // score columns per thread: tx + 16 j

// Rows [row0, row0 + kRows) of a (len, D) matrix into shared memory with
// row stride ld (floats); rows at or past len read as zeros.
template <int D, int kRows>
__device__ __forceinline__ void load_tile(float* dst, int ld, const float* src,
                                          int row0, int len) {
  constexpr int kVecs = D / 4;
  for (int i = threadIdx.x; i < kRows * kVecs; i += kThreads) {
    const int r = i / kVecs;
    const int c = (i % kVecs) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < len)
      val = __ldg(reinterpret_cast<const float4*>(
          src + static_cast<size_t>(row0 + r) * D + c));
    *reinterpret_cast<float4*>(dst + r * ld + c) = val;
  }
}

template <int D>
constexpr size_t smem_bytes() {
  // Q (no pad: a quarter warp reads one row), K (+4: a quarter warp reads
  // 8 rows as float4, conflict-free), V, P (+4).
  return sizeof(float) *
         (kBQ * D + kBK * (D + 4) + kBK * D + kBQ * (kBK + 4));
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 int bh_count, int n_rep, int s_len, int t_len, float scale,
                 int causal, int use_window, int window) {
  constexpr int kLdQ = D;
  constexpr int kLdK = D + 4;
  constexpr int kLdV = D;
  constexpr int kLdP = kBK + 4;
  constexpr int kNC = D / 16;  // output columns per thread: tx + 16 c
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* ks = qs + kBQ * kLdQ;
  float* vs = ks + kBK * kLdK;
  float* ps = vs + kBK * kLdV;

  // longest causal rows first: block 0.. take the last query tile of
  // every (batch, head), then the one before, ...
  const int n_q = (s_len + kBQ - 1) / kBQ;
  const int bh = blockIdx.x % bh_count;
  const int qi = n_q - 1 - static_cast<int>(blockIdx.x / bh_count);
  const int q0 = qi * kBQ;
  const float* qb = q + static_cast<size_t>(bh) * s_len * D;
  const float* kb = k + static_cast<size_t>(bh / n_rep) * t_len * D;
  const float* vb = v + static_cast<size_t>(bh / n_rep) * t_len * D;
  float* ob = o + static_cast<size_t>(bh) * s_len * D;

  const int tx = threadIdx.x & 15;   // lanes tx share their rows
  const int ty = threadIdx.x >> 4;   // rows ty * kTM ... + kTM - 1
  const int row_base = q0 + ty * kTM;

  load_tile<D, kBQ>(qs, kLdQ, qb, q0, s_len);

  float m[kTM], l[kTM], acc[kTM][kNC];
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kNC; ++c) acc[i][c] = 0.f;
  }

  const int n_k = (t_len + kBK - 1) / kBK;
  for (int kt = 0; kt < n_k; ++kt) {
    const int k0 = kt * kBK;
    // tile-level reachability (flash_attention.py:48-52)
    if (causal && k0 > q0 + kBQ - 1) break;
    if (use_window && !(q0 - (k0 + kBK - 1) < window)) continue;

    __syncthreads();  // the previous tile's K, V and P reads are done
    load_tile<D, kBK>(ks, kLdK, kb, k0, t_len);
    load_tile<D, kBK>(vs, kLdV, vb, k0, t_len);
    __syncthreads();

    float s[kTM][kTN];
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[kTM], kv[kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
        qv[i] = *reinterpret_cast<const float4*>(qs + (ty * kTM + i) * kLdQ + d);
#pragma unroll
      for (int j = 0; j < kTN; ++j)
        kv[j] = *reinterpret_cast<const float4*>(ks + (tx + 16 * j) * kLdK + d);
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const int r = row_base + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        const int c = k0 + tx + 16 * j;
        bool keep = c < t_len;
        if (causal) keep = keep && r >= c;
        if (use_window) keep = keep && r - c < window;
        s[i][j] = keep ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        rs += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = alpha * l[i] + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kNC; ++c) acc[i][c] *= alpha;
#pragma unroll
      for (int j = 0; j < kTN; ++j)
        ps[(ty * kTM + i) * kLdP + tx + 16 * j] = s[i][j];
    }
    __syncthreads();  // P complete

#pragma unroll 2
    for (int kk = 0; kk < kBK; kk += 4) {
      float4 pv[kTM];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
        pv[i] = *reinterpret_cast<const float4*>(ps + (ty * kTM + i) * kLdP + kk);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float vv[kNC];
#pragma unroll
        for (int c = 0; c < kNC; ++c) vv[c] = vs[(kk + u) * kLdV + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < kTM; ++i) {
          const float p = u == 0 ? pv[i].x : u == 1 ? pv[i].y
                        : u == 2 ? pv[i].z : pv[i].w;
#pragma unroll
          for (int c = 0; c < kNC; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int r = row_base + i;
    if (r >= s_len) continue;
    const bool no_key = m[i] == kNegInf;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < kNC; ++c)
      ob[static_cast<size_t>(r) * D + tx + 16 * c] =
          no_key ? 0.f : acc[i][c] / denom;
  }
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* o, int bh,
               int n_rep, int s_len, int t_len, float scale, int causal,
               int use_window, int window, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  const long long n_cta = static_cast<long long>((s_len + kBQ - 1) / kBQ) * bh;
  if (n_cta > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidConfiguration);
  if (smem > kDefaultSmem) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  flash_fwd_kernel<D><<<static_cast<unsigned>(n_cta), kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), bh, n_rep, s_len,
      t_len, scale, causal, use_window, window);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bfloat16: tensor cores (wgmma), TMA, a K/V ring
// ---------------------------------------------------------------------------

namespace tc {

constexpr int kConsumers = 2;                     // warpgroups of 64 rows
constexpr int kBQ = 64 * kConsumers;              // query rows per CTA
constexpr int kBK = 128;                          // key / value rows per tile
constexpr int kStages = 3;                        // K/V ring depth
constexpr int kThreads = 128 * (kConsumers + 1);  // + a producer warpgroup
constexpr int kProducerRegs = 24;                 // setmaxnreg, per thread
constexpr int kConsumerRegs = 240;
constexpr float kLog2e = 1.4426950408889634f;

// 2^x on the special function unit: ~2 ulp, subnormal results flushed
// to 0 (p is summed against l >= 1, alpha multiplies O).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int D>
struct Cfg {
  // A tile row of D bf16 lands as D * 2 / kRowBytes boxes of kRowBytes per
  // row, each swizzled over its own rows (128-byte swizzle; 64 at hd 32).
  static constexpr int kRowBytes = D * 2 < 128 ? D * 2 : 128;
  static constexpr int kBoxes = D * 2 / kRowBytes;
  static constexpr int kBoxCols = kRowBytes / 2;
  static constexpr int kQBox = kBQ * kRowBytes;   // bytes of one Q box
  static constexpr int kKBox = kBK * kRowBytes;   // bytes of one K / V box
  static constexpr int kQBytes = kBoxes * kQBox;
  static constexpr int kKVBytes = kBoxes * kKBox;  // one of K or V
  // wgmma descriptor layout type: 1 = 128-byte swizzle, 2 = 64-byte
  static constexpr uint64_t kLayout = kRowBytes == 128 ? 1 : 2;
  // 1024 bytes of slack to align the buffers to the swizzle's period,
  // then Q, the ring, and 1 + 2 * kStages mbarriers.
  static constexpr size_t kSmem =
      1024 + kQBytes + 2 * kStages * kKVBytes + 8 * (1 + 2 * kStages);
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

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Wait for the completion of the barrier's phase of this parity.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of a 3-D tensor map (coordinates innermost first) into shared
// memory, completing on bar.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// A wgmma shared-memory matrix descriptor: start address, leading and
// stride byte offsets (16-byte units) and the swizzle layout type.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32) | (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N committed wgmma groups are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Named barrier id (1 + warpgroup) over both consumer warpgroups: one
// warpgroup's turn to issue its products.
__device__ __forceinline__ void turn_wait(int wg) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + wg), "n"(256) : "memory");
}

__device__ __forceinline__ void turn_pass(int wg) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(1 + (1 - wg)), "n"(256)
               : "memory");
}

// Keeps the compiler from moving reads or writes of an accumulator
// register across the asynchronous wgmma that owns it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// wgmma.m64nNk16, float32 += bf16 x bf16.  wgmma_ss (N = 128): A and B
// K-major in shared memory (descriptors da, db), D = A B + (scale_d ? D :
// 0).  wgmma_rs (N = 32, 64, 128 by the accumulator's size, N / 2 floats
// a thread): A from four registers (bf16x2 pairs), B MN-major in shared
// memory (the transpose bit), D += A B.
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
        "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
        "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
        "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t* a,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
      ", {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t* a,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}"
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t* a,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}"
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
        "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
        "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
        "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v,
                __nv_bfloat16* __restrict__ o, int bh_count, int n_rep,
                int s_len, int t_len, float scale, int causal, int use_window,
                int window) {
  using C = Cfg<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t q_s = smem_u32(base);
  const uint32_t ring = q_s + C::kQBytes;  // stage st: K, then V
  const uint32_t bars = ring + 2 * kStages * C::kKVBytes;
  const uint32_t q_bar = bars;
  // full[st] = bars + 8 (1 + st); empty[st] = bars + 8 (1 + kStages + st)

  const int n_q = (s_len + kBQ - 1) / kBQ;
  const int bh = blockIdx.x % bh_count;
  const int q0 = (n_q - 1 - static_cast<int>(blockIdx.x / bh_count)) * kBQ;
  const int kvh = bh / n_rep;

  // the key tiles this CTA's rows reach (flash_attention.py:48-52)
  const int n_k = (t_len + kBK - 1) / kBK;
  int kt_end = n_k;
  if (causal) kt_end = min(kt_end, (q0 + kBQ - 1) / kBK + 1);
  int kt_begin = 0;
  if (use_window)
    while (kt_begin < kt_end && !(q0 - (kt_begin * kBK + kBK - 1) < window))
      ++kt_begin;

  if (threadIdx.x == 0) {
    mbar_init(q_bar, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(bars + 8 * (1 + st), 1);
      mbar_init(bars + 8 * (1 + kStages + st), 4 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    // producer warpgroup: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs)
                 : "memory");
    if (threadIdx.x % 128 != 0) return;
    mbar_expect_tx(q_bar, C::kQBytes);
    for (int b = 0; b < C::kBoxes; ++b)
      tma_load(q_s + b * C::kQBox, &tm_q, q_bar, b * C::kBoxCols, q0, bh);
    for (int kt = kt_begin; kt < kt_end; ++kt) {
      const int i = kt - kt_begin;
      const int st = i % kStages;
      if (i >= kStages)
        mbar_wait(bars + 8 * (1 + kStages + st), (i / kStages - 1) & 1);
      const uint32_t full = bars + 8 * (1 + st);
      const uint32_t k_s = ring + 2 * st * C::kKVBytes;
      const uint32_t v_s = k_s + C::kKVBytes;
      mbar_expect_tx(full, 2 * C::kKVBytes);
      for (int b = 0; b < C::kBoxes; ++b) {
        tma_load(k_s + b * C::kKBox, &tm_k, full, b * C::kBoxCols, kt * kBK,
                 kvh);
        tma_load(v_s + b * C::kKBox, &tm_v, full, b * C::kBoxCols, kt * kBK,
                 kvh);
      }
    }
    return;
  }

  // consumer warpgroup wg: query rows q0 + 64 wg ... + 63
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs)
               : "memory");
  const int t = threadIdx.x % 128;
  const int warp = t / 32, lane = t % 32;
  const int r_lo = q0 + 64 * wg;
  const int row0 = r_lo + 16 * warp + lane / 4;  // and row0 + 8
  const int col0 = 2 * (lane % 4);               // + 8 j, + 1
  const uint32_t q_wg = q_s + 64 * wg * C::kRowBytes;
  constexpr uint32_t kSbo = 8 * C::kRowBytes;    // next 8-row group

  const float scale_log2 = scale * kLog2e;
  float o_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o_acc[i] = 0.f;
  float m0 = kNegInf, m1 = kNegInf;  // rows row0, row0 + 8
  float l0 = 0.f, l1 = 0.f;          // this thread's share of l
  uint32_t p_hi[kBK / 4], p_lo[kBK / 4];

  auto k_stage = [&](int st) { return ring + 2 * st * C::kKVBytes; };
  auto issue_scores = [&](float (&s)[kBK / 2], uint32_t k_s) {
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      const int box = ks * 32 / C::kRowBytes;
      const int off = ks * 32 % C::kRowBytes;
      wgmma_ss(s,
               make_desc(q_wg + box * C::kQBox + off, 16, kSbo, C::kLayout),
               make_desc(k_s + box * C::kKBox + off, 16, kSbo, C::kLayout),
               ks > 0);
    }
    wgmma_commit();
  };
  auto issue_pv = [&](uint32_t v_s) {
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks)
      wgmma_rs(o_acc, p_hi + 4 * ks,
               make_desc(v_s + ks * 16 * C::kRowBytes, C::kKBox, kSbo,
                         C::kLayout));
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks)
      wgmma_rs(o_acc, p_lo + 4 * ks,
               make_desc(v_s + ks * 16 * C::kRowBytes, C::kKBox, kSbo,
                         C::kLayout));
    wgmma_commit();
  };
  // mask, exp2 in place; updates m and l, returns the rescale factors
  auto softmax = [&](float (&s)[kBK / 2], int k0, float& alpha0,
                     float& alpha1) {
    const bool need_mask = k0 + kBK > t_len ||
                           (causal && k0 + kBK - 1 > r_lo) ||
                           (use_window && r_lo + 63 - k0 >= window);
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[4 * j + e];
        if (need_mask) {
          const int r = row0 + (e >= 2 ? 8 : 0);
          const int c = k0 + 8 * j + col0 + (e & 1);
          bool keep = c < t_len;
          if (causal) keep = keep && r >= c;
          if (use_window) keep = keep && r - c < window;
          x = keep ? x : kNegInf;
        }
        s[4 * j + e] = x;
        if (e < 2) mx0 = fmaxf(mx0, x);
        else mx1 = fmaxf(mx1, x);
      }
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    alpha0 = ex2((m0 - mn0) * scale_log2);
    alpha1 = ex2((m1 - mn1) * scale_log2);
    m0 = mn0;
    m1 = mn1;
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = ex2((s[4 * j + e] - (e < 2 ? mn0 : mn1)) * scale_log2);
        s[4 * j + e] = p;
        if (e < 2) rs0 += p;
        else rs1 += p;
      }
    }
    l0 = alpha0 * l0 + rs0;
    l1 = alpha1 * l1 + rs1;
  };
  auto split_p = [&](const float (&s)[kBK / 2]) {
#pragma unroll
    for (int i = 0; i < kBK / 4; ++i) {
      const __nv_bfloat162 hi = __floats2bfloat162_rn(s[2 * i], s[2 * i + 1]);
      const float2 hf = __bfloat1622float2(hi);
      const __nv_bfloat162 lo =
          __floats2bfloat162_rn(s[2 * i] - hf.x, s[2 * i + 1] - hf.y);
      p_hi[i] = *reinterpret_cast<const uint32_t*>(&hi);
      p_lo[i] = *reinterpret_cast<const uint32_t*>(&lo);
    }
  };
  auto rescale = [&](float alpha0, float alpha1) {
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o_acc[4 * j] *= alpha0;
      o_acc[4 * j + 1] *= alpha0;
      o_acc[4 * j + 2] *= alpha1;
      o_acc[4 * j + 3] *= alpha1;
    }
  };

  mbar_wait(q_bar, 0);
  if (kt_begin < kt_end) {
    mbar_wait(bars + 8, 0);
    if (wg == 1) turn_pass(wg);  // warpgroup 0 issues first
    {
      float s[kBK / 2];
      fence_regs(s);
      turn_wait(wg);
      issue_scores(s, k_stage(0));
      turn_pass(wg);
      wgmma_wait<0>();
      fence_regs(s);
      float a0, a1;
      softmax(s, kt_begin * kBK, a0, a1);
      split_p(s);
    }
    for (int kt = kt_begin + 1; kt < kt_end; ++kt) {
      const int i = kt - kt_begin;
      const int st = i % kStages, prev = (i - 1) % kStages;
      mbar_wait(bars + 8 * (1 + st), (i / kStages) & 1);
      float s[kBK / 2];
      fence_regs(s);
      turn_wait(wg);
      issue_scores(s, k_stage(st));
      fence_regs(o_acc);
      issue_pv(k_stage(prev) + C::kKVBytes);
      turn_pass(wg);
      wgmma_wait<1>();
      fence_regs(s);
      float a0, a1;
      softmax(s, kt * kBK, a0, a1);
      wgmma_wait<0>();
      fence_regs(o_acc);
      if (lane == 0) mbar_arrive(bars + 8 * (1 + kStages + prev));  // per warp
      rescale(a0, a1);
      split_p(s);
    }
    const int st = (kt_end - 1 - kt_begin) % kStages;
    fence_regs(o_acc);
    turn_wait(wg);
    issue_pv(k_stage(st) + C::kKVBytes);
    if (wg == 0) turn_pass(wg);  // warpgroup 1 owes no further turn
    wgmma_wait<0>();
    fence_regs(o_acc);
  }

  // l: the quad's shares; then O / max(l, 1e-30) in bf16 (0 for a row
  // that kept no key), rows below S
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  __nv_bfloat16* ob = o + static_cast<size_t>(bh) * s_len * D;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + 8 * h;
    if (r >= s_len) continue;
    const float dn = h ? d1 : d0;
    const bool no_key = (h ? m1 : m0) == kNegInf;
    __nv_bfloat16* orow = ob + static_cast<size_t>(r) * D + col0;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) = __floats2bfloat162_rn(
          no_key ? 0.f : o_acc[4 * j + 2 * h] / dn,
          no_key ? 0.f : o_acc[4 * j + 2 * h + 1] / dn);
  }
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

// A (D, rows, heads) bf16 tensor map with boxes of (kBoxCols, box_rows, 1).
template <int D>
int make_map(CUtensorMap* map, EncodeTiled encode, const void* ptr, int rows,
             int heads, int box_rows) {
  using C = Cfg<D>;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(heads)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(rows) * D * 2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(C::kBoxCols),
                             static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      C::kRowBytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                          : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int bh,
           int n_rep, int s_len, int t_len, float scale, int causal,
           int use_window, int window, cudaStream_t stream) {
  using C = Cfg<D>;
  EncodeTiled encode;
  int err = encode_fn(&encode);
  if (err) return err;
  CUtensorMap mq, mk, mv;
  if ((err = make_map<D>(&mq, encode, q, s_len, bh, kBQ))) return err;
  if ((err = make_map<D>(&mk, encode, k, t_len, bh / n_rep, kBK))) return err;
  if ((err = make_map<D>(&mv, encode, v, t_len, bh / n_rep, kBK))) return err;
  const long long n_cta = static_cast<long long>((s_len + kBQ - 1) / kBQ) * bh;
  if (n_cta > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaError_t e = cudaFuncSetAttribute(
      flash_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(C::kSmem));
  if (e != cudaSuccess) return static_cast<int>(e);
  flash_tc_kernel<D><<<static_cast<unsigned>(n_cta), kThreads, C::kSmem,
                       stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), bh, n_rep, s_len, t_len,
      scale, causal, use_window, window);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
void config(int* out) {
  out[0] = kBQ;
  out[1] = kBK;
  out[2] = kStages;
  out[3] = kConsumers;
  out[4] = static_cast<int>(Cfg<D>::kSmem);
  out[5] = kProducerRegs;
  out[6] = kConsumerRegs;
}

}  // namespace tc

// One route per type: float32 on the CUDA cores, bfloat16 on the tensor
// cores.
template <int D>
int launch_route(int dtype, const void* q, const void* k, const void* v,
                 void* o, int bh, int n_rep, int s_len, int t_len, float scale,
                 int causal, int use_window, int window, cudaStream_t st) {
  if (dtype == 0)
    return launch_f32<D>(q, k, v, o, bh, n_rep, s_len, t_len, scale, causal,
                         use_window, window, st);
  if (dtype == 1)
    return tc::launch<D>(q, k, v, o, bh, n_rep, s_len, t_len, scale, causal,
                         use_window, window, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// K7.  q, o (bh, s_len, hd); k, v (bh / n_rep, t_len, hd); query head b
// reads key/value head b / n_rep; contiguous, 16-byte aligned; dtype 0 =
// float32 (CUDA cores), 1 = bfloat16 (tensor cores); hd in {32, 64, 128};
// the window applies when use_window is non-zero.
int fa_forward(const void* q, const void* k, const void* v, void* o, int bh,
               int n_rep, int s_len, int t_len, int hd, int dtype,
               float scale, int causal, int use_window, int window,
               void* stream) {
  if (bh <= 0 || s_len <= 0 || t_len <= 0 || n_rep <= 0 || bh % n_rep)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32:
      return launch_route<32>(dtype, q, k, v, o, bh, n_rep, s_len, t_len,
                              scale, causal, use_window, window, st);
    case 64:
      return launch_route<64>(dtype, q, k, v, o, bh, n_rep, s_len, t_len,
                              scale, causal, use_window, window, st);
    case 128:
      return launch_route<128>(dtype, q, k, v, o, bh, n_rep, s_len, t_len,
                               scale, causal, use_window, window, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The bf16 route's configuration at head width hd, from the constants it
// was built with: out[7] = query rows per CTA, key / value rows per tile,
// ring stages, consumer warpgroups, dynamic shared memory bytes, and the
// producer's and consumers' registers per thread after setmaxnreg.
int fa_tc_config(int hd, int* out) {
  switch (hd) {
    case 32:
      tc::config<32>(out);
      return 0;
    case 64:
      tc::config<64>(out);
      return 0;
    case 128:
      tc::config<128>(out);
      return 0;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* fa_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
