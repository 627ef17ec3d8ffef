// Flash attention forward (K7) for Hopper (sm_90a), with a plain C
// interface for ctypes.
//
//   K7 (fa_forward) replaces
//     src/repro/kernels/flash_attention/flash_attention.py: _flash_kernel
//     causal (optionally sliding-window) attention with an online softmax
//     over key/value tiles; q (BH, S, hd), k and v (BH, T, hd), float32 or
//     bfloat16, computed in float32, the output in the input's type.
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
//     (-inf) - (-inf) = NaN instead.)  The output is acc / max(l, 1e-30);
//   * a tile the row block cannot reach (k0 > q0 + BQ - 1 when causal,
//     q0 - (k0 + BK - 1) >= window with a window) is skipped whole;
//   * the ragged edge (S or T not a multiple of the tile) is masked here:
//     rows past S are neither loaded nor stored, columns past T read as
//     zero keys and values and are dropped.  (The interpret-mode Pallas
//     kernel reads NaN padding there and returns NaN rows; this kernel
//     returns what the oracle does.)
//
// What bounds it at the main path's shape (qwen3-4b prefill: BH = 4 x 32 =
// 128, S = T = 2,048, hd = 128, bf16, causal): 2 products of
// 2 * BH * hd * S(S+1)/2 flops = 137 GFLOP, 0.14 ms at the tensor cores'
// 989 TFLOP/s bf16 peak, against 4 * 128 * 2,048 * 128 * 2 B = 0.27 GB
// moved once, 0.08 ms at 3.35 TB/s: compute-bound.
//
// What the design does about it, simply: a CTA of 256 threads owns one
// (bh, 64-row query tile) and walks the key/value tiles of 64 rows in
// increasing order in a loop (the TPU's sequential innermost grid axis).
// Q, K, V and the tile's probabilities are staged in shared memory as
// float32; every product and the softmax are float32 FMAs on the CUDA
// cores, as the Pallas kernel upcasts, so the kernel is bound by the
// CUDA cores' 67 TFLOP/s (about 2 ms per launch at best), tens of times
// above the tensor-core bound.  A thread owns 4 query rows: their running
// max, sum and (4 x hd/16) accumulator stay in registers, and the row
// max and sum reduce across the 16 threads sharing the rows with warp
// shuffles.  CTAs are numbered so that the longest causal rows start
// first.  Tensor cores (wgmma), TMA and a pipelined tile ring are later
// work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;         // query rows per CTA
constexpr int kBK = 64;         // key / value rows per tile
constexpr int kThreads = 256;   // 16 x 16
constexpr int kTM = kBQ / 16;   // query rows per thread
constexpr int kTN = kBK / 16;   // score columns per thread: tx + 16 j
constexpr float kNegInf = -1e30f;
constexpr int kDefaultSmem = 48 * 1024;

__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }

__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Rows [row0, row0 + kRows) of a (len, D) matrix into shared memory with
// row stride ld (floats); rows at or past len read as zeros.
template <class T, int D, int kRows>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src,
                                          int row0, int len) {
  constexpr int kVecs = D / 4;
  for (int i = threadIdx.x; i < kRows * kVecs; i += kThreads) {
    const int r = i / kVecs;
    const int c = (i % kVecs) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < len) val = load4(src + static_cast<size_t>(row0 + r) * D + c);
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

template <class T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int bh_count,
                 int s_len, int t_len, float scale, int causal,
                 int use_window, int window) {
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
  const T* qb = q + static_cast<size_t>(bh) * s_len * D;
  const T* kb = k + static_cast<size_t>(bh) * t_len * D;
  const T* vb = v + static_cast<size_t>(bh) * t_len * D;
  T* ob = o + static_cast<size_t>(bh) * s_len * D;

  const int tx = threadIdx.x & 15;   // lanes tx share their rows
  const int ty = threadIdx.x >> 4;   // rows ty * kTM ... + kTM - 1
  const int row_base = q0 + ty * kTM;

  load_tile<T, D, kBQ>(qs, kLdQ, qb, q0, s_len);

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
    load_tile<T, D, kBK>(ks, kLdK, kb, k0, t_len);
    load_tile<T, D, kBK>(vs, kLdV, vb, k0, t_len);
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
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < kNC; ++c)
      store(ob + static_cast<size_t>(r) * D + tx + 16 * c, acc[i][c] / denom);
  }
}

template <class T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int bh,
           int s_len, int t_len, float scale, int causal, int use_window,
           int window, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  if (smem > kDefaultSmem) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const unsigned grid =
      static_cast<unsigned>((s_len + kBQ - 1) / kBQ) * static_cast<unsigned>(bh);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), bh, s_len, t_len, scale,
      causal, use_window, window);
  return static_cast<int>(cudaGetLastError());
}

template <class T>
int dispatch_hd(const void* q, const void* k, const void* v, void* o, int bh,
                int s_len, int t_len, int hd, float scale, int causal,
                int use_window, int window, cudaStream_t stream) {
  switch (hd) {
    case 32:
      return launch<T, 32>(q, k, v, o, bh, s_len, t_len, scale, causal,
                           use_window, window, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, bh, s_len, t_len, scale, causal,
                           use_window, window, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, bh, s_len, t_len, scale, causal,
                            use_window, window, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// K7.  q, o (bh, s_len, hd); k, v (bh, t_len, hd); contiguous, 16-byte
// aligned; dtype 0 = float32, 1 = bfloat16; hd in {32, 64, 128}; the
// window applies when use_window is non-zero.
int fa_forward(const void* q, const void* k, const void* v, void* o, int bh,
               int s_len, int t_len, int hd, int dtype, float scale,
               int causal, int use_window, int window, void* stream) {
  if (bh <= 0 || s_len <= 0 || t_len <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_hd<float>(q, k, v, o, bh, s_len, t_len, hd, scale,
                              causal, use_window, window, st);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16>(q, k, v, o, bh, s_len, t_len, hd,
                                      scale, causal, use_window, window, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* fa_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
