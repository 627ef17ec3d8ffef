// WKV6 recurrence (K8) for Hopper (sm_90a), with a plain C interface for
// ctypes.
//
//   K8 (wkv6_forward) replaces
//     src/repro/kernels/rwkv6_scan/rwkv6_scan.py: _wkv6_kernel
//     the RWKV-6 recurrence per (batch * head): r, k, v, w (BH, S, hd)
//     float32, u (BH, hd), the initial state (BH, hd, hd) float32; out y
//     (BH, S, hd) and the final state, float32.
//
// What it computes, step by step, as the Pallas kernel does:
//   y_t[j] = sum_i r_t[i] * (S[i][j] + u[i] * k_t[i] * v_t[j])
//   S[i][j] <- w_t[i] * S[i][j] + k_t[i] * v_t[j]
// The decay scales the state's rows i (the k index); y_t reads the state
// from before step t's update.  The Pallas kernel carried S in VMEM from
// one sequence chunk (grid step) to the next; here one CTA walks the whole
// sequence of its (b * h), so S never leaves the CTA.
//
// What bounds it at the main path's shape (rwkv6-1.6b prefill: BH = 4 x 32
// = 128, S = 2,048, hd = 64): r, k, v, w read once and y written once,
// 5 x 16.8 M floats = 336 MB (340 MB with u and the two states), 0.10 ms
// at 3.35 TB/s, against 5 flops per state element per step (an FMA for
// r . S, a product and an FMA for the update; the u bonus factors out as
// v_j * sum_i r_i u_i k_i, O(hd) a step) = 5.5 GFLOP, 0.08 ms at the CUDA
// cores' 67 TFLOP/s float32 peak: bytes bound it.  This kernel spends 7
// flops per element, as the Pallas kernel's form does: it adds the bonus
// u_i * k_i * v_j to each state element before the product with r_i (the
// factored sum would be computed alike by each of a row group's threads).
// The S steps of one (b * h) depend on each other, and only 128 CTAs exist
// for 132 SMs: in practice the kernel is bound by the latency of one step,
// times S, and by how well the loads of the inputs hide behind the steps.
//
// What the design does about it, simply: a CTA of 256 threads owns one
// (b * h); thread (g, j) keeps column j of the state over the rows
// g * R ... g * R + R - 1 in registers (R = hd * hd / 256 rows, 16 at
// hd 64).  A tile of 64 steps of r, k, v and w is staged in shared memory
// by cooperative float4 loads; then every thread runs the 64 steps alone,
// with no barrier between steps: the state update needs nothing from other
// threads, and each step's partial y (its R rows) goes to shared memory.
// One barrier per tile, then the partials of the 256 / hd row groups are
// summed in order and y is written coalesced.  A ragged last tile (S not a
// multiple of 64) is masked.  The next tile's loads are issued into
// registers before a tile's steps run, so their latency hides behind the
// steps.  Shared memory: 4 x 64 x hd floats of inputs plus 64 x 256 floats
// of partials, 128 KB at hd 64 (opt-in above 48 KB).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;  // steps staged per tile
constexpr int kDefaultSmem = 48 * 1024;

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * (4 * kTile * HD + kTile * kThreads);
}

// A tile of kTile rows of r, k, v and w, held in registers between its
// loads from device memory and its store to shared memory: thread x holds
// float4 number x + kThreads * n of each input's tile.
template <int HD>
struct Prefetch {
  static constexpr int kPer = kTile * HD / 4 / kThreads;
  float4 val[4][kPer];

  // Rows [t0, t0 + len) of the four (S, HD) inputs; rows past len are not
  // read.
  __device__ __forceinline__ void load(const float* const* src, int t0,
                                       int len) {
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const float4* s4 = reinterpret_cast<const float4*>(
          src[m] + static_cast<size_t>(t0) * HD);
#pragma unroll
      for (int n = 0; n < kPer; ++n) {
        const int i = threadIdx.x + kThreads * n;
        if (i < len * (HD / 4)) val[m][n] = __ldg(s4 + i);
      }
    }
  }

  __device__ __forceinline__ void store(float* const* dst, int len) const {
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      float4* d4 = reinterpret_cast<float4*>(dst[m]);
#pragma unroll
      for (int n = 0; n < kPer; ++n) {
        const int i = threadIdx.x + kThreads * n;
        if (i < len * (HD / 4)) d4[i] = val[m][n];
      }
    }
  }
};

// kRows consecutive floats of shared memory (a broadcast: every thread of
// a warp reads the same rows), as float4 where kRows allows.
template <int kRows>
__device__ __forceinline__ void load_rows(float* dst, const float* src) {
  if constexpr (kRows % 4 == 0) {
#pragma unroll
    for (int a = 0; a < kRows; a += 4) {
      const float4 x = *reinterpret_cast<const float4*>(src + a);
      dst[a] = x.x;
      dst[a + 1] = x.y;
      dst[a + 2] = x.z;
      dst[a + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int a = 0; a < kRows; ++a) dst[a] = src[a];
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
wkv6_kernel(const float* __restrict__ r, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ w,
            const float* __restrict__ u, const float* __restrict__ s0,
            float* __restrict__ y, float* __restrict__ s_out, int seq_len) {
  constexpr int kGroups = kThreads / HD;  // row groups
  constexpr int kRows = HD / kGroups;     // state rows per thread
  extern __shared__ __align__(16) float smem[];
  float* rs = smem;
  float* ks = rs + kTile * HD;
  float* vs = ks + kTile * HD;
  float* ws = vs + kTile * HD;
  float* part = ws + kTile * HD;  // [step][group][column]

  const int bh = blockIdx.x;
  const int j = threadIdx.x % HD;
  const int g = threadIdx.x / HD;
  const int i0 = g * kRows;
  const size_t seq_off = static_cast<size_t>(bh) * seq_len * HD;
  const float* const src[4] = {r + seq_off, k + seq_off, v + seq_off,
                               w + seq_off};
  float* const dst[4] = {rs, ks, vs, ws};
  float* yb = y + seq_off;
  const size_t st_off = static_cast<size_t>(bh) * HD * HD;

  float st[kRows], uu[kRows];
#pragma unroll
  for (int a = 0; a < kRows; ++a) {
    st[a] = s0[st_off + static_cast<size_t>(i0 + a) * HD + j];
    uu[a] = u[static_cast<size_t>(bh) * HD + i0 + a];
  }

  Prefetch<HD> pre;
  pre.load(src, 0, min(kTile, seq_len));
  for (int t0 = 0; t0 < seq_len; t0 += kTile) {
    const int len = min(kTile, seq_len - t0);
    __syncthreads();  // the previous tile's inputs and partials are read
    pre.store(dst, len);
    __syncthreads();
    // the next tile's loads fly while this tile's steps run
    if (t0 + kTile < seq_len)
      pre.load(src, t0 + kTile, min(kTile, seq_len - t0 - kTile));

    for (int t = 0; t < len; ++t) {
      float rt[kRows], kt[kRows], wt[kRows];
      load_rows<kRows>(rt, rs + t * HD + i0);
      load_rows<kRows>(kt, ks + t * HD + i0);
      load_rows<kRows>(wt, ws + t * HD + i0);
      const float vj = vs[t * HD + j];
      float acc[2] = {0.f, 0.f};  // two chains: even and odd rows
#pragma unroll
      for (int a = 0; a < kRows; ++a) {
        const float kv = kt[a] * vj;
        acc[a & 1] = fmaf(rt[a], fmaf(uu[a], kv, st[a]), acc[a & 1]);
        st[a] = fmaf(wt[a], st[a], kv);
      }
      part[(t * kGroups + g) * HD + j] = acc[0] + acc[1];
    }
    __syncthreads();  // every group's partials of this tile are written

    for (int idx = threadIdx.x; idx < len * HD; idx += kThreads) {
      const int t = idx / HD;
      const int c = idx % HD;
      float sum = 0.f;
#pragma unroll
      for (int gg = 0; gg < kGroups; ++gg)
        sum += part[(t * kGroups + gg) * HD + c];
      yb[static_cast<size_t>(t0 + t) * HD + c] = sum;
    }
  }

#pragma unroll
  for (int a = 0; a < kRows; ++a)
    s_out[st_off + static_cast<size_t>(i0 + a) * HD + j] = st[a];
}

template <int HD>
int launch(const float* r, const float* k, const float* v, const float* w,
           const float* u, const float* s0, float* y, float* s_out, int bh,
           int seq_len, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  if (smem > kDefaultSmem) {
    cudaError_t e = cudaFuncSetAttribute(
        wkv6_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  wkv6_kernel<HD><<<static_cast<unsigned>(bh), kThreads, smem, stream>>>(
      r, k, v, w, u, s0, y, s_out, seq_len);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// K8.  r, k, v, w, y (bh, seq_len, hd); u (bh, hd); s0, s_out (bh, hd, hd);
// float32, contiguous, 16-byte aligned; hd in {16, 32, 64}; seq_len >= 1.
int wkv6_forward(const void* r, const void* k, const void* v, const void* w,
                 const void* u, const void* s0, void* y, void* s_out, int bh,
                 int seq_len, int hd, void* stream) {
  if (bh <= 0 || seq_len <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* rf = static_cast<const float*>(r);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const float* wf = static_cast<const float*>(w);
  const float* uf = static_cast<const float*>(u);
  const float* sf = static_cast<const float*>(s0);
  float* yf = static_cast<float*>(y);
  float* of = static_cast<float*>(s_out);
  switch (hd) {
    case 16:
      return launch<16>(rf, kf, vf, wf, uf, sf, yf, of, bh, seq_len, st);
    case 32:
      return launch<32>(rf, kf, vf, wf, uf, sf, yf, of, bh, seq_len, st);
    case 64:
      return launch<64>(rf, kf, vf, wf, uf, sf, yf, of, bh, seq_len, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* wkv6_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
