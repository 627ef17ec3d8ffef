// Tree-predict kernels for Hopper (sm_90a), with a plain C interface for
// ctypes.  Four kernels; K1-K3 share one aggregating template, K4 writes
// every (tree, row) leaf:
//
//   K1 (tp_seg_packed) replaces
//     src/repro/kernels/tree_predict/tree_predict.py:
//     _tree_predict_agg_seg_pipelined_kernel
//     fused float32 code word per node, per-row-block chunk ranges.
//   K2 (tp_seg_simple) replaces
//     src/repro/kernels/tree_predict/tree_predict.py:
//     _tree_predict_agg_seg_kernel
//     separate feature / threshold / is_internal tables, every chunk,
//     masks tree_id < T as well as the segment ids.
//   K3 (tp_agg) replaces
//     src/repro/kernels/tree_predict/tree_predict.py:
//     _tree_predict_agg_kernel
//     K2's tables and loop with the segment test compiled out: every tree
//     below T counts for every row.
//   K4 (tp_per_tree) replaces
//     src/repro/kernels/tree_predict/tree_predict.py:
//     _tree_predict_kernel
//     the unaggregated (T, N) leaf fit of every (tree, row) pair.
//
// What they compute: each tree walked `max_depth` levels of its heap
// (node i -> children 2i+1 / 2i+2); an index at or past the heap width h
// reads as a leaf with fit 0, as the TPU kernels read their zero-padded
// heaps.  K1-K3 then reduce per row to vote counts (N, C) or a fit sum
// (N,), over the trees whose segment id equals the row's (K1, K2) or over
// all trees (K3); K4 stores each leaf.
//
// What bounds them on this card: a walk is a chain of dependent loads (the
// node decides which node comes next), so a (tree, row) pair costs
// max_depth load latencies and moves a few bytes per level.  The tables
// are small next to L2 (100 trees at depth 8: 100 * 511 * 8 B = 0.4 MB) and
// are re-read by every row block, so the kernels are bound by load latency
// and the number of pairs in flight, not by HBM bytes or arithmetic.  K4
// also writes 4 * T * N bytes, coalesced along rows.
//
// What the design does about it: the TPU kernels gathered nodes with
// two-level one-hot matrix products because VMEM gathers are slow; here a
// node is ONE indexed load through the read-only cache (__ldg), for any
// heap depth (nothing is staged in shared memory, so deep heaps need no
// second path).  A K1-K3 CTA covers the fixed row block
// [blockIdx.x * block_obs, (blockIdx.x + 1) * block_obs) and runs a pair
// per thread, block_obs consecutive rows of ONE tree per warp-run, so a
// warp's top-level node loads hit the same address.  Each pair writes its
// masked leaf to shared memory; after a barrier one thread per row folds
// the chunk's block_trees values in tree order into the row's output, so
// sums are deterministic (no float atomics) and votes are exact.  A K4 CTA
// covers block_obs rows of block_trees trees, a row per thread, one tree
// after another, so each store of a warp is one contiguous run of a row
// of the output.
// Making them fast (shared-memory staging of chunks, more CTAs per row
// block at small N) is later work; this version is the right one.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// K1 node source: code = (feature * TB + threshold) * 2 + is_internal as
// an exact float32 integer below 2**24.
struct PackedNodes {
  const float* __restrict__ code;
  const float* __restrict__ fit;
  int64_t h;
  int tb2;

  __device__ __forceinline__ bool node(int64_t base, int64_t idx, int& feat,
                                       int& thr) const {
    if (idx >= h) {  // past the heap: the TPU kernel reads a zero word
      feat = 0;
      thr = 0;
      return false;
    }
    const int c = static_cast<int>(__ldg(code + base + idx));
    int q = c / tb2;
    if (c % tb2 != 0 && c < 0) --q;  // floor, as the reference's decode
    const int rem = c - q * tb2;     // in [0, tb2)
    feat = q;
    thr = rem >> 1;
    return (rem & 1) != 0;
  }

  __device__ __forceinline__ float leaf(int64_t base, int64_t idx) const {
    return idx < h ? __ldg(fit + base + idx) : 0.0f;
  }
};

// K2 node source: separate int32 feature / threshold, bool is_internal.
struct SimpleNodes {
  const int* __restrict__ feature;
  const int* __restrict__ threshold;
  const float* __restrict__ fit;
  const unsigned char* __restrict__ is_internal;
  int64_t h;

  __device__ __forceinline__ bool node(int64_t base, int64_t idx, int& feat,
                                       int& thr) const {
    if (idx >= h) {
      feat = 0;
      thr = 0;
      return false;
    }
    feat = __ldg(feature + base + idx);
    thr = __ldg(threshold + base + idx);
    return __ldg(is_internal + base + idx) != 0;
  }

  __device__ __forceinline__ float leaf(int64_t base, int64_t idx) const {
    return idx < h ? __ldg(fit + base + idx) : 0.0f;
  }
};

// The leaf one (tree, row) pair reaches: `max_depth` levels from the root.
template <class Nodes>
__device__ __forceinline__ float walk(const Nodes& nodes, int64_t base,
                                      const int* __restrict__ x, int d,
                                      int max_depth) {
  int64_t idx = 0;
  for (int level = 0; level < max_depth; ++level) {
    int feat, thr;
    if (!nodes.node(base, idx, feat, thr)) break;  // leaf: stays put
    feat = min(max(feat, 0), d - 1);
    idx = (__ldg(x + feat) <= thr) ? 2 * idx + 1 : 2 * idx + 2;
  }
  return nodes.leaf(base, idx);
}

// One CTA per row block.  chunk_lo == nullptr means every chunk
// [0, n_chunks).  n_trees masks tree ids past the real trees (K2, K3); K1
// passes T_pad, whose padding trees carry segment -1.  kSegmented = false
// (K3) compiles the segment test out; obs_seg / tree_seg are then unread.
template <class Nodes, bool kSegmented>
__global__ void seg_agg_kernel(Nodes nodes, const int* __restrict__ xb,
                               const int* __restrict__ obs_seg,
                               const int* __restrict__ tree_seg,
                               const int* __restrict__ chunk_lo,
                               const int* __restrict__ chunk_hi,
                               float* __restrict__ out, int n, int d,
                               int n_trees, int n_chunks, int max_depth,
                               int n_classes, int block_trees,
                               int block_obs) {
  extern __shared__ float slot[];  // [block_trees][block_obs]
  int* slot_cls = reinterpret_cast<int*>(slot);
  const int blk = blockIdx.x;
  const int row0 = blk * block_obs;
  int lo = 0;
  int hi = n_chunks;
  if (chunk_lo != nullptr) {
    lo = chunk_lo[blk];
    hi = chunk_hi[blk];
  }
  const int pairs = block_trees * block_obs;
  for (int ci = lo; ci < hi; ++ci) {
    for (int p = threadIdx.x; p < pairs; p += blockDim.x) {
      const int t = p / block_obs;
      const int r = p - t * block_obs;
      const int row = row0 + r;
      const int tree = ci * block_trees + t;
      float v = 0.0f;
      int cls = -1;
      if (row < n && tree < n_trees &&
          (!kSegmented || tree_seg[tree] == obs_seg[row])) {
        v = walk(nodes, static_cast<int64_t>(tree) * nodes.h,
                 xb + static_cast<int64_t>(row) * d, d, max_depth);
        cls = __float2int_rz(v);  // astype(int32): truncate toward zero
      }
      if (n_classes > 0) {
        slot_cls[p] = cls;
      } else {
        slot[p] = v;
      }
    }
    __syncthreads();
    for (int r = threadIdx.x; r < block_obs; r += blockDim.x) {
      const int row = row0 + r;
      if (row >= n) continue;
      if (n_classes > 0) {
        float* o = out + static_cast<int64_t>(row) * n_classes;
        for (int t = 0; t < block_trees; ++t) {
          const int c = slot_cls[t * block_obs + r];
          if (c >= 0 && c < n_classes) o[c] += 1.0f;  // one-hot: else none
        }
      } else {
        float s = 0.0f;
        for (int t = 0; t < block_trees; ++t) s += slot[t * block_obs + r];
        out[row] += s;
      }
    }
    __syncthreads();
  }
}

constexpr int kMaxThreads = 1024;
constexpr int kDefaultSmem = 48 * 1024;

// K4: a CTA covers block_obs rows of the tree blocks blockIdx.y,
// blockIdx.y + gridDim.y, ... (gridDim.y is capped at 65,535).
__global__ void per_tree_kernel(SimpleNodes nodes, const int* __restrict__ xb,
                                float* __restrict__ out, int n, int d,
                                int n_trees, int max_depth, int block_trees,
                                int block_obs) {
  const int n_tree_blocks = (n_trees + block_trees - 1) / block_trees;
  const int row0 = blockIdx.x * block_obs;
  for (int r = threadIdx.x; r < block_obs; r += blockDim.x) {
    const int row = row0 + r;
    if (row >= n) break;
    const int* x = xb + static_cast<int64_t>(row) * d;
    for (int tb = blockIdx.y; tb < n_tree_blocks; tb += gridDim.y) {
      const int t_end = min(n_trees, (tb + 1) * block_trees);
      for (int tree = tb * block_trees; tree < t_end; ++tree) {
        out[static_cast<int64_t>(tree) * n + row] =
            walk(nodes, static_cast<int64_t>(tree) * nodes.h, x, d,
                 max_depth);
      }
    }
  }
}

template <class Nodes, bool kSegmented>
int launch(Nodes nodes, const int* xb, const int* obs_seg,
           const int* tree_seg, const int* chunk_lo, const int* chunk_hi,
           float* out, int n, int d, int n_trees, int n_chunks,
           int max_depth, int n_classes, int block_trees, int block_obs,
           cudaStream_t stream) {
  const int pairs = block_trees * block_obs;
  int threads = ((pairs + 31) / 32) * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  const size_t smem = static_cast<size_t>(pairs) * sizeof(float);
  if (smem > kDefaultSmem) {
    cudaError_t e = cudaFuncSetAttribute(
        seg_agg_kernel<Nodes, kSegmented>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int grid = (n + block_obs - 1) / block_obs;
  seg_agg_kernel<Nodes, kSegmented><<<grid, threads, smem, stream>>>(
      nodes, xb, obs_seg, tree_seg, chunk_lo, chunk_hi, out, n, d, n_trees,
      n_chunks, max_depth, n_classes, block_trees, block_obs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// K1.  code / fit (t_pad, h) f32; tree_seg (t_pad,) i32 with -1 padding;
// chunk_lo / chunk_hi (ceil(n / block_obs),) i32; out zeroed (n, C) or (n,).
int tp_seg_packed(const int* xb, const int* obs_seg, const float* code,
                  const float* fit, const int* tree_seg, const int* chunk_lo,
                  const int* chunk_hi, float* out, int n, int d, int t_pad,
                  int h, int max_depth, int tb2, int n_classes,
                  int block_trees, int block_obs, void* stream) {
  PackedNodes nodes{code, fit, static_cast<int64_t>(h), tb2};
  return launch<PackedNodes, true>(
      nodes, xb, obs_seg, tree_seg, chunk_lo, chunk_hi, out, n, d, t_pad,
      t_pad / block_trees, max_depth, n_classes, block_trees, block_obs,
      static_cast<cudaStream_t>(stream));
}

// K2.  feature / threshold (t, h) i32, fit (t, h) f32, is_internal (t, h)
// bool bytes; tree_seg (t,) i32; out zeroed (n, C) or (n,).
int tp_seg_simple(const int* xb, const int* obs_seg, const int* tree_seg,
                  const int* feature, const int* threshold, const float* fit,
                  const unsigned char* is_internal, float* out, int n, int d,
                  int t, int h, int max_depth, int n_classes,
                  int block_trees, int block_obs, void* stream) {
  SimpleNodes nodes{feature, threshold, fit, is_internal,
                    static_cast<int64_t>(h)};
  return launch<SimpleNodes, true>(
      nodes, xb, obs_seg, tree_seg, nullptr, nullptr, out, n, d, t,
      (t + block_trees - 1) / block_trees, max_depth, n_classes,
      block_trees, block_obs, static_cast<cudaStream_t>(stream));
}

// K3.  feature / threshold (t, h) i32, fit (t, h) f32, is_internal (t, h)
// bool bytes; out zeroed (n, C) or (n,).
int tp_agg(const int* xb, const int* feature, const int* threshold,
           const float* fit, const unsigned char* is_internal, float* out,
           int n, int d, int t, int h, int max_depth, int n_classes,
           int block_trees, int block_obs, void* stream) {
  SimpleNodes nodes{feature, threshold, fit, is_internal,
                    static_cast<int64_t>(h)};
  return launch<SimpleNodes, false>(
      nodes, xb, nullptr, nullptr, nullptr, nullptr, out, n, d, t,
      (t + block_trees - 1) / block_trees, max_depth, n_classes,
      block_trees, block_obs, static_cast<cudaStream_t>(stream));
}

// K4.  The same tables; out (t, n) f32, every element written.
int tp_per_tree(const int* xb, const int* feature, const int* threshold,
                const float* fit, const unsigned char* is_internal,
                float* out, int n, int d, int t, int h, int max_depth,
                int block_trees, int block_obs, void* stream) {
  SimpleNodes nodes{feature, threshold, fit, is_internal,
                    static_cast<int64_t>(h)};
  const int threads = block_obs < kMaxThreads ? block_obs : kMaxThreads;
  const int n_tree_blocks = (t + block_trees - 1) / block_trees;
  const dim3 grid((n + block_obs - 1) / block_obs,
                  n_tree_blocks < 65535 ? n_tree_blocks : 65535);
  per_tree_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      nodes, xb, out, n, d, t, max_depth, block_trees, block_obs);
  return static_cast<int>(cudaGetLastError());
}

const char* tp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
