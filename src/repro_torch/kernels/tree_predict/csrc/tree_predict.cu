// Tree-predict kernels for Hopper (sm_90a), with a plain C interface for
// ctypes.  K1 and K2 share the segmented kernel (seg_kernel); K3 and K4
// share the whole-forest kernel (forest_kernel):
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
//     per row the vote counts (N, C) or the fit sum (N,) over every tree.
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
// K1 and K2 (seg_kernel), what bounds them: the same dependent chain of
// loads a level, over far less work per launch (a 1,024-row batch of 100
// trees, or K2's 32-tree chunk), so the launch and one walk's latency
// set their time unless the walks are spread over the card; at 65,536
// rows the deep levels' divergent word gathers (up to 32 sectors a warp
// load) bound them through L1.  What the design does about it:
//  - a CTA holds `rows` rows of one row block (the fewest of 8 ... 128
//    whose grid fits the resident CTAs, seg_config) and walks 256 / rows
//    slices of the block's chunk range at once: a slice is a chunk (up to
//    8 trees) or 8 trees of a larger chunk, and a thread walks one
//    slice's trees for one row, all 8 in flight;
//  - every walk takes min(max_depth, bit_length(h)) levels with no branch:
//    the word loads, then the x loads (x staged in shared memory, odd row
//    stride), then the steps idx = internal ? child : idx; past the heap a
//    select reads the zero word; K1 decodes by shift and mask where tb2 is
//    a power of two (a second instantiation divides);
//  - per window of 256 slices the CTA keeps, in order, those with a tree
//    whose segment lies in its rows' segment range (K2 walks every chunk,
//    most of which meet none of a sorted tile's rows), and a warp skips a
//    slice none of whose pairs count;
//  - sums: a slice's thread adds its chunk's leaves in tree order (or
//    keeps the leaves of a larger chunk), the values go to shared memory,
//    and one thread per row adds them in (chunk, tree) order to its total
//    after a barrier a pass, so sums equal the plain version's bit for bit
//    (no float atomics); votes: integer counts in a shared table, or
//    integer atomics into the output and count_kernel past its budget;
//    each element of the output is written once.
//
// K3 and K4, what bounds them: a walk is a chain of dependent loads (the
// node decides which node comes next).  A warp runs 32 rows, which after
// the first levels sit on 32 different nodes, so each level is a
// divergent gather: through L2 (a depth-12 tree is 106 KB in three tables,
// a CTA's trees more than an SM's L1) up to four sectors of 32 B per walk
// and level for a few useful bytes, one chain a thread.  They are bound by
// load latency, instruction issue and sectors per gather, not by HBM
// bytes; K4's 4 T N output bytes bound it only at large N T.
//
// What the design does about it:
//  - a prologue (pack_kernel) completes each heap: a node below a leaf,
//    or below a child past the heap, copies that stop's fit, so every
//    walk takes the same D = min(max_depth, the heap's last level) levels
//    with no stop test and no bounds test, and its answer is the fit
//    where it ends.  It keeps only what a walk reads: one word per node
//    above level D (4 bytes: the clamped feature and the int16 threshold,
//    where d <= 2**15 and every |threshold| < 2**15; else 8 bytes) and
//    the fits of the 2**D nodes on level D;
//  - a CTA owns a group of trees and a range of rows, a fixed assignment
//    that gives each group CTAs in proportion to its trees and about fills
//    the resident CTAs once (forest_config: the SM count and the kernel's
//    occupancy).  It stages the words of its trees' top levels into shared
//    memory once, one cp.async.bulk per tree under one mbarrier, and walks
//    them against tiles of rows whose x it copies into shared memory by
//    cp.async, with an odd row stride (32 rows reading one feature spread
//    over the banks); the tile's bytes come out of the trees' budget.
//    Levels below the staged ones read one word per walk with __ldg;
//    where a tile of x does not fit (d in the thousands) x is read from
//    global memory;
//  - each thread walks its row against W = 8 trees at once (4 when 8
//    would leave more than a quarter of the group's slots idle): each
//    level issues the W word loads, then the W x loads, then the W
//    steps, with no branch;
//  - K4 stores each leaf at out[tree][row]: a warp's store is a contiguous
//    run of 32 rows of one output row;
//  - K3 keeps each row's result in registers for its whole group and
//    writes it once.  Votes for C <= 8 are 8-bit counts packed in one
//    64-bit register (C > 8: integer atomics per pair); sums run per chunk
//    of block_trees trees in tree order, the chunk sums added in chunk
//    order.  With one group the CTA writes the result; with several each
//    writes its chunk sums to a (n_chunks, N) scratch that fold_kernel adds
//    in chunk order (groups are then whole chunks), or adds its integer
//    counts atomically into the output, which count_kernel turns into
//    floats.  No float atomics.

#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>
#include <type_traits>

namespace {

constexpr int kMaxSmem = 232448;

// ---------------------------------------------------------------------------
// K3 and K4: the whole-forest kernel
// ---------------------------------------------------------------------------

// Node words of a completed heap (pack_kernel).  Narrow (4 B): threshold
// << 16 | feature, the feature clamped to [0, d - 1] < 2**15 and the
// threshold in int16.  Wide (8 B): feature, threshold.  Fits are a float32
// array beside the words.
struct NarrowForm {
  using Word = uint32_t;
  __device__ __forceinline__ static int feat(Word w) {
    return static_cast<int>(w & 0xFFFFu);
  }
  __device__ __forceinline__ static int thr(Word w) {
    return static_cast<int>(w) >> 16;  // arithmetic: sign-extends
  }
  __device__ __forceinline__ static Word make(int feat, int thr) {
    return (static_cast<uint32_t>(thr) << 16) | static_cast<uint32_t>(feat);
  }
};

struct WideForm {
  using Word = uint2;
  __device__ __forceinline__ static int feat(Word w) {
    return static_cast<int>(w.x);
  }
  __device__ __forceinline__ static int thr(Word w) {
    return static_cast<int>(w.y);
  }
  __device__ __forceinline__ static Word make(int feat, int thr) {
    return make_uint2(static_cast<uint32_t>(feat), static_cast<uint32_t>(thr));
  }
};

constexpr int kNarrow = 0;  // record forms
constexpr int kWide = 1;

// What a forest launch computes.
constexpr int kPerTree = 0;     // K4: every leaf
constexpr int kVotes = 1;       // K3, C <= kRegClasses: counts in registers
constexpr int kVoteAtomic = 2;  // K3, C > kRegClasses: integer atomics
constexpr int kSum = 3;         // K3, regression

constexpr int kRegClasses = 8;

// The configuration's constants (forest_config), settled on an H100
// (PERF.md, section 6).
constexpr int kThreads = 512;          // rows per tile, one per thread
constexpr int kTreeBytes = 96 * 1024;  // most shared memory for tree tops
constexpr int kXBytes = 136 * 1024;    // largest x tile kept in shared memory
constexpr int kMinGroup = 8;           // fewest trees a group stages
constexpr int kSumLevels = 8;          // K3's sums: one group if these fit

// The launch's configuration, in the order tp_forest_config reports it.
struct ForestCfg {
  int form;            // kNarrow / kWide
  int mode;            // kPerTree / kVotes / kVoteAtomic / kSum
  int walks;           // walks in flight per thread (4 or 8)
  int threads;         // rows per tile
  int depth;           // D: the levels every walk takes
  int levels;          // staged levels (<= D): words of levels < levels
  int staged;          // words staged per tree
  int group;           // trees per group
  int n_groups;
  int x_smem;          // 1: the tile's x in shared memory
  int dpad;            // row stride of the x tile (odd)
  int smem;            // dynamic shared memory bytes
  int resident;        // CTAs resident on the card
  int splits;          // row ranges of a full group
  int rows_per_split;  // rows of one such range (a multiple of 32)
  int splits_last;     // row ranges of the last group
  int rows_last;       // rows of one such range
  int grid;            // (n_groups - 1) * splits + splits_last CTAs
  int partials;        // 1: several groups reduce through a second pass
};
constexpr int kCfgInts = sizeof(ForestCfg) / sizeof(int);

int round_up(int a, int b) { return (a + b - 1) / b * b; }

int bit_length(int v) {
  int b = 0;
  while (v > 0) {
    ++b;
    v >>= 1;
  }
  return b;
}

// The levels every walk takes through the completed heap.
int walk_depth(int h, int max_depth) {
  const int last = bit_length(h) - 1;  // the heap's last level
  return max_depth < last ? max_depth : last;
}

// Per tree in the scratch: words of the 2**depth - 1 nodes above the last
// level walked, and fits of its 2**depth nodes, each padded to at least 4
// (16-byte copies).
int leaf_stride(int depth) { return depth < 2 ? 4 : 1 << depth; }

// Words staged per tree for `levels` <= depth staged levels: the top
// 2**levels - 1 nodes, as a power of two of at least 4 (at most the
// stride); and their shared bytes.
int staged_words(int levels) {
  return levels == 0 ? 0 : (levels < 2 ? 4 : 1 << levels);
}

int64_t tree_bytes(int levels, int word) {
  return static_cast<int64_t>(staged_words(levels)) * word;
}

// Tiling from the shapes alone (the plain twin is tree_predict.py's
// _forest_config).
int forest_tile(int t, int h, int d, int max_depth, int n_classes,
                int per_tree, int block_trees, int form, ForestCfg* c) {
  if (t < 1 || h < 1 || d < 1 || max_depth < 0 || block_trees < 1 ||
      (form != kNarrow && form != kWide))
    return static_cast<int>(cudaErrorInvalidValue);
  c->form = form;
  c->mode = per_tree ? kPerTree
                     : (n_classes == 0 ? kSum
                                       : (n_classes <= kRegClasses
                                              ? kVotes
                                              : kVoteAtomic));
  c->threads = kThreads;
  c->depth = walk_depth(h, max_depth);
  const int word = form == kNarrow ? 4 : 8;
  c->dpad = d | 1;
  // the x tile, when it fits, comes out of the trees' budget
  const int64_t tile = static_cast<int64_t>(c->threads) * c->dpad * 4;
  c->x_smem = tile <= kXBytes;
  const int64_t x_bytes = c->x_smem ? round_up(static_cast<int>(tile), 16) : 0;
  const int64_t room = kMaxSmem - 16 - x_bytes;
  const int budget = room < kTreeBytes ? static_cast<int>(room) : kTreeBytes;
  // votes add up in any order: only sums need groups of whole chunks
  const int unit = c->mode == kSum ? block_trees : 1;
  const int t_units = round_up(t, unit);
  const int g_min = t_units < round_up(kMinGroup, unit)
                        ? t_units
                        : round_up(kMinGroup, unit);
  // the words of the levels walked, not the leaf fits: they would halve
  // the trees a group stages, for one read a walk
  int levels = c->depth;
  // K3's sums run in groups of whole chunks, which leave a small last
  // group whose CTAs walk many rows for few trees: one group of every
  // tree, when their top kSumLevels levels fit, beats deeper staging
  const int floor_levels = levels < kSumLevels ? levels : kSumLevels;
  const bool one_group =
      c->mode == kSum && t * tree_bytes(floor_levels, word) <= budget;
  const int64_t need = one_group ? t : g_min;
  while (levels > 0 && need * tree_bytes(levels, word) > budget)
    --levels;
  c->levels = levels;
  c->staged = staged_words(levels);
  const int64_t per_tree_bytes = tree_bytes(levels, word);
  int g_max = per_tree_bytes
                  ? static_cast<int>(budget / per_tree_bytes) / unit * unit
                  : t;
  if (g_max < unit) g_max = unit;
  if (g_max >= t) {  // one group (nothing staged: every tree in it)
    c->group = t;
    c->n_groups = 1;
  } else {
    const int n_groups = (t + g_max - 1) / g_max;
    c->group = round_up((t + n_groups - 1) / n_groups, unit);
    c->n_groups = (t + c->group - 1) / c->group;
  }
  // 8 walks in flight, unless they leave more than a quarter of a group's
  // walk slots empty
  const int slots = round_up(c->group, 8);
  c->walks = 4 * (slots - c->group) > slots ? 4 : 8;
  c->partials = !per_tree && c->n_groups > 1;
  const int64_t smem = 16 + c->group * per_tree_bytes + x_bytes;
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  c->smem = static_cast<int>(smem);
  return 0;
}

// Row ranges of `trees` trees when `resident` CTAs share t trees by tree
// count: (splits, rows per split), rows a multiple of 32.
void row_ranges(int n, int t, int trees, int resident, int* splits,
                int* rows) {
  int64_t want = static_cast<int64_t>(resident) * trees / t;
  if (want < 1) want = 1;
  *rows = round_up(static_cast<int>((n + want - 1) / want), 32);
  *splits = (n + *rows - 1) / *rows;
}

// Work partition: each group's rows cut into ranges, as many as its share
// of the trees gives it of the resident CTAs (a last group of fewer trees
// gets fewer, longer ranges), so the grid about fills the card once.
void forest_grid(int n, int t, int resident, ForestCfg* c) {
  c->resident = resident;
  row_ranges(n, t, c->group, resident, &c->splits, &c->rows_per_split);
  row_ranges(n, t, t - (c->n_groups - 1) * c->group, resident,
             &c->splits_last, &c->rows_last);
  c->grid = (c->n_groups - 1) * c->splits + c->splits_last;
}

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

// Wait for the barrier's phase of this parity.  Copies that never land
// trap, as a launch error, instead of hanging the card.
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

// `bytes` (a multiple of 16, both addresses 16-byte aligned) from global
// to shared memory, completing on bar.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// Shapes of one forest launch: lh = the heap's levels (bit_length(h)),
// depth = walk_depth(h, max_depth), ws = leaf_stride(depth).
struct ForestShape {
  int n, d, t, h, lh, depth, ws, max_depth, n_classes, block_trees;
};

// The shallowest strict ancestor of node j where a walk stops (a leaf, or
// a node past the heap), or -1.  Deepest first, with no early exit, so
// the ancestors' loads issue together.
__device__ __forceinline__ int stop_above(
    const unsigned char* __restrict__ is_internal, int64_t base, int h,
    int j) {
  const int lj = 31 - __clz(j + 1);  // j's level
  int stop = -1;
#pragma unroll 4
  for (int m = 1; m <= lj; ++m) {
    const int a = ((j + 1) >> m) - 1;
    if (a >= h || !__ldg(is_internal + base + min(a, h - 1))) stop = a;
  }
  return stop;
}

// The prologue: the completed heap's words of the nodes above level
// `depth` and fits of the nodes on it, (t, ws) each, from the four (t, h)
// tables.  A node below a leaf, or below a child past the heap, copies
// that stop (word 0, the stop's fit; fit 0 past the heap), so a walk that
// stopped there keeps its answer through any later levels: every walk
// takes `depth` uniform levels and its answer is the fit where it ends.
// When max_depth reaches past the heap, an internal node of the heap's
// last level has fit 0 (its walks leave the heap).
template <class F>
__global__ void pack_kernel(const int* __restrict__ feature,
                            const int* __restrict__ threshold,
                            const float* __restrict__ fit,
                            const unsigned char* __restrict__ is_internal,
                            typename F::Word* __restrict__ words,
                            float* __restrict__ fits, ForestShape s) {
  const int64_t total = static_cast<int64_t>(s.t) * s.ws;
  const int first_leaf = (1 << s.depth) - 1;
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                   threadIdx.x;
       i < total; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t tree = i / s.ws;
    const int j = static_cast<int>(i - tree * s.ws);
    const int64_t base = tree * s.h;
    typename F::Word w = F::make(0, 0);
    if (j < first_leaf && j < s.h && stop_above(is_internal, base, s.h, j) < 0)
      w = F::make(min(max(__ldg(feature + base + j), 0), s.d - 1),
                  __ldg(threshold + base + j));
    words[i] = w;
    float f = 0.0f;
    const int leaf = first_leaf + j;
    if (j <= first_leaf) {  // the 2**depth nodes of level depth
      const int stop = stop_above(is_internal, base, s.h, leaf);
      if (stop >= 0) {
        if (stop < s.h) f = __ldg(fit + base + stop);
      } else if (leaf < s.h) {
        const bool cut = s.depth == s.lh - 1 && s.max_depth >= s.lh &&
                         __ldg(is_internal + base + leaf);
        f = cut ? 0.0f : __ldg(fit + base + leaf);
      }
    }
    fits[i] = f;
  }
}

// A 4-byte shared-memory load at a 32-bit shared address: one address
// instruction per x load, where indexing the row's pointer took two.
// Volatile, so it is never moved above the barrier that publishes the
// tile.
__device__ __forceinline__ int lds_int(uint32_t addr) {
  int v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}

// One level of W walks: every walk reads its node's word (through
// `load`), then its row's x at the node's feature, then steps to the child
// that picks.  No walk stops: past a leaf it walks the leaf's copies.
template <class F, bool kXSmem, int W, class Load>
__device__ __forceinline__ void level(int (&idx)[W], Load load, const int* xr,
                                      const int* __restrict__ xg) {
  typename F::Word w[W];
#pragma unroll
  for (int k = 0; k < W; ++k) w[k] = load(k, idx[k]);
  int xv[W];
#pragma unroll
  for (int k = 0; k < W; ++k)
    xv[k] = kXSmem ? lds_int(smem_u32(xr) + 4 * F::feat(w[k]))
                   : __ldg(xg + F::feat(w[k]));
#pragma unroll
  for (int k = 0; k < W; ++k)
    idx[k] = 2 * idx[k] + (xv[k] <= F::thr(w[k]) ? 1 : 2);
}

// One row tile's x, rows [r0, r0 + rows), into `xs` (row stride dpad):
// 4-byte cp.async copies, all in flight at once, one commit group per
// tile.
__device__ __forceinline__ void load_x_tile(int* xs,
                                            const int* __restrict__ xb,
                                            int r0, int rows, int d,
                                            int dpad) {
  const int* src = xb + static_cast<int64_t>(r0) * d;
  const int total = rows * d;
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    const int r = e / d;
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                     smem_u32(xs + r * dpad + (e - r * d))),
                 "l"(reinterpret_cast<uint64_t>(src + e))
                 : "memory");
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// One row against the CTA's trees [t0, t0 + nt), W at a time: K4 stores
// each leaf; K3 adds its votes or its chunk sums, then writes the row's
// result (or its partials) once.
template <class F, int kMode, bool kXSmem, int W>
__device__ __forceinline__ void walk_row(
    const typename F::Word* sw,
    const typename F::Word* __restrict__ words,
    const float* __restrict__ fits, const int* xr,
    const int* __restrict__ xg, float* __restrict__ out,
    float* __restrict__ partial, const ForestShape& s, const ForestCfg& c,
    int t0, int nt, int row) {
  const int first_leaf = (1 << s.depth) - 1;
  float total = 0.0f;  // kSum: chunk sums added in chunk order
  float chunk = 0.0f;  // kSum: the open chunk's leaves in tree order
  int votes[kRegClasses];  // kVotes: the row's counts
#pragma unroll
  for (int k = 0; k < kRegClasses; ++k) votes[k] = 0;
  // kVotes: 8-bit counts of class k at bits 8k, added into votes every
  // 128 trees (W divides 128)
  uint64_t packed = 0;
  auto unpack = [&]() {
#pragma unroll
    for (int k = 0; k < kRegClasses; ++k)
      votes[k] += static_cast<int>((packed >> (8 * k)) & 0xFFu);
    packed = 0;
  };

  for (int tt = 0; tt < nt; tt += W) {
    // walk k takes tree tt + k; past the group's last tree it repeats that
    // tree and its leaf is dropped
    int local[W];
    int idx[W];
#pragma unroll
    for (int k = 0; k < W; ++k) {
      local[k] = min(tt + k, nt - 1);
      idx[k] = 0;
    }
    const typename F::Word* tops[W];  // each walk's staged tree
#pragma unroll
    for (int k = 0; k < W; ++k) tops[k] = sw + local[k] * c.staged;
    int lv = 0;
    for (; lv < c.levels; ++lv)  // from the staged tops
      level<F, kXSmem>(
          idx, [&](int k, int i) { return tops[k][i]; }, xr, xg);
    for (; lv < s.depth; ++lv)
      level<F, kXSmem>(
          idx,
          [&](int k, int i) {
            return __ldg(words + static_cast<int64_t>(t0 + local[k]) * s.ws +
                         i);
          },
          xr, xg);
    float leaves[W];
#pragma unroll
    for (int k = 0; k < W; ++k) {
      const int leaf = idx[k] - first_leaf;
      leaves[k] =
          __ldg(fits + static_cast<int64_t>(t0 + local[k]) * s.ws + leaf);
    }
    // the leaves, in tree order
#pragma unroll
    for (int k = 0; k < W; ++k) {
      if (tt + k >= nt) break;
      const int tree = t0 + tt + k;
      const float leaf = leaves[k];
      if (kMode == kPerTree) {
        out[static_cast<int64_t>(tree) * s.n + row] = leaf;
      } else if (kMode == kSum) {
        if (tree % s.block_trees == 0 && tree != t0) {
          if (c.partials)
            partial[static_cast<int64_t>(tree / s.block_trees - 1) * s.n +
                    row] = chunk;
          else
            total += chunk;
          chunk = 0.0f;
        }
        chunk += leaf;
      } else {
        const int cls = __float2int_rz(leaf);  // astype(int32)
        if (cls >= 0 && cls < s.n_classes) {
          if (kMode == kVotes)
            packed += uint64_t{1} << (8 * cls);
          else
            atomicAdd(reinterpret_cast<int*>(out) +
                          static_cast<int64_t>(row) * s.n_classes + cls,
                      1);
        }
      }
    }
    if (kMode == kVotes && ((tt + W) & 127) == 0) unpack();
  }
  if (kMode == kVotes) unpack();
  if (kMode == kSum) {
    const int last = t0 + nt - 1;
    if (c.partials)
      partial[static_cast<int64_t>(last / s.block_trees) * s.n + row] =
          chunk;
    else
      out[row] = total + chunk;
  } else if (kMode == kVotes) {
    float* o = out + static_cast<int64_t>(row) * s.n_classes;
#pragma unroll
    for (int v = 0; v < kRegClasses; ++v) {
      if (v >= s.n_classes) break;
      if (!c.partials)
        o[v] = static_cast<float>(votes[v]);
      else if (votes[v])
        atomicAdd(reinterpret_cast<int*>(o) + v, votes[v]);
    }
  }
}

// One CTA: the trees of one group against one range of rows (forest_grid),
// a row per thread, W trees at a time.
template <class F, int kMode, bool kXSmem, int W>
__global__ void __launch_bounds__(kThreads)
    forest_kernel(const typename F::Word* __restrict__ words,
                  const float* __restrict__ fits,
                  const int* __restrict__ xb, float* __restrict__ out,
                  float* __restrict__ partial, ForestShape s, ForestCfg c) {
  using Word = typename F::Word;
  extern __shared__ __align__(16) unsigned char smem[];
  Word* sw = reinterpret_cast<Word*>(smem + 16);
  int* xs = reinterpret_cast<int*>(sw + c.group * c.staged);
  const uint32_t bar = smem_u32(smem);
  // CTAs [0, (n_groups - 1) * splits) take the full groups, the rest the
  // last group
  const int full = (c.n_groups - 1) * c.splits;
  const bool last = static_cast<int>(blockIdx.x) >= full;
  const int g = last ? c.n_groups - 1 : blockIdx.x / c.splits;
  const int split = last ? blockIdx.x - full : blockIdx.x % c.splits;
  const int rows_per = last ? c.rows_last : c.rows_per_split;
  const int t0 = g * c.group;
  const int nt = min(c.group, s.t - t0);
  const int row_lo = split * rows_per;
  const int row_hi = min(s.n, row_lo + rows_per);

  if (threadIdx.x == 0 && c.staged > 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    const uint32_t wbytes = c.staged * sizeof(Word);
    mbar_expect_tx(bar, wbytes * nt);
    for (int i = 0; i < nt; ++i)
      bulk_load(smem_u32(sw + i * c.staged),
                words + static_cast<int64_t>(t0 + i) * s.ws, wbytes, bar);
  }
  __syncthreads();  // the barrier is initialised before anyone waits on it
  bool staged = c.staged == 0;
  if (kXSmem)
    load_x_tile(xs, xb, row_lo, min(c.threads, row_hi - row_lo), s.d,
                c.dpad);

  for (int r0 = row_lo; r0 < row_hi; r0 += c.threads) {
    const int rows = min(c.threads, row_hi - r0);
    const int next = r0 + c.threads;
    if (kXSmem) {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      __syncthreads();  // every thread's copies of this tile have landed
    }
    if (!staged) {
      mbar_wait(bar, 0);
      staged = true;
    }
    if (static_cast<int>(threadIdx.x) < rows) {
      const int row = r0 + threadIdx.x;
      walk_row<F, kMode, kXSmem, W>(sw, words, fits,
                                 xs + threadIdx.x * c.dpad,
                                 xb + static_cast<int64_t>(row) * s.d, out,
                                 partial, s, c, t0, nt, row);
    }
    // the next tile overwrites this one once its walks are done
    if (kXSmem && next < row_hi) {
      __syncthreads();
      load_x_tile(xs, xb, next, min(c.threads, row_hi - next), s.d, c.dpad);
    }
  }
}

// Several groups, regression: out[row] = the chunk sums in chunk order.
__global__ void fold_kernel(const float* __restrict__ partial,
                            float* __restrict__ out, int n, int n_chunks) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n) return;
  float total = 0.0f;
  for (int k = 0; k < n_chunks; ++k)
    total += partial[static_cast<int64_t>(k) * n + row];
  out[row] = total;
}

// Integer vote counts, added atomically in place, to float32.
__global__ void count_kernel(float* __restrict__ out, int64_t size) {
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                   threadIdx.x;
       i < size; i += static_cast<int64_t>(gridDim.x) * blockDim.x)
    out[i] = static_cast<float>(reinterpret_cast<const int*>(out)[i]);
}

template <class F, int kMode, bool kXSmem, int W>
int forest_occupancy(const ForestCfg& c, int* per_sm) {
  cudaError_t e = cudaFuncSetAttribute(
      forest_kernel<F, kMode, kXSmem, W>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, c.smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, forest_kernel<F, kMode, kXSmem, W>, c.threads, c.smem));
}

template <class F, int kMode, bool kXSmem>
int forest_occupancy_w(const ForestCfg& c, int* per_sm) {
  return c.walks == 4 ? forest_occupancy<F, kMode, kXSmem, 4>(c, per_sm)
                      : forest_occupancy<F, kMode, kXSmem, 8>(c, per_sm);
}

template <class F, int kMode>
int forest_occupancy_x(const ForestCfg& c, int* per_sm) {
  return c.x_smem ? forest_occupancy_w<F, kMode, true>(c, per_sm)
                  : forest_occupancy_w<F, kMode, false>(c, per_sm);
}

template <class F>
int forest_occupancy_form(const ForestCfg& c, int* per_sm) {
  switch (c.mode) {
    case kPerTree:
      return forest_occupancy_x<F, kPerTree>(c, per_sm);
    case kVotes:
      return forest_occupancy_x<F, kVotes>(c, per_sm);
    case kVoteAtomic:
      return forest_occupancy_x<F, kVoteAtomic>(c, per_sm);
    default:
      return forest_occupancy_x<F, kSum>(c, per_sm);
  }
}

// The full configuration on the current device: tiling, then the grid
// from the SM count and the kernel's occupancy at that tiling.
int forest_config(int t, int h, int n, int d, int max_depth, int n_classes,
                  int per_tree, int block_trees, int form, ForestCfg* c) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  int err = forest_tile(t, h, d, max_depth, n_classes, per_tree, block_trees,
                        form, c);
  if (err) return err;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  err = form == kNarrow ? forest_occupancy_form<NarrowForm>(*c, &per_sm)
                        : forest_occupancy_form<WideForm>(*c, &per_sm);
  if (err) return err;
  forest_grid(n, t, sms * (per_sm > 0 ? per_sm : 1), c);
  return 0;
}

template <class F, int kMode, bool kXSmem>
int forest_main_w(const typename F::Word* words, const float* fits,
                  const int* xb, float* out, float* partial,
                  const ForestShape& s, const ForestCfg& c, cudaStream_t st) {
  if (c.walks == 4)
    forest_kernel<F, kMode, kXSmem, 4><<<c.grid, c.threads, c.smem, st>>>(
        words, fits, xb, out, partial, s, c);
  else
    forest_kernel<F, kMode, kXSmem, 8><<<c.grid, c.threads, c.smem, st>>>(
        words, fits, xb, out, partial, s, c);
  return static_cast<int>(cudaGetLastError());
}

template <class F, int kMode>
int forest_main(const typename F::Word* words, const float* fits,
                const int* xb, float* out, float* partial,
                const ForestShape& s, const ForestCfg& c, cudaStream_t st) {
  return c.x_smem ? forest_main_w<F, kMode, true>(words, fits, xb, out,
                                                  partial, s, c, st)
                  : forest_main_w<F, kMode, false>(words, fits, xb, out,
                                                   partial, s, c, st);
}

template <class F>
int forest_launch_form(const int* xb, const int* feature,
                       const int* threshold, const float* fit,
                       const unsigned char* is_internal, void* records,
                       float* partial, float* out, const ForestShape& s,
                       const ForestCfg& c, cudaStream_t st) {
  using Word = typename F::Word;
  const int64_t total = static_cast<int64_t>(s.t) * s.ws;
  Word* words = static_cast<Word*>(records);
  float* fits = reinterpret_cast<float*>(words + total);
  const int64_t blocks = (total + 255) / 256;
  pack_kernel<F><<<static_cast<int>(blocks < 4096 ? blocks : 4096), 256, 0,
                   st>>>(feature, threshold, fit, is_internal, words, fits,
                         s);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  switch (c.mode) {
    case kPerTree:
      return forest_main<F, kPerTree>(words, fits, xb, out, partial, s, c,
                                      st);
    case kVotes:
      err = forest_main<F, kVotes>(words, fits, xb, out, partial, s, c, st);
      break;
    case kVoteAtomic:
      err = forest_main<F, kVoteAtomic>(words, fits, xb, out, partial, s, c,
                                        st);
      break;
    default:
      err = forest_main<F, kSum>(words, fits, xb, out, partial, s, c, st);
      if (err || !c.partials) return err;
      fold_kernel<<<(s.n + 255) / 256, 256, 0, st>>>(
          partial, out, s.n, (s.t + s.block_trees - 1) / s.block_trees);
      return static_cast<int>(cudaGetLastError());
  }
  if (err || (c.mode == kVotes && !c.partials)) return err;
  const int64_t size = static_cast<int64_t>(s.n) * s.n_classes;
  const int64_t cblocks = (size + 255) / 256;
  count_kernel<<<static_cast<int>(cblocks < 4096 ? cblocks : 4096), 256, 0,
                 st>>>(out, size);
  return static_cast<int>(cudaGetLastError());
}

int forest_launch(const int* xb, const int* feature, const int* threshold,
                  const float* fit, const unsigned char* is_internal,
                  void* records, float* partial, float* out, int n, int d,
                  int t, int h, int max_depth, int n_classes, int per_tree,
                  int block_trees, int form, void* stream) {
  ForestCfg c;
  int err = forest_config(t, h, n, d, max_depth, n_classes, per_tree,
                          block_trees, form, &c);
  if (err) return err;
  const ForestShape s{n,         d,
                      t,         h,
                      bit_length(h), c.depth,
                      leaf_stride(c.depth), max_depth,
                      n_classes, block_trees};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (form == kNarrow)
    return forest_launch_form<NarrowForm>(xb, feature, threshold, fit,
                                          is_internal, records, partial, out,
                                          s, c, st);
  return forest_launch_form<WideForm>(xb, feature, threshold, fit,
                                      is_internal, records, partial, out, s,
                                      c, st);
}

// ---------------------------------------------------------------------------
// K1 and K2: the segmented kernel
// ---------------------------------------------------------------------------

// K1's nodes: the fused code word (feature * TB + threshold) * 2 +
// is_internal, an exact float32 integer below 2**24.  kPow2 (tb2 a power
// of two, as on every serving path: fused_threshold_base rounds TB up)
// decodes by shift and mask, the arithmetic shift flooring negative words
// too; any other tb2 by floor division, as the reference's decode.  A
// walk loads its node's word unconditionally (at an index clamped into
// the heap) and selects the zero word where the load does not count, so
// a level's loads carry no branch and issue together.
template <bool kPow2>
struct PackedNodes {
  using Raw = float;
  const float* __restrict__ code;
  const float* __restrict__ fit;
  int h;
  int tb2;
  int shift;  // log2(tb2) when kPow2

  __device__ __forceinline__ Raw load(int base, int at) const {
    return __ldg(code + base + at);
  }

  // The word where `on` (a valid walk inside the heap), else the zero
  // word: feature 0, threshold 0, not internal.
  __device__ __forceinline__ void decode(Raw w, bool on, int& feat, int& thr,
                                         bool& in) const {
    const int c = on ? static_cast<int>(w) : 0;
    int rem;
    if (kPow2) {
      feat = c >> shift;
      rem = c & (tb2 - 1);
    } else {
      int q = c / tb2;
      if (c % tb2 != 0 && c < 0) --q;  // floor
      feat = q;
      rem = c - q * tb2;
    }
    thr = rem >> 1;
    in = (rem & 1) != 0;
  }

  __device__ __forceinline__ float leaf(int base, int at) const {
    return __ldg(fit + base + at);
  }

  // One load a level: staging the trees' top levels saved no time, at 8
  // rows a CTA or at 128 (PERF.md, section 6).
  static constexpr bool kStaged = false;
};

// K2's nodes: separate int32 feature / threshold, bool is_internal.
struct SimpleNodes {
  struct Raw {
    int feat, thr;
    unsigned char in;
  };
  const int* __restrict__ feature;
  const int* __restrict__ threshold;
  const float* __restrict__ fit;
  const unsigned char* __restrict__ is_internal;
  int h;

  __device__ __forceinline__ Raw load(int base, int at) const {
    return Raw{__ldg(feature + base + at), __ldg(threshold + base + at),
               __ldg(is_internal + base + at)};
  }

  __device__ __forceinline__ void decode(Raw w, bool on, int& feat, int& thr,
                                         bool& in) const {
    feat = on ? w.feat : 0;
    thr = on ? w.thr : 0;
    in = on && w.in != 0;
  }

  __device__ __forceinline__ float leaf(int base, int at) const {
    return __ldg(fit + base + at);
  }

  // Three loads a level: the top levels of a pass's trees are staged in
  // shared memory, a node as (feature, threshold) when internal, else
  // (kLeafWord, 0) (a leaf, or outside the heap).  (In 4 bytes, as K3's
  // narrow records, they staged no faster: PERF.md, section 6.)
  static constexpr bool kStaged = true;
  using Staged = int2;
  static constexpr int kLeafWord = INT_MIN;
  __device__ __forceinline__ Staged stage(int off, bool in_heap) const {
    const Raw w = load(off, 0);
    return in_heap && w.in ? make_int2(w.feat, w.thr)
                           : make_int2(kLeafWord, 0);
  }
  __device__ __forceinline__ Raw staged(const Staged* p, int idx) const {
    const int2 w = p[idx];
    return Raw{w.x, w.y, static_cast<unsigned char>(w.x != kLeafWord)};
  }
};

// The configuration's constants (seg_config), settled on an H100 (PERF.md,
// section 6).
constexpr int kSegThreads = 256;              // threads of a CTA
constexpr int kSegWalkBits = 3;
constexpr int kSegWalks = 1 << kSegWalkBits;  // trees a thread walks at once
constexpr int kSegValues = 8;       // fold values a thread keeps a pass
constexpr int kSegMinRows = 8;      // fewest rows a CTA holds
constexpr int kSegMaxRows = 128;    // most rows a CTA holds
constexpr int kSegXBytes = 48 * 1024;       // largest x tile in shared memory
constexpr int kSegCountBytes = 32 * 1024;   // largest shared vote table
constexpr int kSegStageBytes = 128 * 1024;  // most shared memory for trees
constexpr int kSegMinLevels = 3;    // fewest levels worth staging
constexpr int kSegStagedBytes = 8;  // a staged node (K2's int2)

// What a segmented launch reduces.
constexpr int kSegSums = 0;        // regression: chunk sums folded in order
constexpr int kSegVotes = 1;       // votes: integer counts in shared memory
constexpr int kSegVoteAtomic = 2;  // votes past kSegCountBytes: integer
                                   // atomics into the output, then
                                   // count_kernel

// How a launch reads a node.
constexpr int kTables = 0;  // K2: the separate tables
constexpr int kShift = 1;   // K1, tb2 a power of two: shift and mask
constexpr int kDivide = 2;  // K1, any other tb2: floor division

// The launch's configuration, in the order tp_seg_config reports it.
struct SegCfg {
  int mode;      // kSegSums / kSegVotes / kSegVoteAtomic
  int decode;    // kTables / kShift / kDivide
  int threads;   // kSegThreads
  int rows;      // rows a CTA holds: a tile inside one row block
  int cols;      // threads / rows: slices a CTA walks at once for a row
  int walks;     // trees a thread walks at once: one slice
  int slices;    // slices per chunk of block_trees trees
  int values;    // a slice's values for the fold: 1 (its chunk's sum) or
                 // walks (its leaves)
  int rounds;    // slices a thread walks per pass (1 when trees are
                 // staged, else kSegValues / values)
  int depth;     // levels a walk takes: min(max_depth, bit_length(h))
  int levels;    // levels of a pass's trees staged in shared memory
  int staged;    // nodes staged per tree: 2**levels (0: none)
  int x_smem;    // 1: the tile's x in shared memory
  int dpad;      // row stride of the x tile (odd)
  int smem;      // dynamic shared memory bytes
  int tiles;     // tiles per row block
  int resident;  // CTAs resident on the card
  int grid;      // row blocks * tiles
};
constexpr int kSegCfgInts = sizeof(SegCfg) / sizeof(int);

// Shapes of one segmented launch.
struct SegShape {
  int n, d, n_trees, n_chunks, h, n_classes, block_trees, block_obs;
};

__host__ __device__ __forceinline__ int seg_x_bytes(const SegCfg& c) {
  return c.x_smem ? (c.rows * c.dpad * 4 + 15) / 16 * 16 : 0;
}

// Where the staged trees start: after the x tile and the fold's values
// (sums) or the vote table, 16-byte aligned.
__host__ __device__ __forceinline__ int seg_stage_offset(const SegCfg& c,
                                                        int n_classes) {
  const int table = c.mode == kSegSums
                        ? kSegThreads * kSegValues * 4
                        : (c.mode == kSegVotes ? c.rows * n_classes * 4 : 0);
  return seg_x_bytes(c) + (table + 15) / 16 * 16;
}

// Tiling from the shapes alone, before the rows a CTA holds are chosen
// (the plain twin is tree_predict.py's _seg_config).
int seg_tile(int n, int d, int t, int h, int max_depth, int n_classes,
             int block_trees, int block_obs, int tb2, int simple,
             SegCfg* c) {
  if (n < 1 || d < 1 || t < 0 || h < 0 || block_trees < 1 ||
      block_obs < 1 || (!simple && tb2 < 1) ||
      static_cast<int64_t>(t) * h >= (int64_t{1} << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  c->decode = simple ? kTables : ((tb2 & (tb2 - 1)) == 0 ? kShift : kDivide);
  c->threads = kSegThreads;
  c->walks = kSegWalks;
  c->slices = (block_trees + kSegWalks - 1) / kSegWalks;
  c->values = c->slices == 1 ? 1 : kSegWalks;
  const int lh = bit_length(h);
  c->depth = max_depth < lh ? max_depth : lh;
  c->dpad = d | 1;
  return 0;
}

// The fields that follow from `rows`: shared memory (the x tile where it
// fits, then the fold's values or the vote table) and the grid.
void seg_size(int n, int block_obs, int n_classes, int rows, SegCfg* c) {
  c->rows = rows;
  c->cols = kSegThreads / rows;
  c->x_smem = static_cast<int64_t>(rows) * c->dpad * 4 <= kSegXBytes;
  const int64_t counts = static_cast<int64_t>(rows) * n_classes * 4;
  c->mode = n_classes <= 0 ? kSegSums
                           : (counts <= kSegCountBytes ? kSegVotes
                                                       : kSegVoteAtomic);
  // a pass stages the top levels of its slices' trees, one slice a column:
  // as many levels as fit kSegStageBytes, if that is at least
  // kSegMinLevels (the first levels' loads share their sectors anyway)
  int levels = c->decode == kTables ? c->depth : 0;  // K2 only
  while (levels > 0 && static_cast<int64_t>(c->cols) * kSegWalks *
                               (int64_t{1} << levels) * kSegStagedBytes >
                           kSegStageBytes)
    --levels;
  c->levels = levels < kSegMinLevels ? 0 : levels;
  c->staged = c->levels ? 1 << c->levels : 0;
  c->rounds = c->levels ? 1 : kSegValues / c->values;
  c->smem = seg_stage_offset(*c, n_classes) +
            c->cols * kSegWalks * c->staged * kSegStagedBytes;
  const int block_rows = block_obs < n ? block_obs : n;
  c->tiles = (block_rows + rows - 1) / rows;
  const int64_t blocks = (static_cast<int64_t>(n) + block_obs - 1) / block_obs;
  c->grid = static_cast<int>(blocks * c->tiles);
}

// Rows a CTA holds: the fewest (a power of two from kSegMinRows to
// kSegMaxRows; from 2 * kSegMinRows for K2, whose fewer columns then stage
// a level more) whose grid fits the resident CTAs, so a small batch spreads
// its walks over the card and a large one runs in about one wave.
void seg_rows(int n, int block_obs, int n_classes, int resident, SegCfg* c) {
  c->resident = resident;
  int rows = c->decode == kTables ? 2 * kSegMinRows : kSegMinRows;
  seg_size(n, block_obs, n_classes, rows, c);
  while (rows < kSegMaxRows && c->grid > resident) {
    rows *= 2;
    seg_size(n, block_obs, n_classes, rows, c);
  }
}

// One level of W walks from their words: the steps idx = internal ?
// child : idx (the reference's own), after the W x loads, no branch.
template <class Nodes, bool kXSmem>
__device__ __forceinline__ void seg_step(
    const Nodes& nodes, const typename Nodes::Raw (&raw)[kSegWalks],
    const bool (&valid)[kSegWalks], int (&idx)[kSegWalks], int last,
    const int* xr, const int* __restrict__ xg, int d) {
  int feat[kSegWalks], thr[kSegWalks];
  bool in[kSegWalks];
#pragma unroll
  for (int k = 0; k < kSegWalks; ++k)
    nodes.decode(raw[k], valid[k] && idx[k] <= last, feat[k], thr[k], in[k]);
  int xv[kSegWalks];
#pragma unroll
  for (int k = 0; k < kSegWalks; ++k) {
    const int f = min(max(feat[k], 0), d - 1);
    xv[k] = kXSmem ? xr[f] : __ldg(xg + f);
  }
#pragma unroll
  for (int k = 0; k < kSegWalks; ++k)
    idx[k] = in[k] ? 2 * idx[k] + (xv[k] <= thr[k] ? 1 : 2) : idx[k];
}

// W walks of one thread's row, `depth` uniform levels from the root: the
// first `levels` from the trees staged in shared memory (K2: slot `slot`
// of stage_mem, 2**levels nodes a tree), the rest from global memory; each
// level issues the W word loads, then the W x loads, then the W steps.  A
// walk past the heap reads the zero word, so it stays put, and its leaf
// is 0; an invalid walk (its loads at tree 0, row r0: addresses that
// exist) reads the zero word and its leaf is 0.
template <class Nodes, bool kXSmem>
__device__ __forceinline__ void seg_walk(
    const Nodes& nodes, const int (&base)[kSegWalks],
    const bool (&valid)[kSegWalks], const unsigned char* stage_mem,
    int slot, int levels, const int* xr, const int* __restrict__ xg, int d,
    int depth, float (&leaf)[kSegWalks]) {
  const int last = nodes.h - 1;
  if (last < 0) {  // no heap: every leaf is 0 (and depth is 0)
#pragma unroll
    for (int k = 0; k < kSegWalks; ++k) leaf[k] = 0.0f;
    return;
  }
  int idx[kSegWalks];
#pragma unroll
  for (int k = 0; k < kSegWalks; ++k) idx[k] = 0;
  typename Nodes::Raw raw[kSegWalks];
  int lv = 0;
  if constexpr (Nodes::kStaged) {
    const auto* st =
        reinterpret_cast<const typename Nodes::Staged*>(stage_mem) +
        (slot << (levels + kSegWalkBits));
    for (; lv < min(levels, depth); ++lv) {
#pragma unroll
      for (int k = 0; k < kSegWalks; ++k)
        raw[k] = nodes.staged(st + (k << levels), idx[k]);
      seg_step<Nodes, kXSmem>(nodes, raw, valid, idx, last, xr, xg, d);
    }
  }
  for (; lv < depth; ++lv) {
#pragma unroll
    for (int k = 0; k < kSegWalks; ++k)
      raw[k] = nodes.load(base[k], min(idx[k], last));
    seg_step<Nodes, kXSmem>(nodes, raw, valid, idx, last, xr, xg, d);
  }
  float fit[kSegWalks];
#pragma unroll
  for (int k = 0; k < kSegWalks; ++k)
    fit[k] = nodes.leaf(base[k], min(idx[k], last));
#pragma unroll
  for (int k = 0; k < kSegWalks; ++k)
    leaf[k] = valid[k] && idx[k] <= last ? fit[k] : 0.0f;
}

// One CTA: a tile of `rows` rows inside row block b, against the chunks
// [chunk_lo[b], chunk_hi[b]) (every chunk when chunk_lo is null), cut into
// slices: a chunk, or `walks` trees of one.  A window of up to
// kSegThreads slices at a time, the CTA keeps those whose trees' segments
// fall inside its rows' segment range, in order; thread (q, r) =
// (threadIdx / rows, threadIdx % rows) walks kept slice q + cols * i for
// row r, and a warp skips a slice none of whose pairs count.  Sums: each
// pass the slices' values go to shared memory (a chunk's sum in tree
// order, or the leaves), and after a barrier thread r (q = 0) adds them in
// (chunk, tree) order into its running total, which it writes once.
// Skipped pairs would add +0.0, which changes no total (one starting at
// +0.0 never becomes -0.0).  Votes: integer counts in a shared table (or
// atomics into the output), written once.  n_trees masks trees past the
// real ones (K2); K1 passes T_pad, whose padding trees carry segment -1.
// Node offsets are 32-bit (the launch refuses t * h >= 2**31).
template <class Nodes, int kMode, bool kXSmem>
__global__ void __launch_bounds__(kSegThreads)
    seg_kernel(Nodes nodes, const int* __restrict__ xb,
               const int* __restrict__ obs_seg,
               const int* __restrict__ tree_seg,
               const int* __restrict__ chunk_lo,
               const int* __restrict__ chunk_hi, float* __restrict__ out,
               SegShape s, SegCfg c) {
  constexpr int W = kSegWalks;
  constexpr int kWarps = kSegThreads / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int kept[kSegThreads];  // the window's kept slices, in order
  __shared__ int warp_min[kWarps], warp_max[kWarps], warp_kept[kWarps];
  int* xs = reinterpret_cast<int*>(smem);  // [rows][dpad]
  float* vals = reinterpret_cast<float*>(smem + seg_x_bytes(c));
  int* counts = reinterpret_cast<int*>(smem + seg_x_bytes(c));  // [rows][C]
  // K2: the pass's trees, [slot][walk][2**levels nodes]
  unsigned char* stage_mem = smem + seg_stage_offset(c, s.n_classes);
  const int blk = blockIdx.x / c.tiles;
  const int64_t blk0 = static_cast<int64_t>(blk) * s.block_obs;
  const int64_t r0l = blk0 + static_cast<int64_t>(blockIdx.x - blk * c.tiles) *
                                 c.rows;
  int64_t end = blk0 + s.block_obs;  // the block's end, the tile's, n
  if (end > r0l + c.rows) end = r0l + c.rows;
  if (end > s.n) end = s.n;
  if (end <= r0l) return;  // a tile past its block's last row
  const int r0 = static_cast<int>(r0l);
  const int nrows = static_cast<int>(end - r0l);
  int lo = 0;
  int hi = s.n_chunks;
  if (chunk_lo != nullptr) {
    lo = max(chunk_lo[blk], 0);
    hi = min(chunk_hi[blk], s.n_chunks);
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int r = threadIdx.x % c.rows;
  const int q = threadIdx.x / c.rows;
  const bool row_ok = r < nrows;
  const int row = r0 + (row_ok ? r : 0);
  const int seg = obs_seg[row];
  const int* xg = xb + static_cast<int64_t>(row) * s.d;
  if (kXSmem) {
    const int* src = xb + static_cast<int64_t>(r0) * s.d;
    for (int e = threadIdx.x; e < nrows * s.d; e += kSegThreads) {
      const int rr = e / s.d;
      xs[rr * c.dpad + (e - rr * s.d)] = src[e];
    }
  }
  if (kMode == kSegVotes)
    for (int e = threadIdx.x; e < c.rows * s.n_classes; e += kSegThreads)
      counts[e] = 0;
  // the rows' segment range
  const int wmin = __reduce_min_sync(0xffffffffu, seg);
  const int wmax = __reduce_max_sync(0xffffffffu, seg);
  if (lane == 0) {
    warp_min[warp] = wmin;
    warp_max[warp] = wmax;
  }
  __syncthreads();
  int seg_lo = warp_min[0];
  int seg_hi = warp_max[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) {
    seg_lo = min(seg_lo, warp_min[w]);
    seg_hi = max(seg_hi, warp_max[w]);
  }
  const int* xr = xs + r * c.dpad;

  const int n_sl = hi > lo ? (hi - lo) * c.slices : 0;
  const int per_pass = c.cols * c.rounds;
  float total = 0.0f;  // sums, thread r of q = 0: the chunk sums in order
  float open = 0.0f;   // the open chunk's leaves in tree order
  int open_chunk = -1;
  for (int w0 = 0; w0 < n_sl; w0 += kSegThreads) {
    // keep the window's slices that may meet the rows, in order
    {
      const int j = w0 + threadIdx.x;
      bool keep = false;
      if (j < n_sl) {
        const int chunk = j / c.slices;
        const int part = j - chunk * c.slices;
        const int t0 = (lo + chunk) * s.block_trees + part * W;
        const int nk = min(W, s.block_trees - part * W);
        int ts[W];
#pragma unroll
        for (int k = 0; k < W; ++k)
          ts[k] = __ldg(tree_seg + min(t0 + k, s.n_trees - 1));
#pragma unroll
        for (int k = 0; k < W; ++k)
          keep |= k < nk && t0 + k < s.n_trees && ts[k] >= seg_lo &&
                  ts[k] <= seg_hi;
      }
      const unsigned ballot = __ballot_sync(0xffffffffu, keep);
      if (lane == 0) warp_kept[warp] = __popc(ballot);
      __syncthreads();
      int before = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w)
        if (w < warp) before += warp_kept[w];
      if (keep) kept[before + __popc(ballot & ((1u << lane) - 1))] = j;
    }
    int n_kept = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) n_kept += warp_kept[w];
    __syncthreads();  // the kept list is complete
    for (int p0 = 0; p0 < n_kept; p0 += per_pass) {
      if constexpr (Nodes::kStaged) {
        if (c.levels > 0) {  // stage the top levels of the pass's trees
          __shared__ int stage_tree[kSegThreads];  // slot * W + k: its tree
          const int n_pass = min(per_pass, n_kept - p0);
          if (static_cast<int>(threadIdx.x) < n_pass * W) {  // slot trees
            const int k = threadIdx.x & (W - 1);
            const int j = kept[p0 + (threadIdx.x >> kSegWalkBits)];
            const int chunk = j / c.slices;
            const int part = j - chunk * c.slices;
            const int tree = (lo + chunk) * s.block_trees + part * W + k;
            stage_tree[threadIdx.x] =
                k < min(W, s.block_trees - part * W) && tree < s.n_trees
                    ? tree
                    : -1;
          }
          __syncthreads();
          auto* st = reinterpret_cast<typename Nodes::Staged*>(stage_mem);
          // kStageBatch loads in flight a thread, then their stores
          constexpr int kStageBatch = 8;
          const int n_nodes = n_pass * W << c.levels;
          for (int e0 = 0; e0 < n_nodes; e0 += kSegThreads * kStageBatch) {
            typename Nodes::Staged w[kStageBatch];
#pragma unroll
            for (int b = 0; b < kStageBatch; ++b) {
              const int e = e0 + b * kSegThreads + threadIdx.x;
              const int tree = e < n_nodes ? stage_tree[e >> c.levels] : -1;
              const int node = e & (c.staged - 1);
              const bool in_heap = tree >= 0 && node < s.h;
              w[b] = nodes.stage(in_heap ? tree * s.h + node : 0, in_heap);
            }
#pragma unroll
            for (int b = 0; b < kStageBatch; ++b) {
              const int e = e0 + b * kSegThreads + threadIdx.x;
              if (e < n_nodes) st[e] = w[b];
            }
          }
          __syncthreads();
        }
      }
      for (int rd = 0; rd < c.rounds; ++rd) {
        if (p0 + rd * c.cols >= n_kept) break;  // no kept slice left
        const int i = p0 + rd * c.cols + q;  // the kept slice, in order
        const bool here = i < n_kept;
        const int j = here ? kept[i] : 0;
        const int chunk = j / c.slices;
        const int part = j - chunk * c.slices;
        const int t0 = (lo + chunk) * s.block_trees + part * W;
        const int nk = min(W, s.block_trees - part * W);
        int segs[W];
#pragma unroll
        for (int k = 0; k < W; ++k)
          segs[k] = __ldg(tree_seg + min(t0 + k, s.n_trees - 1));
        int base[W];
        bool valid[W];
        bool any = false;
#pragma unroll
        for (int k = 0; k < W; ++k) {
          const int tree = t0 + k;
          const bool pair = here && row_ok && k < nk && tree < s.n_trees;
          valid[k] = pair && segs[k] == seg;
          base[k] = (pair ? tree : 0) * s.h;
          any |= valid[k];
        }
        float leaf[W];
        if (__any_sync(0xffffffffu, any)) {
          seg_walk<Nodes, kXSmem>(nodes, base, valid, stage_mem,
                                  rd * c.cols + q, c.levels, xr, xg, s.d,
                                  c.depth, leaf);
        } else {
#pragma unroll
          for (int k = 0; k < W; ++k) leaf[k] = 0.0f;
        }
        if (kMode == kSegSums) {
          if (here) {
            float* v = vals + (rd * c.cols + q) * c.values * c.rows + r;
            if (c.values == 1) {  // the whole chunk: its sum in tree order
              float sum = leaf[0];
#pragma unroll
              for (int k = 1; k < W; ++k)
                if (k < nk) sum += leaf[k];
              v[0] = sum;
            } else {
#pragma unroll
              for (int k = 0; k < W; ++k)
                if (k < nk) v[k * c.rows] = leaf[k];
            }
          }
        } else {
#pragma unroll
          for (int k = 0; k < W; ++k) {
            const int cls = __float2int_rz(leaf[k]);  // astype(int32)
            if (valid[k] && cls >= 0 && cls < s.n_classes) {
              if (kMode == kSegVotes)
                atomicAdd(counts + r * s.n_classes + cls, 1);
              else
                atomicAdd(reinterpret_cast<int*>(out) +
                              static_cast<int64_t>(row) * s.n_classes + cls,
                          1);
            }
          }
        }
      }
      if (kMode == kSegSums) {
        __syncthreads();  // the pass's values are in shared memory
        if (static_cast<int>(threadIdx.x) < c.rows) {  // q = 0: fold row r
          const int stop = min(p0 + per_pass, n_kept);
          for (int i = p0; i < stop; ++i) {
            const float* v = vals + (i - p0) * c.values * c.rows + r;
            if (c.values == 1) {
              total += v[0];
            } else {
              const int j = kept[i];
              const int chunk = j / c.slices;
              const int part = j - chunk * c.slices;
              if (chunk != open_chunk) {  // a new chunk: close the last
                total += open;
                open = 0.0f;
                open_chunk = chunk;
              }
              const int nk = min(W, s.block_trees - part * W);
              for (int k = 0; k < nk; ++k) open += v[k * c.rows];
            }
          }
        }
        __syncthreads();  // folded: the next pass may overwrite the values
      } else if (c.levels > 0) {
        __syncthreads();  // walked: the next pass may restage
      }
    }
    __syncthreads();  // the next window may overwrite the kept list
  }
  if (kMode == kSegSums) {
    if (static_cast<int>(threadIdx.x) < c.rows && row_ok)
      out[r0 + r] = total + open;
  } else if (kMode == kSegVotes) {
    __syncthreads();
    float* o = out + static_cast<int64_t>(r0) * s.n_classes;
    for (int e = threadIdx.x; e < nrows * s.n_classes; e += kSegThreads)
      o[e] = static_cast<float>(counts[e]);
  }
}

// f(mode, x in shared memory) as integral constants, for the
// configuration's instantiation.
template <class F>
int seg_dispatch(const SegCfg& c, F&& f) {
  using std::false_type;
  using std::integral_constant;
  using std::true_type;
  if (c.mode == kSegSums)
    return c.x_smem ? f(integral_constant<int, kSegSums>{}, true_type{})
                    : f(integral_constant<int, kSegSums>{}, false_type{});
  if (c.mode == kSegVotes)
    return c.x_smem ? f(integral_constant<int, kSegVotes>{}, true_type{})
                    : f(integral_constant<int, kSegVotes>{}, false_type{});
  return c.x_smem ? f(integral_constant<int, kSegVoteAtomic>{}, true_type{})
                  : f(integral_constant<int, kSegVoteAtomic>{}, false_type{});
}

template <class Nodes>
int seg_occupancy(const SegCfg& c, int* per_sm) {
  return seg_dispatch(c, [&](auto mode, auto xsm) {
    auto kernel = seg_kernel<Nodes, decltype(mode)::value,
                             decltype(xsm)::value>;
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, c.smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        per_sm, kernel, c.threads, c.smem));
  });
}

// The full configuration on the current device: the tiling, then the rows
// a CTA holds from the resident CTAs (the SM count and the kernel's
// occupancy at the largest shared memory any row count would take).
int seg_config(int n, int d, int t, int h, int max_depth, int n_classes,
               int block_trees, int block_obs, int tb2, int simple,
               SegCfg* c) {
  int err = seg_tile(n, d, t, h, max_depth, n_classes, block_trees,
                     block_obs, tb2, simple, c);
  if (err) return err;
  int smem = 0;
  for (int rows = kSegMinRows; rows <= kSegMaxRows; rows *= 2) {
    seg_size(n, block_obs, n_classes, rows, c);
    smem = c->smem > smem ? c->smem : smem;
  }
  c->smem = smem;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (c->decode == kTables)
    err = seg_occupancy<SimpleNodes>(*c, &per_sm);
  else if (c->decode == kShift)
    err = seg_occupancy<PackedNodes<true>>(*c, &per_sm);
  else
    err = seg_occupancy<PackedNodes<false>>(*c, &per_sm);
  if (err) return err;
  seg_rows(n, block_obs, n_classes, sms * (per_sm > 0 ? per_sm : 1), c);
  return 0;
}

struct SegPtrs {
  const int* xb;
  const int* obs_seg;
  const int* tree_seg;
  const int* chunk_lo;
  const int* chunk_hi;
  float* out;
};

template <class Nodes>
int seg_launch(const Nodes& nodes, const SegPtrs& p, const SegShape& s,
               const SegCfg& c, cudaStream_t st) {
  const int64_t size = static_cast<int64_t>(s.n) * s.n_classes;
  if (c.mode == kSegVoteAtomic) {
    cudaError_t e = cudaMemsetAsync(p.out, 0, size * sizeof(float), st);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  int err = seg_dispatch(c, [&](auto mode, auto xsm) {
    auto kernel = seg_kernel<Nodes, decltype(mode)::value,
                             decltype(xsm)::value>;
    // always: the occupancy query set the attribute for another row count
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, c.smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    kernel<<<c.grid, c.threads, c.smem, st>>>(nodes, p.xb, p.obs_seg,
                                              p.tree_seg, p.chunk_lo,
                                              p.chunk_hi, p.out, s, c);
    return static_cast<int>(cudaGetLastError());
  });
  if (err || c.mode != kSegVoteAtomic) return err;
  const int64_t blocks = (size + 255) / 256;
  count_kernel<<<static_cast<int>(blocks < 4096 ? blocks : 4096), 256, 0,
                 st>>>(p.out, size);
  return static_cast<int>(cudaGetLastError());
}

int log2_of(int v) {
  int k = 0;
  while ((1 << k) < v) ++k;
  return k;
}


}  // namespace

extern "C" {

// K1.  code / fit (t_pad, h) f32; tree_seg (t_pad,) i32 with -1 padding;
// chunk_lo / chunk_hi (ceil(n / block_obs),) i32; out (n, C) or (n,) f32,
// every element written.
int tp_seg_packed(const int* xb, const int* obs_seg, const float* code,
                  const float* fit, const int* tree_seg, const int* chunk_lo,
                  const int* chunk_hi, float* out, int n, int d, int t_pad,
                  int h, int max_depth, int tb2, int n_classes,
                  int block_trees, int block_obs, void* stream) {
  SegCfg c;
  const int err = seg_config(n, d, t_pad, h, max_depth, n_classes,
                             block_trees, block_obs, tb2, 0, &c);
  if (err) return err;
  const SegShape s{n, d, t_pad, t_pad / block_trees, h, n_classes,
                   block_trees, block_obs};
  const SegPtrs p{xb, obs_seg, tree_seg, chunk_lo, chunk_hi, out};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (c.decode == kShift)
    return seg_launch(PackedNodes<true>{code, fit, h, tb2, log2_of(tb2)}, p,
                      s, c, st);
  return seg_launch(PackedNodes<false>{code, fit, h, tb2, 0}, p, s, c, st);
}

// K2.  feature / threshold (t, h) i32, fit (t, h) f32, is_internal (t, h)
// bool bytes; tree_seg (t,) i32; out (n, C) or (n,) f32, every element
// written.
int tp_seg_simple(const int* xb, const int* obs_seg, const int* tree_seg,
                  const int* feature, const int* threshold, const float* fit,
                  const unsigned char* is_internal, float* out, int n, int d,
                  int t, int h, int max_depth, int n_classes,
                  int block_trees, int block_obs, void* stream) {
  SegCfg c;
  const int err = seg_config(n, d, t, h, max_depth, n_classes, block_trees,
                             block_obs, 0, 1, &c);
  if (err) return err;
  const SegShape s{n, d, t, (t + block_trees - 1) / block_trees, h,
                   n_classes, block_trees, block_obs};
  const SegPtrs p{xb, obs_seg, tree_seg, nullptr, nullptr, out};
  return seg_launch(SimpleNodes{feature, threshold, fit, is_internal, h}, p,
                    s, c, static_cast<cudaStream_t>(stream));
}

// The configuration of a K1 (simple 0, tb2 its decode's) or K2 (simple 1,
// tb2 ignored) launch on the current device, out[18] in SegCfg's order
// (mode, decode, threads, rows, cols, walks, slices, values, rounds,
// depth, staged levels, staged nodes per tree, x in shared memory, x row
// stride, shared memory bytes, tiles per row block, resident CTAs, grid).
int tp_seg_config(int n, int d, int t, int h, int max_depth, int n_classes,
                  int block_trees, int block_obs, int tb2, int simple,
                  int* out) {
  SegCfg c;
  const int err = seg_config(n, d, t, h, max_depth, n_classes, block_trees,
                             block_obs, tb2, simple, &c);
  if (err) return err;
  const int* v = reinterpret_cast<const int*>(&c);
  for (int i = 0; i < kSegCfgInts; ++i) out[i] = v[i];
  return 0;
}

// K3.  feature / threshold (t, h) i32, fit (t, h) f32, is_internal (t, h)
// bool bytes; records: scratch of t * ws node words of the form (0: 4
// bytes, 1: 8), then t * ws float32 fits, ws = leaf_stride(walk_depth(h,
// max_depth)); partial: (ceil(t / block_trees), n) f32 scratch,
// read only when tp_forest_config reports partials for a regression;
// out zeroed (n, C) or (n,).  form 0 needs d <= 2**15 and every
// |threshold| < 2**15 (tree_predict.py's _record_form).
int tp_agg(const int* xb, const int* feature, const int* threshold,
           const float* fit, const unsigned char* is_internal, void* records,
           float* partial, float* out, int n, int d, int t, int h,
           int max_depth, int n_classes, int block_trees, int form,
           void* stream) {
  return forest_launch(xb, feature, threshold, fit, is_internal, records,
                       partial, out, n, d, t, h, max_depth, n_classes, 0,
                       block_trees, form, stream);
}

// K4.  The same tables and scratch; out (t, n) f32, every element written.
int tp_per_tree(const int* xb, const int* feature, const int* threshold,
                const float* fit, const unsigned char* is_internal,
                void* records, float* out, int n, int d, int t, int h,
                int max_depth, int block_trees, int form, void* stream) {
  return forest_launch(xb, feature, threshold, fit, is_internal, records,
                       nullptr, out, n, d, t, h, max_depth, 0, 1,
                       block_trees, form, stream);
}

// The configuration of a K3 (per_tree 0) or K4 (per_tree 1) launch on the
// current device, out[20] in ForestCfg's order (form, mode, walks,
// threads, depth, levels, staged words and leaf fits per tree, group,
// n_groups, x in shared memory, x row stride, shared memory bytes,
// resident CTAs, splits and rows per split of a full group and of the
// last, grid, partials).
int tp_forest_config(int t, int h, int n, int d, int max_depth,
                     int n_classes, int per_tree, int block_trees, int form,
                     int* out) {
  ForestCfg c;
  const int err =
      forest_config(t, h, n, d, max_depth, per_tree ? 0 : n_classes,
                    per_tree, block_trees, form, &c);
  if (err) return err;
  const int* v = reinterpret_cast<const int*>(&c);
  for (int i = 0; i < kCfgInts; ++i) out[i] = v[i];
  return 0;
}

const char* tp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
