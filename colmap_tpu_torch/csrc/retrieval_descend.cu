// K30 retrieval_descend: vocabulary-tree descent to a leaf word.
//
// Replaces colmap_tpu/retrieval/visual_index.py `_tree_descend` (l.117,
// jitted at l.139), which per level gathers every descriptor's (B, D)
// children into an (N, B, D) block and runs a batched einsum; the host
// pads descriptors into chunks of 65536 rows.
//
// Function: node = 0; at each of L levels child = argmin_j Σ_d (x_d -
// c[l][node, j, d])², the lowest j on exact ties, node = node B + child;
// the output is the leaf id node in [0, B^L).
// Layout: the levels are one (Σ_l B^(l+1), D) float32 tensor, level l's
// rows starting at Σ_{k<l} B^(k+1), node n's children at n B .. n B + B - 1.
//
// Arithmetic, the same in both regimes below and bit for bit that of the
// warp-a-row kernel this one replaced: the 128 dims are 32 groups of 4
// (group l: dims 4l..4l+3; groups past D are 0), group l's partial is (dx²
// + dy²) + (dz² + dw²), and the 32 partials are summed in the tree of an
// xor butterfly over lane offsets 16, 8, 4, 2, 1: T(b, m) = T(b, 2m) + T(b +
// m, 2m) for the groups l = b mod m, T(l, 32) the partial, T(0, 1) the sum.
// A child wins where its sum is below the best so far (`d < best` from best
// = inf, so the lowest j on a tie, and j = 0 where nothing is finite).
//
// Two regimes, chosen by kernels/retrieval.py `_descend_plan` from N, B, L
// and D alone (no host read):
// (a) direct, below 150 000 rows (one image's ~2000 rows: almost every call):
//     a warp a row through all levels, lane l holding group l, the
//     children rows read from L2. A level issues the loads of 8 children
//     before any reduction, then reduces their 8 sums at once by a
//     transposing butterfly (at each offset a lane keeps half of its values,
//     sends the partner the other half and adds what it receives: 9
//     shuffles, not 40; lane l ends with child l >> 2's sum, formed in the
//     tree above, since addition commutes) and takes the argmin over the
//     lanes by (distance bits, j) (distances are >= 0, so their bits order
//     as the floats do; one that is not below infinity keys as infinity). At
//     depth 5 a row takes 5 rounds of one L2 trip, where the old kernel
//     chained 40 loads and 200 shuffles.
// (b) sorted passes, for a corpus (2M rows, `rank_images_bow`): the direct
//     regime reads ~40 children rows of 512 B from L2 a row (~41 GB at 2M
//     rows). Instead the levels are descended in passes of k levels, k the
//     most whose subtree (B + ... + B^k rows) fits the shared-memory budget
//     (2 at B = 8, D = 128: 36 KB). Before pass p > 0 the rows are bucketed
//     by their node (G = B^(pk) groups) with a counting sort written here:
//     the previous pass's blocks count their rows' nodes in shared memory and
//     add the counts to G global counters; one block scans them into row
//     offsets and work items (groups cut into items of kItemRows rows); a
//     scatter writes row indices by node, a shared histogram a block
//     reserving its ranges with one atomic a node (the order within a node
//     is free: the output is per row). A pass's block finds its item by
//     binary search, stages its node's subtree in shared memory by cp.async,
//     and each thread takes one row, held in 128 registers, and sums the
//     tree itself: no shuffle, no select. Where a warp's rows stand at one
//     node (always at the pass's first level) a child's float4 is one
//     broadcast read for 32 rows; at a pass's deeper level the threads of a
//     warp read up to B nodes' rows, each node's rows padded by 16 bytes so
//     that different nodes fall in different banks. Each pass reads the rows
//     once (1 GB at 2M rows, three passes at 8^5) and each item its subtree
//     once.
// Bound on the card: at 2M rows through 8^5 the distances' operations (3 a
// (row, child, dim): 3.1e10) and the rows (1 GB), counted once.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "retrieval_common.cuh"

namespace ctt {
namespace ret {

constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kInvalidKey = 0xffffffffu;
constexpr int kDirectBlock = 128;   // (a): 4 warps, a row each
constexpr int kPassBlock = 128;     // (b): a thread a row
constexpr int kPassBlocksPerSm = 3;
constexpr int kChunk = 8;           // (a): children evaluated together
constexpr int kItemRows = 512;      // (b): rows of a work item
constexpr int kScatterThreads = 256;
constexpr int kScatterPerThread = 8;
constexpr int kScatterRows = kScatterThreads * kScatterPerThread;
constexpr int kScatterBins = 12288;  // groups counted in 48 KB of shared memory
constexpr int kScanThreads = 1024;
constexpr int kMaxSmem = 232448;     // a block's shared memory on an H100

__device__ __forceinline__ unsigned dist_key(float d) {
  return d < INFINITY ? __float_as_uint(d) : 0x7f800000u;
}

template <int N>
struct Log2 {
  static constexpr int value = 1 + Log2<N / 2>::value;
};
template <>
struct Log2<1> {
  static constexpr int value = 0;
};

// One transposing step at lane offset OFF over the first N values of v.
template <int N, int OFF>
__device__ __forceinline__ void half_step(float* v, int lane) {
  const bool upper = lane & OFF;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const float send = upper ? v[i] : v[i + N / 2];
    const float keep = upper ? v[i + N / 2] : v[i];
    v[i] = keep + __shfl_xor_sync(kFull, send, OFF);
  }
}

// V <= 8 sums of 32 lanes' partials v[0..V): lane l returns sum
// (l >> (5 - log2 V)). Every step's size is a constant, so v stays in
// registers.
template <int V>
__device__ __forceinline__ float transpose_sum(float (&v)[V], int lane) {
  static_assert(V <= kChunk, "a chunk of children");
  if constexpr (V >= 2) half_step<V, 16>(v, lane);
  if constexpr (V >= 4) half_step<V / 2, 8>(v, lane);
  if constexpr (V >= 8) half_step<V / 4, 4>(v, lane);
  float d = v[0];
#pragma unroll
  for (int off = 16 >> Log2<V>::value; off > 0; off >>= 1) d += __shfl_xor_sync(kFull, d, off);
  return d;
}

// (a) Children j0 .. j0 + valid - 1 (valid <= BC) of the warp's row, at c +
// j D4. Updates the best (key, child) where this chunk holds a strictly
// smaller key, so the lowest j wins a tie.
template <int BC>
__device__ __forceinline__ void eval_chunk(float4 xv, const float4* c, int j0, int valid, int D4,
                                           int lane, unsigned& best_key, int& best_j) {
  constexpr int kShift = 5 - Log2<BC>::value;
  const bool on = lane < D4;
  float4 cv[BC];
#pragma unroll
  for (int j = 0; j < BC; ++j) cv[j] = on && j < valid ? __ldg(c + (j0 + j) * D4 + lane) : zero4();
  float v[BC];
#pragma unroll
  for (int j = 0; j < BC; ++j) {
    float4 acc = zero4();
    if (on) acc_sq(xv, cv[j], acc);
    v[j] = total(acc);
  }
  const float d = transpose_sum<BC>(v, lane);
  int j = lane >> kShift;
  unsigned key = j < valid ? dist_key(d) : kInvalidKey;
#pragma unroll
  for (int b = 0; b < Log2<BC>::value; ++b) {
    const int off = 1 << (kShift + b);
    const unsigned pk = __shfl_xor_sync(kFull, key, off);
    const int pj = __shfl_xor_sync(kFull, j, off);
    if (pk < key || (pk == key && pj < j)) {
      key = pk;
      j = pj;
    }
  }
  if (key < best_key) {  // every lane holds the chunk's winner
    best_key = key;
    best_j = j0 + j;
  }
}

// (a) A warp a row through all L levels, children from L2.
__global__ void __launch_bounds__(kDirectBlock)
descend_direct_kernel(int N, int D4, int B, int L, const float4* __restrict__ x,
                      const float4* __restrict__ levels, int* __restrict__ out) {
  const long long row = ((long long)blockIdx.x * kDirectBlock + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= N) return;  // the whole warp leaves together
  const float4 xv = lane < D4 ? __ldg(x + row * D4 + lane) : zero4();
  long long node = 0, base = 0, level_nodes = 1;
  for (int l = 0; l < L; ++l) {
    const float4* c = levels + (base + node * B) * D4;
    unsigned best_key = kInvalidKey;
    int best_j = 0;
    for (int j0 = 0; j0 < B; j0 += kChunk) {
      const int n = min(kChunk, B - j0);
      if (n > 4)
        eval_chunk<8>(xv, c, j0, n, D4, lane, best_key, best_j);
      else if (n > 2)
        eval_chunk<4>(xv, c, j0, n, D4, lane, best_key, best_j);
      else if (n == 2)
        eval_chunk<2>(xv, c, j0, n, D4, lane, best_key, best_j);
      else
        eval_chunk<1>(xv, c, j0, n, D4, lane, best_key, best_j);
    }
    base += level_nodes * B;
    level_nodes *= B;
    node = node * B + best_j;
  }
  if (lane == 0) out[row] = (int)node;
}

// (b) T(b, m) of one row against one child row c (the tree above), each
// thread alone.
template <int Bb, int M, bool kFullDim>
__device__ __forceinline__ float tree_sum(const float4 (&x)[32], const float4* c, int D4) {
  if constexpr (M == 32) {
    if (!kFullDim && Bb >= D4) return 0.f;
    float4 acc = zero4();
    acc_sq(x[Bb], c[Bb], acc);
    return total(acc);
  } else {
    return tree_sum<Bb, 2 * M, kFullDim>(x, c, D4) + tree_sum<Bb + M, 2 * M, kFullDim>(x, c, D4);
  }
}

struct PassArgs {
  int N, D4, B, k;        // k levels from the pass's first level l0
  int G;                  // groups: the B^l0 nodes of level l0
  long long level_base;   // first row of level l0 in `levels`
  const float4* x;
  const float4* levels;
  const int* order;       // rows by node (first pass: null, rows in order)
  const int* offsets;     // (G + 1) first row of each group in `order`
  const int* items;       // (G + 1) first work item of each group
  int* node;              // out: each row's node at level l0 + k
  int* counts_next;       // rows a node of level l0 + k, or null in the last pass
};

__device__ __forceinline__ void cp_async16(float4* dst, const float4* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s), "l"(src));
}

// (b) One work item: up to kItemRows rows of one group, through the k
// levels of the group's subtree staged in shared memory, a thread a row.
// Level m's nodes (B^m of them) each take B rows and a float4 of padding.
template <bool kFullDim>
__global__ void __launch_bounds__(kPassBlock, kPassBlocksPerSm)
descend_pass_kernel(PassArgs a) {
  extern __shared__ float4 sub[];  // the subtree's rows, then the node counts
  __shared__ int s_item[3];
  if (threadIdx.x == 0) {
    int g = 0, begin = 0, end = 0;
    const int item = blockIdx.x;
    if (a.order == nullptr) {
      begin = item * kItemRows;
      end = min(a.N, begin + kItemRows);
    } else if (item < a.items[a.G]) {
      int lo = 0, hi = a.G;  // items[lo] <= item < items[hi]
      while (hi - lo > 1) {
        const int mid = (lo + hi) >> 1;
        if (a.items[mid] <= item) lo = mid; else hi = mid;
      }
      g = lo;
      begin = a.offsets[g] + (item - a.items[g]) * kItemRows;
      end = min(a.offsets[g + 1], begin + kItemRows);
    }
    s_item[0] = g;
    s_item[1] = begin;
    s_item[2] = end;
  }
  __syncthreads();
  const int g = s_item[0], begin = s_item[1], end = s_item[2];
  if (begin >= end) return;
  const int D4 = a.D4, B = a.B, k = a.k, ns = B * D4 + 1;  // a node's float4s, padded
  // Stage level l0 + m's nodes g B^m .. (g + 1) B^m - 1, m < k.
  int at = 0, nodes = 1;
  long long gbase = a.level_base, level_nodes = a.G;
  for (int m = 0; m < k; ++m) {
    const float4* src = a.levels + (gbase + (long long)g * nodes * B) * D4;
    for (int i = threadIdx.x; i < nodes * B * D4; i += kPassBlock) {
      const int n = i / (B * D4);
      cp_async16(sub + at + n * ns + (i - n * B * D4), src + i);
    }
    at += nodes * ns;
    gbase += level_nodes * B;
    level_nodes *= B;
    nodes *= B;
  }
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;" ::: "memory");
  int* counts = reinterpret_cast<int*>(sub + at);  // nodes = B^k of them
  if (a.counts_next)
    for (int i = threadIdx.x; i < nodes; i += kPassBlock) counts[i] = 0;
  __syncthreads();

  for (int i = begin + threadIdx.x; i < end; i += kPassBlock) {
    const int row = a.order ? a.order[i] : i;
    float4 x[32];
#pragma unroll
    for (int l = 0; l < 32; ++l)
      x[l] = kFullDim || l < D4 ? __ldg(a.x + (long long)row * D4 + l) : zero4();
    int local = 0, off = 0, level = 1;
    for (int m = 0; m < k; ++m) {
      const float4* c = sub + off + local * ns;
      float best = INFINITY;
      int best_j = 0;
      for (int j = 0; j < B; ++j) {
        const float d = tree_sum<0, 1, kFullDim>(x, c + j * D4, D4);
        if (d < best) {
          best = d;
          best_j = j;
        }
      }
      local = local * B + best_j;
      off += level * ns;
      level *= B;
    }
    a.node[row] = g * nodes + local;
    if (a.counts_next) atomicAdd(&counts[local], 1);
  }
  if (a.counts_next) {
    __syncthreads();
    for (int i = threadIdx.x; i < nodes; i += kPassBlock)
      if (counts[i]) atomicAdd(&a.counts_next[g * nodes + i], counts[i]);
  }
}

// Row offsets, cursors and first work items of G groups from their counts.
__global__ void __launch_bounds__(kScanThreads)
descend_scan_kernel(int G, const int* __restrict__ counts, int* __restrict__ offsets,
                    int* __restrict__ cursor, int* __restrict__ items) {
  __shared__ int s_rows[kScanThreads / 32], s_items[kScanThreads / 32];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int per = (G + kScanThreads - 1) / kScanThreads;
  const int lo = min(G, t * per), hi = min(G, lo + per);
  int rows = 0, its = 0;
  for (int i = lo; i < hi; ++i) {
    const int c = counts[i];
    rows += c;
    its += (c + kItemRows - 1) / kItemRows;
  }
  int r_in = rows, i_in = its;  // inclusive scans within the warp
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int ur = __shfl_up_sync(kFull, r_in, o), ui = __shfl_up_sync(kFull, i_in, o);
    if (lane >= o) {
      r_in += ur;
      i_in += ui;
    }
  }
  if (lane == 31) {
    s_rows[warp] = r_in;
    s_items[warp] = i_in;
  }
  __syncthreads();
  int r = r_in - rows, it = i_in - its;
  for (int w = 0; w < warp; ++w) {
    r += s_rows[w];
    it += s_items[w];
  }
  for (int i = lo; i < hi; ++i) {
    const int c = counts[i];
    offsets[i] = r;
    cursor[i] = r;
    items[i] = it;
    r += c;
    it += (c + kItemRows - 1) / kItemRows;
  }
  if (t == kScanThreads - 1) {
    offsets[G] = r;
    items[G] = it;
  }
}

// order[cursor[g]++] = row for each row of node g (ranges reserved a block
// and node at a time).
__global__ void __launch_bounds__(kScatterThreads)
descend_scatter_kernel(int N, int G, const int* __restrict__ node, int* __restrict__ cursor,
                       int* __restrict__ order) {
  extern __shared__ int bins[];  // G counts, then bases, where G <= kScatterBins
  const int begin = blockIdx.x * kScatterRows;
  if (G <= kScatterBins) {
    for (int i = threadIdx.x; i < G; i += kScatterThreads) bins[i] = 0;
    __syncthreads();
    int g[kScatterPerThread], rank[kScatterPerThread];
#pragma unroll
    for (int q = 0; q < kScatterPerThread; ++q) {
      const int row = begin + q * kScatterThreads + threadIdx.x;
      g[q] = row < N ? node[row] : -1;
      rank[q] = g[q] >= 0 ? atomicAdd(&bins[g[q]], 1) : 0;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < G; i += kScatterThreads)
      if (bins[i]) bins[i] = atomicAdd(&cursor[i], bins[i]);
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kScatterPerThread; ++q)
      if (g[q] >= 0) order[bins[g[q]] + rank[q]] = begin + q * kScatterThreads + threadIdx.x;
  } else {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int q = 0; q < kScatterPerThread; ++q) {
      const int row = begin + q * kScatterThreads + threadIdx.x;
      const int g = row < N ? node[row] : -1;
      const unsigned peers = __match_any_sync(kFull, g);
      const int leader = __ffs(peers) - 1;
      int base = 0;
      if (lane == leader && g >= 0) base = atomicAdd(&cursor[g], __popc(peers));
      base = __shfl_sync(kFull, base, leader);
      if (g >= 0) order[base + __popc(peers & ((1u << lane) - 1u))] = row;
    }
  }
}

// Bytes of a pass of k levels: the subtree's rows with 16 bytes of padding
// a node, then B^k counts (kernels/retrieval.py `_pass_smem`).
inline long long pass_smem(int B, int k, int D) {
  long long bytes = 0, nodes = 1;
  for (int m = 0; m < k; ++m) {
    bytes += nodes * ((long long)B * D * 4 + 16);
    nodes *= B;
  }
  return bytes + nodes * 4;
}

inline long long ipow(int b, int e) {
  long long p = 1;
  for (int i = 0; i < e; ++i) p *= b;
  return p;
}

// The sorted passes' workspace: every later pass's counts (zeroed once),
// then `order` (N ints), then each later pass's offsets, cursors and items.
struct Workspace {
  long long counts[64], offsets[64], cursor[64], items[64], order, counts_ints, bytes;
};

inline Workspace workspace(int N, int B, int L, int k) {
  Workspace w{};
  const int passes = (L + k - 1) / k;
  long long at = 0;
  for (int p = 1; p < passes; ++p) {
    w.counts[p] = at;
    at += ipow(B, p * k);
  }
  w.counts_ints = at;
  w.order = at;
  at += N;
  for (int p = 1; p < passes; ++p) {
    const long long G = ipow(B, p * k);
    w.offsets[p] = at;
    at += G + 1;
    w.cursor[p] = at;
    at += G;
    w.items[p] = at;
    at += G + 1;
  }
  w.bytes = at * 4;
  return w;
}

}  // namespace ret
}  // namespace ctt

// Workspace bytes of the sorted passes (k levels a pass; 0 for the direct
// regime).
extern "C" long long retrieval_descend_workspace_bytes(int N, int B, int L, int k) {
  if (k <= 0 || L <= 0) return 0;
  return ctt::ret::workspace(N, B, L, k).bytes;
}

// x (N, D) float32, D = 4 * D4 <= 128; levels (Σ_l B^(l+1), D) float32;
// out (N,) int32 leaf ids. k = 0: the direct regime; k > 0: sorted passes
// of k levels (kernels/retrieval.py `_descend_plan`), with `ws` of
// retrieval_descend_workspace_bytes.
extern "C" int retrieval_descend_f32(int N, int D, int B, int L, int k, const float* x,
                                     const float* levels, int* out, void* ws, void* stream) {
  using namespace ctt::ret;
  cudaStream_t s = (cudaStream_t)stream;
  const int D4 = D / 4;
  if (N <= 0 || L <= 0) return (int)cudaGetLastError();
  if (k <= 0) {
    descend_direct_kernel<<<blocks_for((long long)N * 32, kDirectBlock), kDirectBlock, 0, s>>>(
        N, D4, B, L, reinterpret_cast<const float4*>(x), reinterpret_cast<const float4*>(levels),
        out);
    return (int)cudaGetLastError();
  }
  const int passes = (L + k - 1) / k;
  if (passes >= 64 || pass_smem(B, k, D) + 64 > kMaxSmem) return (int)cudaErrorInvalidValue;
  const Workspace w = workspace(N, B, L, k);
  int* wi = static_cast<int*>(ws);
  if (passes > 1) {
    const cudaError_t e = cudaMemsetAsync(wi, 0, w.counts_ints * 4, s);
    if (e != cudaSuccess) return (int)e;
  }
  long long level_base = 0;
  for (int p = 0; p < passes; ++p) {
    const int l0 = p * k, kp = L - l0 < k ? L - l0 : k;
    const int G = (int)ipow(B, l0);
    PassArgs a{N, D4, B, kp, G, level_base, reinterpret_cast<const float4*>(x),
               reinterpret_cast<const float4*>(levels), nullptr, nullptr, nullptr, out,
               p + 1 < passes ? wi + w.counts[p + 1] : nullptr};
    long long grid = (N + kItemRows - 1) / kItemRows;
    if (p > 0) {
      descend_scan_kernel<<<1, kScanThreads, 0, s>>>(G, wi + w.counts[p], wi + w.offsets[p],
                                                      wi + w.cursor[p], wi + w.items[p]);
      const int bins = G <= kScatterBins ? G * 4 : 0;
      descend_scatter_kernel<<<blocks_for(N, kScatterRows), kScatterThreads, bins, s>>>(
          N, G, out, wi + w.cursor[p], wi + w.order);
      a.order = wi + w.order;
      a.offsets = wi + w.offsets[p];
      a.items = wi + w.items[p];
      grid += G < N ? G : N;  // an upper bound on the items; the rest return
    }
    const long long smem = pass_smem(B, kp, D);
    auto kernel = D4 == 32 ? descend_pass_kernel<true> : descend_pass_kernel<false>;
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
    kernel<<<(unsigned)grid, kPassBlock, (size_t)smem, s>>>(a);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    for (int m = 0; m < kp; ++m) level_base += ipow(B, l0 + m + 1);
  }
  return (int)cudaGetLastError();
}
