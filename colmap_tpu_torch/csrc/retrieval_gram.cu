// K31 retrieval_gram: S = W Wᵀ, the all-pairs bag-of-words similarity.
//
// Replaces colmap_tpu/retrieval/visual_index.py `rank_images_bow`'s jitted
// `w @ w.T` (l.487), a dense GEMM on the MXU.
//
// Function: S[i, j] = Σ_k W[i, k] W[j, k] for W (n, K) float32 row-major,
// the n images' idf-weighted, L2-normalized word histograms.
//
// Bound on the card: the histograms are sparse (about 2000 descriptors an
// image over 32 768 words leave 5.5% of W nonzero). The products S needs,
// Σ_k c_k (c_k + 1) / 2 for the c_k images that hold word k, are under 1% of
// a dense product's, so reading W once (131 MB) and writing S once bound it.
// A dense kernel multiplies every zero and cannot come near that.
//
// Design: an inverted file, COLMAP's own way to score bags of words.
// (1) gram_count reads W in tiles of 32 rows x 256 columns, coalesced along
//     k: the nonzeros of each (row chunk, column) and (column strip, row),
//     and the largest |w|. gram_prefix and gram_scan (one block) turn them
//     into offsets, and choose the regime and the scale 2^F on the card.
// (2) gram_fill reads W again and writes every nonzero at its rank: word
//     k's list of (i, w_ik) in ascending i, and row i's list of (where i
//     stands in word k's list, where that list ends). No atomics: the
//     layout is the same in every run.
// (3) gram_sparse: one block of 32 warps a row i (and a tile of 4096 j
//     when n exceeds it) keeps an int64 accumulator for every j >= i in
//     shared memory. For each word of row i it walks that word's list from
//     i's own entry on (j >= i, ascending) and adds w_ik w_jk, the lanes of
//     a warp on neighbouring entries of 32 words' lists laid end to end. A
//     product of two floats is exact in float64; scaled by 2^F and rounded
//     to an integer, it is added with integer atomics, whose sums do not
//     depend on the order. The block writes S[i, j] and S[j, i] from the
//     same sum: S is exactly symmetric, two runs give the same bits, and
//     each entry is its float64-exact value rounded twice (to 2^-F, then to
//     float32). F is the largest with r m² 2^F < 2^61, for m = max |w| and
//     r the most nonzeros of a row: |S[i, j]| <= r m² by Cauchy-Schwarz
//     over row i's words, so no sum overflows. m and r are integer maxima,
//     so F is the same in every run (a float row norm summed by atomics
//     would not be). Each product reads its 8-byte list entry from L2
//     (the lists, 14 MB, stay there): on the tree's W that is 1.26 GB for
//     its 1.57e8 products, what bounds this design.
// (4) The dense regime: `vocab_tree_pairs`' W (1000 x 256) is nearly all
//     nonzero, where the inverted file does the dense work with a list read
//     and a shared atomic a product. gram_scan picks the sparse kernels only
//     where they do at most 1/32 of the dense kernel's products
//     (32 Σ_k c_k (c_k + 1) <= n (n + 1) K: about a sixth of W nonzero or
//     less, spread evenly). Then nnz² <= K Σ_k c_k² keeps the lists below
//     n K / 4 + 1 entries. Their capacity is that, or kCapMax (just below
//     2^31, for int offsets) where n K / 4 is larger; gram_scan counts nnz
//     in 64 bits and takes the sparse kernels only where it fits, so a W
//     of any size runs (a larger one dense). The lists take 16 bytes an
//     entry: the workspace is about 4 n K bytes, W's own size, up to 32 GiB.
//     Otherwise gram_dense runs: a 32 x 32 tile of S over the upper
//     triangle, its K split four ways across 256 threads and summed in a
//     fixed order, each thread a 4 x 4 patch of float32 FMAs in k order,
//     added every 128 k of its own into a float64 sum in shared memory (a
//     float32 sum over all of K drifts by ~sqrt(K) ulps: 1e-5 of S is lost
//     by K = 2^20; kept in registers, the float64 sums made a 1000 x 256
//     W's call 1.6x as long on an H100); the block writes the tile and its
//     mirror, so S is exactly symmetric and the same in every run there
//     too. All five kernels are launched; those of the other regime return
//     at once. The host reads nothing. A W whose
//     whole dense product is at most 2^27 FMAs (vocab_tree_pairs' 1000 x 256
//     of its default 256 words) goes to gram_dense alone, by its shape: the
//     count, prefix and scan that would choose cost ~0.015 ms on an H100,
//     about what the dense kernel takes for 2^27 FMAs there (0.021-0.026
//     ms for 1.28e8), so the choice cannot pay for itself.
#include <cuda_runtime.h>

#include <algorithm>
#include <climits>
#include <cmath>

#include "retrieval_common.cuh"

namespace ctt {
namespace ret {

constexpr int kStrip = 256;        // columns of a gram_count / gram_fill block (one a thread)
constexpr int kChunk = 32;         // rows of a gram_count / gram_fill block
constexpr int kScanThreads = 1024;
constexpr int kSparseWarps = 32;   // a block of gram_sparse
constexpr int kSparseThreads = 32 * kSparseWarps;
constexpr int kSparsePer = 2;      // products a lane a step (loads in flight)
constexpr int kTileJ = 4096;       // j of a block's shared accumulator (32 KB)
constexpr int kSparseBound = 61;   // r m² 2^F < 2^kSparseBound
constexpr unsigned long long kDenseRatio = 32;  // sparse iff its products <= 1/32 of the dense ones
constexpr unsigned long long kDenseOnly = 1ull << 27;  // n (n + 1) K / 2 FMAs: dense by shape
constexpr long long kCapMax = INT_MAX - kSparseThreads;  // entries of the lists, int-indexed

constexpr int kGramTile = 32;
constexpr int kGramStep = 32;
constexpr int kGramSplit = 4;      // k of a step split across four thread groups
constexpr int kGramGroup = 64;     // threads of a group: 8 x 8, a 4 x 4 patch each
constexpr int kGramThreads = kGramSplit * kGramGroup;
constexpr int kGramPad = kGramTile + 4;  // rows stay 16-byte aligned for float4 reads
constexpr int kGramFlush = 16;     // steps a float32 sum spans before its float64 add

struct GramParams {
  unsigned int maxabs_bits;  // max |w| as float bits (non-negative floats order as their bits)
  int sparse;                // 1: the inverted file; 0: the dense kernel
  double scale, inv_scale;   // 2^F, 2^-F
};

struct __align__(8) Entry {  // an entry of word k's list: image i and w_ik
  int i;
  float w;
};

__device__ __forceinline__ unsigned lanemask_lt() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

// (1) Counts of a 32 x 256 tile: colcnt[c][k], rowcnt[s][i], max |w|.
__global__ void __launch_bounds__(kStrip)
gram_count(int n, int K, const float* __restrict__ w, int* __restrict__ colcnt,
           int* __restrict__ rowcnt, GramParams* __restrict__ prm) {
  __shared__ int rc[kChunk];
  __shared__ unsigned smax;
  const int s = blockIdx.x, c = blockIdx.y, lane = threadIdx.x & 31;
  const int k = s * kStrip + threadIdx.x, r0 = c * kChunk, rows = min(kChunk, n - r0);
  if (threadIdx.x < kChunk) rc[threadIdx.x] = 0;
  if (threadIdx.x == 0) smax = 0u;
  __syncthreads();
  int cnt = 0;
  unsigned m = 0u;
  for (int r = 0; r < rows; r += 8) {
    float v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u)
      v[u] = (k < K && r + u < rows) ? __ldg(w + (size_t)(r0 + r + u) * K + k) : 0.f;
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const bool nz = v[u] != 0.f;
      cnt += nz;
      if (nz) m = max(m, __float_as_uint(fabsf(v[u])));
      const unsigned mask = __ballot_sync(0xffffffffu, nz);
      if (lane == 0 && mask) atomicAdd(&rc[r + u], __popc(mask));
    }
  }
  m = __reduce_max_sync(0xffffffffu, m);
  if (lane == 0 && m) atomicMax(&smax, m);
  if (k < K) colcnt[(size_t)c * K + k] = cnt;
  __syncthreads();
  if (threadIdx.x < rows) rowcnt[(size_t)s * n + r0 + threadIdx.x] = rc[threadIdx.x];
  if (threadIdx.x == 0 && smax) atomicMax(&prm->maxabs_bits, smax);
}

// x[0], x[stride], ... (m values) become their exclusive prefix; returns
// their sum. Loads go eight at a time, so that they overlap.
__device__ int prefix_in_place(int* __restrict__ x, size_t stride, int m) {
  int sum = 0;
  for (int c0 = 0; c0 < m; c0 += 8) {
    int v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) v[u] = c0 + u < m ? x[(c0 + u) * stride] : 0;
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      if (c0 + u < m) x[(c0 + u) * stride] = sum;
      sum += v[u];
    }
  }
  return sum;
}

// Each column's counts over the chunks and each row's over the strips become
// exclusive prefixes in place; coltot and rowtot get the totals.
__global__ void __launch_bounds__(256)
gram_prefix(int n, int K, int chunks, int strips, int* __restrict__ colcnt,
            int* __restrict__ rowcnt, int* __restrict__ coltot, int* __restrict__ rowtot) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t < K) {
    coltot[t] = prefix_in_place(colcnt + t, K, chunks);
  } else if (t < (long long)K + n) {
    rowtot[t - K] = prefix_in_place(rowcnt + (t - K), n, strips);
  }
}

// Exclusive scan of v over the block; *total gets the block's sum. The
// sums wrap modulo 2^32 (offsets are used only where nnz fits an int).
__device__ unsigned block_scan(unsigned v, unsigned* total) {
  __shared__ unsigned warp_sum[kScanThreads / 32];
  __shared__ unsigned sum_all;
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  unsigned x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sum[wid] = x;
  __syncthreads();
  if (wid == 0) {
    const unsigned t = lane < (int)(blockDim.x >> 5) ? warp_sum[lane] : 0u;
    unsigned u = t;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned y = __shfl_up_sync(0xffffffffu, u, o);
      if (lane >= o) u += y;
    }
    warp_sum[lane] = u - t;
    if (lane == 31) sum_all = u;
  }
  __syncthreads();
  const unsigned out = x - v + warp_sum[wid];
  *total = sum_all;
  __syncthreads();
  return out;
}

// (1, one block) col_off (K + 1) and row_off (n + 1) from the totals; the
// work, the regime and the scale.
__global__ void __launch_bounds__(kScanThreads)
gram_scan(int n, int K, long long cap, const int* __restrict__ coltot,
          const int* __restrict__ rowtot, int* __restrict__ col_off, int* __restrict__ row_off,
          GramParams* __restrict__ prm) {
  __shared__ unsigned long long work_s, nnz_s;
  __shared__ int rmax_s;
  if (threadIdx.x == 0) {
    work_s = 0ull;
    nnz_s = 0ull;
    rmax_s = 0;
  }
  __syncthreads();
  // Tiles of 4 x 1024 entries, four consecutive ones a thread, each tile
  // one block scan, its total carried into the next.
  unsigned long long work = 0ull, nnz = 0ull;
  unsigned carry = 0u, total;
  int rmax = 0;
  for (int k0 = 0; k0 < K; k0 += 4 * kScanThreads) {
    const int kb = k0 + 4 * threadIdx.x;
    unsigned v[4], sum = 0u;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      v[u] = kb + u < K ? (unsigned)coltot[kb + u] : 0u;
      work += (unsigned long long)v[u] * (unsigned long long)(v[u] + 1);
      nnz += v[u];
      sum += v[u];
    }
    unsigned at = carry + block_scan(sum, &total);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (kb + u < K) col_off[kb + u] = (int)at;
      at += v[u];
    }
    carry += total;
  }
  if (threadIdx.x == 0) col_off[K] = (int)carry;
  carry = 0u;
  for (int i0 = 0; i0 < n; i0 += 4 * kScanThreads) {
    const int ib = i0 + 4 * threadIdx.x;
    unsigned v[4], sum = 0u;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      v[u] = ib + u < n ? (unsigned)rowtot[ib + u] : 0u;
      rmax = max(rmax, (int)v[u]);
      sum += v[u];
    }
    unsigned at = carry + block_scan(sum, &total);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (ib + u < n) row_off[ib + u] = (int)at;
      at += v[u];
    }
    carry += total;
  }
  if (threadIdx.x == 0) row_off[n] = (int)carry;
  for (int o = 16; o > 0; o >>= 1) {
    work += __shfl_down_sync(0xffffffffu, work, o);
    nnz += __shfl_down_sync(0xffffffffu, nnz, o);
  }
  rmax = __reduce_max_sync(0xffffffffu, rmax);
  if ((threadIdx.x & 31) == 0) {
    atomicAdd(&work_s, work);
    atomicAdd(&nnz_s, nnz);
    atomicMax(&rmax_s, rmax);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const double m = (double)__uint_as_float(prm->maxabs_bits);
    const double bound = (double)rmax_s * m * m;
    int e = 0;
    if (bound > 0.0) frexp(bound, &e);  // bound < 2^e
    const int F = bound > 0.0 ? kSparseBound - e : 0;
    prm->scale = ldexp(1.0, F);
    prm->inv_scale = ldexp(1.0, -F);
    const unsigned long long dense = (unsigned long long)n * (unsigned long long)(n + 1) * K;
    prm->sparse = (kDenseRatio * work_s <= dense && nnz_s <= (unsigned long long)cap) ? 1 : 0;
  }
}

// (2) Every nonzero of a 32 x 256 tile at its rank in its word's list and
// in its row's list.
__global__ void __launch_bounds__(kStrip)
gram_fill(int n, int K, const float* __restrict__ w, const int* __restrict__ colpre,
          const int* __restrict__ rowpre, const int* __restrict__ col_off,
          const int* __restrict__ row_off, const GramParams* __restrict__ prm,
          Entry* __restrict__ cols, int2* __restrict__ rowl) {
  if (!prm->sparse) return;
  __shared__ unsigned masks[kChunk][kStrip / 32];
  __shared__ int wbase[kChunk][kStrip / 32];  // where a warp's part of a row's list begins
  const int s = blockIdx.x, c = blockIdx.y, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int k = s * kStrip + threadIdx.x, r0 = c * kChunk, rows = min(kChunk, n - r0);
  float v[kChunk];  // the thread's column of the tile, kept for the writes
#pragma unroll
  for (int r = 0; r < kChunk; ++r)
    v[r] = (k < K && r < rows) ? __ldg(w + (size_t)(r0 + r) * K + k) : 0.f;
#pragma unroll
  for (int r = 0; r < kChunk; ++r) {
    const unsigned mask = __ballot_sync(0xffffffffu, v[r] != 0.f);
    if (lane == 0) masks[r][warp] = mask;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < rows * (kStrip / 32); e += kStrip) {
    const int r = e / (kStrip / 32), q = e % (kStrip / 32);
    int at = row_off[r0 + r] + rowpre[(size_t)s * n + r0 + r];
    for (int p = 0; p < q; ++p) at += __popc(masks[r][p]);
    wbase[r][q] = at;
  }
  __syncthreads();
  if (k >= K) return;
  int pos = col_off[k] + colpre[(size_t)c * K + k];
  const int end = col_off[k + 1];
  const unsigned below = lanemask_lt();
  // Row by row, so that a warp's lanes write neighbouring places of a row's
  // list together.
#pragma unroll
  for (int r = 0; r < kChunk; ++r) {
    if (v[r] == 0.f) continue;
    cols[pos] = Entry{r0 + r, v[r]};
    rowl[wbase[r][warp] + __popc(masks[r][warp] & below)] = make_int2(pos, end);
    ++pos;
  }
}

// First q in [q0, q1) of an ascending list with cols[q].i >= j.
__device__ __forceinline__ int lower_bound(const Entry* __restrict__ cols, int q0, int q1, int j) {
  while (q0 < q1) {
    const int mid = q0 + ((q1 - q0) >> 1);
    if (cols[mid].i < j) q0 = mid + 1;
    else q1 = mid;
  }
  return q0;
}

// (3) Row i of S for j in this block's tile, j >= i, and its mirror.
__global__ void __launch_bounds__(kSparseThreads)
gram_sparse(int n, const Entry* __restrict__ cols, const int2* __restrict__ rowl,
            const int* __restrict__ row_off, const GramParams* __restrict__ prm,
            float* __restrict__ s) {
  if (!prm->sparse) return;
  extern __shared__ unsigned accs[];
  __shared__ int part_start[kSparseWarps][33], part_q0[kSparseWarps][32];
  __shared__ float part_w[kSparseWarps][32];
  const int i = blockIdx.x;
  const int lo = max(i, (int)blockIdx.y * kTileJ), hi = min(n, ((int)blockIdx.y + 1) * kTileJ);
  if (lo >= hi) return;
  const int span = hi - lo;
  for (int j = threadIdx.x; j < 2 * span; j += kSparseThreads) accs[j] = 0u;
  __syncthreads();
  const double scale = prm->scale;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // The int64 sums as two 32-bit words, each added with a native 32-bit
  // shared atomic (a 64-bit one is a compare-and-swap loop): the low word
  // wraps, and the add that wraps it sees so in its return value and
  // carries one into the high word.
  unsigned* acc_lo = accs;
  int* acc_hi = reinterpret_cast<int*>(accs + span);
  int* start = part_start[warp];
  const int e1 = row_off[i + 1];
  // A warp takes 32 of row i's words at a time, a word a lane: its part of
  // the word's list, [q0, q1). The lanes then walk the 32 parts laid end to
  // end, products f = lane, lane + 32, ...: every lane busy, neighbouring
  // lanes on neighbouring entries, kSparsePer loads in flight a lane. A lane's
  // part index t only grows, so it follows f by the parts' starts.
  for (int e0 = row_off[i] + 32 * warp; e0 < e1; e0 += kSparseThreads) {
    const int e = e0 + lane;
    int q0 = 0, q1 = 0;
    float aw = 0.f;
    if (e < e1) {
      const int2 pe = rowl[e];  // i's own entry in word k's list, and that list's end
      aw = cols[pe.x].w;
      q0 = lo == i ? pe.x : lower_bound(cols, pe.x, pe.y, lo);
      q1 = hi == n ? pe.y : lower_bound(cols, q0, pe.y, hi);
    }
    const int len = q1 - q0;
    int incl = len;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += y;
    }
    const int total = __shfl_sync(0xffffffffu, incl, 31);
    start[lane] = incl - len;
    if (lane == 31) start[32] = total;
    part_q0[warp][lane] = q0;
    part_w[warp][lane] = aw;
    __syncwarp();
    int t = 0;
    for (int f0 = lane; f0 < total; f0 += kSparsePer * 32) {
      int q[kSparsePer];
      float a[kSparsePer];
#pragma unroll
      for (int u = 0; u < kSparsePer; ++u) {
        const int f = f0 + 32 * u;
        q[u] = -1;
        a[u] = 0.f;
        if (f < total) {
          while (start[t + 1] <= f) ++t;
          q[u] = part_q0[warp][t] + f - start[t];
          a[u] = part_w[warp][t];
        }
      }
      Entry b[kSparsePer];
#pragma unroll
      for (int u = 0; u < kSparsePer; ++u)
        if (q[u] >= 0) b[u] = cols[q[u]];
#pragma unroll
      for (int u = 0; u < kSparsePer; ++u) {
        if (q[u] < 0) continue;
        const long long v = __double2ll_rn((double)a[u] * (double)b[u].w * scale);
        const unsigned low = (unsigned)v;
        const unsigned old = atomicAdd(&acc_lo[b[u].i - lo], low);
        const int high = (int)(v >> 32) + (old + low < old ? 1 : 0);
        if (high) atomicAdd(&acc_hi[b[u].i - lo], high);
      }
    }
    __syncwarp();
  }
  __syncthreads();
  const double inv = prm->inv_scale;
  for (int j = lo + threadIdx.x; j < hi; j += kSparseThreads) {
    const unsigned long long sum =
        ((unsigned long long)(long long)acc_hi[j - lo] << 32) + acc_lo[j - lo];
    const float v = (float)((double)(long long)sum * inv);
    s[(size_t)i * n + j] = v;
    if (j != i) s[(size_t)j * n + i] = v;
  }
}

// (4) The dense regime: a 32 x 32 tile of S on or above the diagonal.
__global__ void __launch_bounds__(kGramThreads)
gram_dense(int n, int K, int tiles, const float* __restrict__ w,
           const GramParams* __restrict__ prm, float* __restrict__ s) {
  if (prm != nullptr && prm->sparse) return;
  __shared__ __align__(16) float a[kGramStep][kGramPad];
  __shared__ __align__(16) float b[kGramStep][kGramPad];
  __shared__ double sum64[kGramSplit][16][kGramGroup];  // a thread's patch, lanes adjacent
  __shared__ float out[kGramTile][kGramTile + 1];
  // Tile pair (ti, tj), ti <= tj, of this block: blocks run row by row over
  // the upper triangle of the tiles.
  int t = blockIdx.x, ti = 0;
  while (t >= tiles - ti) {
    t -= tiles - ti;
    ++ti;
  }
  const int tj = ti + t;
  const int i0 = ti * kGramTile, j0 = tj * kGramTile;
  const int g = threadIdx.x / kGramGroup, lt = threadIdx.x % kGramGroup;
  const int tx = lt & 7, ty = lt >> 3;
  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      acc[r][c] = 0.f;
      sum64[g][4 * r + c][lt] = 0.0;
    }
  auto flush = [&]() {
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        sum64[g][4 * r + c][lt] += (double)acc[r][c];
        acc[r][c] = 0.f;
      }
  };
  // Each thread loads 4 + 4 of a step's values into registers, the next
  // step's before this step's products, so that the loads overlap them.
  constexpr int kPer = kGramTile * kGramStep / kGramThreads;
  float ra[kPer], rb[kPer];
  auto load = [&](int k0) {
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int e = threadIdx.x + kGramThreads * u, r = e / kGramStep, k = k0 + e % kGramStep;
      ra[u] = (k < K && i0 + r < n) ? __ldg(w + (size_t)(i0 + r) * K + k) : 0.f;
      rb[u] = (k < K && j0 + r < n) ? __ldg(w + (size_t)(j0 + r) * K + k) : 0.f;
    }
  };
  load(0);
  for (int k0 = 0; k0 < K; k0 += kGramStep) {
    __syncthreads();
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int e = threadIdx.x + kGramThreads * u, r = e / kGramStep, kk = e % kGramStep;
      a[kk][r] = ra[u];
      b[kk][r] = rb[u];
    }
    __syncthreads();
    if (k0 + kGramStep < K) load(k0 + kGramStep);
    // Group g takes k0 + 8 g .. k0 + 8 g + 7 of the step.
#pragma unroll
    for (int u = 0; u < kGramStep / kGramSplit; ++u) {
      const int kk = g * (kGramStep / kGramSplit) + u;
      const float4 av = *reinterpret_cast<const float4*>(&a[kk][4 * ty]);
      const float4 bv = *reinterpret_cast<const float4*>(&b[kk][4 * tx]);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(ar[r], br[c], acc[r][c]);
    }
    if ((k0 / kGramStep) % kGramFlush == kGramFlush - 1) flush();
  }
  flush();
  __syncthreads();
  if (g == 0) {
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        double v = sum64[0][4 * r + c][lt];
#pragma unroll
        for (int q = 1; q < kGramSplit; ++q) v += sum64[q][4 * r + c][lt];
        out[4 * ty + r][4 * tx + c] = (float)v;
      }
  }
  __syncthreads();
  // The tile and its mirror, each written along its rows.
  for (int e = threadIdx.x; e < kGramTile * kGramTile; e += kGramThreads) {
    const int r = e / kGramTile, c = e % kGramTile;
    if (i0 + r < n && j0 + c < n) s[(size_t)(i0 + r) * n + j0 + c] = out[r][c];
    if (ti != tj && j0 + r < n && i0 + c < n) s[(size_t)(j0 + r) * n + i0 + c] = out[c][r];
  }
}

// The workspace, carved in 256-byte aligned pieces.
struct GramLayout {
  size_t params, colcnt, rowcnt, coltot, rowtot, col_off, row_off, cols, rowl, total;
  long long cap;
  int chunks, strips;
};

inline size_t align256(size_t x) { return (x + 255) & ~(size_t)255; }

inline bool dense_only(int n, int K) {
  return (unsigned long long)n * (unsigned long long)(n + 1) * K / 2 <= kDenseOnly;
}

inline GramLayout gram_layout(int n, int K) {
  GramLayout L;
  L.chunks = blocks_for(n, kChunk);
  L.strips = blocks_for(K, kStrip);
  L.cap = std::min((long long)n * K / 4 + 1, kCapMax);
  size_t off = 0;
  auto take = [&](size_t bytes) {
    const size_t at = off;
    off = align256(off + bytes);
    return at;
  };
  L.params = take(sizeof(GramParams));
  L.colcnt = take(sizeof(int) * (size_t)L.chunks * K);
  L.rowcnt = take(sizeof(int) * (size_t)L.strips * n);
  L.coltot = take(sizeof(int) * (size_t)K);
  L.rowtot = take(sizeof(int) * (size_t)n);
  L.col_off = take(sizeof(int) * ((size_t)K + 1));
  L.row_off = take(sizeof(int) * ((size_t)n + 1));
  L.cols = take(sizeof(Entry) * (size_t)L.cap);
  L.rowl = take(sizeof(int2) * (size_t)L.cap);
  L.total = off;
  return L;
}

}  // namespace ret
}  // namespace ctt

// Bytes of the workspace retrieval_gram_f32 takes for W (n, K).
extern "C" long long retrieval_gram_workspace_bytes(int n, int K) {
  using namespace ctt::ret;
  return dense_only(n, K) ? 0 : (long long)gram_layout(n, K).total;
}

// w (n, K) float32 row-major; s (n, n) float32; ws the
// workspace (retrieval_gram_workspace_bytes; none for a W dense by shape).
// Launches the five kernels on the stream (gram_dense alone for a W dense by
// shape) and returns cudaGetLastError().
extern "C" int retrieval_gram_f32(int n, int K, const float* w, float* s, void* ws,
                                  void* stream) {
  using namespace ctt::ret;
  if (n <= 0) return (int)cudaGetLastError();
  const cudaStream_t st = (cudaStream_t)stream;
  const int tiles = blocks_for(n, kGramTile);
  if (dense_only(n, K)) {
    gram_dense<<<tiles * (tiles + 1) / 2, kGramThreads, 0, st>>>(n, K, tiles, w, nullptr, s);
    return (int)cudaGetLastError();
  }
  const GramLayout L = gram_layout(n, K);
  char* base = static_cast<char*>(ws);
  auto* prm = reinterpret_cast<GramParams*>(base + L.params);
  int* colcnt = reinterpret_cast<int*>(base + L.colcnt);
  int* rowcnt = reinterpret_cast<int*>(base + L.rowcnt);
  int* coltot = reinterpret_cast<int*>(base + L.coltot);
  int* rowtot = reinterpret_cast<int*>(base + L.rowtot);
  int* col_off = reinterpret_cast<int*>(base + L.col_off);
  int* row_off = reinterpret_cast<int*>(base + L.row_off);
  auto* cols = reinterpret_cast<Entry*>(base + L.cols);
  auto* rowl = reinterpret_cast<int2*>(base + L.rowl);
  cudaError_t err = cudaMemsetAsync(prm, 0, sizeof(GramParams), st);
  if (err != cudaSuccess) return (int)err;
  const dim3 tiles_grid(L.strips, L.chunks);
  // K = 0: no strips, so every row total is 0 and S is 0.
  if (K > 0) gram_count<<<tiles_grid, kStrip, 0, st>>>(n, K, w, colcnt, rowcnt, prm);
  gram_prefix<<<blocks_for((long long)K + n, 256), 256, 0, st>>>(n, K, L.chunks, L.strips, colcnt,
                                                                   rowcnt, coltot, rowtot);
  gram_scan<<<1, kScanThreads, 0, st>>>(n, K, L.cap, coltot, rowtot, col_off, row_off, prm);
  if (K > 0) {
    gram_fill<<<tiles_grid, kStrip, 0, st>>>(n, K, w, colcnt, rowcnt, col_off, row_off, prm, cols,
                                             rowl);
  }
  const int jt = blocks_for(n, kTileJ);
  const int sparse_smem = (int)(sizeof(unsigned long long) * (size_t)min(n, kTileJ));
  gram_sparse<<<dim3(n, jt), kSparseThreads, sparse_smem, st>>>(n, cols, rowl, row_off, prm, s);
  gram_dense<<<tiles * (tiles + 1) / 2, kGramThreads, 0, st>>>(n, K, tiles, w, prm, s);
  return (int)cudaGetLastError();
}
