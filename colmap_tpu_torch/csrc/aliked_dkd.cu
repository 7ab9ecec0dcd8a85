// K51 aliked_dkd: ALIKED's keypoint detection on the score map.
//
// Replaces colmap_tpu/feature/aliked.py _nms_keypoints (l.141-176): a
// (2r + 1)^2 max filter with -inf outside the image (reduce_window SAME),
// peaks where score >= pooled and score > threshold, lax.top_k of K, and a
// (2r + 1)^2 soft-argmax refinement (softmax(20 w), clipped indices), the
// refined position clipped to the image.
//
// Bound on the card: bytes. The score map is read once (28 MB at 3072 x
// 2304) and the K keys, positions and scores written: ~8.5 us at 3.35 TB/s.
// What stands between a kernel and that bound is the selection: the
// candidates (every local maximum above the threshold) far outnumber the K
// kept, and a device-wide sort of them, or a host read of their count in
// the middle of the pipeline, costs more than the peak test.
//
// Design: every step on the card, launched by one C entry; the wrapper
// reads the selected count once, after the last launch.
// (a) dkd_peaks: a block loads its 32 x 32 output tile and a halo of
//     kMaxRadius into shared memory once, coalesced, takes the separable
//     (2r + 1)^2 max (rows, then columns; -inf outside the image) and tests
//     score >= pooled & score > threshold. It appends its candidates' keys
//     (0x7FFFFFFF - bits(score)) << 32 | flat index with one atomicAdd a
//     block, and histograms their first byte (bits 63-56) in shared memory
//     (one atomic a warp for each distinct byte: the keys of a bin often
//     share the next byte, and atomics on one address serialise), merged
//     into the global histogram with integer atomics. Scores are
//     sigmoid outputs, non-negative, so their bits order as the floats do,
//     and the keys are unique: ascending key order is lax.top_k's order
//     (score descending, index ascending on ties, the plateau's case),
//     whatever order the candidates were appended in.
// (b) dkd_select, bytes 1-7: an MSB-first radix select of the K-th smallest
//     key. Every block resolves the previous byte's histogram into the bin
//     that holds the K-th key (the same on every block; block 0 keeps it)
//     and histograms the next byte of the keys in that bin. The candidates
//     stay in L2 (8 bytes each). When a bin holds exactly the keys still
//     wanted, or there are <= K candidates, the threshold is known and the
//     remaining passes return at once.
// (c) dkd_compact keeps the keys <= the threshold: exactly min(K,
//     candidates), in no particular order; a block counts its share of the
//     candidates first and takes its place in the output with one atomic.
// (d) dkd_sort: a block sorts a run of up to 2048 keys in shared memory
//     (bitonic, a pair a thread a stage); dkd_merge merges the runs
//     pairwise, each key written at its index plus its rank in the other
//     run (a binary search; the keys are unique). One block on 8192 keys
//     would be bound by its one SM's shared memory (91 stages of 64 KB); at
//     K = 8192 four blocks sort and two merges follow.
// (e) dkd_refine: one thread a selected keypoint: the window's softmax
//     weights as jax.nn.softmax forms them (exp(x - max) / sum), then
//     sum(w * offset) in the window's row-major order.
#include <cuda_runtime.h>

namespace ctt {
namespace aliked_dkd {

typedef unsigned long long u64;

constexpr int kMaxRadius = 3;
constexpr int kTile = 32;                      // output tile of dkd_peaks
constexpr int kIn = kTile + 2 * kMaxRadius;    // with its halo
constexpr int kPeakThreads = 256;              // 32 x 8, four rows a thread
constexpr int kSelectThreads = 256;
constexpr int kSelectBlocks = 1056;            // eight a streaming multiprocessor
constexpr int kSelectPer = 4;                  // keys a thread a step
constexpr int kSelectStep = kSelectThreads * kSelectPer;
constexpr int kSortN = 2048;                   // keys a sort block (16 KB), a pair a thread
constexpr int kSortThreads = 1024;
constexpr int kMergeThreads = 256;
constexpr int kRefineThreads = 128;

struct SelState {
  u64 prefix;  // the bytes of the K-th key found so far
  u64 thresh;  // once done: keep the keys <= thresh
  int krem;    // rank of the K-th key among the keys that share prefix's bytes
  int done;
};

struct Ctrl {
  int count;  // candidates
  int nsel;   // selected
  unsigned hist[8][256];
  SelState st[8];  // st[d]: after byte d's histogram is resolved
};

// Resolves byte d's histogram into the bin of the K-th key; one full warp.
__device__ void resolve(SelState& s, const unsigned* __restrict__ hist, int d) {
  if (s.done) return;
  const int lane = threadIdx.x & 31;
  unsigned c[8], sum = 0u;
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    c[u] = hist[lane * 8 + u];
    sum += c[u];
  }
  unsigned incl = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  const unsigned want = (unsigned)s.krem;
  const int owner = __ffs(__ballot_sync(0xffffffffu, incl >= want)) - 1;
  int bin = 0;
  unsigned before = 0u, inbin = 0u;
  if (lane == owner) {
    unsigned cum = incl - sum;
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      if (inbin == 0u && cum + c[u] >= want) {
        bin = lane * 8 + u;
        before = cum;
        inbin = c[u];
      }
      cum += c[u];
    }
  }
  bin = __shfl_sync(0xffffffffu, bin, owner);
  before = __shfl_sync(0xffffffffu, before, owner);
  inbin = __shfl_sync(0xffffffffu, inbin, owner);
  const int shift = 56 - 8 * d;
  s.prefix |= (u64)bin << shift;
  s.krem = (int)(want - before);
  if (inbin == (unsigned)s.krem) {
    s.done = 1;
    s.thresh = s.prefix | ((1ull << shift) - 1ull);
  }
}

// hist[digit] += 1 for the lanes of a warp with `in`, one atomic for each
// distinct digit: the keys of a bin often share the next byte.
__device__ __forceinline__ void add_to_hist(unsigned* hist, bool in, unsigned digit) {
  const unsigned peers = __match_any_sync(0xffffffffu, in ? digit : 256u);
  if (in && (threadIdx.x & 31) == (unsigned)(__ffs(peers) - 1))
    atomicAdd(&hist[digit], (unsigned)__popc(peers));
}

__device__ __forceinline__ SelState initial(int count, int K) {
  SelState s;
  s.prefix = 0ull;
  s.krem = K;
  s.done = count <= K;
  s.thresh = ~0ull;
  return s;
}

__global__ void __launch_bounds__(kPeakThreads)
dkd_peaks(int h, int w, int r, float threshold, const float* __restrict__ score,
          u64* __restrict__ keys, Ctrl* __restrict__ ctrl) {
  __shared__ float tile[kIn][kIn + 1];
  __shared__ float hmax[kIn][kTile + 1];
  __shared__ unsigned hist[256];
  __shared__ int warp_count[kPeakThreads / 32];
  __shared__ int block_base;
  const int x0 = blockIdx.x * kTile, y0 = blockIdx.y * kTile;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  constexpr int kLoads = (kIn * kIn + kPeakThreads - 1) / kPeakThreads;
  float v[kLoads];  // all of a thread's loads first, so that they overlap
#pragma unroll
  for (int u = 0; u < kLoads; ++u) {
    const int e = tid + kPeakThreads * u, ty = e / kIn, tx = e % kIn;
    const int y = y0 + ty - kMaxRadius, x = x0 + tx - kMaxRadius;
    v[u] = (e < kIn * kIn && y >= 0 && y < h && x >= 0 && x < w)
               ? __ldg(score + (size_t)y * w + x) : -INFINITY;
  }
#pragma unroll
  for (int u = 0; u < kLoads; ++u) {
    const int e = tid + kPeakThreads * u;
    if (e < kIn * kIn) tile[e / kIn][e % kIn] = v[u];
  }
  hist[tid] = 0u;
  __syncthreads();
  for (int e = tid; e < kIn * kTile; e += kPeakThreads) {
    const int ty = e / kTile, tx = e % kTile;
    float m = -INFINITY;
    for (int d = -r; d <= r; ++d) m = fmaxf(m, tile[ty][tx + kMaxRadius + d]);
    hmax[ty][tx] = m;
  }
  __syncthreads();
  // Thread (lane, warp) tests column lane of rows warp, warp + 8, +16, +24.
  bool cand[4];
  float sv[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int ty = warp + 8 * q, y = y0 + ty, x = x0 + lane;
    const float s = tile[ty + kMaxRadius][lane + kMaxRadius];
    float m = -INFINITY;
    for (int d = -r; d <= r; ++d) m = fmaxf(m, hmax[ty + kMaxRadius + d][lane]);
    sv[q] = s;
    cand[q] = y < h && x < w && s >= m && s > threshold;
  }
  // The block's candidates: a warp's, row q after row q - 1, each row's in
  // lane order (neighbouring lanes write neighbouring keys); the warps'
  // parts one after another.
  unsigned masks[4];
  int warp_total = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    masks[q] = __ballot_sync(0xffffffffu, cand[q]);
    warp_total += __popc(masks[q]);
  }
  if (lane == 0) warp_count[warp] = warp_total;
  __syncthreads();
  if (tid == 0) {
    int total = 0;
    for (int q = 0; q < kPeakThreads / 32; ++q) {
      const int c = warp_count[q];
      warp_count[q] = total;
      total += c;
    }
    block_base = total ? atomicAdd(&ctrl->count, total) : 0;
  }
  __syncthreads();
  int pos = block_base + warp_count[warp];
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const u64 idx = (u64)(y0 + warp + 8 * q) * (u64)w + (u64)(x0 + lane);
    const u64 key = ((0x7FFFFFFFull - (u64)__float_as_uint(sv[q])) << 32) | idx;
    if (cand[q]) keys[pos + __popc(masks[q] & below)] = key;
    pos += __popc(masks[q]);
    add_to_hist(hist, cand[q], (unsigned)(key >> 56));
  }
  __syncthreads();
  if (hist[tid]) atomicAdd(&ctrl->hist[0][tid], hist[tid]);
}

// Byte d (1-7): resolves byte d - 1, then histograms byte d of the keys in
// the K-th key's bin.
__global__ void __launch_bounds__(kSelectThreads)
dkd_select(int d, int K, const u64* __restrict__ keys, Ctrl* __restrict__ ctrl) {
  __shared__ SelState st_s;
  __shared__ unsigned hist[256];
  if (threadIdx.x < 32) {
    SelState s = d == 1 ? initial(ctrl->count, K) : ctrl->st[d - 2];
    resolve(s, ctrl->hist[d - 1], d - 1);
    if (threadIdx.x == 0) {
      st_s = s;
      if (blockIdx.x == 0) ctrl->st[d - 1] = s;
    }
  }
  hist[threadIdx.x] = 0u;
  __syncthreads();
  if (st_s.done) return;
  const int count = ctrl->count, hi_shift = 64 - 8 * d, lo_shift = 56 - 8 * d;
  const u64 want = st_s.prefix >> hi_shift;
  // Four keys a thread a step, loaded before they are counted, so that
  // enough loads are in flight to stream the candidates.
  for (int base = blockIdx.x * kSelectStep; base < count; base += gridDim.x * kSelectStep) {
    u64 k[kSelectPer];
#pragma unroll
    for (int u = 0; u < kSelectPer; ++u) {
      const int i = base + kSelectThreads * u + threadIdx.x;
      k[u] = i < count ? keys[i] : ~0ull;
    }
#pragma unroll
    for (int u = 0; u < kSelectPer; ++u) {
      const int i = base + kSelectThreads * u + threadIdx.x;
      add_to_hist(hist, i < count && (k[u] >> hi_shift) == want,
                  (unsigned)(k[u] >> lo_shift) & 255u);
    }
  }
  __syncthreads();
  if (hist[threadIdx.x]) atomicAdd(&ctrl->hist[d][threadIdx.x], hist[threadIdx.x]);
}

// Resolves byte 7 and keeps the keys <= the threshold.
__global__ void __launch_bounds__(kSelectThreads)
dkd_compact(const u64* __restrict__ keys, Ctrl* __restrict__ ctrl, u64* __restrict__ sel) {
  __shared__ u64 thresh_s;
  __shared__ int kept_s, placed_s, base_s;
  if (threadIdx.x == 0) kept_s = placed_s = 0;
  if (threadIdx.x < 32) {
    SelState s = ctrl->st[6];
    resolve(s, ctrl->hist[7], 7);
    if (threadIdx.x == 0) {
      thresh_s = s.thresh;
      if (blockIdx.x == 0) ctrl->st[7] = s;
    }
  }
  __syncthreads();
  const u64 thresh = thresh_s;
  const int count = ctrl->count, lane = threadIdx.x & 31;
  // A block's share of the candidates: counted, one atomicAdd for its place
  // in sel, then written.
  const int per = ((count + gridDim.x - 1) / gridDim.x + kSelectThreads - 1) &
                  ~(kSelectThreads - 1);
  const int b0 = min(count, blockIdx.x * per), b1 = min(count, b0 + per);
  int mine = 0;
#pragma unroll 4
  for (int i = b0 + threadIdx.x; i < b1; i += kSelectThreads) mine += keys[i] <= thresh;
  mine = __reduce_add_sync(0xffffffffu, mine);
  if (lane == 0 && mine) atomicAdd(&kept_s, mine);
  __syncthreads();
  if (threadIdx.x == 0) base_s = kept_s ? atomicAdd(&ctrl->nsel, kept_s) : 0;
  __syncthreads();
#pragma unroll 4
  for (int base = b0; base < b1; base += kSelectThreads) {
    const int i = base + threadIdx.x;
    const u64 k = i < b1 ? keys[i] : ~0ull;
    const bool keep = i < b1 && k <= thresh;
    const unsigned mask = __ballot_sync(0xffffffffu, keep);
    if (!mask) continue;
    const int leader = __ffs(mask) - 1;
    int at = 0;
    if (lane == leader) at = atomicAdd(&placed_s, __popc(mask));
    at = __shfl_sync(0xffffffffu, at, leader);
    if (keep) sel[base_s + at + __popc(mask & ((1u << lane) - 1u))] = k;
  }
}

// Sorts run blockIdx.x (kSortN keys, the last one shorter) of src into dst.
__global__ void __launch_bounds__(kSortThreads)
dkd_sort(const u64* __restrict__ src, u64* __restrict__ dst, const Ctrl* __restrict__ ctrl) {
  extern __shared__ u64 sk[];
  const int n = ctrl->nsel, start = blockIdx.x * kSortN;
  if (start >= n) return;
  const int m = min(kSortN, n - start);
  int len = 2;
  while (len < m) len <<= 1;
  for (int i = threadIdx.x; i < len; i += kSortThreads) sk[i] = i < m ? src[start + i] : ~0ull;
  __syncthreads();
  for (int k = 2; k <= len; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int p = threadIdx.x; p < len / 2; p += kSortThreads) {
        const int i = 2 * p - (p & (j - 1)), ixj = i + j;  // j a power of two
        const u64 a = sk[i], b = sk[ixj];
        if ((a > b) == ((i & k) == 0)) {
          sk[i] = b;
          sk[ixj] = a;
        }
      }
      __syncthreads();
    }
  }
  for (int i = threadIdx.x; i < m; i += kSortThreads) dst[start + i] = sk[i];
}

// Merges sorted runs of `width` pairwise: src -> dst.
__global__ void __launch_bounds__(kMergeThreads)
dkd_merge(int width, const u64* __restrict__ src, u64* __restrict__ dst,
          const Ctrl* __restrict__ ctrl) {
  const int n = ctrl->nsel;
  const long long g = (long long)blockIdx.x * kMergeThreads + threadIdx.x;
  if (g >= n) return;
  const long long run = g / width, start = run * width, other = (run ^ 1) * width;
  const long long olen = min((long long)width, (long long)n - other);
  const u64 key = src[g];
  if (olen <= 0) {
    dst[g] = key;
    return;
  }
  long long a = 0, b = olen;  // keys of the other run below key
  while (a < b) {
    const long long mid = (a + b) >> 1;
    if (src[other + mid] < key) a = mid + 1;
    else b = mid;
  }
  dst[min(start, other) + (g - start) + a] = key;
}

__global__ void __launch_bounds__(kRefineThreads)
dkd_refine(int h, int w, int r, const float* __restrict__ score, const u64* __restrict__ keys,
           const Ctrl* __restrict__ ctrl, float* __restrict__ xy, float* __restrict__ scores) {
  const int i = blockIdx.x * kRefineThreads + threadIdx.x;
  if (i >= ctrl->nsel) return;
  const unsigned idx = (unsigned)(keys[i] & 0xFFFFFFFFull);
  const int y = (int)(idx / (unsigned)w), x = (int)(idx % (unsigned)w);
  const int side = 2 * r + 1;
  float v[(2 * kMaxRadius + 1) * (2 * kMaxRadius + 1)];
  float m = -INFINITY;
  for (int a = 0; a < side; ++a) {
    const int yy = min(max(y + a - r, 0), h - 1);
    for (int b = 0; b < side; ++b) {
      const int xx = min(max(x + b - r, 0), w - 1);
      const float t = 20.f * __ldg(score + (size_t)yy * w + xx);
      v[a * side + b] = t;
      m = fmaxf(m, t);
    }
  }
  float sum = 0.f;
  for (int j = 0; j < side * side; ++j) {
    v[j] = expf(v[j] - m);
    sum += v[j];
  }
  float dy = 0.f, dx = 0.f;
  for (int a = 0; a < side; ++a)
    for (int b = 0; b < side; ++b) {
      const float wgt = v[a * side + b] / sum;
      dy += wgt * (float)(a - r);
      dx += wgt * (float)(b - r);
    }
  xy[2 * i] = fminf(fmaxf((float)x + dx, 0.f), (float)w - 1.f);
  xy[2 * i + 1] = fminf(fmaxf((float)y + dy, 0.f), (float)h - 1.f);
  scores[i] = __ldg(score + idx);
}

inline size_t align256(size_t x) { return (x + 255) & ~(size_t)255; }

// Workspace: Ctrl, the candidates' keys (h w), two buffers of cap keys.
struct DkdLayout {
  size_t keys, sel, buf, total;
};

inline DkdLayout dkd_layout(int h, int w, int cap) {
  DkdLayout L;
  L.keys = align256(sizeof(Ctrl));
  L.sel = align256(L.keys + sizeof(u64) * (size_t)h * w);
  L.buf = align256(L.sel + sizeof(u64) * (size_t)cap);
  L.total = L.buf + sizeof(u64) * (size_t)cap;
  return L;
}

}  // namespace aliked_dkd
}  // namespace ctt

// Bytes of the workspace aliked_dkd_f32 takes.
extern "C" long long aliked_dkd_workspace_bytes(int h, int w, int cap) {
  return (long long)ctt::aliked_dkd::dkd_layout(h, w, cap).total;
}

// score (h, w), h w < 2^31; cap = min(K, h w) >= 1; writes the first n =
// min(K, peaks) keypoints in lax.top_k's order to xy (cap, 2) and scores
// (cap,), and n to n_out (1,) int32. Returns cudaGetLastError().
extern "C" int aliked_dkd_f32(int h, int w, int r, float threshold, int cap, const float* score,
                              void* ws, float* xy, float* scores, int* n_out,
                              cudaStream_t stream) {
  using namespace ctt::aliked_dkd;
  if (r < 0 || r > kMaxRadius || h <= 0 || w <= 0 || cap <= 0 ||
      (long long)h * w >= 0x7FFFFFFFll)
    return (int)cudaErrorInvalidValue;
  const DkdLayout L = dkd_layout(h, w, cap);
  char* base = static_cast<char*>(ws);
  auto* ctrl = reinterpret_cast<Ctrl*>(base);
  auto* keys = reinterpret_cast<u64*>(base + L.keys);
  u64* sel = reinterpret_cast<u64*>(base + L.sel);
  u64* buf = reinterpret_cast<u64*>(base + L.buf);
  cudaError_t err = cudaMemsetAsync(ctrl, 0, sizeof(Ctrl), stream);
  if (err != cudaSuccess) return (int)err;
  dkd_peaks<<<dim3((w + kTile - 1) / kTile, (h + kTile - 1) / kTile), kPeakThreads, 0, stream>>>(
      h, w, r, threshold, score, keys, ctrl);
  for (int d = 1; d < 8; ++d)
    dkd_select<<<kSelectBlocks, kSelectThreads, 0, stream>>>(d, cap, keys, ctrl);
  dkd_compact<<<kSelectBlocks, kSelectThreads, 0, stream>>>(keys, ctrl, sel);
  const int runs = (cap + kSortN - 1) / kSortN;
  dkd_sort<<<runs, kSortThreads, sizeof(u64) * kSortN, stream>>>(sel, buf, ctrl);
  u64* src = buf;
  u64* dst = sel;
  for (long long width = kSortN; width < cap; width *= 2) {
    dkd_merge<<<(cap + kMergeThreads - 1) / kMergeThreads, kMergeThreads, 0, stream>>>(
        (int)width, src, dst, ctrl);
    u64* t = src;
    src = dst;
    dst = t;
  }
  dkd_refine<<<(cap + kRefineThreads - 1) / kRefineThreads, kRefineThreads, 0, stream>>>(
      h, w, r, score, src, ctrl, xy, scores);
  err = cudaMemcpyAsync(n_out, &ctrl->nsel, sizeof(int), cudaMemcpyDeviceToDevice, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
