// K53 lightglue_attention: LightGlue's attention and log-assignment.
//
// (a) lightglue_attention_f32 replaces colmap_tpu/feature/lightglue.py
// _attention (l.118-124), with _apply_rotary (l.99-105) on _self_block's q
// and k (l.131-132): per head, softmax(q k^T / 8 with masked keys at -1e9)
// v, masked queries set to 0. One block of 128 threads takes 32 queries of
// one head; each query is held by 4 lanes, lane s holding dims 16 t + 4 s
// + u (t, u < 4: the four lanes' float4 reads of one key row fall in
// different banks). Keys and values stream through shared memory in tiles
// of 64 rows (the rotation applied to k as it loads, to q once in
// registers); a query's logit is its 4 lanes' partial dots summed by two
// xor shuffles (the same bits on the 4 lanes), and the softmax is online:
// per chunk of 16 keys the running max moves once and the sum and output
// are rescaled once. Keys beyond the set take no part; masked keys enter
// with the finite logit -1e9, as colmap_tpu's, so a row whose keys are all
// masked averages them as colmap_tpu's softmax does. q, k, v are rows of
// any stride (column blocks of the qkv product), head h at columns
// 64 h .. 64 h + 63, and the output is written in _unheads' layout.
//
// (b) lightglue_assignment_f32 replaces the log-assignment of
// lightglue_forward (l.177-187) and match_lightglue's extraction (l.221-230)
// on the similarity sim (N1, N2) (the product itself is torch.matmul): the
// masked sim (-1e9 off the valid rows and columns), its row and column
// log_softmax as (x - max) - log(sum exp(x - max)), plus log(m + 1e-12) of
// each side's matchability, summed in colmap_tpu's order. Four kernels: row
// statistics (a warp a row), column statistics and each column's argmax
// over the valid rows (32 columns x 8 row groups a block, the groups' parts
// merged in order), each row's argmax over the valid columns with the
// mutual check and exp(score) > threshold (a warp a row; it also writes the
// scores when asked), and one block that compacts the kept rows into the
// match list in row order. Argmaxes take the first index on ties, as
// numpy's. The (N1, N2) scores never go to the host.
//
// Bound on the card. (a): operations, 4 H N1 N2 64 flops a call (4.3 GFLOP
// at N = 2048, 4 heads: 64 us at 67 TFLOP/s); a pair's forward makes 36
// calls. (b): bytes, sim read once (16.8 MB at 2048 x 2048): 5 us.
#include <cuda_runtime.h>

namespace ctt {
namespace lightglue {

constexpr int kDh = 64, kQueries = 32, kTile = 64, kChunk = 16, kThreads = 128;
constexpr float kMasked = -1e9f, kEps = 1e-12f;

__device__ __forceinline__ float4 rotate(float4 x, const float* cosv, const float* sinv, int p) {
  const float c0 = __ldg(cosv + p), s0 = __ldg(sinv + p);
  const float c1 = __ldg(cosv + p + 1), s1 = __ldg(sinv + p + 1);
  return make_float4(x.x * c0 - x.y * s0, x.x * s0 + x.y * c0, x.z * c1 - x.w * s1,
                     x.z * s1 + x.w * c1);
}

__global__ void __launch_bounds__(kThreads)
attention_kernel(int nq, int nk, const float* __restrict__ q, int qs, const float* __restrict__ k,
                 int ks, const float* __restrict__ v, int vs,
                 const unsigned char* __restrict__ mask_q,
                 const unsigned char* __restrict__ mask_k, const float* __restrict__ cosv,
                 const float* __restrict__ sinv, float* __restrict__ out, int os) {
  __shared__ __align__(16) float kt[kTile][kDh];
  __shared__ __align__(16) float vt[kTile][kDh];
  __shared__ int kflag[kTile];  // 1 valid, 0 masked
  const int h = blockIdx.y, tid = threadIdx.x, sub = tid & 3;
  const int qi = blockIdx.x * kQueries + (tid >> 2);
  const bool qin = qi < nq;
  const int col = h * kDh + 4 * sub;  // + 16 t

  float qr[16];
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (qin) {
      x = *reinterpret_cast<const float4*>(q + (size_t)qi * qs + col + 16 * t);
      if (cosv != nullptr) x = rotate(x, cosv + (size_t)qi * (kDh / 2), sinv + (size_t)qi * (kDh / 2),
                                      8 * t + 2 * sub);
    }
    qr[4 * t] = x.x;
    qr[4 * t + 1] = x.y;
    qr[4 * t + 2] = x.z;
    qr[4 * t + 3] = x.w;
  }
  float o[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) o[i] = 0.f;
  float m = -INFINITY, l = 0.f;

  for (int k0 = 0; k0 < nk; k0 += kTile) {
    __syncthreads();
    for (int i = tid; i < kTile * (kDh / 4); i += kThreads) {
      const int r = i / (kDh / 4), c = i % (kDh / 4), kk = k0 + r;
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
      if (kk < nk) {
        kv = *reinterpret_cast<const float4*>(k + (size_t)kk * ks + h * kDh + 4 * c);
        vv = *reinterpret_cast<const float4*>(v + (size_t)kk * vs + h * kDh + 4 * c);
        if (cosv != nullptr)
          kv = rotate(kv, cosv + (size_t)kk * (kDh / 2), sinv + (size_t)kk * (kDh / 2), 2 * c);
      }
      *reinterpret_cast<float4*>(&kt[r][4 * c]) = kv;
      *reinterpret_cast<float4*>(&vt[r][4 * c]) = vv;
    }
    for (int i = tid; i < kTile; i += kThreads) kflag[i] = (k0 + i < nk && mask_k[k0 + i]) ? 1 : 0;
    __syncthreads();
    const int nvalid = min(kTile, nk - k0);
    for (int c0 = 0; c0 < nvalid; c0 += kChunk) {
      float s[kChunk];
      float cmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const int r = c0 + j;
        float part = 0.f;
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const float4 kv = *reinterpret_cast<const float4*>(&kt[r][16 * t + 4 * sub]);
          part = fmaf(qr[4 * t], kv.x, part);
          part = fmaf(qr[4 * t + 1], kv.y, part);
          part = fmaf(qr[4 * t + 2], kv.z, part);
          part = fmaf(qr[4 * t + 3], kv.w, part);
        }
        part += __shfl_xor_sync(0xffffffffu, part, 1);
        part += __shfl_xor_sync(0xffffffffu, part, 2);
        s[j] = r >= nvalid ? -INFINITY : (kflag[r] ? part * 0.125f : kMasked);
        cmax = fmaxf(cmax, s[j]);
      }
      const float mnew = fmaxf(m, cmax);
      const float corr = expf(m - mnew);
      l *= corr;
#pragma unroll
      for (int i = 0; i < 16; ++i) o[i] *= corr;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const float p = expf(s[j] - mnew);
        l += p;
        const int r = c0 + j;
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const float4 vv = *reinterpret_cast<const float4*>(&vt[r][16 * t + 4 * sub]);
          o[4 * t] = fmaf(p, vv.x, o[4 * t]);
          o[4 * t + 1] = fmaf(p, vv.y, o[4 * t + 1]);
          o[4 * t + 2] = fmaf(p, vv.z, o[4 * t + 2]);
          o[4 * t + 3] = fmaf(p, vv.w, o[4 * t + 3]);
        }
      }
      m = mnew;
    }
  }
  if (!qin) return;
  const float scale = mask_q[qi] ? 1.f / l : 0.f;
#pragma unroll
  for (int t = 0; t < 4; ++t)
    *reinterpret_cast<float4*>(out + (size_t)qi * os + col + 16 * t) =
        make_float4(o[4 * t] * scale, o[4 * t + 1] * scale, o[4 * t + 2] * scale,
                    o[4 * t + 3] * scale);
}

__device__ __forceinline__ float masked_sim(const float* sim, int n2, int i, int j,
                                            const unsigned char* mask1,
                                            const unsigned char* mask2) {
  return (mask1[i] && mask2[j]) ? __ldg(sim + (size_t)i * n2 + j) : kMasked;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, s));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) x += __shfl_xor_sync(0xffffffffu, x, s);
  return x;
}

// The better of two (value, index) candidates: larger value, then smaller index.
__device__ __forceinline__ void better(float& bv, int& bi, float v, int i) {
  if (v > bv || (v == bv && i < bi)) {
    bv = v;
    bi = i;
  }
}

// row (3, n1): max, log sum exp(x - max), log(m1 + eps) of each row.
__global__ void __launch_bounds__(256)
row_stats_kernel(int n1, int n2, const float* __restrict__ sim, const unsigned char* mask1,
                 const unsigned char* mask2, const float* __restrict__ m1, float* row) {
  const int i = blockIdx.x * 8 + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (i >= n1) return;
  float mx = -INFINITY;
  for (int j = lane; j < n2; j += 32) mx = fmaxf(mx, masked_sim(sim, n2, i, j, mask1, mask2));
  mx = warp_max(mx);
  float sum = 0.f;
  for (int j = lane; j < n2; j += 32) sum += expf(masked_sim(sim, n2, i, j, mask1, mask2) - mx);
  sum = warp_sum(sum);
  if (lane == 0) {
    row[i] = mx;
    row[n1 + i] = logf(sum);
    row[2 * n1 + i] = logf(__ldg(m1 + i) + kEps);
  }
}

__device__ __forceinline__ float score_at(float x, int i, int j, int n1, int n2, const float* row,
                                          const float* col) {
  const float s_row = (x - row[i]) - row[n1 + i];
  const float s_col = (x - col[j]) - col[n2 + j];
  return ((s_row + s_col) + row[2 * n1 + i]) + col[2 * n2 + j];
}

// col (3, n2) as row's, and best21 (n2,): each column's argmax over the
// valid rows. Block: 32 columns x 8 row groups (rows g, g + 8, ...).
__global__ void __launch_bounds__(256)
col_kernel(int n1, int n2, const float* __restrict__ sim, const unsigned char* mask1,
           const unsigned char* mask2, const float* __restrict__ m2, const float* row, float* col,
           int* best21) {
  __shared__ float pv[8][32];
  __shared__ int pi[8][32];
  const int lane = threadIdx.x & 31, g = threadIdx.x >> 5, j = blockIdx.x * 32 + lane;
  const bool jin = j < n2;
  float mx = -INFINITY;
  if (jin)
    for (int i = g; i < n1; i += 8) mx = fmaxf(mx, masked_sim(sim, n2, i, j, mask1, mask2));
  pv[g][lane] = mx;
  __syncthreads();
  float cmx = -INFINITY;
  for (int q = 0; q < 8; ++q) cmx = fmaxf(cmx, pv[q][lane]);
  __syncthreads();
  float sum = 0.f;
  if (jin)
    for (int i = g; i < n1; i += 8) sum += expf(masked_sim(sim, n2, i, j, mask1, mask2) - cmx);
  pv[g][lane] = sum;
  __syncthreads();
  if (g == 0 && jin) {
    float tot = 0.f;
    for (int q = 0; q < 8; ++q) tot += pv[q][lane];
    col[j] = cmx;
    col[n2 + j] = logf(tot);
    col[2 * n2 + j] = logf(__ldg(m2 + j) + kEps);
  }
  __syncthreads();  // col of this block's columns is written before pass 3 reads it
  float bv = -INFINITY;
  int bi = 0x7fffffff;
  if (jin)
    for (int i = g; i < n1; i += 8) {
      if (!mask1[i]) continue;
      const float s = score_at(masked_sim(sim, n2, i, j, mask1, mask2), i, j, n1, n2, row, col);
      if (s > bv || bi == 0x7fffffff) {
        bv = s;
        bi = i;
      }
    }
  pv[g][lane] = bv;
  pi[g][lane] = bi;
  __syncthreads();
  if (g == 0 && jin) {
    float v0 = pv[0][lane];
    int i0 = pi[0][lane];
    for (int q = 1; q < 8; ++q)
      if (pi[q][lane] != 0x7fffffff) better(v0, i0, pv[q][lane], pi[q][lane]);
    best21[j] = i0 == 0x7fffffff ? 0 : i0;
  }
}

// Each row's argmax over the valid columns, the mutual check and the
// threshold: keep (n1,), best12 (n1,); the scores when asked.
__global__ void __launch_bounds__(256)
row_kernel(int n1, int n2, float threshold, const float* __restrict__ sim,
           const unsigned char* mask1, const unsigned char* mask2, const float* row,
           const float* col, const int* best21, int* best12, int* keep, float* scores) {
  const int i = blockIdx.x * 8 + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (i >= n1) return;
  float bv = -INFINITY;
  int bi = 0x7fffffff;
  for (int j = lane; j < n2; j += 32) {
    const float s = score_at(masked_sim(sim, n2, i, j, mask1, mask2), i, j, n1, n2, row, col);
    if (scores != nullptr) scores[(size_t)i * n2 + j] = s;
    if (mask2[j] && (s > bv || bi == 0x7fffffff)) {
      bv = s;
      bi = j;
    }
  }
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, bv, s);
    const int oi = __shfl_xor_sync(0xffffffffu, bi, s);
    if (oi != 0x7fffffff && (bi == 0x7fffffff || ov > bv || (ov == bv && oi < bi))) {
      bv = ov;
      bi = oi;
    }
  }
  if (lane == 0) {
    const bool found = bi != 0x7fffffff;
    best12[i] = found ? bi : 0;
    keep[i] = (found && mask1[i] && best21[bi] == i && expf(bv) > threshold) ? 1 : 0;
  }
}

// One block: the kept rows' (row, best12) pairs in row order, and count.
__global__ void __launch_bounds__(1024)
compact_kernel(int n1, const int* keep, const int* best12, int* matches, int* count) {
  __shared__ int warp_tot[32];
  __shared__ int base;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) base = 0;
  __syncthreads();
  for (int c0 = 0; c0 < n1; c0 += 1024) {
    const int i = c0 + tid;
    const int f = i < n1 ? keep[i] : 0;
    int incl = f;
#pragma unroll
    for (int s = 1; s < 32; s <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, s);
      if (lane >= s) incl += y;
    }
    if (lane == 31) warp_tot[warp] = incl;
    __syncthreads();
    int before = 0;
    for (int w = 0; w < warp; ++w) before += warp_tot[w];
    if (f) {
      const int pos = base + before + incl - 1;
      matches[2 * pos] = i;
      matches[2 * pos + 1] = best12[i];
    }
    __syncthreads();
    if (tid == 0) {
      int tot = 0;
      for (int w = 0; w < 32; ++w) tot += warp_tot[w];
      base += tot;
    }
    __syncthreads();
  }
  if (tid == 0) *count = base;
}

}  // namespace lightglue
}  // namespace ctt

// q (nq, qs-strided rows), k and v (nk, strided rows), head h at columns
// 64 h .. 64 h + 63; masks (nq,), (nk,) bytes; cos, sin (nq, 32) or null
// (no rotation); out (nq, os-strided rows). Returns cudaGetLastError().
extern "C" int lightglue_attention_f32(int heads, int nq, int nk, const float* q, int qs,
                                       const float* k, int ks, const float* v, int vs,
                                       const unsigned char* mask_q, const unsigned char* mask_k,
                                       const float* cosv, const float* sinv, float* out, int os,
                                       cudaStream_t stream) {
  using namespace ctt::lightglue;
  if (nq > 0 && nk > 0 && heads > 0) {
    const dim3 grid((nq + kQueries - 1) / kQueries, heads);
    attention_kernel<<<grid, kThreads, 0, stream>>>(nq, nk, q, qs, k, ks, v, vs, mask_q, mask_k,
                                                    cosv, sinv, out, os);
  }
  return (int)cudaGetLastError();
}

// sim (n1, n2); masks (n1,), (n2,) bytes; m1 (n1,), m2 (n2,) matchability.
// Scratch: row (3, n1), col (3, n2), best21 (n2,), best12 (n1,), keep (n1,).
// Writes matches (count, 2) int32 (row, column) in row order and count (1,);
// scores (n1, n2) when not null. Returns cudaGetLastError().
extern "C" int lightglue_assignment_f32(int n1, int n2, float threshold, const float* sim,
                                        const unsigned char* mask1, const unsigned char* mask2,
                                        const float* m1, const float* m2, float* row, float* col,
                                        int* best21, int* best12, int* keep, int* matches,
                                        int* count, float* scores, cudaStream_t stream) {
  using namespace ctt::lightglue;
  if (n1 > 0 && n2 > 0) {
    row_stats_kernel<<<(n1 + 7) / 8, 256, 0, stream>>>(n1, n2, sim, mask1, mask2, m1, row);
    col_kernel<<<(n2 + 31) / 32, 256, 0, stream>>>(n1, n2, sim, mask1, mask2, m2, row, col,
                                                   best21);
    row_kernel<<<(n1 + 7) / 8, 256, 0, stream>>>(n1, n2, threshold, sim, mask1, mask2, row, col,
                                                 best21, best12, keep, scores);
    compact_kernel<<<1, 1024, 0, stream>>>(n1, keep, best12, matches, count);
  }
  return (int)cudaGetLastError();
}
