// K53 lightglue_attention: LightGlue's attention and log-assignment.
//
// (a) lightglue_attention_f32 replaces colmap_tpu/feature/lightglue.py
// _attention (l.118-124), with _apply_rotary (l.99-105) on _self_block's q
// and k (l.131-132): per head, softmax(q k^T / 8 with masked keys at -1e9)
// v, masked queries set to 0. q, k, v are rows of any stride (column blocks
// of the qkv product), head h at columns 64 h .. 64 h + 63, and the output
// is written in _unheads' layout. Up to three kernels a call:
//   rotate  (self-attention only) writes the rotated q and k, (n, H * 64)
//           each, to a workspace (2 x 2 MB at n = 2048, held in L2);
//   tile    the attention on the tensor cores. A block of 4 warps takes 64
//           queries of one head and one range of key tiles (its split); a
//           warp owns 16 queries. Keys and values stream through shared
//           memory in tiles of 64 rows by cp.async, two stages, rows padded
//           to 68 floats (the B fragments' 32 lanes fall in 32 banks). Both
//           products are mma.sync m16n8k8 TF32 in three passes (3xTF32:
//           each operand x split into big, the nearest TF32 value as
//           cvt.rna.tf32 gives it, and small, that of x - big; big*big +
//           big*small + small*big summed in float32), which keeps float32's
//           accuracy at the tensor cores' rate. q, scaled by 1/8 (exact), is
//           held in registers; q, k, v and p are split as their fragments
//           are read. A tile's p v is summed on the tensor cores and added
//           to the running o in float32 FMAs. A warp's 16 x 64
//           logits of a tile are its accumulator fragments: the row max takes
//           two quad shuffles and each expf is computed once, by the lane
//           that holds the logit. The accumulator layout (columns 2t, 2t + 1
//           of an 8-key slice) is not the A operand's (columns t, t + 4), so
//           the p v product reads its keys permuted: A column t is key 2t, A
//           column t + 4 key 2t + 1, and the B fragment reads v's rows 2t and
//           2t + 1 to match (the sum over keys does not depend on their
//           order; no shuffle or shared round trip). Keys at or beyond nk
//           take no part (-inf); masked keys enter with the finite logit
//           -1e9, as colmap_tpu's, so a row whose keys are all masked
//           averages them as colmap_tpu's softmax does. With one split the
//           block writes o / l (0 for a masked query); with s splits it
//           writes its partial (o, m, l) to a workspace of s x H x nq x 68
//           floats;
//   merge   (s > 1) combines the partials by log-sum-exp: M = max m_s, L =
//           sum l_s e^(m_s - M), o = sum o_s e^(m_s - M) / L, 0 for a masked
//           query. A split with no keys leaves m = -inf, l = 0, o = 0, which
//           the merge weighs by e^-inf = 0.
// The split count s fills the card: with B = ceil(nq / 64) H blocks for
// one split and S the SMs times the blocks one SM holds at once (the
// occupancy of the tile kernel), s = max(1, floor(S / B)), at most
// max(1, floor(nk / 256)) so that each split keeps at least 4 tiles; s = 1
// (no merge) where B already fills the card.
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
// at N = 2048, 4 heads: 64 us at float32's 67 TFLOP/s; the three TF32
// passes are 12.9 GFLOP, 26 us at the 495 TFLOP/s dense TF32 rate); a
// pair's forward makes 36 calls. (b): bytes, sim read once (16.8 MB at 2048
// x 2048): 5 us.
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace ctt {
namespace lightglue {

constexpr int kDh = 64;
constexpr float kMasked = -1e9f, kEps = 1e-12f;
// (a): 64 queries (4 warps of 16) a block; key tiles of 64 rows padded to
// 68 floats; two stages of K and V; partials of 68 floats a row (o, m, l).
constexpr int kBlockQ = 64, kWarps = 4, kThreads = 32 * kWarps, kTileK = 64, kStride = 68;
constexpr int kStages = 2, kTileFloats = kTileK * kStride;
constexpr int kSmemBytes = kStages * 2 * kTileFloats * (int)sizeof(float);
constexpr int kPart = 68, kMinSplitKeys = 256, kMaxDevices = 64;

__device__ __forceinline__ float4 rotate(float4 x, const float* cosv, const float* sinv, int p) {
  const float c0 = __ldg(cosv + p), s0 = __ldg(sinv + p);
  const float c1 = __ldg(cosv + p + 1), s1 = __ldg(sinv + p + 1);
  return make_float4(x.x * c0 - x.y * s0, x.x * s0 + x.y * c0, x.z * c1 - x.w * s1,
                     x.z * s1 + x.w * c1);
}

// Rotated rows of q (blockIdx.y 0) and k (1) into y (2, n, heads * 64).
__global__ void __launch_bounds__(256)
attention_rotate_kernel(int n, int heads, const float* __restrict__ q, int qs,
                        const float* __restrict__ k, int ks, const float* __restrict__ cosv,
                        const float* __restrict__ sinv, float* __restrict__ y) {
  const int width4 = heads * (kDh / 4);
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)n * width4) return;
  const int row = (int)(i / width4), c = 4 * (int)(i % width4);
  const float* x = blockIdx.y ? k + (size_t)row * ks : q + (size_t)row * qs;
  const float4 r = rotate(*reinterpret_cast<const float4*>(x + c), cosv + (size_t)row * (kDh / 2),
                          sinv + (size_t)row * (kDh / 2), (c % kDh) / 2);
  *reinterpret_cast<float4*>(y + ((size_t)blockIdx.y * n + row) * heads * kDh + c) = r;
}

// x = big + small, both TF32 (3xTF32's operand split), each the nearest
// TF32 value, ties away from zero, as cvt.rna.tf32.f32 gives it, but in
// integer operations at their full rate (cvt runs on the conversion unit,
// a quarter of it): big is (bits + 0x1000) & 0xFFFFE000, and small is
// passed as its bits + 0x1000, since the tensor cores read only the top
// 19 bits of a TF32 operand. x - big is exact in float32.
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
  small = __float_as_uint(x - __uint_as_float(big)) + 0x1000u;
}

// d += a b, one m16n8k8 TF32 product with float32 accumulation.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b in 3xTF32: the two small terms first, then big * big.
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ab)[4],
                                     const uint32_t (&as)[4], float b0, float b1) {
  uint32_t bb0, bs0, bb1, bs1;
  split(b0, bb0, bs0);
  split(b1, bb1, bs1);
  mma(d, as, bb0, bb1);
  mma(d, ab, bs0, bs1);
  mma(d, ab, bb0, bb1);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool full) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s), "l"(src),
               "r"(full ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// grid (ceil(nq / 64), heads, splits). Lane (g, t) = (lane / 4, lane % 4)
// holds rows g and g + 8 of its warp's 16 queries.
__global__ void __launch_bounds__(kThreads, 2)
attention_tile_kernel(int nq, int nk, const float* __restrict__ q, int qs,
                      const float* __restrict__ k, int ks, const float* __restrict__ v, int vs,
                      const unsigned char* __restrict__ mask_q,
                      const unsigned char* __restrict__ mask_k, float* __restrict__ out, int os,
                      float* __restrict__ part) {
  extern __shared__ __align__(16) float smem[];
  const int h = blockIdx.y, sp = blockIdx.z, splits = gridDim.z;
  const int tid = threadIdx.x, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int r0 = blockIdx.x * kBlockQ + (tid >> 5) * 16 + g, r1 = r0 + 8;
  const int ntiles = (nk + kTileK - 1) / kTileK;
  const int tb = (int)((long long)ntiles * sp / splits);
  const int te = (int)((long long)ntiles * (sp + 1) / splits);

  auto load_tile = [&](int tile, int stage) {
    float* kt = smem + stage * 2 * kTileFloats;
    float* vt = kt + kTileFloats;
    for (int i = tid; i < kTileK * (kDh / 4); i += kThreads) {
      const int r = i / (kDh / 4), c = 4 * (i % (kDh / 4)), key = tile * kTileK + r;
      const bool in = key < nk;
      const size_t row = in ? (size_t)key : 0;
      cp_async16(kt + r * kStride + c, k + row * ks + h * kDh + c, in);
      cp_async16(vt + r * kStride + c, v + row * vs + h * kDh + c, in);
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
  };
  if (tb < te) load_tile(tb, 0);

  // q / 8 (exact) in A fragment order: a0 (g, t), a1 (g + 8, t), a2 (g,
  // t + 4), a3 (g + 8, t + 4) of each 8-column slice kk; split each tile
  // (32 registers rather than 64 for both halves).
  float qf[8][4];
  {
    const float* p0 = q + (size_t)r0 * qs + h * kDh;
    const float* p1 = q + (size_t)r1 * qs + h * kDh;
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const int c = 8 * kk + t;
      qf[kk][0] = r0 < nq ? 0.125f * p0[c] : 0.f;
      qf[kk][1] = r1 < nq ? 0.125f * p1[c] : 0.f;
      qf[kk][2] = r0 < nq ? 0.125f * p0[c + 4] : 0.f;
      qf[kk][3] = r1 < nq ? 0.125f * p1[c + 4] : 0.f;
    }
  }
  float o[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  for (int tile = tb; tile < te; ++tile) {
    const int stage = (tile - tb) & 1, key0 = tile * kTileK;
    // The key flags of this lane's 16 logit columns 8 n + 2 t + c: bit
    // 2 n + c set for a key inside the set, in `keep` for a valid one.
    unsigned inside = 0, keep = 0;
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int key = key0 + 8 * n + 2 * t + c;
        if (key < nk) {
          inside |= 1u << (2 * n + c);
          if (__ldg(mask_k + key)) keep |= 1u << (2 * n + c);
        }
      }
    if (tile + 1 < te) {
      load_tile(tile + 1, stage ^ 1);
      asm volatile("cp.async.wait_group 1;" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;" ::: "memory");
    }
    __syncthreads();
    const float* kt = smem + stage * 2 * kTileFloats;
    const float* vt = kt + kTileFloats;

    // s = (q / 8) k^T: B fragment b0 (k = t, n = g) = K[8 n + g][8 kk + t].
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      uint32_t qb[4], qsm[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) split(qf[kk][i], qb[i], qsm[i]);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const float* kr = kt + (8 * n + g) * kStride + 8 * kk + t;
        mma3(s[n], qb, qsm, kr[0], kr[4]);
      }
    }

    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const unsigned bit = 1u << (2 * n + c);
        const bool in = inside & bit, kept = keep & bit;
        s[n][c] = in ? (kept ? s[n][c] : kMasked) : -INFINITY;
        s[n][c + 2] = in ? (kept ? s[n][c + 2] : kMasked) : -INFINITY;
        mx0 = fmaxf(mx0, s[n][c]);
        mx1 = fmaxf(mx1, s[n][c + 2]);
      }
    // Every tile holds a key of the set (key0 < nk), so the maxima are finite.
    const float mn0 = fmaxf(m0, quad_max(mx0)), mn1 = fmaxf(m1, quad_max(mx1));
    const float c0 = expf(m0 - mn0), c1 = expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    l0 *= c0;
    l1 *= c1;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        s[n][c] = expf(s[n][c] - mn0);
        s[n][c + 2] = expf(s[n][c + 2] - mn1);
        l0 += s[n][c];
        l1 += s[n][c + 2];
      }
    }

    // The tile's p v over its 8-key slices j: A column t is key 8 j + 2 t,
    // column t + 4 key 8 j + 2 t + 1 (the accumulator's own columns), so
    // b0 (k = t, n = g) = V[8 j + 2 t][8 nn + g], b1 = V[8 j + 2 t + 1][...].
    // It is summed on the tensor cores within the tile only; the running o
    // takes it in float32 FMAs (o c + pv), since the tensor cores' float32
    // additions truncate and a sum over every tile of a split drifts.
    float pv[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) pv[n][0] = pv[n][1] = pv[n][2] = pv[n][3] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      uint32_t ab[4], as[4];
      split(s[j][0], ab[0], as[0]);
      split(s[j][2], ab[1], as[1]);
      split(s[j][1], ab[2], as[2]);
      split(s[j][3], ab[3], as[3]);
      const float* vr = vt + (8 * j + 2 * t) * kStride + g;
#pragma unroll
      for (int nn = 0; nn < 8; ++nn) mma3(pv[nn], ab, as, vr[8 * nn], vr[kStride + 8 * nn]);
    }
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      o[n][0] = fmaf(o[n][0], c0, pv[n][0]);
      o[n][1] = fmaf(o[n][1], c0, pv[n][1]);
      o[n][2] = fmaf(o[n][2], c1, pv[n][2]);
      o[n][3] = fmaf(o[n][3], c1, pv[n][3]);
    }
    __syncthreads();  // the stage is read before the next prefetch overwrites it
  }

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const int col = h * kDh + 2 * t;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = half ? r1 : r0;
    if (r >= nq) continue;
    const float m = half ? m1 : m0, l = half ? l1 : l0;
    if (splits == 1) {
      const float scale = mask_q[r] ? 1.f / l : 0.f;
#pragma unroll
      for (int n = 0; n < 8; ++n)
        *reinterpret_cast<float2*>(out + (size_t)r * os + col + 8 * n) =
            make_float2(o[n][2 * half] * scale, o[n][2 * half + 1] * scale);
    } else {
      float* p = part + (((size_t)sp * gridDim.y + h) * nq + r) * kPart;
#pragma unroll
      for (int n = 0; n < 8; ++n)
        *reinterpret_cast<float2*>(p + 8 * n + 2 * t) =
            make_float2(o[n][2 * half], o[n][2 * half + 1]);
      if (t == 0) *reinterpret_cast<float2*>(p + kDh) = make_float2(m, l);
    }
  }
}

// The log-sum-exp merge of the splits' partials: 16 threads a (head,
// query) row, a float4 of o each.
__global__ void __launch_bounds__(256)
attention_merge_kernel(int nq, int heads, int splits, const float* __restrict__ part,
                       const unsigned char* __restrict__ mask_q, float* __restrict__ out, int os) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)heads * nq * (kDh / 4)) return;
  const int row = (int)(i / (kDh / 4)), c = 4 * (int)(i % (kDh / 4));
  const int h = row / nq, r = row % nq;
  const size_t step = (size_t)heads * nq * kPart;
  const float* p = part + (size_t)row * kPart;
  float M = -INFINITY;
  for (int s = 0; s < splits; ++s) M = fmaxf(M, __ldg(p + s * step + kDh));
  float L = 0.f;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s = 0; s < splits; ++s) {
    const float* ps = p + s * step;
    const float w = expf(__ldg(ps + kDh) - M);
    const float4 x = __ldg(reinterpret_cast<const float4*>(ps + c));
    L += w * __ldg(ps + kDh + 1);
    acc.x += w * x.x;
    acc.y += w * x.y;
    acc.z += w * x.z;
    acc.w += w * x.w;
  }
  const float scale = mask_q[r] ? 1.f / L : 0.f;
  *reinterpret_cast<float4*>(out + (size_t)r * os + h * kDh + c) =
      make_float4(acc.x * scale, acc.y * scale, acc.z * scale, acc.w * scale);
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

namespace {

// Per device: the tile kernel's dynamic shared memory set, its occupancy.
int g_per_sm[ctt::lightglue::kMaxDevices], g_sms[ctt::lightglue::kMaxDevices];

int tile_setup(int* per_sm, int* sms) {
  using namespace ctt::lightglue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (g_per_sm[dev] == 0) {
    err = cudaFuncSetAttribute(attention_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemBytes);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&g_sms[dev], cudaDevAttrMultiProcessorCount, dev);
    int n = 0;
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, attention_tile_kernel, kThreads,
                                                          kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    g_per_sm[dev] = n > 0 ? n : 1;
  }
  *per_sm = g_per_sm[dev];
  *sms = g_sms[dev];
  return 0;
}

}  // namespace

// K53 (a)'s design for (heads, nq, nk): info[0] the split count s, [1] the
// tile kernel's blocks an SM holds, [2] the SMs, [3] its registers a
// thread, [4] its local (spilled) bytes a thread, [5] its dynamic shared
// bytes a block, [6] its threads a block. Returns a CUDA error code.
extern "C" int lightglue_attention_plan(int heads, int nq, int nk, int* info) {
  using namespace ctt::lightglue;
  int per_sm = 0, sms = 0;
  int err = tile_setup(&per_sm, &sms);
  if (err != 0) return err;
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, attention_tile_kernel);
  if (e != cudaSuccess) return (int)e;
  const long long blocks = (long long)((nq + kBlockQ - 1) / kBlockQ) * heads;
  long long s = blocks > 0 ? (long long)per_sm * sms / blocks : 1;
  s = s < 1 ? 1 : s;
  const long long most = nk / kMinSplitKeys > 1 ? nk / kMinSplitKeys : 1;
  info[0] = (int)(s < most ? s : most);
  info[1] = per_sm;
  info[2] = sms;
  info[3] = attr.numRegs;
  info[4] = (int)attr.localSizeBytes;
  info[5] = kSmemBytes;
  info[6] = kThreads;
  return 0;
}

// q (nq, qs-strided rows), k and v (nk, strided rows), head h at columns
// 64 h .. 64 h + 63; masks (nq,), (nk,) bytes; cos, sin (nq, 32) or null
// (no rotation), with rot a workspace of (2, nq, heads * 64) floats; splits
// from lightglue_attention_plan, with part a workspace of (splits, heads,
// nq, 68) floats when splits > 1; out (nq, os-strided rows). Returns
// cudaGetLastError().
extern "C" int lightglue_attention_f32(int heads, int nq, int nk, int splits, const float* q,
                                       int qs, const float* k, int ks, const float* v, int vs,
                                       const unsigned char* mask_q, const unsigned char* mask_k,
                                       const float* cosv, const float* sinv, float* rot,
                                       float* part, float* out, int os, cudaStream_t stream) {
  using namespace ctt::lightglue;
  if (nq > 0 && nk > 0 && heads > 0) {
    int per_sm = 0, sms = 0;
    const int err = tile_setup(&per_sm, &sms);
    if (err != 0) return err;
    const int width = heads * kDh;
    if (cosv != nullptr) {
      const long long n4 = (long long)nq * width / 4;
      attention_rotate_kernel<<<dim3((unsigned)((n4 + 255) / 256), 2), 256, 0, stream>>>(
          nq, heads, q, qs, k, ks, cosv, sinv, rot);
      q = rot;
      k = rot + (size_t)nq * width;
      qs = ks = width;
    }
    const dim3 grid((nq + kBlockQ - 1) / kBlockQ, heads, splits);
    attention_tile_kernel<<<grid, kThreads, kSmemBytes, stream>>>(nq, nk, q, qs, k, ks, v, vs,
                                                                  mask_q, mask_k, out, os, part);
    if (splits > 1) {
      const long long n = (long long)heads * nq * (kDh / 4);
      attention_merge_kernel<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
          nq, heads, splits, part, mask_q, out, os);
    }
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
