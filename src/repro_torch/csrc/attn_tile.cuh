// Tiled online-softmax attention shared by the block-sparse FUM kernel
// (hdp_block_attn.cu) and the dense flash kernel (flash_attention.cu).
//
// q, k, v, out are [BH, S, hd] row-major. One CUDA block serves R query
// rows of one q tile of one (b*h) row: R = min(block_q, 32) keeps the
// fp32 Q, FQ, accumulator, K, V and score tiles of a 128x128 tile with
// hd = 128 inside the 227 KB of shared memory (a q tile wider than 32
// rows is served by several blocks that each walk the same KV list).
// The block walks its KV blocks in order, keeping m, l and acc on chip
// (the TPU kernel carried them in VMEM scratch across its sequential
// grid axis):
// * sparse (the FUM kernel): only the blocks listed in
//   kv_idx[bh, i, :counts[bh, i]]; a head with head_kept = 0 loads
//   nothing and writes zeros; a listed index outside [0, nk) turns the
//   block's rows to NaN rather than reading outside K/V;
// * dense (flash): every block, skipping those wholly in the future of
//   the block's last row under causal.
// A KV tile is loaded once per step into shared memory (fp32, K rows
// padded by one float against bank conflicts), rows past Sk read as
// zero and are masked, so nothing outside [0, Sk) is ever read.
// Scores: one thread per (row, column), s = q.k (minus fq.fk with
// fractions by trunc when approx), times scale (and *score_scale),
// valid when col < kv_len (and row >= col under causal); per-row max and
// sum with one warp per row; acc = acc*corr + p.V with one thread per
// (row, d), where p is rounded to V's type first as the reference does
// (p.astype(v.dtype)); the row sum l takes the unrounded p. All
// accumulation is fp32; l is floored at 1e-30 so an empty row is 0.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace attn_tile {

constexpr float kNeg = -1e30f;
constexpr int kThreads = 256;
constexpr int kMaxRows = 32;   // query rows per CUDA block

__device__ __forceinline__ float nan_f() { return __int_as_float(0x7fc00000); }

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// p as the P.V product sees it: rounded to V's type, back in fp32
template <typename TV> __device__ __forceinline__ float round_to(float p) {
  return to_f(from_f<TV>(p));
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename TIn, typename TV, typename TOut>
struct Args {
  const TIn* q;            // [BH, Sq, hd]
  const TIn* k;            // [BH, Sk, hd]
  const TV* v;             // [BH, Sk, hd]
  TOut* out;               // [BH, Sq, hd]
  const int* kv_idx;       // [BH, nq, mk]   (sparse only)
  const int* counts;       // [BH, nq]       (sparse only)
  const int* head_kept;    // [BH]           (sparse only)
  const int* kv_len;       // [BH] or null   (sparse only)
  const float* score_scale;  // [1] or null
  int Sq, Sk, hd, bq, bk, nq, nk, mk;
  int R, nsub;             // rows per CUDA block, blocks per q tile
  int sparse, causal, approx;
  float scale;             // fp32(1/sqrt(hd))
};

template <typename TIn, typename TV, typename TOut>
__global__ void __launch_bounds__(kThreads)
tile_kernel(const Args<TIn, TV, TOut> a) {
  const int i = blockIdx.x / a.nsub, sub = blockIdx.x - i * a.nsub;
  const int bh = blockIdx.y;
  const int R = a.R, hd = a.hd, bk = a.bk;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int row0 = i * a.bq + sub * R;                  // first row served
  const int nrows = min(R, a.bq - sub * R);             // rows of this block

  extern __shared__ float smem[];
  float* q_s = smem;                    // [R, hd]
  float* fq_s = q_s + R * hd;           // [R, hd]
  float* acc_s = fq_s + R * hd;         // [R, hd]
  float* k_s = acc_s + R * hd;          // [bk, hd + 1]
  float* v_s = k_s + bk * (hd + 1);     // [bk, hd]
  float* s_s = v_s + bk * hd;           // [R, bk] scores, then p
  float* m_s = s_s + R * bk;            // [R]
  float* l_s = m_s + R;                 // [R]
  float* c_s = l_s + R;                 // [R] per-step correction

  const size_t base_q = (size_t)bh * a.Sq * hd;
  const size_t base_k = (size_t)bh * a.Sk * hd;
  for (int e = tid; e < R * hd; e += blockDim.x) {
    const int r = e / hd, d = e - r * hd;
    const int row = row0 + r;
    const float x = (r < nrows && row < a.Sq) ? to_f(a.q[base_q + (size_t)row * hd + d]) : 0.f;
    q_s[e] = x;
    fq_s[e] = x - truncf(x);
    acc_s[e] = 0.f;
  }
  for (int r = tid; r < R; r += blockDim.x) {
    m_s[r] = kNeg;
    l_s[r] = 0.f;
  }

  int steps, len = a.Sk;
  float gate = 1.f;
  const int* list = nullptr;
  if (a.sparse) {
    const bool kept = a.head_kept[bh] > 0;
    gate = kept ? 1.f : 0.f;
    int cnt = a.counts[(size_t)bh * a.nq + i];
    cnt = cnt < 0 ? 0 : (cnt > a.mk ? a.mk : cnt);
    steps = kept ? cnt : 0;
    list = a.kv_idx + ((size_t)bh * a.nq + i) * a.mk;
    if (a.kv_len != nullptr) len = min(a.kv_len[bh], a.Sk);
    bool bad = false;
    for (int j = tid; j < steps; j += blockDim.x) bad |= list[j] < 0 || list[j] >= a.nk;
    if (__syncthreads_or(bad)) {
      for (int e = tid; e < nrows * hd; e += blockDim.x) {
        const int row = row0 + e / hd;
        if (row < a.Sq) a.out[base_q + (size_t)row0 * hd + e] = from_f<TOut>(nan_f());
      }
      return;
    }
  } else {
    steps = a.nk;
    if (a.causal) {   // tiles wholly in the future of the last row
      const int last = row0 + nrows - 1;
      steps = min(a.nk, last / bk + 1);
    }
  }
  const float sc = a.score_scale != nullptr ? __fmul_rn(a.scale, a.score_scale[0]) : a.scale;

  for (int j = 0; j < steps; ++j) {
    const int blk = a.sparse ? list[j] : j;
    const int col0 = blk * bk;
    __syncthreads();   // the previous step's readers are done
    for (int e = tid; e < bk * hd; e += blockDim.x) {
      const int c = e / hd, d = e - c * hd;
      const int col = col0 + c;
      float kx = 0.f, vx = 0.f;
      if (col < a.Sk) {
        kx = to_f(a.k[base_k + (size_t)col * hd + d]);
        vx = to_f(a.v[base_k + (size_t)col * hd + d]);
      }
      k_s[c * (hd + 1) + d] = kx;
      v_s[e] = vx;
    }
    __syncthreads();

    for (int e = tid; e < R * bk; e += blockDim.x) {
      const int r = e / bk, c = e - r * bk;
      const int row = row0 + r, col = col0 + c;
      const float* qr = q_s + r * hd;
      const float* fr = fq_s + r * hd;
      const float* kr = k_s + c * (hd + 1);
      float s1 = 0.f, s2 = 0.f;
      if (a.approx) {
        for (int d = 0; d < hd; ++d) {
          const float kx = kr[d];
          s1 = fmaf(qr[d], kx, s1);
          s2 = fmaf(fr[d], kx - truncf(kx), s2);
        }
      } else {
        for (int d = 0; d < hd; ++d) s1 = fmaf(qr[d], kr[d], s1);
      }
      const bool valid = r < nrows && col < len && (!a.causal || row >= col);
      s_s[e] = valid ? __fmul_rn(a.approx ? s1 - s2 : s1, sc) : kNeg;
    }
    __syncthreads();

    for (int r = warp; r < R; r += nwarps) {
      float mx = kNeg;
      for (int c = lane; c < bk; c += 32) mx = fmaxf(mx, s_s[r * bk + c]);
      mx = warp_max(mx);
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      const int row = row0 + r;
      float sum = 0.f;
      for (int c = lane; c < bk; c += 32) {
        const int col = col0 + c;
        const bool valid = r < nrows && col < len && (!a.causal || row >= col);
        const float p = valid ? expf(s_s[r * bk + c] - m_new) : 0.f;
        s_s[r * bk + c] = round_to<TV>(p);
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
        c_s[r] = corr;
      }
    }
    __syncthreads();

    for (int e = tid; e < R * hd; e += blockDim.x) {
      const int r = e / hd, d = e - r * hd;
      const float* pr = s_s + r * bk;
      float pv = 0.f;
      for (int c = 0; c < bk; ++c) pv = fmaf(pr[c], v_s[c * hd + d], pv);
      acc_s[e] = acc_s[e] * c_s[r] + pv;
    }
  }
  __syncthreads();
  for (int e = tid; e < nrows * hd; e += blockDim.x) {
    const int r = e / hd;
    if (row0 + r >= a.Sq) continue;
    float l = l_s[r];
    l = l < 1e-30f ? 1e-30f : l;   // keeps NaN, like jnp.maximum
    a.out[base_q + (size_t)row0 * hd + e] = from_f<TOut>(acc_s[e] / l * gate);
  }
}

// Dynamic shared memory of one block: the layout at the top of tile_kernel.
inline size_t smem_bytes(int R, int hd, int bk) {
  return sizeof(float) * ((size_t)3 * R * hd + (size_t)bk * (hd + 1) +
                          (size_t)bk * hd + (size_t)R * bk + 3 * (size_t)R);
}

// Fills the grid fields of `a`, sets the shared-memory attribute and
// launches; returns the cudaError_t (0 = success). Above the 227 KB a
// block may use, the attribute call (and so the launch) is refused.
template <typename TIn, typename TV, typename TOut>
int launch(Args<TIn, TV, TOut> a, int BH, cudaStream_t stream) {
  a.nq = (a.Sq + a.bq - 1) / a.bq;
  a.nk = (a.Sk + a.bk - 1) / a.bk;
  a.R = a.bq < kMaxRows ? a.bq : kMaxRows;
  a.nsub = (a.bq + a.R - 1) / a.R;
  const size_t smem = smem_bytes(a.R, a.hd, a.bk);
  cudaError_t err = cudaFuncSetAttribute(
      tile_kernel<TIn, TV, TOut>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (BH == 0 || a.nq == 0) return 0;
  tile_kernel<TIn, TV, TOut><<<dim3(a.nq * a.nsub, BH), kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace attn_tile
