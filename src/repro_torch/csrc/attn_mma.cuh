// The products, the online softmax and the small helpers shared by the
// tensor-core attention kernels (flash_attention_tc.cu and
// hdp_block_attn_tc.cu; the wgmma instructions are in wgmma.cuh).
//
// Fragment layout. A warp of a warpgroup owns 16 rows of a wgmma
// m64nN accumulator; with g = lane / 4 and t = lane % 4 it holds, for
// each 8-column n-tile j, d[j][0], d[j][1] = (row g, columns 8j + 2t,
// 8j + 2t + 1) and d[j][2], d[j][3] = (row g + 8, the same columns): the
// C layout of mma.sync.m16n8k16. A row therefore lives in one quad of
// four threads, so the online softmax's row max and row sum need two
// shuffles, and the fp32 P fragment turns into the register A operand
// of P.V (rounded to bf16 there; the row sum l takes the unrounded p, as
// the reference does): A reg 0 = (row g, k 2t..2t+1), reg 1 = (row g+8,
// k 2t..), reg 2 = (row g, k 2t+8..), reg 3 = (row g+8, k 2t+8..).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace attn_mma {

constexpr float kNeg = -1e30f;            // initial row max, as the reference
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float nan_f() { return __int_as_float(0x7fc00000); }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy global -> shared; zero-fills when !pred (no
// byte is read then, but `src` must still be a valid address).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(pred ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Online-softmax step over one S tile held in registers. s holds raw
// scores, -inf where masked; `scale` (> 0) maps them to the exp2 domain
// (the softmax scale times log2 e). m and l are the rows' running max
// (exp2 domain) and this thread's partial row sum. On return s holds
// p = 2^(s * scale - m_new) (0 where masked), l and the output
// accumulator o are rescaled by 2^(m_old - m_new) and l has the
// (unrounded) p added.
template <int NT, int DT>
__device__ __forceinline__ void softmax_step(float (&s)[NT][4], float scale,
                                             float (&m)[2], float (&l)[2],
                                             float (&o)[DT][4]) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    mx[0] = fmaxf(mx[0], fmaxf(s[n][0], s[n][1]));
    mx[1] = fmaxf(mx[1], fmaxf(s[n][2], s[n][3]));
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    const float m_new = fmaxf(m[h], mx[h] * scale);
    const float corr = ex2(m[h] - m_new);
    m[h] = m_new;
    l[h] *= corr;
#pragma unroll
    for (int d = 0; d < DT; ++d) {
      o[d][2 * h] *= corr;
      o[d][2 * h + 1] *= corr;
    }
  }
#pragma unroll
  for (int n = 0; n < NT; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = ex2(fmaf(s[n][e], scale, -m[e >> 1]));
      s[n][e] = p;
      l[e >> 1] += p;
    }
  }
}

// S (+)= A . B^T over the first 16 KS columns for one warpgroup, as KS
// wgmma m64n{BN}k16 steps with K-major operands in 128-byte-swizzled
// shared memory: `a` at the warpgroup's first row of a tile of `a_rows`
// rows, `b` a BN-row tile. KS is the head size over 16 (7 at hd 112,
// whose tiles are 128 columns wide: the zero columns 112-127 are never
// multiplied). `first` starts the sum (its first step ignores s).
// Issued, not waited for; the caller fences before and commits after.
template <int KS, int BN>
__device__ __forceinline__ void qk(float (&s)[BN / 8][4], uint32_t a, int a_rows,
                                   uint32_t b, bool first) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const uint32_t off = (kk & 3) * 32;   // 16 columns inside a 64-column atom
    const uint64_t da = wgmma::desc(a + (kk >> 2) * (a_rows * 128) + off, 16, 1024);
    const uint64_t db = wgmma::desc(b + (kk >> 2) * (BN * 128) + off, 16, 1024);
    if constexpr (BN == 128) wgmma::wgmma_ss_n128(s, da, db, !(first && kk == 0));
    else wgmma::wgmma_ss_n64(s, da, db, !(first && kk == 0));
  }
}

// o += P . V for one warpgroup: P from the s registers, rounded to bf16
// one k16 step at a time, V a swizzled [BN x HD] tile at shared address
// v read transposed (MN-major: its 64-column sub-tiles lie BN * 128
// bytes apart). Waits for the products.
template <int HD, int BN>
__device__ __forceinline__ void pv(const float (&s)[BN / 8][4], uint32_t v,
                                   float (&o)[HD / 8][4]) {
  wgmma::fence();
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {
    const uint32_t p[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                           pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                           pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                           pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
    const uint64_t dv = wgmma::desc(v + kk * 16 * 128, BN * 128, 1024);
    if constexpr (HD == 128) wgmma::wgmma_rs_n128(o, p, dv);
    else wgmma::wgmma_rs_n64(o, p, dv);
  }
  wgmma::commit();
  wgmma::wait<0>();
}

// Zeroes columns HD_IN..HD-1 of a 128-byte-swizzled [rows x HD] bf16
// tile at shared address t (nothing when HD_IN == HD). The kernels call
// it once per tile: their loads write only columns < HD_IN, so the
// padding of a head size that is not a multiple of 64 stays zero.
template <int HD, int HD_IN>
__device__ __forceinline__ void zero_cols(uint32_t t, int rows, int tid,
                                          int nthr) {
  constexpr int PAD = (HD - HD_IN) / 8;   // 16-byte chunks a row
  if constexpr (PAD > 0) {
    for (int c = tid; c < rows * PAD; c += nthr) {
      const int r = c / PAD, ch = HD_IN / 8 + (c - r * PAD);
      asm volatile("st.shared.v4.u32 [%0], {%1, %1, %1, %1};\n"
                   :: "r"(t + wgmma::sw128(r, ch, rows)), "r"(0) : "memory");
    }
  }
}

// Completes l across the quad and floors it at 1e-30 (keeps NaN, like
// jnp.maximum), so an empty row writes 0.
__device__ __forceinline__ void finish_l(float (&l)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    l[h] = l[h] < 1e-30f ? 1e-30f : l[h];
  }
}

}  // namespace attn_mma
