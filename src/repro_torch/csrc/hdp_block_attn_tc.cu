// Block-sparse FUM attention on Hopper's tensor cores (sm_90a), bf16 V.
//
// Replaces the TPU kernel repro/kernels/hdp_block_attn.py:
// hdp_block_sparse_attention (its pallas_call at :144), the paper's
// Fetch-Upon-Mask dataflow, for bf16 V, hd 64, 112 or 128 and 64- or 128-row
// blocks (the aligned prefill's shapes; other shapes and fp32 V take the
// CUDA-core tile kernel of hdp_block_attn.cu). For each (b*h, q tile)
// only the KV blocks listed in kv_idx[..., :counts] are loaded; scores
// QK^T - FQ.FK^T (fractions by trunc) times 1/sqrt(hd) and score_scale,
// masked to cols < kv_len (and rows >= cols under causal), an online
// softmax across the listed blocks, p rounded to bf16 for P.V; a head
// with head_kept = 0 loads nothing and writes zeros, a listed index
// outside [0, nk) turns the tile's rows to NaN, an empty row writes 0.
// The output is fp32 (the reference returns qq's dtype).
//
// Exact bf16 limbs. q and k are fp32 values on the Q4.12 fixed-point
// grid. Each splits exactly into three bf16 limbs: I = trunc(x) (an
// integer in [-16, 16]), F = x - I and F_hi = bf16(F), F_lo = F - F_hi
// (F has at most 12 significant bits, F_hi keeps 8 and the remainder
// fits bf16's 8). With approx on the score is
//   QQ.KQ^T - FQ.FK^T = IQ.IK + IQ.FK + FQ.IK
//     = IQ.IK + IQ.FK_hi + IQ.FK_lo + FQ_hi.IK + FQ_lo.IK,
// five bf16 tensor-core products into one fp32 accumulator, each limb
// product exact in fp32; approx off adds the four FQ.FK limb products.
// bf16 limbs were chosen over int8 ones (an exact int32 score needs FK
// in two int8 limbs and three separately weighted int32 accumulators,
// 192 registers a thread for a 16 x 128 tile) because they share the
// flash kernel's fragments, its softmax and its P.V step unchanged.
//
// Bound: at the prefill shapes the work of the listed blocks, 4 + 2
// flops per valid (row, col, d), is far above the bytes of Q, the listed
// K/V tiles and the output; the limb split makes all of it bf16
// tensor-core work, so the bound is the bf16 rate (the limbs execute
// 5 + 1 products, not 2 + 1).
//
// Design (wgmma.cuh, attn_mma.cuh): one CTA of block_q / 64 warpgroups
// per q tile of one (b*h); each warpgroup owns 64 rows. The CTA splits
// its fp32 Q tile into the three limb tiles in shared memory once. For
// each listed KV block it splits the fp32 K block into three limb tiles
// while the bf16 V block arrives by cp.async, all in the 128-byte
// swizzle wgmma reads; then each warpgroup issues the limb products as
// wgmma m64n{block_k}k16 with both operands in shared memory into one
// fp32 accumulator, applies the scale and masks, runs the online
// softmax, and P (bf16, registers) . V as wgmma m64n{hd}k16 with V read
// transposed. At hd 128 and 128 x 128 blocks the Q limbs, K limbs and V
// take 224 KB of shared memory, so the K/V blocks are not
// double-buffered: the next block's load waits for the current block's
// products. q tiles are launched last-first (the causal rows with the
// most listed blocks first).
//
// hd 112 (zamba2-7b) is padded in shared memory, never in global
// memory: the limb tiles, V and O stay 128 columns wide (the hd-128
// layouts, swizzle and shared memory, 230,400 bytes at 128 x 128
// blocks), the loads read 448-byte fp32 and 224-byte bf16 rows (HD_IN),
// columns 112-127 of every tile are zeroed once (zero limbs, exact +0
// terms), each limb product takes 7 k16 steps instead of 8, P.V stays
// m64n128 over V's zero columns, and the stores write only columns < 112.

#include "attn_mma.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace attn_mma;

// HD_IN: the head size of the rows in global memory; HD: the width of
// the tiles in shared memory and of O in registers (a multiple of 64)
template <int HD_IN, int BK>
struct Cfg {
  static constexpr int HD = HD_IN <= 64 ? 64 : 128;
  static constexpr int KLIMB = BK * HD * 2;       // bytes of one K limb tile
  // Q limbs, K limbs, V, and slack to align the tiles to 1024 bytes
  static int smem(int bq) { return 3 * bq * HD * 2 + 4 * KLIMB + 1024; }
};

struct Args {
  const float* q;            // [BH, Sq, hd] fp32 fixed grid
  const float* k;            // [BH, Sk, hd] fp32 fixed grid
  const bf16* v;             // [BH, Sk, hd]
  float* out;                // [BH, Sq, hd]
  const int* kv_idx;         // [BH, nq, mk]
  const int* counts;         // [BH, nq]
  const int* head_kept;      // [BH]
  const int* kv_len;         // [BH] or null
  const float* score_scale;  // [1] or null
  int Sq, Sk, bq, nq, nk, mk, causal, approx;
  float scale;               // fp32(1/sqrt(hd))
};

// I, F_hi, F_lo of a grid value, as floats (each exact in bf16)
__device__ __forceinline__ void limbs(float x, float& i, float& hi, float& lo) {
  i = truncf(x);
  const float f = x - i;
  hi = __bfloat162float(__float2bfloat16_rn(f));
  lo = f - hi;
}

// Splits row r, elements c..c+3 (x) of a swizzled tile of `rows` rows
// into the three limb tiles at t0, t0 + stride, t0 + 2 * stride.
__device__ __forceinline__ void store_limbs(uint8_t* t0, int stride, int rows,
                                            int r, int c, float4 x) {
  float i[4], hi[4], lo[4];
  limbs(x.x, i[0], hi[0], lo[0]);
  limbs(x.y, i[1], hi[1], lo[1]);
  limbs(x.z, i[2], hi[2], lo[2]);
  limbs(x.w, i[3], hi[3], lo[3]);
  const uint32_t off = wgmma::sw128(r, c >> 3, rows) + (c & 7) * 2;
  *reinterpret_cast<uint2*>(t0 + off) = make_uint2(pack_bf16(i[0], i[1]), pack_bf16(i[2], i[3]));
  *reinterpret_cast<uint2*>(t0 + stride + off) =
      make_uint2(pack_bf16(hi[0], hi[1]), pack_bf16(hi[2], hi[3]));
  *reinterpret_cast<uint2*>(t0 + 2 * stride + off) =
      make_uint2(pack_bf16(lo[0], lo[1]), pack_bf16(lo[2], lo[3]));
}

template <int HD_IN, int BK>
__global__ void __launch_bounds__(256, 1) block_tc_kernel(const Args a) {
  constexpr int HD = Cfg<HD_IN, BK>::HD, KLIMB = Cfg<HD_IN, BK>::KLIMB;
  constexpr int CH = HD_IN / 8, C4 = HD_IN / 4;   // 16-byte chunks, float4s of a row
  constexpr int NT = BK / 8;      // n-tiles of S
  constexpr int DT = HD / 8;      // n-tiles of O
  const int i = a.nq - 1 - (int)blockIdx.y;
  const int bh = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2;
  const int nthr = blockDim.x;
  const int bq = a.bq, row0 = i * bq;
  const int nrows = min(bq, a.Sq - row0);
  const size_t base_q = (size_t)bh * a.Sq * HD_IN;
  const size_t base_k = (size_t)bh * a.Sk * HD_IN;

  const bool kept = a.head_kept[bh] > 0;
  int steps = a.counts[(size_t)bh * a.nq + i];
  steps = kept ? (steps < 0 ? 0 : (steps > a.mk ? a.mk : steps)) : 0;
  const int* list = a.kv_idx + ((size_t)bh * a.nq + i) * a.mk;
  bool bad = false;
  for (int j = tid; j < steps; j += nthr) bad |= list[j] < 0 || list[j] >= a.nk;
  if (__syncthreads_or(bad) || !kept) {   // NaN rows, or a gated head's zeros
    const float fill = kept ? nan_f() : 0.f;
    for (int e = tid; e < nrows * HD_IN; e += nthr) a.out[base_q + (size_t)row0 * HD_IN + e] = fill;
    return;
  }
  const int len = a.kv_len != nullptr ? min(a.kv_len[bh], a.Sk) : a.Sk;
  const float sc = a.score_scale != nullptr ? __fmul_rn(a.scale, a.score_scale[0]) : a.scale;

  extern __shared__ uint8_t smem[];
  uint8_t* q_l = smem + (((smem_u32(smem) + 1023u) & ~1023u) - smem_u32(smem));
  uint8_t* k_l = q_l + 3 * bq * HD * 2;       // [3][BK][HD] limbs of K
  uint8_t* v_t = k_l + 3 * KLIMB;             // [BK][HD] V
  const int q_stride = bq * HD * 2;            // [3][bq][HD] limbs of Q

  for (int e = tid; e < bq * C4; e += nthr) {
    const int r = e / C4, c = (e - r * C4) * 4;
    const float4 x = r < nrows
        ? *reinterpret_cast<const float4*>(a.q + base_q + (size_t)(row0 + r) * HD_IN + c)
        : make_float4(0.f, 0.f, 0.f, 0.f);
    store_limbs(q_l, q_stride, bq, r, c, x);
  }
  for (int t = 0; t < 3; ++t) {   // the padding of the Q and K limbs and V
    zero_cols<HD, HD_IN>(smem_u32(q_l) + t * q_stride, bq, tid, nthr);
    zero_cols<HD, HD_IN>(smem_u32(k_l) + t * KLIMB, BK, tid, nthr);
  }
  zero_cols<HD, HD_IN>(smem_u32(v_t), BK, tid, nthr);

  float o[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
  const int r_lo = row0 + wg * 64 + (warp & 3) * 16 + (lane >> 2);
  // this warpgroup's rows in each Q limb tile; the K limb tiles; V
  const uint32_t qa = smem_u32(q_l) + wg * 64 * 128, ka = smem_u32(k_l);
  const uint32_t va = smem_u32(v_t);

  for (int j = 0; j < steps; ++j) {
    const int col0 = list[j] * BK;
    __syncthreads();   // the previous block's readers are done
    for (int c = tid; c < BK * CH; c += nthr) {
      const int r = c / CH, ch = c - r * CH;
      const bool ok = col0 + r < a.Sk;
      cp_async16(va + wgmma::sw128(r, ch, BK),
                 a.v + base_k + (size_t)(ok ? col0 + r : 0) * HD_IN + ch * 8, ok);
    }
    cp_async_commit();
#pragma unroll 4
    for (int e = tid; e < BK * C4; e += nthr) {
      const int r = e / C4, c = (e - r * C4) * 4;
      const float4 x = col0 + r < a.Sk
          ? *reinterpret_cast<const float4*>(a.k + base_k + (size_t)(col0 + r) * HD_IN + c)
          : make_float4(0.f, 0.f, 0.f, 0.f);
      store_limbs(k_l, KLIMB, BK, r, c, x);
    }
    cp_async_wait<0>();
    wgmma::fence_async_smem();   // the limbs and V, for wgmma's reads
    __syncthreads();

    // limbs 0, 1, 2 = I, F_hi, F_lo: IQ.IK + IQ.FK_hi + IQ.FK_lo +
    // FQ_hi.IK + FQ_lo.IK, and with approx off + FQ.FK
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    wgmma::fence();
    constexpr int KS = HD_IN / 16;
    qk<KS, BK>(s, qa, bq, ka, true);
    qk<KS, BK>(s, qa, bq, ka + KLIMB, false);
    qk<KS, BK>(s, qa, bq, ka + 2 * KLIMB, false);
    qk<KS, BK>(s, qa + q_stride, bq, ka, false);
    qk<KS, BK>(s, qa + 2 * q_stride, bq, ka, false);
    if (!a.approx) {
#pragma unroll
      for (int qf = 1; qf < 3; ++qf)
#pragma unroll
        for (int kf = 1; kf < 3; ++kf)
          qk<KS, BK>(s, qa + qf * q_stride, bq, ka + kf * KLIMB, false);
    }
    wgmma::commit();
    wgmma::wait<0>();

#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = col0 + n * 8 + (lane & 3) * 2 + (e & 1);
        const int row = r_lo + (e >> 1) * 8;
        const bool valid = col < len && (!a.causal || row >= col);
        s[n][e] = valid ? __fmul_rn(s[n][e], sc) : -INFINITY;
      }
    }
    softmax_step<NT, DT>(s, kLog2e, m, l, o);

    pv<HD, BK>(s, va, o);
  }

  finish_l(l);
  float* ob = a.out + base_q;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r_lo + h * 8;
    if (row >= row0 + nrows) continue;
#pragma unroll
    for (int d = 0; d < HD_IN / 8; ++d) {   // columns < HD_IN
      const int col = d * 8 + (lane & 3) * 2;
      *reinterpret_cast<float2*>(ob + (size_t)row * HD_IN + col) =
          make_float2(o[d][2 * h] / l[h], o[d][2 * h + 1] / l[h]);
    }
  }
}

template <int HD_IN, int BK>
int launch(Args a, int BH, cudaStream_t st) {
  const int smem = Cfg<HD_IN, BK>::smem(a.bq);
  cudaError_t err = cudaFuncSetAttribute(
      block_tc_kernel<HD_IN, BK>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (BH == 0 || a.nq == 0) return 0;
  block_tc_kernel<HD_IN, BK><<<dim3(BH, a.nq), a.bq * 2, smem, st>>>(a);   // a warpgroup per 64 rows
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// q, k fp32 fixed-grid and v bf16 [BH, S, hd]; out fp32 [BH, Sq, hd];
// hd 64, 112 or 128, bq and bk 64 or 128 (else cudaErrorInvalidValue).
// kv_len and score_scale may be null. Launches on `stream`; returns the
// cudaError_t of the launch (0 = success). Nothing is synchronised and
// nothing is allocated.
int hdp_block_attn_tc_launch(const float* q, const float* k, const void* v,
                             float* out, const int* kv_idx, const int* counts,
                             const int* head_kept, const int* kv_len,
                             const float* score_scale, int BH, int Sq, int Sk,
                             int hd, int bq, int bk, int mk, int causal,
                             int approx, float scale, void* stream) {
  Args a{};
  a.q = q; a.k = k; a.v = static_cast<const bf16*>(v); a.out = out;
  a.kv_idx = kv_idx; a.counts = counts; a.head_kept = head_kept;
  a.kv_len = kv_len; a.score_scale = score_scale;
  a.Sq = Sq; a.Sk = Sk; a.bq = bq; a.mk = mk;
  a.nq = (Sq + bq - 1) / bq; a.nk = (Sk + bk - 1) / bk;
  a.causal = causal; a.approx = approx; a.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bq != 64 && bq != 128) return static_cast<int>(cudaErrorInvalidValue);
  if (hd == 128 && bk == 128) return launch<128, 128>(a, BH, st);
  if (hd == 128 && bk == 64) return launch<128, 64>(a, BH, st);
  if (hd == 112 && bk == 128) return launch<112, 128>(a, BH, st);
  if (hd == 112 && bk == 64) return launch<112, 64>(a, BH, st);
  if (hd == 64 && bk == 128) return launch<64, 128>(a, BH, st);
  if (hd == 64 && bk == 64) return launch<64, 64>(a, BH, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* hdp_block_attn_tc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
