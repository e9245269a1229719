// Dense flash attention on Hopper's tensor cores (sm_90a), bf16.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py:
// flash_attention (its pallas_call at :87) for bf16 q, k, v with hd 64,
// 112 or 128: softmax(q.k^T / sqrt(hd)) v with an online softmax over KV
// tiles, cols < Sk masked (ragged S) and, under causal, rows >= cols,
// KV tiles wholly in the future of the q tile skipped; fp32 scores and
// accumulators, p rounded to bf16 for P.V, the row sum of the unrounded
// p, the output in bf16. (fp32 and other head sizes take the CUDA-core
// tile kernel of flash_attention.cu.)
//
// hd 112 (zamba2-7b) is padded in shared memory, never in global
// memory: the tiles and the O accumulator stay 128 columns wide (the
// hd-128 layouts and swizzle), the copies read 224-byte rows (HD_IN),
// columns 112-127 of every tile are zeroed once, QK^T takes 7 k16 steps
// instead of 8, P.V stays m64n128 over the zero columns (1/7 more P.V
// work than needed), and the stores write only columns < 112.
//
// Bound: operations. At qwen2-1.5b's aligned prefill (B 2, 12 heads,
// S 4096, hd 128, causal) QK^T and P.V are ~1.0e11 flops against ~50 MB
// of q, k, v and output: far above the card's ~295 flops/byte ridge for
// bf16 tensor cores, so the bound is the bf16 tensor rate.
//
// Design (the FlashAttention schedule on wgmma; wgmma.cuh, attn_mma.cuh):
// * one CTA of two warpgroups per 128-row q tile of one (b*h); each
//   warpgroup owns 64 rows, and Q is loaded once;
// * K/V tiles of 128 rows (32 KB each at hd 128) come through a
//   two-stage ring of cp.async copies issued by all threads into the
//   128-byte-swizzled layout wgmma reads, K and V in separate groups:
//   the copy of tile j+1 is in flight while tile j is computed, and
//   S = Q.K^T starts before V has arrived;
// * S = Q.K^T as wgmma m64n128k16 with both operands in shared memory,
//   fp32 accumulators in registers; the ragged and causal masks only on
//   the tiles that need them; the online softmax per quad (scale and
//   log2 e folded into one FMA before exp2); P rounded to bf16 in
//   registers is the A operand of P.V, wgmma m64n{hd}k16 with V read
//   transposed (MN-major) from shared memory into a 64 x hd fp32
//   accumulator;
// * under causal the grid launches the q tiles with the most KV tiles
//   first, so the short tail tiles fill the card at the end.
// The tile sizes are the kernel's own: the wrapper's block_q/block_k
// only change where the reference rounds its online softmax. Not yet
// done: a TMA producer warp (the consumer threads issue the copies) and
// overlapping one warpgroup's softmax with the other's products.

#include "attn_mma.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace attn_mma;

constexpr int kWG = 2;                  // warpgroups, 64 q rows each
constexpr int kBM = 64 * kWG;           // q rows per CTA
constexpr int kBN = 128;                // KV rows per tile
constexpr int kThreads = 128 * kWG;

// HD_IN: the head size of the rows in global memory; HD: the width of
// the tiles in shared memory and of O in registers (a multiple of 64)
template <int HD_IN>
struct Cfg {
  static constexpr int HD = HD_IN <= 64 ? 64 : 128;
  static constexpr int TILE = kBN * HD * 2;          // bytes of a K or V tile
  static constexpr int QBYTES = kBM * HD * 2;
  // Q + 2 x (K, V), and slack to align the tiles to 1024 bytes
  static constexpr int SMEM = QBYTES + 4 * TILE + 1024;
};

// cp.async copy of ROWS rows of HD_IN columns from row r0 of src (rows
// >= nvalid read as zeros) into the swizzled tile at shared address dst
template <int HD_IN, int ROWS>
__device__ __forceinline__ void load_tile(const bf16* src, uint32_t dst, int r0,
                                          int nvalid, int tid) {
  constexpr int CH = HD_IN / 8;
  for (int c = tid; c < ROWS * CH; c += kThreads) {
    const int r = c / CH, ch = c - r * CH;
    const int gr = r0 + r;
    const bool ok = gr < nvalid;
    cp_async16(dst + wgmma::sw128(r, ch, ROWS), src + (size_t)(ok ? gr : 0) * HD_IN + ch * 8, ok);
  }
}

// all threads: their cp.async groups but the newest N are done, and the
// data are visible to every thread's wgmma
template <int N>
__device__ __forceinline__ void arrived() {
  cp_async_wait<N>();
  wgmma::fence_async_smem();
  __syncthreads();
}

template <int HD_IN>
__global__ void __launch_bounds__(kThreads, 1)
flash_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, bf16* __restrict__ out, int Sq,
                int Sk, int nq, int causal, float scale_log2) {
  constexpr int HD = Cfg<HD_IN>::HD, TILE = Cfg<HD_IN>::TILE;
  constexpr int NT = kBN / 8;     // n-tiles of S
  constexpr int DT = HD / 8;      // n-tiles of O
  const int i = causal ? nq - 1 - (int)blockIdx.y : (int)blockIdx.y;
  const int bh = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2;
  const int wrow = wg * 64 + (warp & 3) * 16;   // the warp's first row
  const int row0 = i * kBM;

  extern __shared__ uint8_t smem[];
  const uint32_t q_s = (smem_u32(smem) + 1023u) & ~1023u;
  const uint32_t kv_s = q_s + Cfg<HD_IN>::QBYTES;   // stage s: K at +2s*TILE, V after

  const bf16* qb = q + (size_t)bh * Sq * HD_IN;
  const bf16* kb = k + (size_t)bh * Sk * HD_IN;
  const bf16* vb = v + (size_t)bh * Sk * HD_IN;

  zero_cols<HD, HD_IN>(q_s, kBM, tid, kThreads);   // Q, then K, V of both stages
  for (int t = 0; t < 4; ++t) zero_cols<HD, HD_IN>(kv_s + t * TILE, kBN, tid, kThreads);

  int n_tiles = (Sk + kBN - 1) / kBN;
  if (causal) n_tiles = min(n_tiles, min(row0 + kBM - 1, Sq - 1) / kBN + 1);

  // cp.async groups: Q, then K and V of each tile in turn
  load_tile<HD_IN, kBM>(qb, q_s, row0, Sq, tid);
  cp_async_commit();
  if (n_tiles > 0) load_tile<HD_IN, kBN>(kb, kv_s, 0, Sk, tid);
  cp_async_commit();
  if (n_tiles > 0) load_tile<HD_IN, kBN>(vb, kv_s + TILE, 0, Sk, tid);
  cp_async_commit();

  float o[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
  const int r_lo = row0 + wrow + (lane >> 2);
  // this warpgroup's 64 Q rows, in every 64-column sub-tile
  const uint32_t q_wg = q_s + wg * 64 * 128;

  for (int j = 0; j < n_tiles; ++j) {
    const uint32_t k_t = kv_s + (j & 1) * 2 * TILE, v_t = k_t + TILE;
    arrived<1>();         // Q and K of tile j; every warp is past tile j-1
    if (j + 1 < n_tiles) {   // into the stage that tile j-1 used
      const uint32_t nxt = kv_s + ((j + 1) & 1) * 2 * TILE;
      load_tile<HD_IN, kBN>(kb, nxt, (j + 1) * kBN, Sk, tid);
      cp_async_commit();
      load_tile<HD_IN, kBN>(vb, nxt + TILE, (j + 1) * kBN, Sk, tid);
    } else {
      cp_async_commit();
    }
    cp_async_commit();

    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    wgmma::fence();
    qk<HD_IN / 16, kBN>(s, q_wg, kBM, k_t, true);
    wgmma::commit();
    wgmma::wait<0>();

    const int col0 = j * kBN;
    if (col0 + kBN > Sk || (causal && col0 + kBN - 1 > row0 + wrow)) {
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = col0 + n * 8 + (lane & 3) * 2 + (e & 1);
          const int row = r_lo + (e >> 1) * 8;
          if (col >= Sk || (causal && col > row)) s[n][e] = -INFINITY;
        }
    }
    softmax_step<NT, DT>(s, scale_log2, m, l, o);

    arrived<2>();         // V of tile j
    pv<HD, kBN>(s, v_t, o);
  }
  cp_async_wait<0>();   // nothing in flight at exit (no tile: Q's copy)

  finish_l(l);
  bf16* ob = out + (size_t)bh * Sq * HD_IN;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r_lo + h * 8;
    if (row >= Sq) continue;
#pragma unroll
    for (int d = 0; d < HD_IN / 8; ++d) {   // columns < HD_IN
      const int col = d * 8 + (lane & 3) * 2;
      *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)row * HD_IN + col) =
          __floats2bfloat162_rn(o[d][2 * h] / l[h], o[d][2 * h + 1] / l[h]);
    }
  }
}

template <int HD_IN>
int launch(const bf16* q, const bf16* k, const bf16* v, bf16* out, int BH,
           int Sq, int Sk, int causal, float scale, cudaStream_t st) {
  const int smem = Cfg<HD_IN>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      flash_tc_kernel<HD_IN>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nq = (Sq + kBM - 1) / kBM;
  if (BH == 0 || nq == 0) return 0;
  flash_tc_kernel<HD_IN><<<dim3(BH, nq), kThreads, smem, st>>>(
      q, k, v, out, Sq, Sk, nq, causal, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// bf16 q/k/v/out [BH, S, hd] row-major, hd 64, 112 or 128. Launches on
// `stream`; returns the cudaError_t of the launch (0 = success;
// cudaErrorInvalidValue for another hd). Nothing is synchronised and
// nothing is allocated.
int flash_attention_tc_launch(const void* q, const void* k, const void* v,
                              void* out, int BH, int Sq, int Sk, int hd,
                              int causal, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  bf16* op = static_cast<bf16*>(out);
  if (hd == 128) return launch<128>(qp, kp, vp, op, BH, Sq, Sk, causal, scale, st);
  if (hd == 112) return launch<112>(qp, kp, vp, op, BH, Sq, Sk, causal, scale, st);
  if (hd == 64) return launch<64>(qp, kp, vp, op, BH, Sq, Sk, causal, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* flash_attention_tc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
