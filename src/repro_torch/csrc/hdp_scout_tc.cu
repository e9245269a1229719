// HDP integer scout on Hopper's int8 tensor cores (sm_90a).
//
// Replaces the TPU kernel repro/kernels/hdp_scout.py:hdp_scout (its
// pallas_call at :101), the paper's PE array and Sparsity Engine, for hd
// a multiple of 32 up to 128 or hd 112 (zamba2-7b's, run as hd 128 on
// copies whose columns 112-127 are zero) and 64- or 128-row blocks (the
// aligned prefills' shapes; smaller head sizes and blocks take the dp4a
// kernel of hdp_scout.cu). The function is the same as there: for each
// (b*h, q tile i) |IQ.IK^T| pooled per KV block into theta (rows < Sq,
// cols < Sk, rows >= cols under causal), the row threshold over the
// analytically valid blocks (block start < Sk, and under causal <= the
// tile's last row), keep = theta >= threshold and valid, and theta_head
// = the sum of a head's thetas. A value that is not an integer in
// [-128, 127] turns the theta of every q tile that reads it to NaN, its
// keep to 0 and its head's theta_head to NaN.
//
// Exact. The integer parts fit in int8, so every score is an exact int32
// (|s| <= 128 * 128 * hd = 2^21 at hd 128; a zero byte of the padded
// copies adds an exact 0), a thread's sum of the |s| it
// holds for one block (64 of them) is an exact int32 (< 2^27), the
// block sums across the CTA are exact 64-bit integers, and theta rounds
// to fp32 once: theta equals the plain version's (exact float64 sums,
// rounded once) bit for bit, and so do keep and theta_head.
//
// Bound: bytes. The kernel must read IQ and IK once (fp32, 2 x B*H*S*hd
// x 4 bytes) and write theta and keep; the products, one int8
// multiply-add per (valid row, valid col, d), take less time at the
// int8 tensor-core rate.
//
// Design (wgmma.cuh, attn_mma.cuh):
// * a pre-pass (pack_kernel) converts IQ and IK once to int8 copies
//   padded with zero rows to whole blocks and, at hd 112, with zero
//   columns to rows of 128 bytes (hd 112 is 3.5 k32 steps, and the
//   128-byte swizzle wants whole rows), and flags each block of rows
//   that holds a bad value in its real columns. It reads the fp32 inputs once from device
//   memory, through their strides (the prefill passes [B, H, S, hd] views
//   of [B, S, H, hd] tensors); converting inside the main kernel instead
//   would convert each K block once per later q tile (16x at S 4096), at
//   ~60 instructions per four values;
// * one CTA per (b*h, q tile) with one warpgroup per 64 q rows; CTAs are
//   launched last tile first (under causal tile i walks i + 1 blocks,
//   so the heaviest start first). The q tile and a four-stage ring of K
//   blocks sit in shared memory as int8 rows of 128 bytes in the 128-byte
//   swizzle wgmma reads, written by cp.async; blocks t + 1 .. t + 3 are
//   in flight while block t's products run (the copies' row width hdp
//   is a template argument, so the k32 steps carry no branch);
// * each warpgroup issues hdp / 32 wgmma m64n{bk}k32 s8 products per
//   block into int32 accumulators, then takes |s| in registers (the
//   zero padding contributes 0; only blocks that cross the diagonal
//   mask row >= col), sums them per thread in int32 and across the warp
//   in 64 bits; the warps' sums of each block add up to its exact 64-bit
//   theta after the last block;
// * the Sparsity Engine step, the 64-bit theta_head atomics and the
//   bad-input rule are those of hdp_scout.cu.
//
// The C interface takes raw pointers and the stream; the wrapper
// (repro_torch/kernels/hdp_scout.py) checks shapes, dtypes, devices and
// alignment, allocates the outputs, the int8 copies, the block flags and
// the zeroed per-head scratch, and launches on PyTorch's current stream.

#include "attn_mma.cuh"

namespace {

using attn_mma::cp_async16;
using attn_mma::cp_async_commit;
using attn_mma::cp_async_wait;
using attn_mma::nan_f;
using attn_mma::smem_u32;

constexpr int kMaxWarps = 8;
constexpr int kStages = 4;   // the ring of K blocks in shared memory
constexpr float kBig = 1e30f;

// one of the two matrices the pre-pass converts
struct PackSide {
  const float* x;        // [B, H, S, hd], element (b, h, s, d) at
  long long sb, sh, ss;  //   b * sb + h * sh + s * ss + d
  int8_t* x8;            // [BH, n * blk, hdp]
  int* bad;              // [BH, n]: the block of rows holds a bad value
  int S, blk, n;
};

struct Args {
  const int8_t* iq8;               // [BH, nq * bq, hdp]
  const int8_t* ik8;               // [BH, nk * bk, hdp]
  const int* q_bad;                // [BH, nq]
  const int* k_bad;                // [BH, nk]
  float* theta;                    // [BH, nq, nk]
  uint8_t* keep;                   // [BH, nq, nk]
  float* theta_head;               // [BH]
  unsigned long long* head_acc;    // [BH] zeroed: exact sum of thetas
  int* head_done;                  // [BH] zeroed: q tiles finished
  int* head_bad;                   // [BH] zeroed: a tile saw bad input
  int Sk, bq, nq, nk;
  int causal, use_max;
  float c_ext, c_mean;
};

// one integer-valued fp32 in [-128, 127] -> its int8 byte; false otherwise
// (NaN fails x == truncf(x))
__device__ __forceinline__ bool byte_of(float x, uint32_t& b) {
  const bool ok = x == truncf(x) && x >= -128.f && x <= 127.f;
  b = static_cast<uint32_t>(static_cast<int>(ok ? x : 0.f)) & 0xffu;
  return ok;
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// grid (max(nq, nk), BH, 2): block j of rows of iq (z = 0) or ik (z = 1)
// to int8 rows of hdp bytes, four values per thread and step; rows past
// S and columns past hd are zero.
__global__ void __launch_bounds__(256) pack_kernel(const PackSide q,
                                                  const PackSide k, int H,
                                                  int hd, int hdp) {
  const PackSide p = blockIdx.z ? k : q;
  const int j = blockIdx.x, bh = blockIdx.y;
  if (j >= p.n) return;
  const int W = hd >> 2, Wp = hdp >> 2, blk = p.blk, S = p.S;
  const int row0 = j * blk;
  const float* src = p.x + (bh / H) * p.sb + (bh % H) * p.sh;
  uint32_t* dst = reinterpret_cast<uint32_t*>(
      p.x8 + ((size_t)bh * p.n * blk + row0) * hdp);
  bool ok = true;
#pragma unroll 4
  for (int e = threadIdx.x; e < blk * Wp; e += blockDim.x) {
    const int r = e / Wp, c = e - r * Wp;
    uint32_t word = 0;
    if (row0 + r < S && c < W) {
      const float4 f = __ldg(reinterpret_cast<const float4*>(
          src + (row0 + r) * p.ss + 4 * c));
      uint32_t b0, b1, b2, b3;
      ok &= byte_of(f.x, b0) & byte_of(f.y, b1) & byte_of(f.z, b2) &
            byte_of(f.w, b3);
      word = b0 | (b1 << 8) | (b2 << 16) | (b3 << 24);
    }
    dst[e] = word;
  }
  const bool bad = __syncthreads_or(!ok);
  if (threadIdx.x == 0) p.bad[(size_t)bh * p.n + j] = bad ? 1 : 0;
}

// `rows` int8 rows of hdp bytes at src -> a tile of 128-byte rows in the
// 128-byte swizzle (16-byte chunk c of row r at chunk c ^ (r & 7)), by
// cp.async (the caller commits); chunks past hdp / 16 are never read by
// the products.
__device__ __forceinline__ void load_tile(uint8_t* tile, const int8_t* src,
                                          int rows, int hdp) {
  const int ch = hdp >> 4;
  const uint32_t t = smem_u32(tile);
  for (int e = threadIdx.x; e < rows * ch; e += blockDim.x) {
    const int r = e / ch, c = e - r * ch;
    cp_async16(t + r * 128 + ((c ^ (r & 7)) << 4),
               src + (size_t)r * hdp + c * 16, true);
  }
}

// hdp / 32 = KS k32 steps, 32 bytes of a 128-byte row each
template <int BN, int KS>
__device__ __forceinline__ void issue(int (&d)[BN / 8][4], uint32_t qa,
                                      uint32_t kb) {
  wgmma::fence();
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const uint64_t da = wgmma::desc(qa + kk * 32, 16, 1024);
    const uint64_t db = wgmma::desc(kb + kk * 32, 16, 1024);
    if constexpr (BN == 128) wgmma::wgmma_s8_n128(d, da, db, kk > 0);
    else wgmma::wgmma_s8_n64(d, da, db, kk > 0);
  }
  wgmma::commit();
}

template <int BN, int KS>
__global__ void __launch_bounds__(256, 2) scout_tc_kernel(const Args a) {
  const int bh = blockIdx.x;
  const int i = a.nq - 1 - (int)blockIdx.y;   // the heaviest tiles first
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2, nwarps = blockDim.x >> 5;
  constexpr int hdp = KS * 32;
  const int bq = a.bq;
  const int row0 = i * bq;
  const int last_row = row0 + bq - 1;
  // the blocks this tile walks: every block, or under causal those that
  // start at or before the tile's last row (the analytically valid ones)
  const int nblk = a.causal ? min(a.nk, last_row / BN + 1) : a.nk;

  extern __shared__ uint8_t smem_raw[];
  uint8_t* q_t = smem_raw + (((smem_u32(smem_raw) + 1023u) & ~1023u) -
                             smem_u32(smem_raw));                 // [bq][128]
  uint8_t* k_t = q_t + bq * 128;                           // [kStages][BN][128]
  unsigned long long* th_w =                          // [nwarps][nk] warp sums
      reinterpret_cast<unsigned long long*>(k_t + kStages * BN * 128);
  unsigned long long* th_s = th_w + kMaxWarps * a.nk;           // [nk]
  unsigned long long* red_u = th_s + a.nk;                      // [kMaxWarps]
  double* red_d = reinterpret_cast<double*>(red_u + kMaxWarps);  // [kMaxWarps]
  float* red_lo = reinterpret_cast<float*>(red_d + kMaxWarps);   // [kMaxWarps]
  float* red_hi = red_lo + kMaxWarps;                            // [kMaxWarps]
  int* red_n = reinterpret_cast<int*>(red_hi + kMaxWarps);       // [kMaxWarps]
  float* thr_s = reinterpret_cast<float*>(red_n + kMaxWarps);    // [1]

  for (int j = nblk + tid; j < a.nk; j += blockDim.x) th_s[j] = 0ull;
  const int8_t* kbase = a.ik8 + (size_t)bh * a.nk * BN * hdp;
  load_tile(q_t, a.iq8 + ((size_t)bh * a.nq * bq + row0) * hdp, bq, hdp);
  cp_async_commit();
  // blocks 0 .. kStages - 2 in flight; one commit group per block (empty
  // past the last), so block t has landed once at most kStages - 2 newer
  // groups are pending
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < nblk)
      load_tile(k_t + t * BN * 128, kbase + (size_t)t * BN * hdp, BN, hdp);
    cp_async_commit();
  }
  bool bad = a.q_bad[(size_t)bh * a.nq + i] != 0;

  const uint32_t qa = smem_u32(q_t) + wg * 64 * 128;
  // accumulator element (n, e) of this thread: row r_lo + 8 (e >> 1),
  // column 8 n + c_lo + (e & 1) of the block
  const int r_lo = row0 + wg * 64 + (warp & 3) * 16 + (lane >> 2);
  const int c_lo = 2 * (lane & 3);
  for (int t = 0; t < nblk; ++t) {
    cp_async_wait<kStages - 2>();
    wgmma::fence_async_smem();
    // block t has landed for every thread, and every warpgroup's
    // products of block t - 1 (the stage refilled below) are done
    __syncthreads();
    int d[BN / 8][4];
    issue<BN, KS>(d, qa, smem_u32(k_t + (t % kStages) * BN * 128));
    const int tn = t + kStages - 1;
    if (tn < nblk)
      load_tile(k_t + (tn % kStages) * BN * 128,
                kbase + (size_t)tn * BN * hdp, BN, hdp);
    cp_async_commit();
    bad |= a.k_bad[(size_t)bh * a.nk + t] != 0;
    wgmma::wait<0>();

    const int col0 = t * BN;
    const bool diag = a.causal && col0 + BN - 1 > row0;
    uint32_t part = 0;   // <= 64 * 2^21
#pragma unroll
    for (int n = 0; n < BN / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int s = d[n][e];
        const uint32_t v = static_cast<uint32_t>(s < 0 ? -s : s);
        const bool in = !diag || r_lo + (e >> 1) * 8 >= col0 + n * 8 + c_lo + (e & 1);
        part += in ? v : 0u;
      }
    }
    const unsigned long long w =
        warp_sum(static_cast<unsigned long long>(part));
    if (lane == 0) th_w[warp * a.nk + t] = w;
  }
  bad = __syncthreads_or(bad);   // also publishes th_w
  for (int j = tid; j < nblk; j += blockDim.x) {
    unsigned long long v = 0ull;
    for (int w = 0; w < nwarps; ++w) v += th_w[w * a.nk + j];
    th_s[j] = v;
  }
  __syncthreads();

  // ---- Sparsity Engine: statistics over the valid blocks of the row ----
  int n = 0;
  float lo = kBig, hi = -kBig;
  double sum = 0.0;
  unsigned long long tot = 0ull;
  for (int j = tid; j < a.nk; j += blockDim.x) {
    const int col0 = j * BN;
    if (col0 < a.Sk && (!a.causal || col0 <= last_row)) {
      const float t = __ull2float_rn(th_s[j]);
      ++n;
      lo = fminf(lo, t);
      hi = fmaxf(hi, t);
      sum += static_cast<double>(t);   // exact: integers far below 2^53
      tot += th_s[j];
    }
  }
  n = warp_sum(n);
  sum = warp_sum(sum);
  tot = warp_sum(tot);
  for (int o = 16; o > 0; o >>= 1) {
    lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
  if (lane == 0) {
    red_n[warp] = n; red_d[warp] = sum; red_u[warp] = tot;
    red_lo[warp] = lo; red_hi[warp] = hi;
  }
  __syncthreads();
  if (tid == 0) {
    n = 0; sum = 0.0; tot = 0ull; lo = kBig; hi = -kBig;
    for (int w = 0; w < nwarps; ++w) {
      n += red_n[w]; sum += red_d[w]; tot += red_u[w];
      lo = fminf(lo, red_lo[w]); hi = fmaxf(hi, red_hi[w]);
    }
    const float cnt = n > 0 ? static_cast<float>(n) : 1.f;
    const float mean = __fdiv_rn(static_cast<float>(sum), cnt);
    const float ext = a.use_max ? hi : lo;
    thr_s[0] = __fadd_rn(__fmul_rn(ext, a.c_ext), __fmul_rn(mean, a.c_mean));
    // per-head theta sum: exact integer atomics, converted by the last
    // q tile of the head to finish
    if (bad) atomicOr(a.head_bad + bh, 1);
    else atomicAdd(a.head_acc + bh, tot);
    __threadfence();
    if (atomicAdd(a.head_done + bh, 1) == a.nq - 1) {
      __threadfence();
      const unsigned long long all = atomicAdd(a.head_acc + bh, 0ull);
      a.theta_head[bh] = atomicOr(a.head_bad + bh, 0) ? nan_f() : __ull2float_rn(all);
    }
  }
  __syncthreads();
  const float thr = thr_s[0];
  const size_t out0 = ((size_t)bh * a.nq + i) * a.nk;
  for (int j = tid; j < a.nk; j += blockDim.x) {
    const int col0 = j * BN;
    const bool valid = col0 < a.Sk && (!a.causal || col0 <= last_row);
    const float t = valid ? __ull2float_rn(th_s[j]) : 0.f;
    a.theta[out0 + j] = bad ? nan_f() : t;
    a.keep[out0 + j] = (!bad && valid && t >= thr) ? 1 : 0;
  }
}

// Dynamic shared memory: the layout at the top of scout_tc_kernel, and
// slack to align the tiles to 1024 bytes.
size_t smem_bytes(int nk, int bq, int bk) {
  return 1024 + (size_t)bq * 128 + kStages * (size_t)bk * 128 +
         sizeof(unsigned long long) * ((size_t)(kMaxWarps + 1) * nk + kMaxWarps) +
         sizeof(double) * kMaxWarps + sizeof(float) * 2 * kMaxWarps +
         sizeof(int) * kMaxWarps + sizeof(float) * 4;
}

template <int BN, int KS>
int launch(const Args& a, int BH, cudaStream_t st) {
  const size_t smem = smem_bytes(a.nk, a.bq, BN);
  cudaError_t err = cudaFuncSetAttribute(
      scout_tc_kernel<BN, KS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  // a warpgroup per 64 q rows
  scout_tc_kernel<BN, KS><<<dim3(BH, a.nq), 2 * a.bq, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// iq/ik fp32 [B, H, S, hd] integer parts with element strides q_s*/k_s*
// (d contiguous, rows 16-byte aligned); iq8/ik8 int8 scratch of
// [BH, nq * bq, hdp] and [BH, nk * bk, hdp], hdp = hd rounded up to a
// multiple of 32 (128 at hd 112); blk_bad int32 scratch of
// BH * (nq + nk); head_acc/head_done/head_bad zeroed by the caller. hd a
// multiple of 32 up to 128 or 112, bq and bk 64 or 128 (else
// cudaErrorInvalidValue). Launches the pre-pass and the scout on
// `stream`; returns the first cudaError_t (0 = success). Nothing is
// synchronised and nothing is allocated.
int hdp_scout_tc_launch(const float* iq, const float* ik, int8_t* iq8,
                        int8_t* ik8, int* blk_bad, float* theta,
                        uint8_t* keep, float* theta_head,
                        unsigned long long* head_acc, int* head_done,
                        int* head_bad, int B, int H, int Sq, int Sk, int hd,
                        int bq, int bk, long long q_sb, long long q_sh,
                        long long q_ss, long long k_sb, long long k_sh,
                        long long k_ss, int causal, int use_max, float c_ext,
                        float c_mean, void* stream) {
  const int BH = B * H;
  if ((hd != 112 && (hd % 32 || hd < 32 || hd > 128)) ||
      (bq != 64 && bq != 128) || (bk != 64 && bk != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  const int hdp = (hd + 31) / 32 * 32;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nq = (Sq + bq - 1) / bq, nk = (Sk + bk - 1) / bk;
  if (BH == 0 || nq == 0) return 0;
  const PackSide q{iq, q_sb, q_sh, q_ss, iq8, blk_bad, Sq, bq, nq};
  const PackSide k{ik, k_sb, k_sh, k_ss, ik8, blk_bad + (size_t)BH * nq, Sk,
                   bk, nk};
  pack_kernel<<<dim3(nq > nk ? nq : nk, BH, 2), 256, 0, st>>>(q, k, H, hd,
                                                               hdp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  Args a{};
  a.iq8 = iq8; a.ik8 = ik8; a.q_bad = q.bad; a.k_bad = k.bad;
  a.theta = theta; a.keep = keep; a.theta_head = theta_head;
  a.head_acc = head_acc; a.head_done = head_done; a.head_bad = head_bad;
  a.Sk = Sk; a.bq = bq; a.nq = nq; a.nk = nk;
  a.causal = causal; a.use_max = use_max; a.c_ext = c_ext; a.c_mean = c_mean;
  switch (hdp / 32 + (bk == 128 ? 0 : 4)) {
    case 1: return launch<128, 1>(a, BH, st);
    case 2: return launch<128, 2>(a, BH, st);
    case 3: return launch<128, 3>(a, BH, st);
    case 4: return launch<128, 4>(a, BH, st);
    case 5: return launch<64, 1>(a, BH, st);
    case 6: return launch<64, 2>(a, BH, st);
    case 7: return launch<64, 3>(a, BH, st);
    default: return launch<64, 4>(a, BH, st);
  }
}

const char* hdp_scout_tc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
