// HDP integer scout for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/hdp_scout.py:hdp_scout (its
// pallas_call at :101): the paper's PE-array importance accumulation and
// Sparsity Engine. For each (b*h, q tile i) it multiplies the integer
// parts IQ of the tile by IK^T of every KV block, pools |s| per block
// into theta (rows < Sq, cols < Sk, and rows >= cols under causal),
// then computes the row threshold over the analytically valid blocks
// (block start < Sk, and under causal <= the tile's last row):
//   rho >= 0: c_ext*max + c_mean*mean,  rho < 0: c_ext*min + c_mean*mean
// and writes theta (0 for invalid blocks), keep = theta >= threshold
// and valid, and theta_head = the sum of a head's thetas.
//
// Design (a simple kernel that is right; speed is later work):
// * one block per (q tile, b*h); the TPU grid's sequential KV-chunk axis
//   becomes a loop over KV blocks inside the block, and theta's row
//   lives in shared memory until the Sparsity Engine step at the end
//   (the TPU carried it in VMEM scratch);
// * the integer parts fit in int8: the tile and each KV block are packed
//   four to a word in shared memory and multiplied with __dp4a, so every
//   score is exact in int32 and every block sum exact in 64 bits. theta
//   converts to fp32 once. (The reference's fp32 block sums are exact
//   only below 2^24; a 128x128 block of calibrated scores reaches 1e8.)
//   A value that is not an integer in [-128, 127] turns the tile's theta
//   to NaN and its keep to 0 instead of being silently wrapped;
// * the row mean is the exact sum of the fp32 thetas (in double) rounded
//   once, divided by the valid count; threshold products and sum are
//   written with __fmul_rn/__fadd_rn so no FMA contraction changes them.
//   theta_head sums across q tiles with 64-bit integer atomics (the sum
//   is exact, so its order does not matter); the last tile of a head to
//   finish converts it to fp32;
// * causally invalid blocks are skipped outright (theta 0).
//
// Bound: bytes at the sizes the model uses. It must read IQ and IK once
// (fp32 here, 2 x B*H*S*hd*4 bytes) and write theta and keep; the int8
// work it needs is one multiply-add per (valid row, valid col, d), which
// the card's int8 tensor-core rate clears faster than the bytes move.
// This kernel uses dp4a on CUDA cores out of shared memory and sits far
// above that bound; tensor-core int8 tiles (wgmma s8) are the later step.
//
// The C interface takes raw pointers and the stream; the wrapper
// (repro_torch/kernels/hdp_scout.py) checks shapes, dtypes, devices and
// alignment, allocates the outputs and the zeroed per-head scratch, and
// launches on PyTorch's current stream.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kBig = 1e30f;

struct Args {
  const float* iq;                 // [BH, Sq, hd] integer-valued
  const float* ik;                 // [BH, Sk, hd]
  float* theta;                    // [BH, nq, nk]
  uint8_t* keep;                   // [BH, nq, nk]
  float* theta_head;               // [BH]
  unsigned long long* head_acc;    // [BH] zeroed: exact sum of thetas
  int* head_done;                  // [BH] zeroed: q tiles finished
  int* head_bad;                   // [BH] zeroed: a tile saw bad input
  int Sq, Sk, hd, bq, bk, nq, nk;
  int causal, use_max;
  float c_ext, c_mean;
};

__device__ __forceinline__ float nan_f() { return __int_as_float(0x7fc00000); }

// one integer-valued fp32 in [-128, 127] -> its int8 byte; false otherwise
// (NaN fails x == truncf(x))
__device__ __forceinline__ bool byte_of(float x, unsigned& b) {
  const bool ok = x == truncf(x) && x >= -128.f && x <= 127.f;
  b = static_cast<unsigned>(static_cast<int>(ok ? x : 0.f)) & 0xffu;
  return ok;
}

// four consecutive values -> one packed word for __dp4a
__device__ __forceinline__ bool pack4(const float* p, int& word) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  unsigned b0, b1, b2, b3;
  const bool ok = byte_of(f.x, b0) & byte_of(f.y, b1) & byte_of(f.z, b2) &
                  byte_of(f.w, b3);
  word = static_cast<int>(b0 | (b1 << 8) | (b2 << 16) | (b3 << 24));
  return ok;
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(kThreads) scout_kernel(const Args a) {
  const int i = blockIdx.x, bh = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int W = a.hd >> 2, Wk = W + 1;   // k rows padded against bank conflicts

  extern __shared__ __align__(16) unsigned char smem[];
  unsigned long long* th_s = reinterpret_cast<unsigned long long*>(smem);  // [nk]
  unsigned long long* red_u = th_s + a.nk;                   // [kWarps]
  double* red_d = reinterpret_cast<double*>(red_u + kWarps); // [kWarps]
  float* red_lo = reinterpret_cast<float*>(red_d + kWarps);  // [kWarps]
  float* red_hi = red_lo + kWarps;                           // [kWarps]
  int* red_n = reinterpret_cast<int*>(red_hi + kWarps);      // [kWarps]
  float* thr_s = reinterpret_cast<float*>(red_n + kWarps);   // [1]
  int* q_s = reinterpret_cast<int*>(thr_s + 4);              // [bq, W]
  int* k_s = q_s + a.bq * W;                                 // [bk, Wk]

  const int row0 = i * a.bq;
  const int last_row = row0 + a.bq - 1;
  bool bad = false;
  const float* qb = a.iq + (size_t)bh * a.Sq * a.hd;
  for (int e = tid; e < a.bq * W; e += blockDim.x) {
    const int r = e / W, w = e - r * W;
    int word = 0;
    if (row0 + r < a.Sq) bad |= !pack4(qb + (size_t)(row0 + r) * a.hd + 4 * w, word);
    q_s[e] = word;
  }

  const float* kbase = a.ik + (size_t)bh * a.Sk * a.hd;
  for (int j = 0; j < a.nk; ++j) {
    const int col0 = j * a.bk;
    // analytic block validity (the same for every thread of the block)
    if (a.causal && col0 > last_row) {
      if (tid == 0) th_s[j] = 0ull;
      continue;
    }
    __syncthreads();   // the previous block's readers of k_s and red_u are done
    for (int e = tid; e < a.bk * W; e += blockDim.x) {
      const int c = e / W, w = e - c * W;
      int word = 0;
      if (col0 + c < a.Sk) bad |= !pack4(kbase + (size_t)(col0 + c) * a.hd + 4 * w, word);
      k_s[c * Wk + w] = word;
    }
    __syncthreads();
    unsigned long long part = 0ull;
    for (int e = tid; e < a.bq * a.bk; e += blockDim.x) {
      const int r = e / a.bk, c = e - r * a.bk;
      const int row = row0 + r, col = col0 + c;
      if (row < a.Sq && col < a.Sk && (!a.causal || row >= col)) {
        const int* qr = q_s + r * W;
        const int* kr = k_s + c * Wk;
        int s = 0;
        for (int w = 0; w < W; ++w) s = __dp4a(qr[w], kr[w], s);
        part += static_cast<unsigned long long>(s < 0 ? -s : s);
      }
    }
    part = warp_sum(part);
    if (lane == 0) red_u[warp] = part;
    __syncthreads();
    if (warp == 0) {
      unsigned long long v = lane < kWarps ? red_u[lane] : 0ull;
      v = warp_sum(v);
      if (lane == 0) th_s[j] = v;
    }
  }
  bad = __syncthreads_or(bad);   // also publishes th_s

  // ---- Sparsity Engine: statistics over the valid blocks of the row ----
  int n = 0;
  float lo = kBig, hi = -kBig;
  double sum = 0.0;
  unsigned long long tot = 0ull;
  for (int j = tid; j < a.nk; j += blockDim.x) {
    const int col0 = j * a.bk;
    if (col0 < a.Sk && (!a.causal || col0 <= last_row)) {
      const float t = __ull2float_rn(th_s[j]);
      ++n;
      lo = fminf(lo, t);
      hi = fmaxf(hi, t);
      sum += static_cast<double>(t);   // exact: each t < 2^31, few terms
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
  __syncthreads();   // red_u is reused below
  if (lane == 0) {
    red_n[warp] = n; red_d[warp] = sum; red_u[warp] = tot;
    red_lo[warp] = lo; red_hi[warp] = hi;
  }
  __syncthreads();
  if (tid == 0) {
    n = 0; sum = 0.0; tot = 0ull; lo = kBig; hi = -kBig;
    for (int w = 0; w < kWarps; ++w) {
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
    const int col0 = j * a.bk;
    const bool valid = col0 < a.Sk && (!a.causal || col0 <= last_row);
    const float t = valid ? __ull2float_rn(th_s[j]) : 0.f;
    a.theta[out0 + j] = bad ? nan_f() : t;
    a.keep[out0 + j] = (!bad && valid && t >= thr) ? 1 : 0;
  }
}

// Dynamic shared memory: the layout at the top of scout_kernel.
size_t smem_bytes(int nk, int bq, int bk, int hd) {
  const int W = hd / 4;
  return sizeof(unsigned long long) * ((size_t)nk + kWarps) +
         sizeof(double) * kWarps + sizeof(float) * 2 * kWarps +
         sizeof(int) * kWarps + sizeof(float) * 4 +
         sizeof(int) * ((size_t)bq * W + (size_t)bk * (W + 1));
}

}  // namespace

extern "C" {

// Launches the kernel on `stream`; returns the cudaError_t of the launch
// (0 = success). head_acc/head_done/head_bad must be zeroed by the
// caller. Nothing is synchronised and nothing is allocated.
int hdp_scout_launch(const float* iq, const float* ik, float* theta,
                     uint8_t* keep, float* theta_head,
                     unsigned long long* head_acc, int* head_done,
                     int* head_bad, int BH, int Sq, int Sk, int hd, int bq,
                     int bk, int causal, int use_max, float c_ext,
                     float c_mean, void* stream) {
  Args a;
  a.iq = iq; a.ik = ik; a.theta = theta; a.keep = keep;
  a.theta_head = theta_head; a.head_acc = head_acc;
  a.head_done = head_done; a.head_bad = head_bad;
  a.Sq = Sq; a.Sk = Sk; a.hd = hd; a.bq = bq; a.bk = bk;
  a.nq = (Sq + bq - 1) / bq;
  a.nk = (Sk + bk - 1) / bk;
  a.causal = causal; a.use_max = use_max;
  a.c_ext = c_ext; a.c_mean = c_mean;
  const size_t smem = smem_bytes(a.nk, bq, bk, hd);
  cudaError_t err = cudaFuncSetAttribute(
      scout_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (BH == 0 || a.nq == 0) return 0;
  scout_kernel<<<dim3(a.nq, BH), kThreads, smem,
                 static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

const char* hdp_scout_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
