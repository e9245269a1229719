// Gather-free paged FUM decode for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/hdp_paged_decode.py:
// hdp_paged_fum_decode (its pallas_call at :189). It computes the same
// function, stages 2 and 3 of every HDP decode layer: for batch row b
// and kv head n it streams only the pool pages listed in
// page_ids[b, :counts[b]] (ascending logical order), dequantizes them
// (int8 codes x per-page [P,N] scale, code -128 -> NaN, a NaN scale
// poisons the page; an fp32 pool's K is snapped to the fixed-point
// grid), forms s = qq.K^T - frac(qq).frac(K)^T over sqrt(hd), masks
// column c of query row r unless c < kv_len[b] + r % Sq and the row's
// keep flag is set, and runs an online softmax across the pages. The
// G*Sq query rows of the GQA group (and of a multi-query verify call)
// share one page stream. A page that is not listed is never loaded.
//
// Design (a simple kernel that is right; speed is later work):
// * one block per (b, n); the TPU grid's sequential page axis becomes a
//   loop inside the block, and the block reads its own page_ids,
//   logical and counts (the TPU got them through scalar prefetch);
// * qq and frac(qq) for the G*Sq rows sit in shared memory; each kept
//   page's K and V for head n are loaded once (positions are N*hd
//   elements apart), dequantized on the way in with the page's scale
//   held in a register, and kept as fp32 in shared memory (K rows padded
//   by one float against bank conflicts);
// * per page: scores (one thread per (row, column)), per-row m and l
//   (one warp per row), then acc = acc*corr + p.V (one thread per
//   (row, d)); all fp32.
//
// Bound: bytes. Per (b, n) the kernel must read kept pages x ps x hd x 2
// int8 bytes (K and V); the arithmetic is ~6*hd flops per (row, column),
// at most a few times the bytes, so the card's memory rate is the
// limit. At qwen2-1.5b shapes (N = 2, B = 8) only B*N = 16 blocks exist
// for 132 SMs, so this kernel runs far below that bound: splitting each
// row's pages across blocks (with a second pass to merge the partial
// softmaxes) is the first thing a later change makes.
//
// The C interface takes raw pointers and the stream; the Python wrapper
// (repro_torch/kernels/hdp_paged_decode.py) checks shapes, dtypes,
// devices and contiguity, allocates the output and launches on
// PyTorch's current stream.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr int kThreads = 256;

struct Args {
  const float* qq;        // [B,N,G,Sq,hd]
  const void* k_pool;     // [P,ps,N,hd] int8 codes or fp32
  const void* v_pool;     // [P,ps,N,hd]
  const float* k_scale;   // [P,N] (quantized pools only)
  const float* v_scale;   // [P,N]
  const int* page_ids;    // [B,mk]
  const int* logical;     // [B,mk]
  const int* counts;      // [B]
  const int* keep;        // [B,mk,N,G,Sq]
  const int* kv_len;      // [B]
  float* out;             // [B,N,G,Sq,hd]
  int B, N, R, Sq, hd, ps, mk, P;
  int quantized, approx;
  float grid, lo, hi;     // fixed-point grid of fp32 pools
  float scale;            // 1/sqrt(hd)
};

__device__ __forceinline__ float nan_f() { return __int_as_float(0x7fc00000); }

__device__ __forceinline__ float dequant(int8_t c, float s) {
  return c == -128 ? nan_f() : static_cast<float>(c) * s;
}

// quantize_fixed: round half to even onto the grid, then clamp; NaN
// stays NaN (an fp32 pool's freed-page poison)
__device__ __forceinline__ float snap(float x, const Args& a) {
  float q = rintf(x * a.grid) / a.grid;
  return q < a.lo ? a.lo : (q > a.hi ? a.hi : q);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// one page's K (snapped/dequantized, rows padded to hd+1) and V into
// shared memory
__device__ void load_page(const Args& a, int pid, int n, float* k_s,
                          float* v_s) {
  const int hd = a.hd, ps = a.ps, N = a.N;
  float ks = 1.f, vs = 1.f;
  if (a.quantized) {
    ks = a.k_scale[(size_t)pid * N + n];
    vs = a.v_scale[(size_t)pid * N + n];
  }
  const size_t page0 = (size_t)pid * ps * N;
  // four elements per load: the wrapper checks hd % 4 == 0 and that both
  // pools are aligned to four elements
  const int hd4 = hd / 4;
  for (int i = threadIdx.x; i < ps * hd4; i += blockDim.x) {
    const int pos = i / hd4, d = (i - pos * hd4) * 4;
    const size_t g = ((page0 + (size_t)pos * N + n) * hd + d);
    float kv[4], vv[4];
    if (a.quantized) {
      const char4 kc = *reinterpret_cast<const char4*>(
          static_cast<const int8_t*>(a.k_pool) + g);
      const char4 vc = *reinterpret_cast<const char4*>(
          static_cast<const int8_t*>(a.v_pool) + g);
      kv[0] = dequant(kc.x, ks); kv[1] = dequant(kc.y, ks);
      kv[2] = dequant(kc.z, ks); kv[3] = dequant(kc.w, ks);
      vv[0] = dequant(vc.x, vs); vv[1] = dequant(vc.y, vs);
      vv[2] = dequant(vc.z, vs); vv[3] = dequant(vc.w, vs);
    } else {
      const float4 kf = *reinterpret_cast<const float4*>(
          static_cast<const float*>(a.k_pool) + g);
      const float4 vf = *reinterpret_cast<const float4*>(
          static_cast<const float*>(a.v_pool) + g);
      kv[0] = snap(kf.x, a); kv[1] = snap(kf.y, a);
      kv[2] = snap(kf.z, a); kv[3] = snap(kf.w, a);
      vv[0] = vf.x; vv[1] = vf.y; vv[2] = vf.z; vv[3] = vf.w;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      k_s[pos * (hd + 1) + d + e] = kv[e];
      v_s[pos * hd + d + e] = vv[e];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
fum_decode_kernel(const Args a) {
  const int n = blockIdx.x, b = blockIdx.y;
  const int R = a.R, hd = a.hd, ps = a.ps;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;

  extern __shared__ float smem[];
  float* q_s = smem;                      // [R, hd]
  float* fq_s = q_s + R * hd;             // [R, hd]
  float* acc_s = fq_s + R * hd;           // [R, hd]
  float* k_s = acc_s + R * hd;            // [ps, hd + 1]
  float* v_s = k_s + ps * (hd + 1);       // [ps, hd]
  float* s_s = v_s + ps * hd;             // [R, ps] scores, then p
  float* m_s = s_s + R * ps;              // [R]
  float* l_s = m_s + R;                   // [R]
  float* c_s = l_s + R;                   // [R] per-page correction
  int* keep_s = reinterpret_cast<int*>(c_s + R);   // [R]

  const size_t row0 = ((size_t)b * a.N + n) * R;   // first (b, n) row
  for (int i = tid; i < R * hd; i += blockDim.x) {
    const float q = a.qq[row0 * hd + i];
    q_s[i] = q;
    fq_s[i] = q - truncf(q);
    acc_s[i] = 0.f;
  }
  for (int r = tid; r < R; r += blockDim.x) {
    m_s[r] = kNeg;
    l_s[r] = 0.f;
  }
  int cnt = a.counts[b];
  cnt = cnt < 0 ? 0 : (cnt > a.mk ? a.mk : cnt);
  // an out-of-range page id is a caller bug: surface it as NaN output
  // rather than reading outside the pool
  bool bad = false;
  for (int j = tid; j < cnt; j += blockDim.x) {
    const int pid = a.page_ids[(size_t)b * a.mk + j];
    bad |= pid < 0 || pid >= a.P;
  }
  bad = __syncthreads_or(bad);
  if (bad) {
    for (int i = tid; i < R * hd; i += blockDim.x) a.out[row0 * hd + i] = nan_f();
    return;
  }
  const int kvl = a.kv_len[b];

  for (int j = 0; j < cnt; ++j) {
    __syncthreads();   // the previous page's readers are done
    const int pid = a.page_ids[(size_t)b * a.mk + j];
    const int col0 = a.logical[(size_t)b * a.mk + j] * ps;
    load_page(a, pid, n, k_s, v_s);
    for (int r = tid; r < R; r += blockDim.x)
      keep_s[r] = a.keep[(((size_t)b * a.mk + j) * a.N + n) * R + r];
    __syncthreads();

    // scores: s = (qq.k - fq.fk) * scale, masked to NEG
    for (int i = tid; i < R * ps; i += blockDim.x) {
      const int r = i / ps, c = i - r * ps;
      const float* qr = q_s + r * hd;
      const float* fr = fq_s + r * hd;
      const float* kr = k_s + c * (hd + 1);
      float s1 = 0.f, s2 = 0.f;
      for (int d = 0; d < hd; ++d) {
        const float k = kr[d];
        s1 = fmaf(qr[d], k, s1);
        s2 = fmaf(fr[d], k - truncf(k), s2);
      }
      const float s = (a.approx ? s1 - s2 : s1) * a.scale;
      const bool valid = col0 + c < kvl + r % a.Sq && keep_s[r] > 0;
      s_s[i] = valid ? s : kNeg;
    }
    __syncthreads();

    // per-row online-softmax statistics; p overwrites the scores
    for (int r = warp; r < R; r += nwarps) {
      float mx = kNeg;
      for (int c = lane; c < ps; c += 32) mx = fmaxf(mx, s_s[r * ps + c]);
      mx = warp_max(mx);
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      const bool row_keep = keep_s[r] > 0;
      const int lim = kvl + r % a.Sq;
      float sum = 0.f;
      for (int c = lane; c < ps; c += 32) {
        const bool valid = row_keep && col0 + c < lim;
        const float p = valid ? expf(s_s[r * ps + c] - m_new) : 0.f;
        s_s[r * ps + c] = p;
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

    // acc = acc * corr + p.V
    for (int i = tid; i < R * hd; i += blockDim.x) {
      const int r = i / hd, d = i - r * hd;
      const float* pr = s_s + r * ps;
      float pv = 0.f;
      for (int c = 0; c < ps; ++c) pv = fmaf(pr[c], v_s[c * hd + d], pv);
      acc_s[i] = acc_s[i] * c_s[r] + pv;
    }
  }
  __syncthreads();
  for (int i = tid; i < R * hd; i += blockDim.x) {
    float l = l_s[i / hd];
    l = l < 1e-30f ? 1e-30f : l;   // keeps NaN, like jnp.maximum
    a.out[row0 * hd + i] = acc_s[i] / l;
  }
}

// Dynamic shared memory of one (b, n) block: the layout at the top of
// fum_decode_kernel.
size_t smem_bytes(int R, int hd, int ps) {
  return sizeof(float) * ((size_t)3 * R * hd + (size_t)ps * (hd + 1) +
                          (size_t)ps * hd + (size_t)R * ps + 3 * (size_t)R) +
         sizeof(int) * (size_t)R;
}

}  // namespace

extern "C" {

// Launches the kernel on `stream`; returns the cudaError_t of the launch
// (0 = success). Nothing is synchronised and nothing is allocated.
int hdp_paged_fum_decode_launch(
    const float* qq, const void* k_pool, const void* v_pool,
    const float* k_scale, const float* v_scale, const int* page_ids,
    const int* logical, const int* counts, const int* keep,
    const int* kv_len, float* out, int B, int N, int G, int Sq, int hd,
    int ps, int mk, int P, int quantized, int approx, int int_bits,
    int frac_bits, float scale, void* stream) {
  Args a;
  a.qq = qq; a.k_pool = k_pool; a.v_pool = v_pool;
  a.k_scale = k_scale; a.v_scale = v_scale;
  a.page_ids = page_ids; a.logical = logical; a.counts = counts;
  a.keep = keep; a.kv_len = kv_len; a.out = out;
  a.B = B; a.N = N; a.R = G * Sq; a.Sq = Sq; a.hd = hd; a.ps = ps;
  a.mk = mk; a.P = P;
  a.quantized = quantized; a.approx = approx;
  a.grid = ldexpf(1.f, frac_bits);
  a.lo = -ldexpf(1.f, int_bits);
  a.hi = ldexpf(1.f, int_bits) - ldexpf(1.f, -frac_bits);
  a.scale = scale;   // 1/sqrt(hd) rounded once, as the plain version does
  // above the 227 KB a block may use, the attribute call (and so the
  // launch) is refused with cudaErrorInvalidValue
  const size_t smem = smem_bytes(a.R, hd, ps);
  cudaError_t err = cudaFuncSetAttribute(
      fum_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B == 0 || N == 0) return 0;
  fum_decode_kernel<<<dim3(N, B), kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

const char* hdp_paged_fum_decode_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
