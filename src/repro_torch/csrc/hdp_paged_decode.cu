// Gather-free paged FUM decode for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/hdp_paged_decode.py:
// hdp_paged_fum_decode (its pallas_call at :189). It computes the same
// function, stages 2 and 3 of every HDP decode layer: for batch row b
// and kv head n it streams only the pool pages listed in
// page_ids[b, :counts[b]] (ascending logical order), dequantizes them
// (int8 codes x per-page [P,N] scale, code -128 -> NaN; fp8 e4m3 V
// codes x their scale, 1.0 in the pool; a NaN scale poisons the page;
// an unquantized pool's K, fp32 or bf16, is snapped to the fixed-point
// grid), forms s = qq.K^T - frac(qq).frac(K)^T over sqrt(hd), masks
// column c of query row r unless c < kv_len[b] + r % Sq and the row's
// keep flag is set, and runs an online softmax across the pages (p is
// rounded to bf16 before p.V on a bf16 pool, as the TPU kernel casts p
// to V's dtype). The
// G*Sq query rows of the GQA group (and of a multi-query verify call)
// share one page stream. A page that is not listed is never loaded, and
// every listed page is loaded for every kv head (as the TPU kernel DMAs
// it), so a NaN on a listed page reaches the output even where p = 0.
//
// Bound: bytes. Per (b, n) the kernel must read the listed pages' K and
// V (ps x hd int8 or fp8 codes each, twice that for a bf16 pool, four
// times for fp32); the arithmetic is ~6*hd flops per (row,
// column), at most a few times the bytes. At qwen2-1.5b's decode (B 8,
// N 2) one block per (b, n) would leave 116 of 132 SMs idle and walk its
// pages one after another, latency-bound.
//
// Design:
// * the pages of each (b, n) are split across S blocks, grid (N, B,
//   S * RC): block s takes the listed pages whose logical slot is s mod
//   S (S comes from shapes alone, without reading counts; one warp
//   compacts the block's entries of the list into shared memory by
//   ballot before the page loop). A page goes
//   to its block by its slot and not by its place in the list, so that
//   a query row's partial sums group alike whatever else is listed: the
//   list of a multi-query verify call is the union over its rows, and a
//   listed page that row r does not keep is an exact no-op for r (m
//   stays, the correction is e^0 = 1, p = 0). Row r of a verify call
//   then gives the bits of the single step at its position, which the
//   speculative round's exact-match accept relies on. Each block runs
//   the online softmax over its pages and, for S > 1, writes its
//   partial (acc, m, l) per row to a workspace; a block with no page
//   writes m = -1e30, l = 0, acc = 0. A second kernel
//   (fum_merge_kernel), one block per (b, n), merges them: m* = max m_s,
//   out = sum acc_s e^(m_s - m*) / max(sum l_s e^(m_s - m*), 1e-30), so a
//   NaN partial stays NaN. S = 1 writes the output directly;
// * the G*Sq query rows split into RC chunks of at most 16 * (256 /
//   max(ps, hd)) rows (32 at ps = hd = 128), one block each, which
//   share the page list and each stream the pages (the later chunks
//   mostly from L2). A verify call's rows go past what one block holds
//   (48 at qwen2-1.5b's G = 6 and 8 drafts): its q, fraction and score
//   tiles would pass the 227 KB of shared memory, and 32 rows a thread
//   would spill registers. A row's arithmetic does not depend on its
//   chunk, so the split changes no bit;
// * inside a block: qq and frac(qq) for the G*Sq rows sit in shared
//   memory; an int8 page's K and V codes are loaded 16 bytes a thread
//   (int4) into registers while the block computes the previous page
//   (two pages in flight), then dequantized on the way into shared
//   memory as fp32 (fp8 V through an exact bit decode of e4m3);
//   unquantized pools are loaded four elements a thread (float4, or
//   8 bytes of bf16) and snapped on the way in, one page at a time
//   (their registers would not hold a second page). The pool format is a
//   template argument, so each format compiles to its own loads;
// * per page: scores with one thread per (column, group of RPT rows),
//   each K value and its fraction read once (float4 along d) for all of
//   the thread's rows; per-row m and l (one warp per row); p.V with one
//   thread per (d, group of RPT rows), its rows' accumulators in
//   registers. The rows are padded to whole groups with zero rows, so
//   the inner loops carry no per-row test. All fp32, each sum in
//   ascending d or column order, as in the one-pass arithmetic of the
//   first version of this kernel.
//
// The C interface takes raw pointers and the stream; the Python wrapper
// (repro_torch/kernels/hdp_paged_decode.py) checks shapes, dtypes,
// devices and contiguity, picks S, allocates the output and the
// workspace and launches on PyTorch's current stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float kNeg = -1e30f;
constexpr int kThreads = 256;

// pool formats: int8 K and V with scales; int8 K with scales and fp8
// e4m3 V (scale 1.0); unquantized fp32 or bf16 K and V
enum Fmt { kI8 = 0, kI8Fp8 = 1, kF32 = 2, kBf16 = 3 };

struct Args {
  const float* qq;        // [B,N,G,Sq,hd]
  const void* k_pool;     // [P,ps,N,hd] int8 codes, fp32 or bf16
  const void* v_pool;     // [P,ps,N,hd]
  const float* k_scale;   // [P,N] (quantized pools only)
  const float* v_scale;   // [P,N]
  const int* page_ids;    // [B,mk]
  const int* logical;     // [B,mk]
  const int* counts;      // [B]
  const int* keep;        // [B,mk,N,G,Sq]
  const int* kv_len;      // [B]
  float* out;             // [B,N,G,Sq,hd]
  float* part;            // [B,N,S,R,hd+2] partials (S > 1)
  unsigned long long* runs;  // [1] the kernel's run count, or null
  // R: G*Sq rows; Rb: rows a block takes (R in RC chunks); Rp: Rb
  // padded to whole RPT groups
  int B, N, R, Rb, Rp, Sq, hd, ps, mk, P, S;
  int approx;
  float grid, lo, hi;     // fixed-point grid of fp32 pools
  float scale;            // 1/sqrt(hd)
};

__device__ __forceinline__ float nan_f() { return __int_as_float(0x7fc00000); }

__device__ __forceinline__ float dequant(int8_t c, float s) {
  return c == -128 ? nan_f() : static_cast<float>(c) * s;
}

// float8_e4m3fn code -> float, exactly: bias 7, no infinity, S.1111.111
// is NaN, exponent 0 is subnormal (m x 2^-9)
__device__ __forceinline__ float fp8_e4m3(int8_t code) {
  const unsigned c = static_cast<unsigned char>(code);
  const unsigned sign = (c & 0x80u) << 24, e = (c >> 3) & 0xFu, m = c & 7u;
  if (e == 15u && m == 7u) return nan_f();
  if (e == 0u) {
    const float v = static_cast<float>(m) * 0.001953125f;
    return sign ? -v : v;
  }
  return __uint_as_float(sign | ((e + 120u) << 23) | (m << 20));
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
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

// code x of a 16- or 4-byte load (x a constant after unrolling)
__device__ __forceinline__ int8_t byte_at(const int4& v, int x) {
  const int w = x < 4 ? v.x : (x < 8 ? v.y : (x < 12 ? v.z : v.w));
  return static_cast<int8_t>(w >> (8 * (x & 3)));
}

__device__ __forceinline__ int8_t byte_at(int v, int x) {
  return static_cast<int8_t>(v >> (8 * (x & 3)));
}

// One int8 page's K and V codes (V int8 or fp8 e4m3 bytes, FP8) for
// head n, held in registers: VB codes per load (16 when hd % 16 == 0,
// else 4), up to ps*hd/VB/kThreads loads a thread for each of K and V.
template <int VB, bool FP8>
struct Codes {
  using Vec = typename std::conditional<VB == 16, int4, int>::type;
  static constexpr int kMax = 128 * 128 / VB / kThreads;
  Vec k[kMax], v[kMax];
  float ks, vs;

  __device__ __forceinline__ void fetch(const Args& a, int pid, int n) {
    const int per_row = a.hd / VB, total = a.ps * per_row;
    const size_t page0 = (size_t)pid * a.ps * a.N;
    ks = a.k_scale[(size_t)pid * a.N + n];
    vs = a.v_scale[(size_t)pid * a.N + n];
#pragma unroll
    for (int u = 0; u < kMax; ++u) {
      const int e = threadIdx.x + u * kThreads;
      if (e < total) {
        const int pos = e / per_row, d = (e - pos * per_row) * VB;
        const size_t g = (page0 + (size_t)pos * a.N + n) * a.hd + d;
        k[u] = *reinterpret_cast<const Vec*>(static_cast<const int8_t*>(a.k_pool) + g);
        v[u] = *reinterpret_cast<const Vec*>(static_cast<const int8_t*>(a.v_pool) + g);
      }
    }
  }

  __device__ __forceinline__ float vdec(int8_t c) const {
    return FP8 ? fp8_e4m3(c) * vs : dequant(c, vs);
  }

  // dequantize into k_s [ps, hd+4] and v_s [ps, hd], four values a store
  __device__ __forceinline__ void store(const Args& a, float* k_s, float* v_s) const {
    const int per_row = a.hd / VB, total = a.ps * per_row;
#pragma unroll
    for (int u = 0; u < kMax; ++u) {
      const int e = threadIdx.x + u * kThreads;
      if (e < total) {
        const int pos = e / per_row, d = (e - pos * per_row) * VB;
#pragma unroll
        for (int x = 0; x < VB; x += 4) {
          *reinterpret_cast<float4*>(k_s + pos * (a.hd + 4) + d + x) = make_float4(
              dequant(byte_at(k[u], x), ks), dequant(byte_at(k[u], x + 1), ks),
              dequant(byte_at(k[u], x + 2), ks), dequant(byte_at(k[u], x + 3), ks));
          *reinterpret_cast<float4*>(v_s + pos * a.hd + d + x) = make_float4(
              vdec(byte_at(v[u], x)), vdec(byte_at(v[u], x + 1)),
              vdec(byte_at(v[u], x + 2)), vdec(byte_at(v[u], x + 3)));
        }
      }
    }
  }
};

// Four consecutive pool elements as floats: one float4 of fp32, or one
// 8-byte load of bf16 (a bf16 is the top half of its float).
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(w.x << 16), __uint_as_float(w.x & 0xffff0000u),
                     __uint_as_float(w.y << 16), __uint_as_float(w.y & 0xffff0000u));
}

// One unquantized page's K (snapped to the grid) and V for head n into
// shared memory, four elements per load; T is float or __nv_bfloat16.
template <typename T>
__device__ __forceinline__ void load_float(const Args& a, int pid, int n,
                                           float* k_s, float* v_s) {
  const int hd4 = a.hd / 4;
  const size_t page0 = (size_t)pid * a.ps * a.N;
#pragma unroll 4
  for (int i = threadIdx.x; i < a.ps * hd4; i += kThreads) {
    const int pos = i / hd4, d = (i - pos * hd4) * 4;
    const size_t g = (page0 + (size_t)pos * a.N + n) * a.hd + d;
    const float4 kf = load4(static_cast<const T*>(a.k_pool) + g);
    const float4 vf = load4(static_cast<const T*>(a.v_pool) + g);
    *reinterpret_cast<float4*>(k_s + pos * (a.hd + 4) + d) =
        make_float4(snap(kf.x, a), snap(kf.y, a), snap(kf.z, a), snap(kf.w, a));
    *reinterpret_cast<float4*>(v_s + pos * a.hd + d) = vf;
  }
}

// F: the pool format (Fmt); VB: codes per int8 load; RPT: rows per
// thread group (the groups, Rp / RPT, fit 256 / ps and 256 / hd).
template <int F, int VB, int RPT>
__global__ void __launch_bounds__(kThreads)
fum_decode_kernel(const Args a) {
  constexpr bool Q = F == kI8 || F == kI8Fp8;
  const int n = blockIdx.x, b = blockIdx.y;
  const int s = blockIdx.z % a.S, r0 = blockIdx.z / a.S * a.Rb;
  // this block's rows: global rows r0 .. r0 + R - 1
  const int R = min(a.Rb, a.R - r0), Rp = a.Rp, hd = a.hd, ps = a.ps;
  const int S = a.S;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = kThreads >> 5, ngrp = Rp / RPT;
  if (a.runs && tid == 0 && (blockIdx.x | blockIdx.y | blockIdx.z) == 0)
    atomicAdd(a.runs, 1ull);

  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);   // [Rp, hd], zero past R
  float* fq_s = q_s + Rp * hd;            // [Rp, hd]
  float* v_s = fq_s + Rp * hd;            // [ps, hd]
  float* k_s = v_s + ps * hd;             // [ps, hd + 4]
  float* s_s = k_s + ps * (hd + 4);       // [Rp, ps] scores, then p
  float* m_s = s_s + Rp * ps;             // [Rb]
  float* l_s = m_s + a.Rb;                // [Rb]
  float* c_s = l_s + a.Rb;                // [Rb] per-page correction
  int* keep_s = reinterpret_cast<int*>(c_s + a.Rb);   // [Rb]
  int* list_s = keep_s + a.Rb;            // [mk] this block's list entries
  __shared__ int n_mine_s;

  // the block's first row in the [B,N,R] rows of qq and out
  const size_t row0 = ((size_t)b * a.N + n) * a.R + r0;
  for (int i = tid; i < Rp * hd; i += kThreads) {
    const float q = i < R * hd ? a.qq[row0 * hd + i] : 0.f;
    q_s[i] = q;
    fq_s[i] = q - truncf(q);
  }
  for (int r = tid; r < R; r += kThreads) {
    m_s[r] = kNeg;
    l_s[r] = 0.f;
  }
  int cnt = a.counts[b];
  cnt = cnt < 0 ? 0 : (cnt > a.mk ? a.mk : cnt);
  // this block's pages: the list entries whose logical slot is s mod S,
  // in list order, compacted by warp 0 (32 entries a ballot)
  if (warp == 0) {
    int mine_n = 0;
    for (int base = 0; base < cnt; base += 32) {
      const int j = base + lane;
      const bool mine = j < cnt && a.logical[(size_t)b * a.mk + j] % S == s;
      const unsigned m = __ballot_sync(0xffffffffu, mine);
      if (mine) list_s[mine_n + __popc(m & ((1u << lane) - 1u))] = j;
      mine_n += __popc(m);
    }
    if (lane == 0) n_mine_s = mine_n;
  }
  // an out-of-range page id is a caller bug: surface it as NaN output
  // rather than reading outside the pool (every block of the row checks
  // the whole list, so all of its partials agree)
  bool bad = false;
  for (int j = tid; j < cnt; j += kThreads) {
    const int pid = a.page_ids[(size_t)b * a.mk + j];
    bad |= pid < 0 || pid >= a.P;
  }
  bad = __syncthreads_or(bad);
  float* pb = a.part + ((((size_t)b * a.N + n) * S + s) * a.R + r0) * (hd + 2);
  if (bad) {
    for (int i = tid; i < R * (hd + 2); i += kThreads) {
      const int c = i % (hd + 2);
      if (S == 1) {
        if (c < hd) a.out[row0 * hd + (i / (hd + 2)) * hd + c] = nan_f();
      } else {
        pb[i] = c < hd ? nan_f() : (c == hd ? kNeg : 0.f);
      }
    }
    return;
  }
  const int kvl = a.kv_len[b];

  // scores: column c, rows sg * RPT + u; p.V: column d, rows pg * RPT + u
  const int c = tid % ps, sg = tid / ps;
  const int d = tid % hd, pg = tid / hd;
  float acc[RPT];
#pragma unroll
  for (int u = 0; u < RPT; ++u) acc[u] = 0.f;

  Codes<VB, F == kI8Fp8> codes;
  const int n_mine = n_mine_s;   // written before the barrier above
  if constexpr (Q) {
    if (n_mine > 0) codes.fetch(a, a.page_ids[(size_t)b * a.mk + list_s[0]], n);
  }
  for (int i = 0; i < n_mine; ++i) {
    const int j = list_s[i];
    __syncthreads();   // the previous page's readers are done
    const int col0 = a.logical[(size_t)b * a.mk + j] * ps;
    if constexpr (Q) {
      codes.store(a, k_s, v_s);
      if (i + 1 < n_mine)
        codes.fetch(a, a.page_ids[(size_t)b * a.mk + list_s[i + 1]], n);
    } else {
      using T = typename std::conditional<F == kBf16, __nv_bfloat16, float>::type;
      load_float<T>(a, a.page_ids[(size_t)b * a.mk + j], n, k_s, v_s);
    }
    for (int r = tid; r < R; r += kThreads)
      keep_s[r] = a.keep[(((size_t)b * a.mk + j) * a.N + n) * a.R + r0 + r];
    __syncthreads();

    // scores: s = (qq.k - fq.fk) * scale, masked to NEG (0 in pad rows)
    if (sg < ngrp) {
      float s1[RPT], s2[RPT];
#pragma unroll
      for (int u = 0; u < RPT; ++u) s1[u] = s2[u] = 0.f;
      const float* kr = k_s + c * (hd + 4);
      const float* qb = q_s + sg * RPT * hd;
      const float* fb = fq_s + sg * RPT * hd;
#pragma unroll 2
      for (int e = 0; e < hd; e += 4) {
        const float4 k = *reinterpret_cast<const float4*>(kr + e);
        const float4 fk = make_float4(k.x - truncf(k.x), k.y - truncf(k.y),
                                      k.z - truncf(k.z), k.w - truncf(k.w));
#pragma unroll
        for (int u = 0; u < RPT; ++u) {
          const float4 q = *reinterpret_cast<const float4*>(qb + u * hd + e);
          const float4 f = *reinterpret_cast<const float4*>(fb + u * hd + e);
          s1[u] = fmaf(q.x, k.x, s1[u]); s2[u] = fmaf(f.x, fk.x, s2[u]);
          s1[u] = fmaf(q.y, k.y, s1[u]); s2[u] = fmaf(f.y, fk.y, s2[u]);
          s1[u] = fmaf(q.z, k.z, s1[u]); s2[u] = fmaf(f.z, fk.z, s2[u]);
          s1[u] = fmaf(q.w, k.w, s1[u]); s2[u] = fmaf(f.w, fk.w, s2[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < RPT; ++u) {
        const int r = sg * RPT + u;
        const float sc = (a.approx ? s1[u] - s2[u] : s1[u]) * a.scale;
        const bool valid = r < R && col0 + c < kvl + (r0 + r) % a.Sq && keep_s[r] > 0;
        s_s[r * ps + c] = r < R ? (valid ? sc : kNeg) : 0.f;
      }
    }
    __syncthreads();

    // per-row online-softmax statistics; p overwrites the scores (l sums
    // p before a bf16 pool's rounding, as the TPU kernel does)
    for (int r = warp; r < R; r += nwarps) {
      float mx = kNeg;
      for (int cc = lane; cc < ps; cc += 32) mx = fmaxf(mx, s_s[r * ps + cc]);
      mx = warp_max(mx);
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      const bool row_keep = keep_s[r] > 0;
      const int lim = kvl + (r0 + r) % a.Sq;
      float sum = 0.f;
      for (int cc = lane; cc < ps; cc += 32) {
        const bool valid = row_keep && col0 + cc < lim;
        const float p = valid ? expf(s_s[r * ps + cc] - m_new) : 0.f;
        s_s[r * ps + cc] = F == kBf16 ? round_bf16(p) : p;
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
    if (pg < ngrp) {
      float pv[RPT];
#pragma unroll
      for (int u = 0; u < RPT; ++u) pv[u] = 0.f;
      const float* pr = s_s + pg * RPT * ps;
      int cc = 0;
      if (ps % 4 == 0) {   // p four columns a load (rows 16-byte aligned)
#pragma unroll 2
        for (; cc < ps; cc += 4) {
          const float v0 = v_s[cc * hd + d], v1 = v_s[(cc + 1) * hd + d];
          const float v2 = v_s[(cc + 2) * hd + d], v3 = v_s[(cc + 3) * hd + d];
#pragma unroll
          for (int u = 0; u < RPT; ++u) {
            const float4 p = *reinterpret_cast<const float4*>(pr + u * ps + cc);
            pv[u] = fmaf(p.x, v0, pv[u]);
            pv[u] = fmaf(p.y, v1, pv[u]);
            pv[u] = fmaf(p.z, v2, pv[u]);
            pv[u] = fmaf(p.w, v3, pv[u]);
          }
        }
      }
      for (; cc < ps; ++cc) {
        const float v = v_s[cc * hd + d];
#pragma unroll
        for (int u = 0; u < RPT; ++u) pv[u] = fmaf(pr[u * ps + cc], v, pv[u]);
      }
#pragma unroll
      for (int u = 0; u < RPT; ++u) {
        const int r = pg * RPT + u;
        if (r < R) acc[u] = acc[u] * c_s[r] + pv[u];
      }
    }
  }
  __syncthreads();
  if (pg < ngrp) {
#pragma unroll
    for (int u = 0; u < RPT; ++u) {
      const int r = pg * RPT + u;
      if (r >= R) continue;
      if (S == 1) {
        float l = l_s[r];
        l = l < 1e-30f ? 1e-30f : l;   // keeps NaN, like jnp.maximum
        a.out[(row0 + r) * hd + d] = acc[u] / l;
      } else {
        float* pr = pb + (size_t)r * (hd + 2);
        pr[d] = acc[u];
        if (d == 0) {
          pr[hd] = m_s[r];
          pr[hd + 1] = l_s[r];
        }
      }
    }
  }
}

// grid (B*N, R), a thread per d: out = sum_s acc_s e^(m_s - m*) /
// max(sum_s l_s e^(m_s - m*), 1e-30) with m* = max_s m_s.
__global__ void __launch_bounds__(128)
fum_merge_kernel(const float* part, float* out, int R, int hd, int S) {
  const int bn = blockIdx.x, r = blockIdx.y, W = hd + 2;
  const float* pb = part + ((size_t)bn * S * R + r) * W;
  for (int d = threadIdx.x; d < hd; d += blockDim.x) {
    float mx = kNeg;
    for (int s = 0; s < S; ++s) mx = fmaxf(mx, pb[(size_t)s * R * W + hd]);
    float l = 0.f, acc = 0.f;
    for (int s = 0; s < S; ++s) {
      const float* pr = pb + (size_t)s * R * W;
      const float w = expf(pr[hd] - mx);
      l += pr[hd + 1] * w;
      acc += pr[d] * w;
    }
    l = l < 1e-30f ? 1e-30f : l;   // keeps NaN
    out[((size_t)bn * R + r) * hd + d] = acc / l;
  }
}

// Dynamic shared memory of one block: the layout at the top of
// fum_decode_kernel.
size_t smem_bytes(int Rb, int Rp, int hd, int ps, int mk) {
  return sizeof(float) * ((size_t)2 * Rp * hd + (size_t)ps * hd +
                          (size_t)ps * (hd + 4) + (size_t)Rp * ps + 3 * (size_t)Rb) +
         sizeof(int) * ((size_t)Rb + mk);
}

template <int F, int VB, int RPT>
int launch(Args a, int rc, cudaStream_t st) {
  a.Rp = (a.Rb + RPT - 1) / RPT * RPT;
  // above the 227 KB a block may use, the attribute call (and so the
  // launch) is refused with cudaErrorInvalidValue
  const size_t smem = smem_bytes(a.Rb, a.Rp, a.hd, a.ps, a.mk);
  cudaError_t err = cudaFuncSetAttribute(
      fum_decode_kernel<F, VB, RPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  fum_decode_kernel<F, VB, RPT><<<dim3(a.N, a.B, a.S * rc), kThreads, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches the kernel (and, for S > 1, the merge) on `stream`; returns
// the first cudaError_t (0 = success). `part` holds B*N*S*G*Sq*(hd+2)
// floats when S > 1 (unused for S = 1). `fmt` is the pool format (Fmt:
// 0 int8, 1 int8 K + fp8 V, 2 fp32, 3 bf16; the first two with scales).
// ps <= 128, hd <= 128 and hd % 4 == 0 (else cudaErrorInvalidValue);
// any G*Sq (the rows split over blocks). Each run of the kernel adds one
// to *runs unless it is null.
// Nothing is synchronised and nothing is allocated.
int hdp_paged_fum_decode_launch(
    const float* qq, const void* k_pool, const void* v_pool,
    const float* k_scale, const float* v_scale, const int* page_ids,
    const int* logical, const int* counts, const int* keep,
    const int* kv_len, float* out, float* part, unsigned long long* runs,
    int B, int N, int G, int Sq,
    int hd, int ps, int mk, int P, int S, int fmt, int approx,
    int int_bits, int frac_bits, float scale, void* stream) {
  Args a;
  a.qq = qq; a.k_pool = k_pool; a.v_pool = v_pool;
  a.k_scale = k_scale; a.v_scale = v_scale;
  a.page_ids = page_ids; a.logical = logical; a.counts = counts;
  a.keep = keep; a.kv_len = kv_len; a.out = out; a.part = part;
  a.runs = runs;
  a.B = B; a.N = N; a.R = G * Sq; a.Sq = Sq; a.hd = hd; a.ps = ps;
  a.mk = mk; a.P = P; a.S = S;
  a.approx = approx;
  a.grid = ldexpf(1.f, frac_bits);
  a.lo = -ldexpf(1.f, int_bits);
  a.hi = ldexpf(1.f, int_bits) - ldexpf(1.f, -frac_bits);
  a.scale = scale;   // 1/sqrt(hd) rounded once, as the plain version does
  if (ps < 1 || ps > 128 || hd < 4 || hd > 128 || hd % 4 || S < 1 ||
      fmt < kI8 || fmt > kBf16)
    return static_cast<int>(cudaErrorInvalidValue);
  // rows a block takes: all of them, or RC even chunks of at most 16
  // per thread group; rows a thread group takes: 4, or 16 when more
  // groups than the threads hold would be needed
  const int groups = kThreads / (ps > hd ? ps : hd);
  const int rc = (a.R + 16 * groups - 1) / (16 * groups);
  a.Rb = (a.R + rc - 1) / rc;
  const bool few = (a.Rb + 3) / 4 <= groups;
  if (B == 0 || N == 0 || a.R == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool wide = hd % 16 == 0 && reinterpret_cast<uintptr_t>(k_pool) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(v_pool) % 16 == 0;
  int err;
  switch (fmt) {
    case kF32: err = few ? launch<kF32, 4, 4>(a, rc, st) : launch<kF32, 4, 16>(a, rc, st); break;
    case kBf16: err = few ? launch<kBf16, 4, 4>(a, rc, st) : launch<kBf16, 4, 16>(a, rc, st); break;
    case kI8Fp8:
      if (wide) err = few ? launch<kI8Fp8, 16, 4>(a, rc, st) : launch<kI8Fp8, 16, 16>(a, rc, st);
      else err = few ? launch<kI8Fp8, 4, 4>(a, rc, st) : launch<kI8Fp8, 4, 16>(a, rc, st);
      break;
    default:
      if (wide) err = few ? launch<kI8, 16, 4>(a, rc, st) : launch<kI8, 16, 16>(a, rc, st);
      else err = few ? launch<kI8, 4, 4>(a, rc, st) : launch<kI8, 4, 16>(a, rc, st);
  }
  if (err != 0 || S == 1) return err;
  fum_merge_kernel<<<dim3(B * N, a.R), hd, 0, st>>>(part, out, a.R, hd, S);
  return static_cast<int>(cudaGetLastError());
}

const char* hdp_paged_fum_decode_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
