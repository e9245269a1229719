// Dense flash attention for Hopper (sm_90a), the paper's HDP-off
// baseline.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py:
// flash_attention (its pallas_call at :87): softmax(q.k^T / sqrt(hd)) v
// with an online softmax over KV tiles, cols < Sk masked (ragged S) and,
// under causal, rows >= cols, with KV tiles wholly in the future of the
// q rows skipped. q, k, v and the output share one type, fp32 or bf16;
// scores and accumulators are fp32, and p is rounded to v's type before
// P.V as the reference does.
//
// Design: the shared tile kernel of attn_tile.cuh in its dense mode
// (one CUDA block per 32-row slice of a q tile walking its KV tiles in
// order, m, l and acc in shared memory; causal skipping uses the slice's
// own last row, which skips at least the tiles the TPU skipped). It
// serves what the tensor-core kernel (flash_attention_tc.cu: bf16, hd 64
// or 128) does not take: fp32 inputs and other head sizes
// (kernels/flash_attention.py:flash_path picks).
//
// Bound: operations. At qwen2-1.5b prefill (B 2, 12 heads, S 4096,
// hd 128) the causal half of QK^T and P.V is ~1e11 flops against ~50 MB
// of q, k, v and output (bf16), far above the card's ridge. This kernel
// runs the products on CUDA cores in fp32 out of shared memory.

#include "attn_tile.cuh"

extern "C" {

// Launches on `stream`; returns the cudaError_t of the launch (0 =
// success). bf16 selects bf16 q/k/v/out (else fp32). Nothing is
// synchronised and nothing is allocated.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* out, int bf16, int BH, int Sq, int Sk,
                           int hd, int bq, int bk, int causal, float scale,
                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    using T = __nv_bfloat16;
    attn_tile::Args<T, T, T> a{};
    a.q = static_cast<const T*>(q); a.k = static_cast<const T*>(k);
    a.v = static_cast<const T*>(v); a.out = static_cast<T*>(out);
    a.Sq = Sq; a.Sk = Sk; a.hd = hd; a.bq = bq; a.bk = bk;
    a.sparse = 0; a.causal = causal; a.approx = 0; a.scale = scale;
    return attn_tile::launch(a, BH, st);
  }
  attn_tile::Args<float, float, float> a{};
  a.q = static_cast<const float*>(q); a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v); a.out = static_cast<float*>(out);
  a.Sq = Sq; a.Sk = Sk; a.hd = hd; a.bq = bq; a.bk = bk;
  a.sparse = 0; a.causal = causal; a.approx = 0; a.scale = scale;
  return attn_tile::launch(a, BH, st);
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
