// Block-sparse FUM attention for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/hdp_block_attn.py:
// hdp_block_sparse_attention (its pallas_call at :144), the paper's
// Fetch-Upon-Mask dataflow: for each (b*h, q tile) only the KV blocks
// listed in kv_idx[..., :counts] are ever loaded; scores are
// QK^T - FQ.FK^T (fractions by trunc) times 1/sqrt(hd) and the
// calibration rescale score_scale, masked to cols < kv_len (and
// rows >= cols under causal), with an online softmax across the listed
// blocks. Heads with head_kept = 0 load nothing and output zeros.
//
// Design: the shared tile kernel of attn_tile.cuh in its sparse mode
// (one CUDA block per 32-row slice of a q tile, the listed KV tiles
// walked in order with m, l and acc in shared memory; the TPU got the
// list through scalar prefetch, here each block reads its own). q and k
// are the fp32 fixed-grid QQ and KQ; v is fp32 or bf16, and p is
// rounded to v's type before P.V as the reference does. The output is
// fp32 (the reference returns qq's dtype).
//
// Bound: the work of the listed blocks, 4 flops per (row, col, d) for
// the two score products and 2 for P.V, against reading Q, the listed
// K/V tiles once and writing the output. The score operands lie on the
// Q4.12 grid and split exactly into bf16 limbs (hdp_block_attn_tc.cu), so
// they are priced at the bf16 tensor rate, P.V at V's type (fp32 V: the
// fp32 rate); at the decode route's shapes the bytes bound instead. This
// kernel computes from shared memory on CUDA cores one (row, column) per
// thread and re-reads each listed tile once per 32-row slice, far from
// that bound. It serves what the tensor-core
// kernel (hdp_block_attn_tc.cu: bf16 V, hd 64 or 128, blocks of 64 or
// 128) does not take: fp32 V (the paged decode's densified route, block
// rows 8) and small blocks or head sizes
// (kernels/hdp_block_attn.py:block_path picks).

#include "attn_tile.cuh"

extern "C" {

// Launches on `stream`; returns the cudaError_t of the launch (0 =
// success). v_bf16 selects bf16 V (else fp32). kv_len and score_scale
// may be null. Nothing is synchronised and nothing is allocated.
int hdp_block_attn_launch(const float* q, const float* k, const void* v,
                          int v_bf16, float* out, const int* kv_idx,
                          const int* counts, const int* head_kept,
                          const int* kv_len, const float* score_scale,
                          int BH, int Sq, int Sk, int hd, int bq, int bk,
                          int mk, int causal, int approx, float scale,
                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (v_bf16) {
    attn_tile::Args<float, __nv_bfloat16, float> a{};
    a.q = q; a.k = k; a.v = static_cast<const __nv_bfloat16*>(v); a.out = out;
    a.kv_idx = kv_idx; a.counts = counts; a.head_kept = head_kept;
    a.kv_len = kv_len; a.score_scale = score_scale;
    a.Sq = Sq; a.Sk = Sk; a.hd = hd; a.bq = bq; a.bk = bk; a.mk = mk;
    a.sparse = 1; a.causal = causal; a.approx = approx; a.scale = scale;
    return attn_tile::launch(a, BH, st);
  }
  attn_tile::Args<float, float, float> a{};
  a.q = q; a.k = k; a.v = static_cast<const float*>(v); a.out = out;
  a.kv_idx = kv_idx; a.counts = counts; a.head_kept = head_kept;
  a.kv_len = kv_len; a.score_scale = score_scale;
  a.Sq = Sq; a.Sk = Sk; a.hd = hd; a.bq = bq; a.bk = bk; a.mk = mk;
  a.sparse = 1; a.causal = causal; a.approx = approx; a.scale = scale;
  return attn_tile::launch(a, BH, st);
}

const char* hdp_block_attn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
