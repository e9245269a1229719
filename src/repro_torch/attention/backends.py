"""The production backends, under the reference's names.

PyTorch counterpart of ``repro.attention.backends``, with the same names,
``supports`` predicates and the reference's TPU priorities, so a call
resolves to the backend of the same name in both packages (the port
ranks by that order on every device, see ``registry``):

| backend             | runs                                           | calls it supports                    |
|---------------------|------------------------------------------------|--------------------------------------|
| xla_dense           | chunked/local/decode_attention                 | HDP off (dense; paged decode)        |
| xla_hdp             | hdp_prefill/decode_attention                   | HDP on, dense layout (+draft/verify) |
| paged_hdp_decode    | hdp_paged_decode_attention, stage 3 "xla"      | HDP on, paged decode (+draft/verify) |
| pallas_flash        | kernels.ops.flash (CUDA flash_attention)       | HDP off, aligned self-attn prefill   |
| pallas_hdp_block    | kernels.ops.hdp_attention_tpu / block stage 3  | HDP on, aligned prefill or paged     |
| pallas_paged_decode | the gather-free FUM kernel (CUDA)              | HDP on, causal paged (+verify)       |

Speculative calls route as in the reference: a verify call (Sq > 1,
each query row scouted for itself) runs on ``pallas_paged_decode`` (the
FUM kernel at Sq rows), ``paged_hdp_decode`` or ``xla_hdp``; a draft
call, which scores from the scout copies, on ``paged_hdp_decode`` or
``xla_hdp`` only (the FUM kernel reads the K pool a draft never reads);
``pallas_hdp_block`` takes neither. None of the kernel backends has a
gradient, so none supports trainable calls; none expresses a sliding
window's lower bound, so windowed calls fall back down the chain.
"""
from __future__ import annotations

from repro_torch.attention.reference import _densify
from repro_torch.attention.registry import register_backend
from repro_torch.attention.spec import AttnCall
from repro_torch.attention.stats import normalize_stats
from repro_torch.models import attention as A

def _heads(x, G):
    """[B,Sk,N,hd] -> [B,N*G,Sk,hd] (repeat KV heads across the group)."""
    return x.transpose(1, 2).repeat_interleave(G, dim=1)


# ------------------------------------------------------------------ xla_dense
def _supports_xla_dense(call: AttnCall) -> bool:
    return call.hdp is None


@register_backend("xla_dense", supports=_supports_xla_dense, priority=10,
                  tags=("xla",))
def run_xla_dense(q, k, v, call, *, q_pos, k_pos, cache=None,
                  page_table=None):
    if call.layout == "paged":
        k, v, _ = _densify(cache, page_table)
    if call.mode == "decode":
        o = A.decode_attention(q, k, v, q_pos=q_pos, k_pos=k_pos,
                               window=call.window, causal=call.causal)
    elif (call.window and q.shape[3] > call.window
          and k.shape[1] == q.shape[3]):
        # the block-local path needs aligned q/k; a chunked serving
        # prefill (q one chunk, k the whole cache) windows by masking
        o = A.local_attention(q, k, v, q_pos=q_pos, k_pos=k_pos,
                              window=call.window, causal=call.causal)
    else:
        chunk = call.chunk if call.chunk else k.shape[1]
        o = A.chunked_attention(q, k, v, q_pos=q_pos, k_pos=k_pos,
                                chunk=min(chunk, max(k.shape[1], 1)),
                                causal=call.causal, window=call.window)
    return o, None


# -------------------------------------------------------------------- xla_hdp
def _supports_xla_hdp(call: AttnCall) -> bool:
    return call.hdp is not None and call.layout == "dense"


@register_backend("xla_hdp", supports=_supports_xla_hdp, priority=10,
                  tags=("xla",))
def run_xla_hdp(q, k, v, call, *, q_pos, k_pos, cache=None, page_table=None):
    if call.mode == "decode":
        out, st = A.hdp_decode_attention(
            q, k, v, q_pos=q_pos, k_pos=k_pos, hdp=call.hdp,
            window=call.window, return_stats=call.needs_stats,
            draft=call.draft, per_query=call.verify)
    else:
        out, st = A.hdp_prefill_attention(
            q, k, v, q_pos=q_pos, k_pos=k_pos, hdp=call.hdp,
            window=call.window, return_stats=call.needs_stats)
    return out, normalize_stats(st)


# ----------------------------------------------------------- paged_hdp_decode
def _supports_paged_hdp(call: AttnCall) -> bool:
    return call.hdp is not None and call.layout == "paged"


def _run_paged(q, call, *, q_pos, k_pos, cache, page_table, stage3):
    # quantized pools carry per-page scales and no scout copies (the
    # scout views are views of the int8 codes); the unquantized pool its
    # k_scout copy, and f_scout when it speculates
    out, st = A.hdp_paged_decode_attention(
        q, cache["k_pages"], cache["v_pages"], cache.get("k_scout"),
        page_table, q_pos=q_pos, k_pos=k_pos, hdp=call.hdp,
        window=call.window, return_stats=call.needs_stats, stage3=stage3,
        draft=call.draft, per_query=call.verify,
        fk_pool=cache.get("f_scout"), k_scale=cache.get("k_scale"),
        v_scale=cache.get("v_scale"), kv_scale=call.kv_scale)
    return out, normalize_stats(st)


@register_backend("paged_hdp_decode", supports=_supports_paged_hdp,
                  priority=10, tags=("xla",))
def run_paged_hdp_decode(q, k, v, call, *, q_pos, k_pos, cache=None,
                         page_table=None):
    return _run_paged(q, call, q_pos=q_pos, k_pos=k_pos, cache=cache,
                      page_table=page_table, stage3="xla")


# --------------------------------------------------------------- pallas_flash
def _supports_pallas_flash(call: AttnCall) -> bool:
    return (call.hdp is None and call.layout == "dense"
            and call.mode == "prefill" and call.self_aligned
            and not call.per_slot and not call.trainable
            and call.window == 0)


@register_backend("pallas_flash", supports=_supports_pallas_flash,
                  priority=20, tags=("pallas",))
def run_pallas_flash(q, k, v, call, *, q_pos, k_pos, cache=None,
                     page_table=None):
    from repro_torch.kernels.ops import flash
    B, N, G, Sq, hd = q.shape
    out = flash(q.reshape(B, N * G, Sq, hd), _heads(k, G), _heads(v, G),
                causal=call.causal)
    return out.reshape(B, N, G, Sq, hd), None


# ----------------------------------------------------------- pallas_hdp_block
def _supports_pallas_hdp(call: AttnCall) -> bool:
    if call.hdp is None or call.trainable or call.window != 0 \
            or call.hdp.approx_softmax:
        return False
    if call.draft is not None or call.verify:
        return False
    if call.layout == "paged":
        return True
    return (call.mode == "prefill" and call.self_aligned
            and not call.per_slot and call.hdp.causal == call.causal)


@register_backend("pallas_hdp_block", supports=_supports_pallas_hdp,
                  priority=20, tags=("pallas",))
def run_pallas_hdp_block(q, k, v, call, *, q_pos, k_pos, cache=None,
                         page_table=None):
    if call.layout == "paged":
        return _run_paged(q, call, q_pos=q_pos, k_pos=k_pos, cache=cache,
                          page_table=page_table, stage3="pallas_block")
    from repro_torch.kernels.ops import hdp_attention_tpu
    B, N, G, Sq, hd = q.shape
    out, st = hdp_attention_tpu(
        q.reshape(B, N * G, Sq, hd), _heads(k, G), _heads(v, G), call.hdp,
        return_stats=call.needs_stats)
    return out.reshape(B, N, G, Sq, hd), normalize_stats(st)


# --------------------------------------------------------- pallas_paged_decode
def _supports_pallas_paged(call: AttnCall) -> bool:
    """The gather-free FUM kernel's per-row validity is ``cols < kv_len``
    (an upper bound only): the causal mask of single-token decode or of
    a multi-query verify call, but no sliding window and no non-causal
    extent. Draft calls fall down the chain."""
    return (call.hdp is not None and call.layout == "paged"
            and call.mode == "decode" and not call.trainable
            and call.window == 0 and not call.hdp.approx_softmax
            and call.causal and call.hdp.causal and call.draft is None)


@register_backend("pallas_paged_decode", supports=_supports_pallas_paged,
                  priority=25, tags=("pallas",))
def run_pallas_paged_decode(q, k, v, call, *, q_pos, k_pos, cache=None,
                            page_table=None):
    return _run_paged(q, call, q_pos=q_pos, k_pos=k_pos, cache=cache,
                      page_table=page_table, stage3="pallas_paged")
