"""The whole step's share of the card's bf16 dense peak: model FLOPs of
the window's real prompt tokens (each at its causal context) and of its
generated tokens (at the mean context of the window's requests' answers)
over the window's seconds times the peak, in %. The card's power limit
is printed beside it."""
from servebench import peaks


def read(w):
    pk = peaks.peak(w.kind)
    if pk is None:
        return None
    m = w.conf["model"]
    flops = sum(peaks.prompt_flops(m, w.hit_tokens(r), len(r.prompt))
                for r in w.admitted)
    ctx = [len(r.prompt) + i for r in w.counted if r.result is not None
           for i in range(len(r.result.tokens))]
    if ctx:
        flops += w.delta("tokens_out") * peaks.token_flops(
            m, sum(ctx) / len(ctx))
    return 100.0 * flops / (w.seconds * pk["bf16_flop_s"])
