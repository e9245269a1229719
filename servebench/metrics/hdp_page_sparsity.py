"""Share of allocated pages the decode's FUM stage did not fetch, over the
window's decode steps (the engine's ``collect_stats`` page sparsity,
on in the traced run only), in %."""


def read(w):
    n = w.delta("page_samples")
    return 100.0 * w.delta("page_sparsity") / n if n else None
