from repro_torch.data.pipeline import (  # noqa: F401
    DataConfig, MemorizeLM, Prefetcher, SyntheticLM, host_slice, make_source)
