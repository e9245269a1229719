"""Cost-driven attention autotuning + adaptive speculation.

PyTorch counterpart of ``repro.autotune``. Three cooperating pieces,
wired into serving when ``AttnSpec(policy="cost")`` (or
``REPRO_ATTN_POLICY=cost``) is active:

* :mod:`repro_torch.autotune.cost` — analytic bytes/FLOPs/step-time
  predictor per registered attention backend, parameterized by the call
  signature and the engine's measured sparsity counters.
* :mod:`repro_torch.autotune.tuner` — per-signature backend chooser with
  a measured-fallback probe cache (serializable for warm starts).
* :mod:`repro_torch.autotune.speculation` — acceptance-EMA controller
  setting the speculative draft length and draft prune aggressiveness
  per round.
"""
from repro_torch.autotune.cost import (OP_WEIGHT, CallSig, CostEstimate,
                                       SparsityEstimate, call_signature,
                                       crossover_table, predict,
                                       predict_engine_step)
from repro_torch.autotune.speculation import SpecConfig, SpecController
from repro_torch.autotune.tuner import (TUNER_CACHE_ENV, Tuner,
                                        default_tuner, reset_default_tuner,
                                        set_default_tuner)

__all__ = [
    "CallSig", "CostEstimate", "SparsityEstimate", "OP_WEIGHT",
    "call_signature", "predict", "predict_engine_step", "crossover_table",
    "Tuner", "TUNER_CACHE_ENV", "default_tuner", "set_default_tuner",
    "reset_default_tuner", "SpecConfig", "SpecController",
]
