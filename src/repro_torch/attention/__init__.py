"""Attention-backend registry: one dispatch layer over the attention
implementations (PyTorch counterpart of ``repro.attention``).

* :class:`AttnCall` — frozen descriptor of one attention invocation.
* :class:`AttnSpec` — backend-selection policy.
* :func:`attention` — the single dispatch entry, returning
  ``(out, AttnStats | None)``.
* :func:`register_backend` / :func:`resolve_backend` /
  :func:`list_backends` — the registry itself.

Backends: ``reference`` (the materializing oracle), ``xla_dense``,
``xla_hdp``, ``paged_hdp_decode`` (plain PyTorch paths, under the
reference's names), ``pallas_flash``, ``pallas_hdp_block`` and
``pallas_paged_decode`` (the hand-written CUDA kernels, under the names
of the TPU kernels they replace).
"""
from repro_torch.attention.registry import (BACKEND_ENV, POLICY_ENV,
                                            Backend, BackendUnsupported,
                                            attention, default_spec,
                                            effective_policy, get_backend,
                                            known_backend_names,
                                            list_backends, register_backend,
                                            resolve_backend)
from repro_torch.attention.spec import (AttnCall, AttnSpec, DraftProfile,
                                        spec_from_legacy)
from repro_torch.attention.stats import AttnStats, normalize_stats

__all__ = [
    "AttnCall", "AttnSpec", "AttnStats", "Backend", "BackendUnsupported",
    "BACKEND_ENV", "POLICY_ENV", "DraftProfile", "attention",
    "default_spec", "effective_policy", "get_backend",
    "known_backend_names", "list_backends", "normalize_stats", "register_backend", "resolve_backend",
    "spec_from_legacy",
]
