"""Cross-cutting helpers shared by serving and training."""
from repro_torch.common.transient import TransientError, is_transient

__all__ = ["TransientError", "is_transient"]
