"""HDP core: configuration, fixed-point quantization, block statistics."""
from repro_torch.core.config import HDPConfig, PAPER_ASIC, TPU_KERNEL

__all__ = ["HDPConfig", "PAPER_ASIC", "TPU_KERNEL"]
