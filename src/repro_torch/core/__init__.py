"""HDP core: the paper's contribution as composable PyTorch functions."""
from repro_torch.core.config import HDPConfig, PAPER_ASIC, TPU_KERNEL
from repro_torch.core.hdp import (HDPStats, dense_attention_reference,
                                  hdp_attention, hdp_attention_reference)
from repro_torch.core.quant import (int_frac_split, quantize_and_split,
                                    quantize_fixed)
from repro_torch.core.topk import (mask_agreement, topk_attention,
                                   topk_block_mask)

__all__ = [
    "HDPConfig", "PAPER_ASIC", "TPU_KERNEL", "HDPStats",
    "hdp_attention", "hdp_attention_reference", "dense_attention_reference",
    "quantize_fixed", "int_frac_split", "quantize_and_split",
    "topk_block_mask", "topk_attention", "mask_agreement",
]
