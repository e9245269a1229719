"""HDP configuration.

All knobs of the paper's Algorithm 2 plus the TPU-adaptation switches.
Defaults mirror the paper: 16-bit fixed point (4 integer + 12 fractional
bits), 2x2 blocks, both rho_B branches supported, approximation on.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class HDPConfig:
    """Configuration for Hybrid Dynamic Pruning attention.

    Attributes:
      enabled: master switch; False -> exact dense attention.
      rho_b: block pruning ratio in (-1, 1). Algorithm 2 line 15:
        Theta = rho*max + (1-rho)*mean      if rho in [0, 1)
        Theta = -rho*min + (1+rho)*mean     if rho in (-1, 0)
      tau_h: head pruning threshold; heads with theta_head <= tau_h are
        pruned entirely (output zeroed, downstream compute skipped).
      block_q / block_k: pruning-block size. The paper's ASIC uses 2x2;
        the Pallas kernel path requires TPU-aligned blocks (>= 8x128).
      int_bits / frac_bits: fixed-point format of the quantizer.
      approx: drop the FQ*FK^T term (paper Sec III-B). False computes the
        exact product of the quantized inputs.
      block_pruning / head_pruning: enable the individual mechanisms.
      normalize_head_score: divide theta_head by the number of valid score
        entries so tau_h is sequence-length independent (TPU adaptation;
        the paper profiles raw sums per model/seq-len).
      approx_softmax: use the ASIC-faithful 2nd-order polynomial exp +
        linear-approximation reciprocal instead of exact softmax.
      causal: compose the HDP mask with a causal mask and exclude fully
        future blocks from row statistics (TPU adaptation for decoder LMs;
        the paper evaluates encoder-only models).
    """

    enabled: bool = True
    rho_b: float = 0.5
    tau_h: float = 0.0
    block_q: int = 2
    block_k: int = 2
    int_bits: int = 4
    frac_bits: int = 12
    # activation-scale calibration for the fixed-point grid ("max" | "rms"
    # | "none"). The paper's co-processor receives Q/K pre-quantized by the
    # host accelerator, i.e. with a calibrated scale; "none" reproduces the
    # raw-value behaviour. Scores are rescaled by 1/(s_q*s_k) afterwards,
    # so calibration changes only integer-part informativeness, never the
    # attention semantics.
    calib: str = "max"
    approx: bool = True
    block_pruning: bool = True
    head_pruning: bool = True
    normalize_head_score: bool = False
    approx_softmax: bool = False
    causal: bool = False
    # HDP is an inference-time technique (no retraining needed). The paper's
    # Sec. V-B fine-tunes *with* pruning active for the SpAtten comparison;
    # setting this replicates that mode in train_step.
    apply_in_training: bool = False

    def __post_init__(self):
        if not (-1.0 < self.rho_b < 1.0):
            raise ValueError(f"rho_b must be in (-1, 1), got {self.rho_b}")
        if self.block_q < 1 or self.block_k < 1:
            raise ValueError("block sizes must be >= 1")
        if self.int_bits < 1 or self.frac_bits < 0:
            raise ValueError("need int_bits >= 1, frac_bits >= 0")

    def replace(self, **kw) -> "HDPConfig":
        return dataclasses.replace(self, **kw)


#: Paper's ASIC configuration (Sec. V): 2x2 blocks, 16-bit fixed point.
PAPER_ASIC = HDPConfig(block_q=2, block_k=2, int_bits=4, frac_bits=12)

#: TPU-native kernel configuration: pruning block == DMA/MXU tile.
TPU_KERNEL = HDPConfig(block_q=128, block_k=128, int_bits=4, frac_bits=12,
                       normalize_head_score=True, causal=True)
