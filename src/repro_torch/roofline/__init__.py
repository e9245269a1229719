"""Hardware profiles the cost model prices with (the reference's
``analysis`` and ``hlo_cost`` parse compiled XLA HLO and have no torch
counterpart yet)."""
from repro_torch.roofline import hardware
from repro_torch.roofline.hardware import (H100_SXM, HOST_CPU,
                                           HardwareProfile, detect_profile,
                                           get_profile)

__all__ = ["hardware", "HardwareProfile", "H100_SXM", "HOST_CPU",
           "detect_profile", "get_profile"]
