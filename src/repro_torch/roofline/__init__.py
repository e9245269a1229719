"""Hardware profiles, the trace cost model and the roofline of a traced
step (``analysis``; ``trace_cost`` takes the place of the reference's
HLO parser ``hlo_cost``)."""
from repro_torch.roofline import analysis, hardware, trace_cost
from repro_torch.roofline.hardware import (H100_SXM, HOST_CPU,
                                           HardwareProfile, detect_profile,
                                           get_profile)

__all__ = ["analysis", "hardware", "trace_cost", "HardwareProfile",
           "H100_SXM", "HOST_CPU", "detect_profile", "get_profile"]
