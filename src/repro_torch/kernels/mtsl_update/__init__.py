from repro_torch.kernels.mtsl_update.ops import mtsl_update_, mtsl_update_multi_
from repro_torch.kernels.mtsl_update.ref import mtsl_update_reference

__all__ = ["mtsl_update_", "mtsl_update_multi_", "mtsl_update_reference"]
