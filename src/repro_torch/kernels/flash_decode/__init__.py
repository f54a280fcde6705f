from repro_torch.kernels.flash_decode.ops import flash_decode
from repro_torch.kernels.flash_decode.ref import decode_reference

__all__ = ["flash_decode", "decode_reference"]
