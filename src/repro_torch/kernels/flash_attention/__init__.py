from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import attn_mask, mha_reference

__all__ = ["attn_mask", "flash_attention", "mha_reference"]
