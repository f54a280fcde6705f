from repro_torch.kernels.flash_attention.ref import attn_mask, mha_reference

__all__ = ["attn_mask", "mha_reference"]
