"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version: K1 (mtsl_update), K2 (flash_attention's kernel), K3 (ssd_scan)
and K4 (flash_decode), one for each TPU kernel of the JAX package."""
