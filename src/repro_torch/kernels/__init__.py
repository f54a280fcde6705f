"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version. K4 (flash_decode) is ported; K1 (mtsl_update), K2
(flash_attention's kernel) and K3 (ssd_scan) are still to be ported."""
