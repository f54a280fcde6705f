"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version. K1 (mtsl_update) and K4 (flash_decode) are ported; K2
(flash_attention's kernel) and K3 (ssd_scan) are still to be ported."""
