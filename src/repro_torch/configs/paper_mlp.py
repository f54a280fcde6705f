"""Paper-scale model 1: 4-layer MLP (paper Table 1, MNIST / Fashion-MNIST).

Paper split: 2 layers on clients, 2 layers on the server.
Runs fully on CPU — this is the faithful-reproduction substrate for the
paper's Tables 2-3 and Figures 2-4.
Copied from `repro.configs.paper_mlp`; both configs must stay equal.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="paper-mlp",
        family="mlp",
        source="paper §4.1 (MNIST/Fashion-MNIST 4-layer MLP)",
        mlp_dims=(784, 256, 128, 64, 10),  # 4 weight layers
        image_size=28,
        image_channels=1,
        num_classes=10,
        split_layers=2,  # paper: 2 client layers + 2 server layers
        num_clients=10,  # one task per class
        dtype="float32",
        param_dtype="float32",
        remat="none",
        scan_layers=False,
    ),
    smoke=ModelConfig(
        name="paper-mlp",
        family="mlp",
        mlp_dims=(64, 32, 32, 16, 10),
        image_size=8,
        image_channels=1,
        num_classes=10,
        split_layers=2,
        num_clients=3,
        dtype="float32",
        remat="none",
        scan_layers=False,
    ),
)
