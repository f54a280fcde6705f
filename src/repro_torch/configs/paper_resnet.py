"""Paper-scale model 2: ResNet-16 (paper Table 1, CIFAR-10/100).

Paper split: 9 conv layers on clients, 7 on the server. Our ResNet-16 is the
standard 3-stage CIFAR ResNet (initial conv + 3 stages x 2 blocks x 2 convs
+ head = 16 weight layers); the MTSL split after stage 2 puts 9 conv layers
client-side, matching the paper.
Copied from `repro.configs.paper_resnet`; both configs must stay equal.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="paper-resnet16",
        family="resnet",
        source="paper §4.1 (CIFAR ResNet-16, split 9/7)",
        resnet_stages=((16, 2), (32, 2), (64, 2)),
        image_size=32,
        image_channels=3,
        num_classes=10,
        split_layers=2,  # stages in the client tower (9 conv layers)
        num_clients=10,
        dtype="float32",
        param_dtype="float32",
        remat="none",
        scan_layers=False,
    ),
    smoke=ModelConfig(
        name="paper-resnet16",
        family="resnet",
        resnet_stages=((8, 1), (16, 1)),
        image_size=16,
        image_channels=3,
        num_classes=10,
        split_layers=1,
        num_clients=3,
        dtype="float32",
        remat="none",
        scan_layers=False,
    ),
)
