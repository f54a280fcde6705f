from repro_torch.optim.optimizers import (
    Optimizer,
    sgd,
    momentum,
    adamw,
    apply_updates,
)
from repro_torch.optim.per_component import (
    ComponentLR,
    per_component_lr,
    lipschitz_lr,
)
from repro_torch.optim.schedules import constant, cosine, warmup_cosine, inverse_sqrt
