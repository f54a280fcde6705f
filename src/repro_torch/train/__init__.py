"""Training: the loop (`train.loop`) and checkpoints in the reference's
file format (`train.checkpoint`)."""
from repro_torch.train.checkpoint import (  # noqa: F401
    load_algorithm_state,
    load_checkpoint,
    save_algorithm_state,
    save_checkpoint,
)
