from repro_torch.data.synthetic import (
    MultiTaskImageSource,
    heterogeneous_label_dist,
)
from repro_torch.data.lm import MultiTaskLMSource
from repro_torch.data.pipeline import client_batches
