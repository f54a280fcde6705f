from repro_torch.serve.engine import ServeEngine, build_prefill_step, build_decode_step
from repro_torch.serve.continuous import ContinuousEngine, Request

__all__ = [
    "ServeEngine",
    "ContinuousEngine",
    "Request",
    "build_prefill_step",
    "build_decode_step",
]
