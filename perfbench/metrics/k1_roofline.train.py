"""K1 (the fused mtsl update) over every f32 leaf a round: p and g read, p
written, against K1's time in the stretch."""
import math

from perfbench.lib.weights import specs
from perfbench.yardstick import costs, peaks


def read(ctx):
    seen = ctx.trace.records("k1")
    seconds = ctx.trace.kernel_s("k1")
    if not seen or seconds <= 0:
        return None
    numel = sum(math.prod(s.shape)
                for s in specs(ctx.cfg, ctx.traffic["num_clients"]))
    c = costs.update_cost(numel, costs.ITEMSIZE[ctx.cfg["param_dtype"]])
    return 100.0 * len(seen) * peaks.bound_s(c.flops, c.bytes, ctx.cfg["param_dtype"]) \
        / seconds
