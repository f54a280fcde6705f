"""Model FLOPs of the traced run's timed rounds (outside the profiled
stretch) over their time, as a share of the card's bf16 peak."""
from perfbench.yardstick import flops, peaks


def read(ctx):
    if not ctx.timed_rounds or ctx.timed_s <= 0:
        return None
    t = ctx.traffic
    f = flops.train_round_flops(ctx.cfg, t["num_clients"], t["batch_per_client"],
                                t["seq_len"])
    return 100.0 * f * ctx.timed_rounds / ctx.timed_s / peaks.PEAK_FLOPS["bfloat16"]
