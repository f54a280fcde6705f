"""K3's forward calls (the SSD scan) in the stretch, each at the designed
mean bound, over their time."""
from perfbench.lib.readers import forward, roofline_pct, train_calls


def read(ctx):
    seen = [r for r in ctx.trace.records("k3") if forward(r[0])]
    seconds = sum(e - s for _, s, e in seen) * 1e-9
    return roofline_pct(train_calls(ctx.cfg, ctx.traffic, "k3"), len(seen), seconds)
