"""K2's forward calls (causal flash attention) in the stretch, each at the
designed mean bound, over their time."""
from perfbench.lib.readers import forward, roofline_pct, train_calls


def read(ctx):
    seen = [r for r in ctx.trace.records("k2") if forward(r[0])]
    seconds = sum(e - s for _, s, e in seen) * 1e-9
    return roofline_pct(train_calls(ctx.cfg, ctx.traffic, "k2"), len(seen), seconds)
