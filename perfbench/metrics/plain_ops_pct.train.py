"""Share of the stretch's kernel time in kernels that are neither matrix
products nor the program's K1-K4: the plain backwards of K2 and K3 and the
model's elementwise work."""
from perfbench.lib.readers import is_matmul
from perfbench.lib.trace import KERNELS


def read(ctx):
    ks = ctx.trace.kernels
    total = sum(e - s for _, s, e in ks)
    if not total:
        return None
    plain = sum(e - s for n, s, e in ks
                if not is_matmul(n) and not any(k in n for k in KERNELS.values()))
    return 100.0 * plain / total
