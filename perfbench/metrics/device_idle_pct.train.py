"""Share of the stretch (first to last device record) with nothing running
on the device."""


def read(ctx):
    tr = ctx.trace
    if not tr.device:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
