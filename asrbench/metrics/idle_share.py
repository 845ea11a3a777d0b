"""idle_share.<moves>: the share of the traced span's wall time in which no
kernel or copy ran on the card, %, by the union of the device intervals."""

from asrbench.core import yardstick


def read(ctx, name):
    if ctx.trace is None or not ctx.trace.device:
        return None
    busy = yardstick.union_length(ctx.device_intervals())
    return 100.0 * (1.0 - busy / ctx.trace.window_s)
