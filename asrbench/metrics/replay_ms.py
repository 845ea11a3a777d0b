"""replay_ms.<moves>: the card's time per replay, ms: the union of the
device's kernel and copy intervals in the traced span (overlaps counted
once) over the replays that span holds."""

from asrbench.core import yardstick


def read(ctx, name):
    n = len(ctx.traced)
    busy = yardstick.union_length(ctx.device_intervals())
    if not n or not busy:
        return None
    return busy / n * 1e3
