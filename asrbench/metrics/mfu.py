"""mfu.<moves>: the whole step's share of the card's bf16 peak, %: the
FLOPs of the work the traced span's replays did (the plain reference's
products counted by ``FlopCounterMode`` at each request's true length, or a
streamed chunk's, and the search's joiner and decoder products at the
emissions these inputs needed) over the span's wall time times 989 TFLOP/s.
The count is the same whatever implements the step."""

from asrbench.core import yardstick


def read(ctx, name):
    recs = ctx.traced
    if ctx.trace is None or not recs or not ctx.trace.device:
        return None
    flops = sum(r["flops"] for r in recs)
    return 100.0 * flops / (ctx.trace.window_s * yardstick.PEAK_BF16)
