"""text_ms.<moves>: the host's results of a replay, ms: the median
``end_decode.text`` or ``end_step.text`` span (tokens to text for every
stream of the call), before the traced span (``_program``)."""

from asrbench.core import spec

NAMES = ("end_decode.text", "end_step.text")


def read(ctx, name):
    return spec.plugin("metrics", "_program").span_ms(ctx, NAMES)
