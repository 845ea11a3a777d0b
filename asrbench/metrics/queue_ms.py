"""queue_ms.<moves>: the host's queueing of a replay, ms: the median
``begin_decode.queue`` or ``begin_step.queue`` span (the program call, the
readback and the event), before the traced span (``_program``)."""

from asrbench.core import spec

NAMES = ("begin_decode.queue", "begin_step.queue")


def read(ctx, name):
    return spec.plugin("metrics", "_program").span_ms(ctx, NAMES)
