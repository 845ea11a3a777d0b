"""prep_ms.<moves>: the host's preparation of a replay's inputs, ms: the
median ``begin_decode.pcm`` span (offline: the batch's int16 rows and their
upload) or ``begin_step.prep`` span (streaming: the ready streams, the
pinned buffers, the windows), before the traced span (``_program``)."""

from asrbench.core import spec

NAMES = ("begin_decode.pcm", "begin_step.prep")


def read(ctx, name):
    return spec.plugin("metrics", "_program").span_ms(ctx, NAMES)
