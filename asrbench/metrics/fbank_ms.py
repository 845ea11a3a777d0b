"""fbank_ms.<moves>: the fbank stage's device time per replay in the traced
span, ms: from each ``k2t_stage_fbank`` marker to the next (``_program``)."""

from asrbench.core import spec


def read(ctx, name):
    return spec.plugin("metrics", "_program").stage_ms(ctx, "fbank")
