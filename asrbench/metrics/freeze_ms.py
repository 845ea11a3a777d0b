"""freeze_ms.<moves>: the freeze stage's device time per replay in the traced
span, ms: from each ``k2t_stage_freeze`` marker to the next (``_program``)."""

from asrbench.core import spec


def read(ctx, name):
    return spec.plugin("metrics", "_program").stage_ms(ctx, "freeze")
