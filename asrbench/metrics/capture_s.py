"""capture_s.<moves>: the system's seconds of graph capture, each key's
eager warm-up and capture on the host clock (its ``program.capture_s``
counter), at the run's end: set-up's captures, and any key captured again
in the window (``_program``)."""

from asrbench.core import spec


def read(ctx, name):
    return spec.plugin("metrics", "_program").counter("program.capture_s")
