"""freeze_roofline.<moves>: the freeze stage (``runtime/online.py::_freeze``),
the least time the traced steps' freezes could take over the device time
of the stage, %.  The least time is, over the traced steps, the lanes each
stepped (its ``ready`` windows) times the model type's
``bounds["freeze_per_lane"]``: one lane's encoder state, as the
configuration's shapes give it (``state_bytes``), read once and written
once at the card's bandwidth.  The count is the same whatever implements
the freeze; the time is the union of the device intervals from each
``k2t_stage_freeze`` marker to the next (``_program``).  Nothing to read
where no step is traced or no model type counts the bound."""

from asrbench.core import spec


def read(ctx, name):
    recs = ctx.traced
    bound_ms = sum(r.get("ready", 0) * r["bounds"].get("freeze_per_lane", 0.0) for r in recs)
    if ctx.trace is None or not bound_ms:
        return None
    took = spec.plugin("metrics", "_program").stage_split(ctx.trace.device).get("freeze")
    if not took:
        return None
    return 100.0 * bound_ms * 1e-3 / took
