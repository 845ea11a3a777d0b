"""host_ms.<moves>: the host's time in the system's API per replay, ms:
``begin_decode`` + ``end_decode`` (offline, a batch or a request) or
``begin_step`` + ``end_step`` (streaming, a step), each on the host clock
around the call, the wait for the card taken out.  The median over the
window's replays before the traced span (the profiler slows the host)."""


def read(ctx, name):
    recs = ctx.untraced
    if not recs:
        return None
    return ctx.median([r["host_s"] for r in recs]) * 1e3
