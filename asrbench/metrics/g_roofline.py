"""g_roofline.<moves>: G (the greedy search kernel, ``rnnt_greedy``), the
least time its calls in the traced span could take over the time they
took, %.  The least time is each traced replay's ``bounds["g"]``, which the
greedy decoding method's file counts: ``yardstick.bound`` of
``greedy_bytes_ops`` at each call's lanes, valid frames and the emissions
these inputs needed."""

KERNEL = "rnnt_greedy"


def read(ctx, name):
    took = sum(e - s for s, e in ctx.device_intervals(KERNEL))
    bound_ms = sum(r["bounds"].get("g", 0.0) for r in ctx.traced)
    if not took or not bound_ms:
        return None
    return 100.0 * bound_ms * 1e-3 / took
