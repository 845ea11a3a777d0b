"""k1_roofline.<moves>: K1 (``relpos_attn_probs``), the least time its calls
in the traced span could take over the time they took, %.  The least time
is each traced replay's ``bounds["k1"]``, which the model type's file counts
(for zipformer2: ``yardstick.bound`` of ``k1_bytes_ops`` at each call's
shapes, one call a layer a replay, the cell's rows and each stack's
frames); the time taken is the device time of the kernels whose name holds
``relpos_attn_probs``.  Nothing to read where no replay counts K1."""

KERNEL = "relpos_attn_probs"


def read(ctx, name):
    took = sum(e - s for s, e in ctx.device_intervals(KERNEL))
    bound_ms = sum(r["bounds"].get("k1", 0.0) for r in ctx.traced)
    if not took or not bound_ms:
        return None
    return 100.0 * bound_ms * 1e-3 / took
