"""k2_roofline.<moves>: K2 (``relpos_attn_ctx``, the conformer's attention),
the least time its calls in the traced span could take over the time they
took, %.  The least time is each traced replay's ``bounds["k2"]``, which
the model type's file counts (for the conformer: ``yardstick.bound`` of
``k2_bytes_ops`` at each call's shapes, one call a layer a replay, the
cell's rows and the padded frames); the time taken is the device time of
the kernels whose name holds ``relpos_attn_ctx``.  Nothing to read where no
replay counts K2."""

KERNEL = "relpos_attn_ctx"


def read(ctx, name):
    took = sum(e - s for s, e in ctx.device_intervals(KERNEL))
    bound_ms = sum(r["bounds"].get("k2", 0.0) for r in ctx.traced)
    if not took or not bound_ms:
        return None
    return 100.0 * bound_ms * 1e-3 / took
