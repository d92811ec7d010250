"""step.device_ms: kernel time on the card over the traced window
(torch.profiler), a batch submitted in it. Layer: resolve step. Moves
txn_per_s."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.batches or ctx.trace.kernel_s <= 0:
        return None
    return ctx.trace.kernel_s / ctx.trace.batches * 1e3
