"""device.idle_pct: the share of the untraced window in which neither a
kernel nor a copy ran on the card: one less the card's busy time a
batch (the union of the profiler's device intervals over the traced
window, over its batches) times the batches the untraced window
completed a second. The traced window's own idle share (`busy_s`,
`window_s`) reads high, since the trace slows the host's calls. Layer:
device. Moves txn_per_s."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.batches or ctx.trace.busy_s <= 0:
        return None
    busy = ctx.trace.busy_s / ctx.trace.batches
    return 100.0 * (1.0 - busy * ctx.window_batches / ctx.seconds)
