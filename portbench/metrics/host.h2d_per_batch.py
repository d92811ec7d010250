"""host.h2d_per_batch: host-to-device transfers a batch over the window,
from the backend's `kernel_stats()["h2d"]["transfers"]` counter. Layer:
host wrappers. Moves txn_per_s."""


def read(ctx):
    if not ctx.batches:
        return None
    return ctx.h2d_transfers / ctx.batches
