"""host.submit_ms: the mean host time of one `submit_arrays` call over
the untraced window's batches (the benchmark's own host-clock span
around each call). Layer: host wrappers. Moves txn_per_s."""


def read(ctx):
    if not ctx.submit_s:
        return None
    return sum(ctx.submit_s) / len(ctx.submit_s) * 1e3
