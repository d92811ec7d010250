"""step_roofline: the least time the traced window's steps need at the
card's memory bandwidth (roofline.step_bytes, with the live history
rows the plain reference counts before and after each step), over the
kernel time of that window, in percent. Layer: resolve step. Moves
txn_per_s."""

import importlib

roofline = importlib.import_module("portbench.roofline")


def read(ctx):
    peak = roofline.peaks(ctx.device_kind)
    if peak is None or ctx.trace is None or ctx.trace.kernel_s <= 0:
        return None
    words = int(ctx.config["key_bytes"]) // 4
    n = ctx.n_txns
    total = sum(roofline.step_bytes(b, a, n, n, n, words)
                for b, a in zip(ctx.rows_before, ctx.rows_after))
    return 100.0 * total / peak["hbm_bytes_per_s"] / ctx.trace.kernel_s
