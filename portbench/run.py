"""Run one cell of the port's benchmark once.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout. Prints one JSON object as the last line of
standard output: `correct`, `attempted`, `failed`, `metrics` (the
cell's end-to-end metrics, or with `--trace 1` its per-layer ones),
`device` and, last, `checks` (each number compared with its limit,
also the last lines of standard error). Exits 3 without a CUDA card or
with fewer cards than the cell asks for, and 4 if JAX or the JAX
package was loaded; neither prints a result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "foundationdb_tpu")


def cache_dirs(root: str) -> None:
    """Kernel build caches at fixed paths inside the checkout."""
    cache = os.path.join(root, ".benchcache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench import harness
    cell, _config, _traffic = harness.find_cell(args.workload)
    cache_dirs(harness.ROOT)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs only on the card",
              file=sys.stderr)
        return 3
    if torch.cuda.device_count() < int(cell["chips"]):
        print(f"the cell needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 3
    result = harness.run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), t_start=T_START)
    found = forbidden_modules()
    if found:
        print(f"loaded in this process: {found}", file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
