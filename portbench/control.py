"""The control of `correct`: the plain reference put in the program's
place with one of the configuration's guarantees broken, compared with
the plain reference as a run compares the program.

    python3 -m portbench.control --workload <cell> --seeds 1 2 3 \\
        --batches <n> [--kind no_intra_batch|no_history]

`no_intra_batch` admits a transaction that reads a key an earlier
transaction of its batch wrote; `no_history` skips the check against
the committed history. Each prints one JSON line a seed with the number
compared (`verdict_mismatches`) and its limit. The benchmark's runs do
not run this. Both replays run on the card where there is one, as a
run's check does.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

KINDS = {"no_intra_batch": {"intra_batch": False},
         "no_history": {"external": False}}


def control_verdicts(loop, config, broken, device):
    """The broken reference's (conflict bits, too-old bits) of every
    batch of `loop`."""
    from . import harness
    conflict_bits, too_old_bits = [], []
    for _i0, got in harness.replay(loop, config, device, **broken):
        conflict_bits += list(np.packbits(got & 1, axis=1))
        too_old_bits += list(np.packbits(got >> 1, axis=1))
    return conflict_bits, too_old_bits


def run_control(name: str, seed: int, batches: int, kind: str,
                overrides: dict | None = None) -> dict:
    from . import harness
    _cell, config, traffic = harness.find_cell(name)
    overrides = overrides or {}
    config = {**config, **overrides.get("config", {})}
    traffic = {**traffic, **overrides.get("traffic", {})}
    pool = harness.generator(traffic).Pool(config, traffic, seed)
    # the loop's schedule (versions, read versions, window edges) as a
    # run of the same length has it
    loop = harness.Loop(harness.NullResolver(), pool, config, traffic)
    loop.run_batches(loop.warmup + batches)
    loop.finish()
    import torch
    device = "cuda" if torch.cuda.is_available() else "cpu"
    t0 = time.perf_counter()
    verdicts = control_verdicts(loop, config, KINDS[kind], device)
    mismatched, _rows, _counts = harness.check_verdicts(verdicts, loop,
                                                        config, device)
    return {"workload": name, "seed": seed, "kind": kind,
            "batches": loop.next,
            "checks": {"verdict_mismatches": {"value": mismatched,
                                              "limit": 0}},
            "correct": mismatched == 0,
            "seconds": time.perf_counter() - t0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--batches", type=int, required=True)
    ap.add_argument("--kind", choices=sorted(KINDS), default="no_intra_batch")
    args = ap.parse_args(argv)
    for seed in args.seeds:
        print(json.dumps(run_control(args.workload, seed, args.batches,
                                     args.kind)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
