"""Transport microbenchmark: request/reply throughput and latency.

Reference: fdbserver -r networktestserver / networktest
(fdbserver/networktest.actor.cpp) — a ping server and a client loop
measuring the RPC path in isolation. Here it exercises the real TCP
transport (frames, wire encoding, reader/writer threads) over
loopback: `python -m foundationdb_tpu_torch.tools.networktest [--requests N]
[--parallel P] [--bytes B]`.
"""

from __future__ import annotations

import sys
import time
from typing import List, Optional

from .. import flow
from ..flow import rng
from ..rpc.tcp import TcpRequestStream, TcpTransport


def run_networktest(requests: int = 2000, parallel: int = 16,
                    payload_bytes: int = 64) -> dict:
    if requests <= 0:
        return {"requests": 0, "parallel": 0, "payload_bytes": payload_bytes,
                "requests_per_second": 0.0, "p50_ms": 0.0, "p99_ms": 0.0}
    parallel = max(1, min(parallel, requests))
    # this tool hosts its OWN wall-clock loop and reseeds the ambient
    # RNG; a caller already running a flow loop (a test, a seeded sim)
    # must get both back EXACTLY as they were — restore in the finally
    # below (clusterbench shares the discipline)
    prev_sched = flow.get_scheduler()
    prev_rng = rng.rng_state()
    flow.set_seed(0)
    s = flow.Scheduler(virtual=False)
    flow.set_scheduler(s)
    server = TcpTransport()
    client = TcpTransport()
    try:
        stream = TcpRequestStream(server)
        server.start()
        client.start()
        payload = b"x" * payload_bytes

        async def serve():
            while True:
                req, reply = await stream.pop()
                reply.send(req)

        async def worker(ref, n, lat):
            for _ in range(n):
                t0 = time.perf_counter()
                got = await ref.get_reply(payload)
                lat.append(time.perf_counter() - t0)
                assert got == payload

        async def main():
            flow.spawn(serve())
            ref = client.ref("127.0.0.1", server.port, stream.token)
            await ref.get_reply(b"warmup")
            lat: List[float] = []
            per, extra = divmod(requests, parallel)
            t0 = time.perf_counter()
            await flow.wait_for_all([
                flow.spawn(worker(ref, per + (1 if i < extra else 0), lat))
                for i in range(parallel)])
            wall = time.perf_counter() - t0
            lat.sort()
            return {
                "requests": len(lat),
                "parallel": parallel,
                "payload_bytes": payload_bytes,
                "requests_per_second": round(len(lat) / wall, 1),
                "p50_ms": round(lat[len(lat) // 2] * 1e3, 3),
                "p99_ms": round(lat[int(len(lat) * 0.99)] * 1e3, 3),
            }

        t = s.spawn(main())
        return s.run(until=t, timeout_time=600)
    finally:
        server.close()
        client.close()
        flow.set_scheduler(prev_sched)
        rng.restore_rng_state(prev_rng)


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    kw = {}
    run_dir = None
    while argv:
        a = argv.pop(0)
        if a == "--requests":
            kw["requests"] = int(argv.pop(0))
        elif a == "--parallel":
            kw["parallel"] = int(argv.pop(0))
        elif a == "--bytes":
            kw["payload_bytes"] = int(argv.pop(0))
        elif a == "--run-dir":
            run_dir = argv.pop(0)
    # CLI runs land their trace events in a run directory and name it
    # in the final summary line, same contract as clusterbench
    # — tracemerge takes the directory as-is
    import json
    import os
    import tempfile
    if run_dir is None:
        run_dir = tempfile.mkdtemp(prefix="fdbtpu-run-")
    else:
        os.makedirs(run_dir, exist_ok=True)
    prev_trace_path = flow.g_trace.path
    flow.reset_trace(os.path.join(
        run_dir, f"trace.networktest.{os.getpid()}.jsonl"))
    flow.trace.set_process_identity("networktest")
    try:
        result = run_networktest(**kw)
    finally:
        flow.g_trace_batch.dump()
        flow.reset_trace(prev_trace_path)
        flow.trace.clear_process_identity()
    result["trace_run_dir"] = run_dir
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
