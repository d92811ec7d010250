"""Cluster host process: serve a cluster on a TCP port.

Reference: fdbserver + fdbmonitor — one OS process hosting the
database, reachable over the network; `python -m
foundationdb_tpu_torch.tools.server --port 4500` plays that role for this
framework: a wall-clock cluster (every role, durable disks, recovery,
DD) whose client surface is served by the TcpGateway, so external
processes — the CLI's --connect mode, the C binding, any
RemoteCluster — speak the real wire protocol to it.
"""

from __future__ import annotations

import sys
from typing import List, Optional

from .. import flow
from ..rpc.gateway import TcpGateway
from ..server import SimCluster


def serve(port: int = 0, seed: int = 0, n_storage: int = 2,
          storage_replicas: int = 1, n_logs: int = 1, n_proxies: int = 1,
          tls=None, data_dir=None, announce=print,
          cluster_file=None, backup_agent: bool = True,
          device=None, knobs=None) -> None:
    """Run until interrupted; announces `LISTENING <port>` once up.
    With --data-dir, durable state lives in REAL files there and
    survives restarting this process. With --cluster-file, writes the
    fdb.cluster-style connection string clients dial (ref: the cluster
    file convention, fdbclient/MonitorLeader.actor.cpp). `device` is
    where a CUDA resolver runs (None: the card; "cpu": the plain
    versions). A missing card or a device fault past the retries ends
    the run with its error: the server never serves on in their
    place. `knobs` ({name: value}) are set on SERVER_KNOBS once the
    cluster is built (its construction resets them).

    Restarted on a data directory that already holds a database, the
    server opens its gateway only once an epoch recruited with the
    stored `\\xff/conf/` rows is fully recovered (ref: the master
    reading the configuration before it recruits): the boot's recovery
    runs on the flags' configuration, and a stored `cuda` row then asks
    for the card before any client is served on the flags' backend."""
    import os as _os
    restarted = data_dir is not None and _os.path.isdir(data_dir) \
        and bool(_os.listdir(data_dir))
    if cluster_file is not None:
        # fail BEFORE booting a cluster if the path can't be written
        d = _os.path.dirname(cluster_file) or "."
        if not _os.path.isdir(d) or not _os.access(d, _os.W_OK):
            raise SystemExit(
                f"--cluster-file directory not writable: {d}")
    c = SimCluster(seed=seed, virtual=False, durable=True,
                   n_storage=n_storage, storage_replicas=storage_replicas,
                   n_logs=n_logs, n_proxies=n_proxies, data_dir=data_dir,
                   backup_driver=backup_agent, device=device)
    for name, value in (knobs or {}).items():
        flow.SERVER_KNOBS.set(name, value)
    gw = TcpGateway(c.client("gateway-host"), port=port, tls=tls)
    try:
        async def main():
            if restarted:
                await _recover_onto_stored_conf(c)
            gw.start()
            if cluster_file is not None:
                from ..client.cluster_file import (
                    ClusterConnectionString, write_cluster_file)
                write_cluster_file(cluster_file, ClusterConnectionString(
                    "fdbtpu", f"s{seed}",
                    (("127.0.0.1", gw.port),)))
            announce(f"LISTENING {gw.port}", flush=True)
            while True:
                await flow.delay(flow.SERVER_KNOBS.server_status_poll_delay)

        c.run(main())
    except KeyboardInterrupt:
        pass
    finally:
        gw.close()
        c.shutdown()


async def _recover_onto_stored_conf(c) -> None:
    """Once the boot's epoch is fully recovered, run the controller's
    conf sync (its loop's round, without waiting for its timer) and
    wait until an epoch recruited with the adopted configuration is
    fully recovered. A recruitment that fails for good ends `c.run`
    with its error instead."""
    from ..server.dbinfo import FULLY_RECOVERED
    cc = c.cc
    db = c.client("conf-boot")
    poll = flow.SERVER_KNOBS.failure_detection_interval
    while True:
        if cc.dbinfo.get().recovery_state == FULLY_RECOVERED:
            try:
                await cc._conf_sync_once(db)
                break
            except flow.FdbError as e:
                if e.name == "operation_cancelled":
                    raise
        await flow.delay(poll)
    while True:
        info, rec = cc.dbinfo.get(), cc._recovery
        if not cc._config_dirty and rec is not None \
                and rec.config == cc.config and rec.epoch == info.epoch \
                and info.recovery_state == FULLY_RECOVERED:
            break
        await flow.delay(poll)
    db.close()


def _knob_value(text: str):
    for parse in (int, float):
        try:
            return parse(text)
        except ValueError:
            pass
    return text


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    from ._tlsargs import TLS_FLAGS, tls_from_args
    kwargs = {}
    tls_args = {}
    while argv:
        a = argv.pop(0)
        if a in TLS_FLAGS:
            tls_args[TLS_FLAGS[a]] = argv.pop(0)
        elif a == "--port":
            kwargs["port"] = int(argv.pop(0))
        elif a == "--data-dir":
            kwargs["data_dir"] = argv.pop(0)
        elif a == "--seed":
            kwargs["seed"] = int(argv.pop(0))
        elif a == "--storage":
            kwargs["n_storage"] = int(argv.pop(0))
        elif a == "--replicas":
            kwargs["storage_replicas"] = int(argv.pop(0))
        elif a == "--logs":
            kwargs["n_logs"] = int(argv.pop(0))
        elif a == "--proxies":
            kwargs["n_proxies"] = int(argv.pop(0))
        elif a in ("--cluster-file", "-C"):
            kwargs["cluster_file"] = argv.pop(0)
        elif a == "--no-backup-agent":
            kwargs["backup_agent"] = False
        elif a == "--device":
            kwargs["device"] = argv.pop(0)
        elif a.startswith("--knob_"):
            # (ref: fdbserver's --knob_<name> <value>)
            name = a[len("--knob_"):].lower()
            if not hasattr(flow.SERVER_KNOBS, name):
                print(f"unknown knob {name}", file=sys.stderr)
                return 2
            kwargs.setdefault("knobs", {})[name] = _knob_value(argv.pop(0))
        else:
            print(f"unknown argument {a}", file=sys.stderr)
            return 2
    try:
        tls = tls_from_args(tls_args)
    except ValueError as e:
        print(str(e), file=sys.stderr)
        return 2
    if tls is not None:
        kwargs["tls"] = tls
    serve(**kwargs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
