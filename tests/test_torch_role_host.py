"""The resolver role in its own OS process on the port's CUDA backend,
at device="cpu" (the kernels' plain versions), through the helpers
that chip_smoke.py's role-host phase runs on the card
(`testing.role_host_run`, `testing.role_cluster_run`):

- a role host recruited on `cuda` over TCP answers a chain of
  ResolveRequests exactly as the in-process role does, across a
  checkpoint, a SIGKILL, a respawn that restores the checkpoint and
  replays the journal above it, and the resend of the last request
  before the kill (the byte-identical cached payload);
- the commit pipeline with two resolver hosts and a tlog host, two
  proxy worker processes over the gateway, resolver host 0 killed and
  respawned halfway: every arrival commits, commits resume, and every
  acknowledged write reads back."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from foundationdb_tpu_torch import testing  # noqa: E402

N_TXNS = 64
N_BATCHES = 16
STEP = 250_000
FIRST = (1 << 30) - 8 * STEP      # the chain crosses 2^30: one re-base


def _requests(seed=5, key_bytes=16, keyspace=3000):
    """chip_smoke.py's role traffic at a small width: one point read and
    one point write a transaction, chained from version 0."""
    from foundationdb_tpu_torch.server.types import (CommitRequest,
                                                     ResolveRequest)
    rng = np.random.default_rng(seed)
    pad = bytes(key_bytes - 8)
    out, prev = [], 0
    for i in range(N_BATCHES):
        v = FIRST + i * STEP
        raw = rng.integers(0, keyspace, 2 * N_TXNS).astype(">u8").tobytes()
        keys = [pad + raw[j:j + 8] for j in range(0, len(raw), 8)]
        txns = tuple(CommitRequest(
            v - STEP, ((r, r + b"\x00"),), ((w, w + b"\x00"),), (),
            report_conflicting_keys=(t == 0 and i % 2 == 1))
            for t, (r, w) in enumerate(zip(keys[0::2], keys[1::2])))
        out.append(ResolveRequest(prev, v, txns))
        prev = v
    return out


def _in_process_replies(requests, backend="cuda"):
    """The in-process role's replies (a virtual scheduler, SimNetwork)."""
    from foundationdb_tpu_torch import flow
    from foundationdb_tpu_torch.rpc import SimNetwork
    from foundationdb_tpu_torch.server.resolver_role import Resolver
    flow.set_seed(0)
    s = flow.Scheduler()
    flow.set_scheduler(s)
    try:
        net = SimNetwork(s, flow.g_random)
        proxy = net.new_process("proxy", machine="p")
        res = Resolver(net.new_process("resolver", machine="r"), backend,
                       device="cpu")
        res.start()
        ref = res.resolves.ref()

        async def run():
            return [await ref.get_reply(r, proxy) for r in requests]

        replies = s.run(until=s.spawn(run()), timeout_time=1e9)
        res.stop()
        return dict(enumerate(replies))
    finally:
        flow.set_scheduler(None)


@pytest.fixture
def short_period(monkeypatch):
    """The host's checkpoint period for CPU-sized requests (a request
    takes milliseconds here, not the card's ~0.8 s)."""
    monkeypatch.setattr(testing, "ROLE_HOST_CKPT_EVERY", 0.5)


def test_role_host_replies_equal_across_a_kill(tmp_path, short_period):
    requests = _requests()
    replies = _in_process_replies(requests)
    assert sum(list(getattr(r, "verdicts", r)).count(0)
               for r in replies.values()) > 0      # some conflicts
    out = testing.role_host_run(requests, replies, str(tmp_path),
                                device="cpu")
    assert out["checkpoints"] >= 1
    assert out["replayed"] == testing.ROLE_HOST_KILL_AT - \
        out["checkpoint_at"]
    assert out["batches"] == [testing.ROLE_HOST_KILL_AT + 1,
                              out["replayed"] + N_BATCHES
                              - testing.ROLE_HOST_KILL_AT - 1]
    # the plain versions count no launch
    assert out["launches"] == [{}, {}]


def test_role_host_rejects_a_differing_reply(tmp_path, short_period,
                                            monkeypatch):
    """The helper's check bites: a reply held to another batch's fails."""
    monkeypatch.setattr(testing, "ROLE_HOST_CKPT_AT", 0)
    monkeypatch.setattr(testing, "ROLE_HOST_KILL_AT", 1)
    requests = _requests()[:3]
    replies = _in_process_replies(requests)
    replies[1] = replies[2]
    with pytest.raises(AssertionError, match="reply 1 differs"):
        testing.role_host_run(requests, replies, str(tmp_path),
                              device="cpu")


def test_role_cluster_commits_through_a_resolver_kill(tmp_path,
                                                      monkeypatch):
    # a CPU's share of the card's 400 arrivals a s for 8 s, and the kill
    # once they are all offered: on a loaded CPU a slow commit pipeline
    # or respawn must not age the arrivals' read versions past the 5 s
    # MVCC window (each too-old abort counts against the run)
    monkeypatch.setattr(testing, "ROLE_CLUSTER_RATE", 10.0)
    monkeypatch.setattr(testing, "ROLE_CLUSTER_DURATION", 4.0)
    monkeypatch.setattr(testing, "ROLE_CLUSTER_KILL_AT", 1.0)
    out = testing.role_cluster_run(str(tmp_path), device="cpu")
    assert out["committed"] == out["offered"] > 0
    assert out["read_back"] == out["committed"]
    assert out["kill_to_ready_s"] > 0
    assert out["kill_to_commit_s"] is None or \
        out["kill_to_ready_s"] <= out["kill_to_commit_s"] <= 120.0
    assert set(out["launches"]) == {
        "ext-resolver-0 before the kill", "ext-resolver-0",
        "ext-resolver-1", "ext-tlog-0"}
