"""The reference's knob cases (tests/test_knobs.py) on the port's knob
table: its size and BUGGIFY-distortion surface, and the distortion
machinery producing distorted values under a buggified seed (and none
with BUGGIFY off). The reference's dead-knob scan waits for the
decision on trimming the port's table to the knobs it reads."""

import importlib
import pathlib
import re

import pytest

torch = pytest.importorskip("torch")

from foundationdb_tpu_torch import flow  # noqa: E402
from foundationdb_tpu_torch.flow.knobs import make_server_knobs  # noqa: E402


@pytest.fixture(autouse=True)
def default_buggify_rates():
    """Hold both packages' BUGGIFY activation and fire rates at their
    defaults: `flow.set_seed` resets neither, and a test that forces a
    site raises a package's fire rate (the reference's
    `test_resolve_pipeline.py` leaves it at 1.0), which would make the
    two packages draw differently in a later test of the same process."""
    saved = []
    for name in ("foundationdb_tpu", "foundationdb_tpu_torch"):
        b = importlib.import_module(f"{name}.flow.rng").g_buggify
        fresh = type(b)()
        saved.append((b, b.activated_p, b.fire_p))
        b.activated_p, b.fire_p = fresh.activated_p, fresh.fire_p
    yield
    for b, activated_p, fire_p in saved:
        b.activated_p, b.fire_p = activated_p, fire_p


REPO = pathlib.Path(__file__).resolve().parent.parent


def test_knob_surface_size():
    k = make_server_knobs()
    assert len(k._defaults) >= 78, len(k._defaults)
    # distortion surface: at least a quarter of the knobs can be
    # BUGGIFY-randomized (control-flow knobs)
    src = (REPO / "foundationdb_tpu_torch/flow/knobs.py").read_text()
    assert len(re.findall(r"lambda", src)) >= 25


def test_buggify_actually_distorts():
    """Across a handful of seeds, SOME knob must come up distorted —
    and with buggify off, none may."""
    try:
        distorted = set()
        for seed in range(12):
            flow.set_seed(seed, buggify_enabled=True)
            k = make_server_knobs(randomize=True)
            for name, default in k._defaults.items():
                if getattr(k, name.lower()) != default:
                    distorted.add(name)
        assert len(distorted) >= 3, distorted

        flow.set_seed(0, buggify_enabled=False)
        k = make_server_knobs(randomize=False)
        for name, default in k._defaults.items():
            assert getattr(k, name.lower()) == default, name
    finally:
        # restore the ambient registry for later tests in this process
        flow.set_seed(0, buggify_enabled=False)
        flow.reset_server_knobs(randomize=False)


def test_buggify_distortions_match_the_reference():
    """The same buggified seed distorts the same knobs to the same
    values in both tables (each package draws from its own g_random)."""
    from foundationdb_tpu import flow as ref_flow
    from foundationdb_tpu.flow.knobs import make_server_knobs as ref_make
    try:
        for seed in range(6):
            flow.set_seed(seed, buggify_enabled=True)
            ours = make_server_knobs(randomize=True)
            ref_flow.set_seed(seed, buggify_enabled=True)
            ref = ref_make(randomize=True)
            assert set(ours._defaults) == set(ref._defaults)
            for name in ref._defaults:
                assert getattr(ours, name.lower()) == \
                    getattr(ref, name.lower()), (seed, name)
    finally:
        for f in (flow, ref_flow):
            f.set_seed(0, buggify_enabled=False)
            f.reset_server_knobs(randomize=False)
