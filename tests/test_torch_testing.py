"""The port's copy of the parity tests' transaction stream
(`foundationdb_tpu_torch.testing.rand_batches`) yields the reference's
stream (`tests/test_packed_interval.py:rand_batches`) draw for draw:
the same transactions, field by field, the same versions."""

import pytest

torch = pytest.importorskip("torch")

from foundationdb_tpu_torch import testing  # noqa: E402
from foundationdb_tpu_torch.models import ResolverTransaction  # noqa: E402
from test_packed_interval import rand_batches as ref_rand_batches  # noqa: E402


@pytest.mark.parametrize("seed,kw", [
    (3, {}),
    (17, {"point": True}),
    (23, {"n_keys": 7, "max_txns": 30, "version_stride": 20,
          "window": 50})])
def test_rand_batches_is_the_reference_stream(seed, kw):
    ours = testing.rand_batches(seed, 40, **kw)
    ref = ref_rand_batches(seed, 40, **kw)
    assert len(ours) == len(ref) == 40
    assert sum(len(b) for b, _v, _o in ours) > 40
    for (b, v, o), (rb, rv, ro) in zip(ours, ref):
        assert (v, o) == (rv, ro)
        assert all(type(t) is ResolverTransaction for t in b)
        assert [tuple(t) for t in b] == [tuple(t) for t in rb]
