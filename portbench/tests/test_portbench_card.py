"""On the card: each cell, a short window, comes out correct."""

import pytest

from portbench import harness


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in
                                  harness.benchmark()["workloads"]])
def test_cell_on_card(card, cell):
    r = harness.run_cell(cell, 2 ** 31 + 99, 2.0, False)
    assert r["correct"], r["checks"]
    assert r["device"]["platform"] == "gpu"
