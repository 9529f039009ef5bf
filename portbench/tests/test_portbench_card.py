"""One short run of each cell on the card (skips without one)."""

import pytest

from portbench.lib.harness import run_cell


@pytest.mark.card
@pytest.mark.parametrize("cell", ["l3_chunks", "l5_archive"])
def test_one_short_run_on_the_card(card, cell):
    res, checks = run_cell(cell, 2**31 + 1, 1.0, True)
    assert res["correct"] is True, checks
    assert res["device"]["platform"] == "gpu"
    assert res["device"]["busy_s"] > 0
    assert "device_idle_share.compress" in res["metrics"]
