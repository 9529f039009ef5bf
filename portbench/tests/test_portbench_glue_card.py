"""The glue spans of one short traced run of each cell on the card (skips
without one): nested, and on the device trace's clock."""

import pytest

from portbench.glue_split import run_with_events, split_line
from portbench.lib import glue


@pytest.mark.card
@pytest.mark.parametrize("cell", ["l3_chunks", "l5_archive"])
def test_glue_spans_nest_and_hold_the_card_work(card, cell):
    res, run, gl = run_with_events(cell, 2**31 + 3, 1.0, True)
    assert res["correct"] is True
    line = split_line(run, gl)
    assert line["nesting_faults"] == 0, line["nesting_fault_lines"]
    # every launch of these cells is made under GLUE_LOCK
    assert line["busy_in_holds"] >= 0.99
    for d in ("compress", "decompress"):
        assert line[f"glue_hold_over_wall.{d}"] <= 1
        assert line[f"entropy_lock_wait_ms_per_MB.{d}"] is not None
        assert line[f"card_copy_bytes_per_byte.{d}"] > 0
    assert set(line["idle_by_glue_state"]) == {f"{d}:{s}" for d in ("compress", "decompress")
                                               for s in glue.STATES}
