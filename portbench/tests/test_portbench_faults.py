"""``correct`` comes out false under the control and under each fault a
one-chip cell can have, and true on the program as it is: the harness's
whole run (the card's check skipped, the plain kernels on the CPU) at a
small corpus."""

import pytest

from portbench import faults
from portbench.lib.harness import run_cell

SMALL = {
    "l5_archive": {"corpus": {"kind": "mixed", "bytes": 600_000, "base_seed": 12,
                              "extent": 1 << 18},
                   "warmup": {"kind": "requests", "count": 1}},
    "l3_chunks": {"corpus": {"kind": "mixed", "bytes": 1 << 20, "base_seed": 12,
                             "extent": 1 << 18},
                  "requests": {"kind": "chunks", "min": 131072, "mean_extra": 131072,
                               "max": 1 << 20, "set": 4},
                  "warmup": {"kind": "requests", "count": 1}},
}


def run(cell, mode=None, seed=2**31 + 101):
    logs = []
    if mode is None:
        res, checks = run_cell(cell, seed, 0.5, False, device="cpu", require_card=False,
                               mix_override=SMALL[cell], log=logs.append)
    else:
        with faults.planted(mode):
            res, checks = run_cell(cell, seed, 0.5, False, device="cpu",
                                   require_card=False, mix_override=SMALL[cell],
                                   log=logs.append)
    return res, checks


@pytest.mark.parametrize("cell", ["l5_archive", "l3_chunks"])
def test_sound_run_is_correct(cell):
    res, checks = run(cell)
    assert res["correct"] is True
    assert res["attempted"] >= 1
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("cell", ["l5_archive", "l3_chunks"])
def test_control_fails_only_the_reference(cell):
    # the port reads its own port-only stream back exactly; the reference
    # does not
    res, checks = run(cell, "control")
    assert res["correct"] is False
    assert checks["roundtrip_bad"] == 0 and checks["failed"] == 0
    assert checks["block_bad"] > 0


@pytest.mark.parametrize("mode", ["token", "answer", "state", "half"])
@pytest.mark.parametrize("cell", ["l5_archive", "l3_chunks"])
def test_fault_is_caught(cell, mode):
    res, checks = run(cell, mode)
    assert res["correct"] is False
    caught = {k for k, v in checks.items() if v > 0}
    assert caught, checks
    if mode == "half":
        assert "frame_bad" in caught
    if mode == "answer":
        # the stream is sound: only the program's own read-back is wrong
        assert "roundtrip_bad" in caught and not caught & {"frame_bad", "block_bad"}


def test_faults_restore_the_program():
    from kanzi_tpu_torch.io import stream as S
    before = (S.encode_block, S.decode_block)
    for mode in faults.MODES:
        with faults.planted(mode):
            pass
    assert (S.encode_block, S.decode_block) == before
