"""The comparison that decides `correct`, driven through a whole run on the
CPU at a small size (the harness's look for a card skipped), with the
timed path broken underneath (vfibench/faults.py): each fault the cells
can have must come out not correct, and the sound run correct."""

import pytest

from vfibench import faults, run


def _run(here, cell):
    return run.run_cell(cell, 9_876_543_210_123, 1.5, False, device="cpu",
                        here=here)


@pytest.mark.parametrize("cell", ["tiny_pairs", "tiny_train"])
def test_sound_runs_are_correct(tiny_here, cell):
    res = _run(tiny_here, cell)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1


@pytest.mark.parametrize("fault", faults.PAIRS)
def test_pairs_faults_are_not_correct(tiny_here, fault):
    with faults.planted("infer", fault):
        res = _run(tiny_here, "tiny_pairs")
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("fault", faults.TRAIN)
def test_train_faults_are_not_correct(tiny_here, fault):
    with faults.planted("train", fault):
        res = _run(tiny_here, "tiny_train")
    assert not res["correct"], res["checks"]
