"""On the card, at sizes a test run holds: the program passes each cell's
comparison and the control fails it (the program switched to the next
precision below its configuration's, as the configuration's "control"
says). `python -m vfibench.control` reads the same at the cells' own
sizes on many seeds, which is where the limits come from."""

import json
import os
import shutil

import pytest
import torch

from conftest import ROOT

# each cell's traffic cut to what a test holds
SMALLER = {"x8_4k": {"height": 1080, "width": 2048, "clip_frames": 3},
           "x2_4k": {"height": 1080, "width": 2048, "clip_frames": 3},
           "x2_2k": {"height": 540, "width": 1024, "clip_frames": 3},
           "train_b8_512": {"pool": 3}}


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(SMALLER))
def test_program_passes_and_control_fails(cell, tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    from vfibench import catalog
    from vfibench.run import run_cell

    here = str(tmp_path / "vfibench")
    shutil.copytree(os.path.join(ROOT, "vfibench"), here,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    os.symlink(os.path.join(ROOT, "checkpoints"),
               str(tmp_path / "checkpoints"))
    name = catalog.load_json("cells", cell, here)["traffic"]
    tr = dict(catalog.load_json("traffic", name, here), **SMALLER[cell])
    if "check_pairs" in tr:
        tr["check_pairs"] = 1
    with open(os.path.join(here, "traffic", name + ".json"), "w") as f:
        json.dump(tr, f)
    control = catalog.load_json(
        "configs", catalog.load_json("cells", cell, here)["config"],
        here)["control"]
    for seed in (5_000_000_001, 5_000_000_002):
        sound = run_cell(cell, seed, 1.0, False, here=here)
        assert sound["correct"], sound["checks"]
        ctl = run_cell(cell, seed, 1.0, False, here=here, control=control)
        assert not ctl["correct"], ctl["checks"]
