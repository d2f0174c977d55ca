"""The teacher_b8_512 cell on the CPU at a small size: loaded through the
catalog, its driver's check passes on the sound teacher, and a whole run
(traced) of a copy of the cell at batch 2 of 64×64 is correct and reads
the program's spans."""

import json
import os
import shutil

import torch

from conftest import ROOT
from vfibench import catalog, run
from vfibench.drivers import teacher_calls

SEED = 9_876_543_210_123


def test_the_cell_loads_and_its_check_passes_at_a_small_size():
    cell = catalog.load_cell("teacher_b8_512")
    assert cell["config"]["name"] == "pwcnet_teacher"
    assert cell["config"]["reduced"] == []
    assert cell["traffic"]["driver"] == "teacher_calls"
    assert cell["chips"] == 1
    cell["config"] = dict(cell["config"], batch_size=2, crop_size=64)
    cell["traffic"] = dict(cell["traffic"], pool=2)
    torch.set_num_threads(2)
    d = teacher_calls.Driver(cell, "cpu", SEED)
    d.setup()
    win = d.window(0.1)
    assert win["requests"] >= 1 and "samples_per_s" in win["e2e"]
    d.release()
    checks = d.check()
    assert set(checks) == set(cell["limits"])
    assert all(v <= lim for v, lim in checks.values()), checks


def test_a_traced_run_of_a_small_copy_is_correct(tmp_path):
    here = str(tmp_path / "vfibench")
    shutil.copytree(os.path.join(ROOT, "vfibench"), here,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))

    def edit(kind, name, new, **changes):
        with open(os.path.join(here, kind, name + ".json")) as f:
            obj = dict(json.load(f), **changes)
        with open(os.path.join(here, kind, new + ".json"), "w") as f:
            json.dump(obj, f)

    edit("configs", "pwcnet_teacher", "tiny_teacher", batch_size=2,
         crop_size=64)
    edit("traffic", "teacher_b8_512", "tiny_teacher", pool=2, trace_calls=1)
    rep = catalog.reported(here)["teacher_b8_512"]
    edit("cells", "teacher_b8_512", "tiny_teacher", config="tiny_teacher",
         traffic="tiny_teacher", end_to_end=rep["end_to_end"],
         per_layer=rep["metrics"])
    torch.set_num_threads(2)
    res = run.run_cell("tiny_teacher", SEED, 0.2, True, device="cpu",
                       here=here)
    assert res["correct"], res["checks"]
    # the program's spans; a CPU run has no device trace and no peaks
    got = set(res["metrics"])
    assert {"trace_teacher.stage.extractor_ms", "trace_teacher.stage.corr_ms",
            "trace_teacher.counter.launches"} <= got
    assert "trace_teacher.mfu" not in got
