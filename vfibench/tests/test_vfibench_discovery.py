"""The harness finds every part by name: a copy of vfibench/ with a new
configuration, traffic mix, cell, end-to-end and per-layer metric added as
files lists, checks and loads them, and writes them into BENCHMARK.json,
with no existing file changed. The committed BENCHMARK.json is what the
parts make."""

import hashlib
import json
import os
import shutil

from conftest import ROOT
from vfibench import catalog

METRIC = '''"""A test's per-layer metric: the pairs of the window."""
UNIT = "pairs"
BETTER = "higher"
SOURCE = "host_clock"
LAYER = "pipeline: eval/pipeline.py Interpolator"
MOVES = "frames_per_s"
WORKLOADS = ["x8_4k"]


def read(rec):
    return rec["layers"].get("pairs")
'''


def _digests(here):
    out = {}
    for d, _, files in os.walk(here):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, here)] = hashlib.sha1(fh.read()).digest()
    return out


def test_new_parts_are_found_by_name(tmp_path):
    """A new metric for a cell that is there (its file names the cell), and
    a new cell with a configuration, a traffic mix and an end-to-end metric
    of its own that reports metrics that are there (its file lists them):
    each a new file, and no file that was there changes."""
    here = str(tmp_path / "vfibench")
    shutil.copytree(os.path.join(ROOT, "vfibench"), here,
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digests(here)

    def put(kind, name, obj):
        with open(os.path.join(here, kind, name + ".json"), "w") as f:
            json.dump(obj, f)

    with open(os.path.join(here, "metrics", "pairs.count.py"), "w") as f:
        f.write(METRIC)
    cfg = catalog.load_json("configs", "papermodel_test5_deploy", here)
    cfg["fldr_config"].update(compute_dtype="float32", flow_dtype="")
    put("configs", "papermodel_test5_f32", cfg)
    put("traffic", "x4_4k", dict(
        catalog.load_json("traffic", "x8_4k", here), multiple=4,
        why="x4 at 2160x4096"))
    put("end_to_end", "frames_per_s_x4", dict(
        catalog.load_json("end_to_end", "frames_per_s", here),
        quantity="frames_per_s", workloads=["x4_4k_f32"]))
    put("cells", "x4_4k_f32", dict(
        catalog.load_json("cells", "x8_4k", here),
        config="papermodel_test5_f32", traffic="x4_4k",
        why="x4 in float32 at 2160x4096", rank=99,
        end_to_end=["peak_mem_gib", "setup_s"],
        per_layer=["mfu.infer", "pairs.count"]))

    assert "x4_4k_f32" in catalog.names("cells", here)
    assert "pairs.count" in catalog.names("metrics", here)
    assert catalog.validate(here) == []
    old = catalog.load_cell("x8_4k", here)
    assert old["layers"]["pairs.count"].read({"layers": {"pairs": 3}}) == 3
    assert "frames_per_s_x4" not in old["e2e"]
    new = catalog.load_cell("x4_4k_f32", here)
    assert new["traffic"]["multiple"] == 4
    assert set(new["e2e"]) == {"frames_per_s_x4", "peak_mem_gib", "setup_s"}
    assert new["e2e"]["frames_per_s_x4"]["quantity"] == "frames_per_s"
    assert set(new["layers"]) == {"mfu.infer_x4", "pairs.count_x4"}
    bench = catalog.benchmark_json(here)
    assert bench["workloads"][-1]["name"] == "x4_4k_f32"
    assert {"name": "papermodel_test5_f32"}.items() <= \
        [c for c in bench["configs"]
         if c["name"] == "papermodel_test5_f32"][0].items()
    layers = {m["name"]: m for m in bench["per_layer"]}
    assert layers["pairs.count"]["workloads"] == ["x8_4k"]
    assert layers["pairs.count"]["moves"] == "frames_per_s"
    assert layers["pairs.count_x4"]["workloads"] == ["x4_4k_f32"]
    assert layers["mfu.infer_x4"]["moves"] == "frames_per_s_x4"
    assert "x4_4k_f32" not in layers["mfu.infer"]["workloads"]
    after = _digests(here)
    assert {k: after[k] for k in before} == before
    # what was there reads as it did
    assert {k: v for k, v in bench.items() if k not in
            ("configs", "workloads", "end_to_end", "per_layer")} == \
        {k: v for k, v in catalog.benchmark_json().items() if k not in
         ("configs", "workloads", "end_to_end", "per_layer")}
    for m in catalog.benchmark_json()["per_layer"]:
        assert layers[m["name"]] == m


def test_a_broken_part_is_refused(tmp_path):
    here = str(tmp_path / "vfibench")
    shutil.copytree(os.path.join(ROOT, "vfibench"), here,
                    ignore=shutil.ignore_patterns("__pycache__"))
    with open(os.path.join(here, "cells", "bad.json"), "w") as f:
        json.dump({"config": "nope", "traffic": "x8_4k", "chips": 2,
                   "why": "x", "end_to_end": ["frames_per_s"],
                   "per_layer": [], "limits": {}}, f)
    bad = catalog.validate(here)
    assert any("no configs/nope" in b for b in bad)
    assert any("chips" in b for b in bad)
    assert any("setup_s" in b for b in bad)


def test_committed_benchmark_json_is_what_the_parts_make():
    assert catalog.validate() == []
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        assert json.load(f) == catalog.benchmark_json()
