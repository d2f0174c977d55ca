"""The harness's tests: CPU cases at small sizes, and cases marked `cuda`
that decide inside the test whether a card is present.

    python -m pytest vfibench/tests -q
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips without one")


import json  # noqa: E402
import shutil  # noqa: E402

import pytest  # noqa: E402

# a few pairs of 200×300 (padded to 256×512) at ×4, and training steps on
# batches of 2 at 128×128: the cells' paths at a size a CPU test holds
TINY_PAIRS = {"driver": "pairs", "why": "a test's pairs", "height": 200,
              "width": 300, "multiple": 4, "clip_frames": 3,
              "motion_px": [2, 6], "warmup_pairs": 1, "check_pairs": 2,
              "trace_pairs": 1}
TINY_TRAIN = {"driver": "train_steps", "why": "a test's steps", "pool": 3,
              "phase_px": 60, "pan_px": 24, "t_range": [0.03125, 0.96875],
              "checked_steps": 3, "trace_steps": 1}


def make_tiny(dest: str) -> str:
    """A copy of vfibench/ under dest with the cells tiny_pairs (x8_4k's
    configuration and limits) and tiny_train (train_b8_512's, at batch 2
    of 128×128); returns the copy's vfibench directory."""
    here = os.path.join(dest, "vfibench")
    shutil.copytree(os.path.join(ROOT, "vfibench"), here,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    os.symlink(os.path.join(ROOT, "checkpoints"),
               os.path.join(dest, "checkpoints"))

    def put(kind, name, obj):
        with open(os.path.join(here, kind, name + ".json"), "w") as f:
            json.dump(obj, f)

    def get(kind, name):
        with open(os.path.join(here, kind, name + ".json")) as f:
            return json.load(f)

    put("traffic", "tiny_pairs", TINY_PAIRS)
    put("traffic", "tiny_train", TINY_TRAIN)
    from vfibench import catalog

    def reports(cell):
        """What the benchmark's cell reports, as a cell's file lists it."""
        rep = catalog.reported(here)[cell]
        return {key: rep[k] for k, key in catalog.CELL_KEY.items()}

    put("cells", "tiny_pairs", dict(get("cells", "x8_4k"),
                                    traffic="tiny_pairs", **reports("x8_4k")))
    cfg = get("configs", "papermodel_train")
    cfg["fldr_config"].update(batch_size=2, patch_size=128)
    put("configs", "tiny_train", cfg)
    put("cells", "tiny_train", dict(get("cells", "train_b8_512"),
                                    traffic="tiny_train", config="tiny_train",
                                    **reports("train_b8_512")))
    return here


@pytest.fixture(scope="session")
def tiny_here(tmp_path_factory):
    import torch

    torch.set_num_threads(2)
    return make_tiny(str(tmp_path_factory.mktemp("vfibench_tiny")))
