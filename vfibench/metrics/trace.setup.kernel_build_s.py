"""Seconds the process waited on the compilers for the port's kernel
libraries (fldrx_torch/ops/_build.py BUILDS): a checkout's first run builds
them, later runs find them built and read 0. None where the process loaded
no library."""

UNIT = "s"
BETTER = "lower"
SOURCE = "program_counter"
LAYER = "set-up: ops/_build.py"
MOVES = "setup_s"
WORKLOADS = ["x8_4k", "train_b8_512", "x2_4k", "x2_2k"]


def read(rec):
    try:
        from fldrx_torch.ops import _build
    except ImportError:
        return None
    builds = getattr(_build, "BUILDS", None)
    if not builds or not (builds["built"] or builds["cached"]):
        return None
    return float(builds["compile_s"])
