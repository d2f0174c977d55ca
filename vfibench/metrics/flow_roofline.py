"""The flow's floor as a share of `flow_ms`: the floor is the sum over the
flow's stages (ingest, pyramid, features, levels, extras) of max(bytes /
HBM bandwidth, flops / the peak of their precision), counted from the
configuration's geometry by vfibench/work.py, on the card's data-sheet
peaks (vfibench/peaks.py)."""

UNIT = "%"
BETTER = "higher"
SOURCE = "program_span"
LAYER = "model and kernels: model/fldrnet.py with ops/ and csrc/"
MOVES = "frames_per_s"
WORKLOADS = ["x8_4k", "x2_4k"]


def read(rec):
    if rec["kind"] != "infer" or not rec["work"]:
        return None
    ms = rec["layers"].get("flow_ms")
    return 100.0 * rec["work"]["flow_floor_ms"] / ms if ms else None
