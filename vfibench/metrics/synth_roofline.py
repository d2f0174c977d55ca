"""A t's synthesis floor as a share of `synth_ms_per_t`: the sum over the
synthesis stages (splat, flowback, gather, refine UNet, blend) of
max(bytes / HBM bandwidth, flops / the peak of their precision), from
vfibench/work.py and vfibench/peaks.py."""

UNIT = "%"
BETTER = "higher"
SOURCE = "program_span"
LAYER = "model and kernels: model/fldrnet.py with ops/ and csrc/"
MOVES = "frames_per_s"
WORKLOADS = ["x8_4k", "x2_4k"]


def read(rec):
    if rec["kind"] != "infer" or not rec["work"]:
        return None
    ms = rec["layers"].get("synth_ms_per_t")
    return 100.0 * rec["work"]["synth_floor_ms_per_t"] / ms if ms else None
