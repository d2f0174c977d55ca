"""Device ms a pair spends in `Interpolator.precompute_flow` (the pair's
host-to-device copy, the pyramid, the block-PCA features, the flow levels
and the t-independent extras): CUDA events around the call, the mean over
the window's pairs."""

UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "pipeline: eval/pipeline.py Interpolator"
MOVES = "frames_per_s"
WORKLOADS = ["x8_4k", "x2_4k"]


def read(rec):
    if rec["kind"] != "infer":
        return None
    return rec["layers"].get("flow_ms")
