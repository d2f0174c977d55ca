"""Device ms a t spends in `Interpolator.synthesize_multi_at` (the splats,
gathers, refine UNet, blend and plain-row output of a chunk of t values):
CUDA events around each chunk, summed over the window and divided by the t
values they covered."""

UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "pipeline: eval/pipeline.py Interpolator"
MOVES = "frames_per_s"
WORKLOADS = ["x8_4k", "x2_4k"]


def read(rec):
    if rec["kind"] != "infer":
        return None
    return rec["layers"].get("synth_ms_per_t")
