"""Device ms a pair in the flow's `extras` span: the t-independent extras:
the full-resolution flows and the importance maps (`flow_extras`). The
program's own span (fldrx_torch/utils/trace.py), the median over the traced
run's pairs."""

UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "pipeline: eval/pipeline.py Interpolator"
MOVES = "frames_per_s"
WORKLOADS = ["x8_4k", "x2_4k"]


def read(rec):
    from vfibench.metrics._spans import per_request

    return per_request(rec, "infer", "flow", ["flow/extras"])
