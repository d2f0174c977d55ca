"""Host ms a pair inside the program's top spans, `flow` and the `synth`
chunks: the Python and launch path the card waits on where the host sets the
pace (fldrx_torch/utils/trace.py), the median over the traced run's
pairs."""

UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "host: the port's Python and launch path"
MOVES = "frames_per_s"
WORKLOADS = ["x8_4k", "x2_4k", "x2_2k"]


def read(rec):
    from vfibench.metrics._spans import per_request

    return per_request(rec, "infer", "flow", ["flow", "synth"], "host_ms")
