"""Device ms a t in the synthesis's `flowback` spans: the flowback flows:
two gathers at the flow grid, upsampled and masked. The program's own spans
(fldrx_torch/utils/trace.py) over the t values of the pair's `synth` spans,
the median over the traced run's pairs."""

UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "model and kernels: model/fldrnet.py with ops/ and csrc/"
MOVES = "frames_per_s"
WORKLOADS = ["x8_4k"]


def read(rec):
    from vfibench.metrics._spans import per_request

    return per_request(rec, "infer", "flow", ["synth/flowback"], per_t=True)
