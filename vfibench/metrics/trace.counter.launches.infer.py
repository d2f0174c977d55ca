"""The port's hand-written kernel launches a pair (the ops modules'
LAUNCHES, counted by the recorder inside the `flow` and `synth` spans), the
median over the traced run's pairs."""

UNIT = "launches"
BETTER = "lower"
SOURCE = "program_counter"
LAYER = "model and kernels: model/fldrnet.py with ops/ and csrc/"
MOVES = "frames_per_s"
WORKLOADS = ["x8_4k", "x2_4k", "x2_2k"]


def read(rec):
    from vfibench.metrics._spans import per_request

    return per_request(rec, "infer", "flow", ["flow", "synth"], "launches")
