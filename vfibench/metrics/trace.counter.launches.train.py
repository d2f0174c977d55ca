"""The port's hand-written kernel launches a training step (the ops modules'
LAUNCHES, counted by the recorder inside the `train_step` span), the median
over the traced run's steps."""

UNIT = "launches"
BETTER = "lower"
SOURCE = "program_counter"
LAYER = "model and kernels: model/fldrnet.py with ops/ and csrc/"
MOVES = "samples_per_s"
WORKLOADS = ["train_b8_512"]


def read(rec):
    from vfibench.metrics._spans import per_request

    return per_request(rec, "train", "train_step", ["train_step"], "launches")
