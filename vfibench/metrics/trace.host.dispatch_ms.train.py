"""Host ms a training step inside the program's `train_step` span
(fldrx_torch/utils/trace.py), the median over the traced run's steps."""

UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "host: the port's Python and launch path"
MOVES = "samples_per_s"
WORKLOADS = ["train_b8_512"]


def read(rec):
    from vfibench.metrics._spans import per_request

    return per_request(rec, "train", "train_step", ["train_step"], "host_ms")
