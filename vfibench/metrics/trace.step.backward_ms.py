"""Device ms a training step in its `backward` span: `loss.backward()`. The
program's own span (fldrx_torch/utils/trace.py), the median over the traced
run's steps."""

UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "train step: train/trainer.py make_train_step"
MOVES = "samples_per_s"
WORKLOADS = ["train_b8_512"]


def read(rec):
    from vfibench.metrics._spans import per_request

    return per_request(rec, "train", "train_step", ["train_step/backward"])
