"""The whole training step's share of the card's peak: 3 × the forward's
model flops, all float32 outside the tensor cores (the recipe keeps TF32
off), over the step's wall time in the traced run's window."""

UNIT = "%"
BETTER = "higher"
SOURCE = "host_clock"
LAYER = "train step: train/trainer.py make_train_step"
MOVES = "samples_per_s"
WORKLOADS = ["train_b8_512"]


def read(rec):
    if rec["kind"] != "train" or not rec["work"]:
        return None
    ms = rec["layers"].get("step_wall_ms")
    return 100.0 * rec["work"]["compute_ms_per_request"] / ms if ms else None
