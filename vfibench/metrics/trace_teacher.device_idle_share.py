"""The share of the traced window in which no operation ran on the card:
1 − the union of the device operations' intervals (torch.profiler) over
the window, for the PWC-Net teacher's calls."""

UNIT = "%"
BETTER = "lower"
SOURCE = "device_trace"
LAYER = "device: the H100"
MOVES = "samples_per_s"
WORKLOADS = ["teacher_b8_512"]


def read(rec):
    tr = rec["trace"]
    if rec["kind"] != "teacher" or not tr:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
