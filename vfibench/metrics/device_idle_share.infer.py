"""The share of the traced window in which no operation ran on the card:
1 − the union of the device operations' intervals (torch.profiler) over
the window, for pairs."""

UNIT = "%"
BETTER = "lower"
SOURCE = "device_trace"
LAYER = "device: the H100"
MOVES = "frames_per_s"
WORKLOADS = ["x8_4k", "x2_4k", "x2_2k"]


def read(rec):
    tr = rec["trace"]
    if rec["kind"] != "infer" or not tr:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
