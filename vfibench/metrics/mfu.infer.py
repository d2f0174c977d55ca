"""The whole pair's share of the card's peak: the model flops of a pair
(flow once, synthesis for each t), each at the peak of its precision
(bfloat16 tensor cores for the refine UNet, float32 outside the tensor
cores for the rest), over the pair's wall time in the traced run's window
(the window's time over its pairs)."""

UNIT = "%"
BETTER = "higher"
SOURCE = "host_clock"
LAYER = "whole pass"
MOVES = "frames_per_s"
WORKLOADS = ["x8_4k", "x2_4k", "x2_2k"]


def read(rec):
    if rec["kind"] != "infer" or not rec["work"]:
        return None
    ms = rec["layers"].get("pair_wall_ms")
    return 100.0 * rec["work"]["compute_ms_per_request"] / ms if ms else None
