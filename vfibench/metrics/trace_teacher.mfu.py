"""The teacher call's share of the card's peak: its float32 flops
(vfibench/work_teacher.py: the convs, deconvs, cost volumes, warps and
resizes of both directions, as the reference's get_flow makes them) at the
float32 peak outside the tensor cores (TF32 is off), over the call's wall
time in the traced run's window."""

UNIT = "%"
BETTER = "higher"
SOURCE = "host_clock"
LAYER = "whole pass"
MOVES = "samples_per_s"
WORKLOADS = ["teacher_b8_512"]


def read(rec):
    if rec["kind"] != "teacher" or not rec["work"]:
        return None
    ms = rec["layers"].get("call_wall_ms")
    return 100.0 * rec["work"]["compute_ms_per_request"] / ms if ms else None
