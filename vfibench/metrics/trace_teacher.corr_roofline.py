"""The correlation kernel's share of its roofline: the floor of a call's
ten cost volumes (vfibench/work_teacher.py: max(bytes / HBM bandwidth,
flops / the float32 peak), both features read and the volume written
once) over the correlation kernels' own device time a call, read from a
device-only profile of two calls made after the traced windows
(drivers/teacher_calls.py `corr_kernel_ms`, from `release()`)."""

UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
LAYER = "teacher: model/pwcnet.py with ops/ and csrc/"
MOVES = "samples_per_s"
WORKLOADS = ["teacher_b8_512"]


def read(rec):
    if rec["kind"] != "teacher" or not rec["work"]:
        return None
    ms = rec["layers"].get("corr_kernel_ms")
    return 100.0 * rec["work"]["corr_floor_ms"] / ms if ms else None
