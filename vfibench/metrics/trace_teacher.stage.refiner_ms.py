"""Device ms a teacher call in its two `refiner` spans (one a direction):
the program's own spans (fldrx_torch/model/pwcnet.py, recorded by
fldrx_torch/utils/trace.py), the median over the traced run's calls."""

UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "teacher: model/pwcnet.py with ops/ and csrc/"
MOVES = "samples_per_s"
WORKLOADS = ["teacher_b8_512"]


def read(rec):
    from vfibench.metrics._spans import per_request

    return per_request(rec, "teacher", "teacher", ["teacher/refiner"])
