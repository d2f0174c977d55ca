"""The port's hand-written kernel launches a teacher call (the ops modules'
LAUNCHES, counted by the recorder inside the `teacher` span: 10
correlation and 8 gather), the median over the traced run's calls."""

UNIT = "launches"
BETTER = "lower"
SOURCE = "program_counter"
LAYER = "teacher: model/pwcnet.py with ops/ and csrc/"
MOVES = "samples_per_s"
WORKLOADS = ["teacher_b8_512"]


def read(rec):
    from vfibench.metrics._spans import per_request

    return per_request(rec, "teacher", "teacher", ["teacher"], "launches")
