"""Device ms a teacher call in its decoders' own work: the two
`decoders` spans (one a direction) less their `corr` and `warp`
spans, so the dense stacks' convs and concatenations, the flow convs and
the deconvs. The program's own spans (fldrx_torch/model/pwcnet.py), the
median over the traced run's calls."""

UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "teacher: model/pwcnet.py with ops/ and csrc/"
MOVES = "samples_per_s"
WORKLOADS = ["teacher_b8_512"]


def read(rec):
    from vfibench.metrics._spans import per_request

    return per_request(rec, "teacher", "teacher", ["teacher/decoders"],
                       "self_device_ms")
