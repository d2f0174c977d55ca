"""vfibench: the benchmark of fldrx_torch on one NVIDIA GPU.

    python3 vfibench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything a cell needs is found by name: `cells/<cell>.json` names its
configuration (`configs/<name>.json`), its traffic (`traffic/<name>.json`,
read by `drivers/<driver>.py`) and its metrics (`end_to_end/<name>.json`,
`metrics/<name>.py`). `catalog.py` lists and checks them and writes
BENCHMARK.json from them. The yardstick lives here too: the inputs
(`inputs.py`), the work counts and peaks (`work.py`, `peaks.py`), the trace
reader (`devtrace.py`), the plain reference (`reference/`) and the
comparison that decides `correct` (`compare.py`).
"""
