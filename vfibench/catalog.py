"""The benchmark's parts, found by name, checked, and written out as
BENCHMARK.json.

    python -m vfibench.catalog            # check; print BENCHMARK.json
    python -m vfibench.catalog --write    # check; write BENCHMARK.json

Every part is a file of its own under vfibench/, named as its entry:

- configs/<name>.json: {source, why, reduced, assumed, checkpoint,
  fldr_config: the program's FLDRConfig fields, ...};
- traffic/<name>.json: {driver: a module of drivers/, why, parameters};
- cells/<name>.json: {config, traffic, chips, why, rank, limits: {compared
  number: limit}, and optionally end_to_end and per_layer: [metric names]};
- end_to_end/<name>.json: {unit, better, bound, source, workloads: [cells],
  and optionally quantity: the driver's quantity it reports, where cells of
  different noise report one quantity under names and bounds of their own,
  `<quantity>_<suffix>`};
- metrics/<name>.py: UNIT, BETTER, SOURCE, LAYER, MOVES (the quantity whose
  metric it moves), WORKLOADS (cells) and read(record) → the value, or None
  where the record holds nothing to read.

A metric is reported in the cells its own file names and in those whose
file lists it: a later change adds a metric to the cells there, or a cell
that reports the metrics there, as new files, and the harness and this
catalog need no edit.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import re
import sys
from typing import Dict, List

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
PATHS = ["vfibench"]
COMMAND = ["python3", "vfibench/run.py"]
SETTINGS = "settings.json"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")
KINDS = {"configs": ".json", "traffic": ".json", "cells": ".json",
         "end_to_end": ".json", "metrics": ".py"}
# the key under which a cell's file may list metrics of each kind
CELL_KEY = {"end_to_end": "end_to_end", "metrics": "per_layer"}


def names(kind: str, here: str = HERE) -> List[str]:
    ext = KINDS[kind]
    d = os.path.join(here, kind)
    return sorted(f[:-len(ext)] for f in os.listdir(d)
                  if f.endswith(ext) and not f.startswith("_"))


def load_json(kind: str, name: str, here: str = HERE) -> dict:
    with open(os.path.join(here, kind, name + KINDS[kind])) as f:
        return json.load(f)


def load_metric(name: str, here: str = HERE):
    """The reader module metrics/<name>.py (a name may hold dots, so it is
    loaded from its file)."""
    path = os.path.join(here, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "vfibench_metric_" + re.sub(r"\W", "_", name), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def settings(here: str = HERE) -> dict:
    with open(os.path.join(here, SETTINGS)) as f:
        return json.load(f)


def _named(kind: str, name: str, here: str) -> List[str]:
    """The cells that a metric's own file names: `workloads` in an
    end-to-end metric's JSON, WORKLOADS in a per-layer reader."""
    if kind == "end_to_end":
        return list(load_json(kind, name, here).get("workloads", []))
    return list(getattr(load_metric(name, here), "WORKLOADS", []))


def reported(here: str = HERE) -> Dict[str, Dict[str, List[str]]]:
    """{cell: {"end_to_end": [names], "metrics": [reader names]}}: what
    each cell reports. A metric is reported in a cell when its own file
    names the cell or the cell's file lists it (under "end_to_end" or
    "per_layer"), so a new metric for the cells there, or a new cell for
    the metrics there, is a new file alone."""
    out = {}
    for c in names("cells", here):
        cell = load_json("cells", c, here)
        out[c] = {k: list(cell.get(key, [])) for k, key in CELL_KEY.items()}
    for kind in CELL_KEY:
        for m in names(kind, here):
            for c in _named(kind, m, here):
                if c in out and m not in out[c][kind]:
                    out[c][kind].append(m)
    return out


def quantity(name: str, here: str = HERE) -> str:
    """The driver's quantity that end-to-end metric `name` reports: its
    "quantity" where cells of different noise report one quantity under
    names and bounds of their own (`<quantity>_<suffix>`), else its
    name."""
    return load_json("end_to_end", name, here).get("quantity", name)


def moved_in(reader: str, cell_e2e: List[str], here: str = HERE) -> List[str]:
    """The end-to-end metrics of a cell that a reader moves: those that
    report the quantity the reader's MOVES names."""
    q = load_metric(reader, here).MOVES
    return [m for m in cell_e2e if m in names("end_to_end", here)
            and quantity(m, here) == q]


def entry_name(reader: str, moved: str, here: str = HERE) -> str:
    """The per-layer metric's name in BENCHMARK.json: the reader's name
    where it moves the metric named as its quantity, and the reader's name
    with the metric's suffix where it moves `<quantity>_<suffix>`
    (mfu.infer moving frames_per_s_x2_2k is mfu.infer_x2_2k)."""
    return reader + moved[len(quantity(moved, here)):]


def layer_entries(here: str = HERE) -> Dict[str, dict]:
    """{per-layer metric name: {"reader", "moves", "workloads"}}, the cells
    in rank order."""
    rep = reported(here)
    out: Dict[str, dict] = {}
    for c in ranked(here):
        for r in rep[c]["metrics"]:
            moved = moved_in(r, rep[c]["end_to_end"], here)
            if len(moved) != 1:
                continue                    # validate() names the fault
            e = entry_name(r, moved[0], here)
            out.setdefault(e, {"reader": r, "moves": moved[0],
                               "workloads": []})["workloads"].append(c)
    return out


def ranked(here: str = HERE) -> List[str]:
    """The cells, by the rank their files give (then by name)."""
    cells = {c: load_json("cells", c, here) for c in names("cells", here)}
    return sorted(cells, key=lambda c: (cells[c].get("rank", 1e9), c))


def load_cell(name: str, here: str = HERE) -> dict:
    """A cell with its configuration, traffic, end-to-end metric
    definitions and per-layer readers (under the names BENCHMARK.json
    gives them) resolved."""
    cell = load_json("cells", name, here)
    rep = reported(here)[name]
    layers = {e: load_metric(d["reader"], here)
              for e, d in layer_entries(here).items()
              if name in d["workloads"]}
    return dict(cell, name=name, root=os.path.dirname(here),
                config=dict(load_json("configs", cell["config"], here),
                            name=cell["config"]),
                traffic=dict(load_json("traffic", cell["traffic"], here),
                             name=cell["traffic"]),
                e2e={m: dict(load_json("end_to_end", m, here),
                             quantity=quantity(m, here))
                     for m in rep["end_to_end"]},
                layers=layers)


def _line(s) -> bool:
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def validate(here: str = HERE) -> List[str]:
    """What is wrong with the parts under `here` (empty when nothing)."""
    bad: List[str] = []
    all_names = {k: names(k, here) for k in KINDS}
    for kind, ns in all_names.items():
        for n in ns:
            if not NAME.match(n):
                bad.append(f"{kind}/{n}: not a valid name")
    for kind in CELL_KEY:
        for m in all_names[kind]:
            for c in _named(kind, m, here):
                if c not in all_names["cells"]:
                    bad.append(f"{kind}/{m}: names no cell {c}")
    drivers = os.listdir(os.path.join(here, "drivers"))
    rep = reported(here)
    used_configs = set()
    for c in all_names["cells"]:
        cell = load_json("cells", c, here)
        for key, kind in (("config", "configs"), ("traffic", "traffic")):
            if cell.get(key) not in all_names[kind]:
                bad.append(f"cells/{c}: no {kind}/{cell.get(key)}")
        used_configs.add(cell.get("config"))
        if cell.get("chips") not in (1, 4):
            bad.append(f"cells/{c}: chips must be 1 or 4")
        if not _line(cell.get("why")):
            bad.append(f"cells/{c}: why must be one line of 1-200 characters")
        e2e = rep[c]["end_to_end"]
        for m in e2e:
            if m not in all_names["end_to_end"]:
                bad.append(f"cells/{c}: no end_to_end/{m}")
        e2e = [m for m in e2e if m in all_names["end_to_end"]]
        if "setup_s" not in e2e or len(e2e) < 2:
            bad.append(f"cells/{c}: needs setup_s and another end-to-end "
                       "metric")
        qs = [quantity(m, here) for m in e2e]
        if len(set(qs)) != len(qs):
            bad.append(f"cells/{c}: two end-to-end metrics of one quantity")
        layers = rep[c]["metrics"]
        if not layers:
            bad.append(f"cells/{c}: needs a per-layer metric")
        for m in layers:
            if m not in all_names["metrics"]:
                bad.append(f"cells/{c}: no metrics/{m}.py")
            elif not moved_in(m, e2e, here):
                bad.append(f"cells/{c}: {m} moves a quantity the cell lacks")
        if not isinstance(cell.get("limits"), dict) or not cell["limits"]:
            bad.append(f"cells/{c}: needs the limits of its comparison")
        if cell.get("traffic") in all_names["traffic"]:
            drv = load_json("traffic", cell["traffic"], here).get("driver")
            if f"{drv}.py" not in drivers:
                bad.append(f"traffic/{cell['traffic']}: no drivers/{drv}.py")
    for c in all_names["configs"]:
        cfg = load_json("configs", c, here)
        if c not in used_configs:
            bad.append(f"configs/{c}: used by no cell")
        if not _line(cfg.get("source")):
            bad.append(f"configs/{c}: source must be one line of 1-200 "
                       "characters")
        red = cfg.get("reduced")
        if not isinstance(red, list) or len(red) > 16 or \
                not all(NAME.match(r) for r in red):
            bad.append(f"configs/{c}: reduced must list at most 16 names")
    for m in all_names["end_to_end"]:
        d = load_json("end_to_end", m, here)
        if not UNIT.match(str(d.get("unit"))) or \
                d.get("better") not in ("lower", "higher") or \
                d.get("source") not in ("host_clock", "device_trace") or \
                not 0 < float(d.get("bound", 0)) <= 0.25:
            bad.append(f"end_to_end/{m}: unit, better, source or bound "
                       "out of range")
        q = d.get("quantity", m)
        if m != q and not m.startswith(q + "_"):
            bad.append(f"end_to_end/{m}: a metric of quantity {q} is named "
                       f"{q}_<suffix>")
    quantities = {quantity(m, here) for m in all_names["end_to_end"]}
    for m in all_names["metrics"]:
        mod = load_metric(m, here)
        if not UNIT.match(str(getattr(mod, "UNIT", ""))) or \
                getattr(mod, "BETTER", "") not in ("lower", "higher") or \
                getattr(mod, "SOURCE", "") not in SOURCES or \
                not _line(getattr(mod, "LAYER", "")) or \
                getattr(mod, "MOVES", "") not in quantities or \
                not callable(getattr(mod, "read", None)):
            bad.append(f"metrics/{m}: UNIT, BETTER, SOURCE, LAYER, MOVES or "
                       "read() missing or out of range")
    entries = layer_entries(here) if not bad else {}
    for e in entries:
        if not NAME.match(e):
            bad.append(f"{e}: not a valid per-layer metric name")
    dup = set(all_names["end_to_end"]) & set(entries)
    for m in sorted(dup):
        bad.append(f"{m}: both an end-to-end and a per-layer metric")
    return bad


def benchmark_json(here: str = HERE) -> dict:
    """BENCHMARK.json as the parts under `here` make it."""
    cells = {c: load_json("cells", c, here) for c in names("cells", here)}
    ordered = ranked(here)
    rep = reported(here)
    e2e = []
    for m in names("end_to_end", here):
        d = load_json("end_to_end", m, here)
        entry = {"name": m, "unit": d["unit"], "better": d["better"],
                 "bound": d["bound"], "source": d["source"]}
        u = [c for c in ordered if m in rep[c]["end_to_end"]]
        if not u:
            continue
        if len(u) != len(ordered):
            entry["workloads"] = u
        e2e.append(entry)
    layers = []
    for e, d in sorted(layer_entries(here).items()):
        mod = load_metric(d["reader"], here)
        layers.append({"name": e, "unit": mod.UNIT, "better": mod.BETTER,
                       "source": mod.SOURCE, "layer": mod.LAYER,
                       "moves": d["moves"], "workloads": d["workloads"]})
    configs = []
    for c in names("configs", here):
        d = load_json("configs", c, here)
        configs.append({"name": c, "source": d["source"],
                        "file": f"vfibench/configs/{c}.json",
                        "reduced": d["reduced"], "why": d["why"]})
    workloads = [{"name": c, "config": cells[c]["config"],
                  "traffic": cells[c]["traffic"], "chips": cells[c]["chips"],
                  "why": cells[c]["why"]} for c in ordered]
    return {"command": COMMAND, "paths": PATHS,
            "run_seconds": settings(here)["run_seconds"], "configs": configs,
            "workloads": workloads, "end_to_end": e2e, "per_layer": layers}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--write", action="store_true")
    args = ap.parse_args(argv)
    bad = validate()
    if bad:
        print("\n".join(bad), file=sys.stderr)
        return 1
    text = json.dumps(benchmark_json(), indent=2) + "\n"
    if args.write:
        with open(os.path.join(ROOT, "BENCHMARK.json"), "w") as f:
            f.write(text)
    else:
        sys.stdout.write(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
