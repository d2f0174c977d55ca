"""Checkpoints and the text log (counterpart of fldrx/train/checkpoint.py
SaveManager; the Orbax manager is not ported).

Files: <model_dir>_latest.npz under checkpoint_dir/<model_dir>, copied to
_best_PSNR.npz when the validation PSNR improves and to _epc<N>.npz every
10 epochs; the text log <model_dir>.txt under text_dir.

Layout of an .npz: the parameters under `params/<flat name>` in fldrx's
names and layouts (conv weights HWIO), so fldrx's SaveManager.load reads
them; the optimiser state under the port's own keys
`opt/<flat name>/{exp_avg,exp_avg_sq,step}`; `meta/step` and the other
`meta/<key>` scalars.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
from typing import Any, Dict, Optional

import numpy as np

from ..config import FLDRConfig
from ..weights import flatten_params, params_to_numpy, unflatten_params


class SaveManager:
    def __init__(self, cfg: FLDRConfig):
        self.cfg = cfg
        self.model_dir = cfg.model_dir
        self.ckpt_dir = os.path.join(cfg.checkpoint_dir, self.model_dir)
        os.makedirs(self.ckpt_dir, exist_ok=True)
        os.makedirs(cfg.text_dir, exist_ok=True)
        self.text_path = os.path.join(cfg.text_dir, f"{self.model_dir}.txt")

    def write_info(self, line: str):
        with open(self.text_path, "a") as f:
            f.write(line if line.endswith("\n") else line + "\n")

    def write_config(self):
        with open(self.text_path, "a") as f:
            for k, v in dataclasses.asdict(self.cfg).items():
                f.write(f"# {k} : {v}\n")

    def _path(self, tag: str) -> str:
        return os.path.join(self.ckpt_dir, f"{self.model_dir}_{tag}.npz")

    def save(self, params, meta: Dict[str, Any],
             opt_state: Optional[Dict[str, Dict[str, np.ndarray]]] = None,
             best: bool = False, epoch: Optional[int] = None, step=None):
        """Write the parameters (the port's tree of tensors), the optimiser
        state (TrainState.optimizer_state()), the step and `meta`."""
        blob = {f"params/{k}": v
                for k, v in flatten_params(params_to_numpy(params)).items()}
        for name, st in (opt_state or {}).items():
            for k, v in st.items():
                blob[f"opt/{name}/{k}"] = np.asarray(v)
        if step is not None:
            blob["meta/step"] = np.asarray(step)
        for k, v in meta.items():
            blob[f"meta/{k}"] = np.asarray(v)
        np.savez(self._path("latest"), **blob)
        if best:
            shutil.copyfile(self._path("latest"), self._path("best_PSNR"))
        if epoch is not None and (epoch + 1) % 10 == 0:
            shutil.copyfile(self._path("latest"), self._path(f"epc{epoch}"))

    def load(self, take_best: bool = False, specific_epoch: int = -1):
        """Returns (numpy parameter tree in fldrx's layout — the input of
        weights.params_from_numpy —, meta, optimiser state or None) from the
        best, latest or a given epoch's checkpoint."""
        if specific_epoch >= 0:
            path = self._path(f"epc{specific_epoch}")
        elif take_best:
            path = self._path("best_PSNR")
        else:
            path = self._path("latest")
        flat, meta, opt = {}, {}, {}
        with np.load(path) as z:
            for k in z.files:
                kind, rest = k.split("/", 1)
                if kind == "params":
                    flat[rest] = z[k]
                elif kind == "meta":
                    meta[rest] = z[k]
                elif kind == "opt":
                    name, field = rest.rsplit("/", 1)
                    opt.setdefault(name, {})[field] = z[k]
        return unflatten_params(flat), meta, (opt or None)

    def exists(self, take_best: bool = False) -> bool:
        tag = "best_PSNR" if take_best else "latest"
        return os.path.exists(self._path(tag))
