"""Checkpoints and the text log (counterpart of fldrx/train/checkpoint.py):
SaveManager writes each checkpoint before save() returns; AsyncSaveManager,
the counterpart of fldrx's OrbaxSaveManager, writes it on a background
thread while training goes on.

Files: <model_dir>_latest.npz under checkpoint_dir/<model_dir>, copied to
_best_PSNR.npz when the validation PSNR improves and to _epc<N>.npz every
10 epochs; the text log <model_dir>.txt under text_dir. Each file is
written under a temporary name and renamed into place, so a reader never
sees half a file.

Layout of an .npz: the parameters under `params/<flat name>` in fldrx's
names and layouts (conv weights HWIO), so fldrx's SaveManager.load reads
them; the optimiser state under the port's own keys
`opt/<flat name>/{exp_avg,exp_avg_sq,step}`; `meta/step` and the other
`meta/<key>` scalars.
"""

from __future__ import annotations

import dataclasses
import io
import os
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..config import FLDRConfig
from ..weights import (flatten_params, named_leaves, params_to_numpy,
                       unflatten_params)


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

    def save(self, params, meta: Dict[str, Any], opt_state=None,
             best: bool = False, epoch: Optional[int] = None, step=None):
        """Write the parameters (the port's tree of tensors), the optimiser
        state (TrainState.optimizer_tensors() or optimizer_state()), the
        step and `meta`."""
        self._write(snapshot(params, meta, opt_state, step), best, epoch)

    def _write(self, blob: Dict[str, np.ndarray], best: bool,
               epoch: Optional[int]) -> None:
        # the npz is made in memory and written whole: np.savez into a file
        # writes each of the ~180 arrays on its own, about twice as slow
        # at the training recipe (chip_smoke.py phase 9b times both)
        buf = io.BytesIO()
        np.savez(buf, **blob)
        tags = ["latest"]
        if best:
            tags.append("best_PSNR")
        if epoch is not None and (epoch + 1) % 10 == 0:
            tags.append(f"epc{epoch}")
        for tag in tags:
            _write_whole(self._path(tag), buf.getbuffer())

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


def _numpy(v) -> np.ndarray:
    """A copy in host memory (synchronous from a card)."""
    if torch.is_tensor(v):
        return v.detach().cpu().numpy().copy()
    return np.array(v)


def snapshot(params, meta: Dict[str, Any], opt_state=None,
             step=None) -> Dict[str, np.ndarray]:
    """The checkpoint's arrays by key, copied to host memory: the
    parameters in fldrx's names and layouts, the optimiser state (tensors
    or arrays), the step and `meta`."""
    blob = {f"params/{k}": v
            for k, v in flatten_params(params_to_numpy(params)).items()}
    for name, st in (opt_state or {}).items():
        for k, v in st.items():
            blob[f"opt/{name}/{k}"] = _numpy(v)
    if step is not None:
        blob["meta/step"] = np.array(step)
    for k, v in meta.items():
        blob[f"meta/{k}"] = np.array(v)
    return blob


def _write_whole(path: str, data) -> None:
    """data into a temporary file beside `path`, then renamed over `path`
    (atomic)."""
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _stage(tensors: Dict):
    """Copies of {key: tensor or array} in host memory, and the CUDA event
    after which they hold their values (None if none is on a card). A card
    tensor is copied with non_blocking into pinned memory: the copies are
    queued on the current stream ahead of whatever the caller queues next,
    so the next step's in-place update cannot overtake them, and save()
    does not wait for them."""
    out, on_card = {}, False
    for key, t in tensors.items():
        if not torch.is_tensor(t):
            out[key] = np.array(t)
        elif t.is_cuda:
            out[key] = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            out[key].copy_(t.detach(), non_blocking=True)
            on_card = True
        else:
            out[key] = t.detach().clone()
    ready = None
    if on_card:
        ready = torch.cuda.Event()
        ready.record()
    return out, ready


class AsyncSaveManager(SaveManager):
    """SaveManager whose save() returns once the checkpoint's copies are
    queued (`_stage`: pinned host buffers filled by non_blocking copies
    from a card, clones on the CPU) and writes the files on one background
    thread, which waits for the copies, while training goes on: the
    counterpart of fldrx's OrbaxSaveManager, in the same files and format
    as SaveManager. (chip_smoke.py phase 9b times save() against a
    synchronous copy, `snapshot`, at the training recipe.)

    load(), exists() and close() first wait for the writes in flight. A
    write's exception is raised again by the next call of save(), load(),
    exists() or close(). Call close() before reading the files by other
    means or leaving the process."""

    def __init__(self, cfg: FLDRConfig):
        super().__init__(cfg)
        self._pool = ThreadPoolExecutor(max_workers=1,
                                        thread_name_prefix="checkpoint")
        self._pending: List[Future] = []

    def _settle(self, wait: bool) -> None:
        """Drop finished writes, raising the first failure; with `wait`,
        wait for every write first."""
        pending, self._pending = self._pending, []
        for i, fut in enumerate(pending):
            if wait or fut.done():
                try:
                    fut.result()
                except BaseException:
                    self._pending = pending[i + 1:]   # raised at later calls
                    raise
            else:
                self._pending.append(fut)

    def save(self, params, meta: Dict[str, Any], opt_state=None,
             best: bool = False, epoch: Optional[int] = None, step=None):
        """Queue the copies now, write later (see the class)."""
        self._settle(wait=False)
        names = [name for name, _ in named_leaves(params)]
        opt = [(n, k) for n, st in (opt_state or {}).items() for k in st]
        staged, ready = _stage(
            {**{("p", n): t for n, t in named_leaves(params)},
             **{("o", n, k): opt_state[n][k] for n, k in opt}})
        meta = {k: np.array(v) for k, v in meta.items()}

        def write():
            if ready is not None:
                ready.synchronize()
            host_params = unflatten_params({n: staged["p", n] for n in names})
            host_opt = {}
            for n, k in opt:
                host_opt.setdefault(n, {})[k] = staged["o", n, k]
            self._write(snapshot(host_params, meta, host_opt, step), best,
                        epoch)

        self._pending.append(self._pool.submit(write))

    def load(self, take_best: bool = False, specific_epoch: int = -1):
        self._settle(wait=True)
        return super().load(take_best, specific_epoch)

    def exists(self, take_best: bool = False) -> bool:
        self._settle(wait=True)
        return super().exists(take_best)

    def close(self) -> None:
        """Wait for every write (raising the first that failed) and end
        the writer thread."""
        try:
            self._settle(wait=True)
        finally:
            self._pool.shutdown()
