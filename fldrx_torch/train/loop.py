"""The training loop (counterpart of fldrx/train/loop.py): the PCA fit on
the first training batch, epochs of train steps, a checkpoint and log lines
per epoch, resume with optimiser state and step, and the T-optimisation
stage with a fresh optimiser.

Not ported yet, and refused rather than skipped: per-epoch validation
(it needs the evaluator; pass `no_validation=True`), `cfg.save_images`
(it needs the visualiser), the Orbax checkpoints, datasets other than
X-Train, and multi-device training.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional

import numpy as np
import torch

from ..api import resolve_device
from ..config import FLDRConfig
from ..data.datasets import XTrain
from ..data.loader import train_batches
from ..model.fldrnet import init_params
from ..ops.block_pca import fit_block_pca
from ..ops.resize import resize_2d
from ..utils.tbevents import EventWriter
from ..weights import named_leaves, params_from_numpy
from .checkpoint import SaveManager
from .trainer import TrainState, make_train_step


class Meter:
    """Running average."""

    def __init__(self):
        self.sum = 0.0
        self.count = 0

    def update(self, v: float):
        self.sum += v
        self.count += 1

    @property
    def avg(self) -> float:
        return self.sum / self.count if self.count else 0.0


def fit_pca_from_batch(frames: np.ndarray, cfg: FLDRConfig, device="cpu"):
    """The block-PCA fit on the first training batch's frames [B,2,H,W,C]
    (every channel of every frame one image). Returns {"pca": ...}, and
    with exac_one_ev false also per-scale fits {"pca_multi": {"s8", ...}}
    on bicubic-downscaled images (a scale too small for one block reuses
    the scale-8 fit). float32 tensors on `device`."""
    frames = np.asarray(frames, np.float32)
    imgs = np.transpose(frames, (0, 1, 4, 2, 3)).reshape(
        -1, *frames.shape[2:4])

    def fit(images):
        st = fit_block_pca(images, cfg.dctvfi_nf, cfg.wiS)
        return {k: torch.tensor(v, dtype=torch.float32, device=device)
                for k, v in (("mean", st.mean), ("ev", st.eigenvectors),
                             ("mean_vec", st.mean_vec))}

    pca8 = fit(imgs)
    if cfg.exac_one_ev:
        return {"pca": pca8}
    multi = {"s8": pca8}
    for s in cfg.scales[1:4]:
        f = cfg.scales[0] / s
        oh, ow = int(imgs.shape[1] * f), int(imgs.shape[2] * f)
        if oh < cfg.wiS or ow < cfg.wiS:
            multi[f"s{s}"] = pca8
            continue
        ds = resize_2d(torch.as_tensor(imgs[..., None]), (oh, ow),
                       "bicubic").numpy()[..., 0]
        multi[f"s{s}"] = fit(ds)
    return {"pca": pca8, "pca_multi": multi}


def assign_params(params, subtree) -> None:
    """Copy `subtree`'s values into the matching leaves of `params` in
    place, so an optimiser that holds those leaves keeps them."""
    new = dict(named_leaves(subtree))
    with torch.no_grad():
        for name, p in named_leaves(params):
            if name in new:
                p.copy_(new.pop(name))
    if new:
        raise KeyError(f"no such parameters: {sorted(new)}")


def _refuse_unported(cfg: FLDRConfig, no_validation: bool) -> None:
    if not no_validation:
        raise NotImplementedError(
            "validation needs the evaluator, which is not ported yet; pass "
            "no_validation=True")
    if cfg.save_images:
        raise NotImplementedError("save_images needs the visualiser, which "
                                  "is not ported yet")
    if cfg.use_orbax:
        raise NotImplementedError("Orbax checkpoints are not ported")
    if cfg.dataset != "X4K1000FPS":
        raise NotImplementedError(f"dataset {cfg.dataset!r} is not ported; "
                                  "only X-Train (X4K1000FPS) is")


def train(cfg: FLDRConfig, max_steps_per_epoch: Optional[int] = None,
          continue_training: bool = False, seed: int = 0,
          no_validation: bool = False, verbose: bool = True, device=None):
    """Full training run on `device` (default cuda). Returns (params,
    best_psnr). Without validation each epoch records test PSNR 1.0, so
    the first epoch's checkpoint is the best one."""
    _refuse_unported(cfg, no_validation)
    dev = resolve_device(device)
    SM = SaveManager(cfg)
    SM.write_config()
    dataset = XTrain(cfg)
    if len(dataset) < cfg.batch_size:
        raise ValueError(
            f"dataset has {len(dataset)} clips < batch_size {cfg.batch_size} "
            f"(drop_last would yield zero batches)")
    steps_per_epoch = max(1, len(dataset) // cfg.batch_size)
    if max_steps_per_epoch:
        steps_per_epoch = min(steps_per_epoch, max_steps_per_epoch)

    start_epoch, best_psnr, pca_fitted = 0, 0.0, False
    opt_state, saved_step = None, None
    if continue_training and SM.exists(take_best=cfg.t_optimization):
        tree, meta, opt_state = SM.load(take_best=cfg.t_optimization)
        params = params_from_numpy(tree, dev)
        start_epoch = int(meta.get("last_epoch", -1)) + 1
        best_psnr = float(meta.get("best_PSNR", 0.0))
        saved_step = meta.get("step")
        pca_fitted = True
    else:
        params = init_params(torch.Generator().manual_seed(seed), cfg, dev)

    state = TrainState.create(params, cfg, steps_per_epoch)
    # the T-optimisation stage starts a fresh optimiser (new rate, frozen
    # groups), so neither the moments nor the step carry over into it
    if not cfg.t_optimization:
        state.load_optimizer_state(
            opt_state, None if saved_step is None else int(saved_step))
    step_fn = make_train_step(cfg)

    scalar_log = os.path.join(cfg.text_dir, f"{cfg.model_dir}_scalars.jsonl")
    tb = EventWriter(os.path.join(cfg.log_dir, f"exp_{cfg.exp_num}"))
    if verbose:
        n = sum(p.numel() for _, p in named_leaves(params))
        print(f"Total Parameters: {n}")
        print(f"[*] Training starts: {steps_per_epoch} steps/epoch, "
              f"epochs {start_epoch}..{cfg.epochs - 1}")
        SM.write_info("Epoch\ttrainLoss\tWarpLoss\tValLoss\ttestPSNR\tbest_PSNR")

    for epoch in range(start_epoch, cfg.epochs):
        losses, warp_loss, batch_psnr = Meter(), Meter(), Meter()
        t_epoch = time.time()
        for i, batch in enumerate(train_batches(dataset, cfg.batch_size,
                                                seed, epoch)):
            if i >= steps_per_epoch:
                break
            if not pca_fitted:
                assign_params(state.params,
                              fit_pca_from_batch(batch["frames"], cfg, dev))
                pca_fitted = True
            batch["epoch"] = np.float32(epoch)
            m = step_fn(state, batch)
            losses.update(float(m["loss"]))
            warp_loss.update(float(m["warp"]))
            batch_psnr.update(float(m["psnr"]))
            if verbose and i % cfg.freq_display == 0:
                print(f"Epoch [{epoch}][{i}/{steps_per_epoch}] "
                      f"loss {losses.avg:.4e} warp {warp_loss.avg:.4e} "
                      f"PSNR {batch_psnr.avg:.2f}")
        if verbose:
            print(f"Time needed for epoch (min): "
                  f"{(time.time() - t_epoch) / 60:.2f}")

        test_psnr, test_loss = 1.0, 1.0
        best = test_psnr > best_psnr
        best_psnr = max(best_psnr, test_psnr)
        SM.save(state.params, {
            "last_epoch": epoch, "batch_size": cfg.batch_size,
            "trainLoss": losses.avg, "testLoss": test_loss,
            "testPSNR": test_psnr, "best_PSNR": best_psnr,
        }, opt_state=state.optimizer_state(), step=state.step, best=best,
            epoch=epoch)
        SM.write_info(f"{epoch}\t\t{losses.avg:.4}\t\t{warp_loss.avg:.4}\t\t"
                      f"{test_loss:.4}\t\t{test_psnr:.4}\t\t{best_psnr:.4}")
        with open(scalar_log, "a") as f:
            f.write(json.dumps({
                "epoch": epoch, "step": state.step,
                "train_loss": losses.avg, "warp_loss": warp_loss.avg,
                "train_psnr": batch_psnr.avg, "val_loss": test_loss,
                "val_psnr": test_psnr, "best_psnr": best_psnr,
            }) + "\n")
        tb.add_scalars({
            "Loss/train": losses.avg, "Loss/warp": warp_loss.avg,
            "PSNR/train": batch_psnr.avg, "Loss/val": test_loss,
            "PSNR/val": test_psnr, "PSNR/best": best_psnr,
        }, step=state.step)
        tb.flush()

    tb.close()
    return state.params, best_psnr


def train_it(cfg: FLDRConfig, toptim: bool = True, **kw):
    """Two stages: the papermodel run, then optionally T-optimisation: 220
    epochs from the best checkpoint at lr 1e-3 with the MSE loss."""
    params, best = train(cfg, **kw)
    if toptim:
        tcfg = cfg.replace(t_optimization=True, init_lr=1e-3, epochs=220)
        params, best = train(tcfg, continue_training=True, **kw)
    return params, best
