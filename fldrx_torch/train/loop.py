"""The training loop (counterpart of fldrx/train/loop.py): the PCA fit on
the first training batch, epochs of train steps, per-epoch validation on
the X-Test validation crops at multiple=4 (skipped for the rest of the run
when the validation data is missing), a checkpoint and log lines per epoch,
the training pyramid image dump of `cfg.save_images`, resume with
optimiser state and step, and the T-optimisation stage with a fresh
optimiser. The training set is the one cfg.dataset names (X-Train,
Inter4K or the Vimeo triplets).

With a (dp, sp) mesh, `train` is one rank of a data-parallel and, where
sp > 1, width-sharded run (parallel/distributed.py): every rank reads the
same global batches and steps on its part; rank 0 alone validates, writes
checkpoints and logs.

cfg.use_orbax picks the asynchronous checkpoints (train/checkpoint.py
AsyncSaveManager, the counterpart of fldrx's Orbax manager): each epoch's
checkpoint is copied to host memory and written while the next epoch
trains.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional

import numpy as np
import torch

from ..config import FLDRConfig
from ..data.datasets import get_train_dataset
from ..data.loader import train_batches
from ..device import resolve_device
from ..eval.evaluator import Meter, evaluate
from ..eval.pipeline import Interpolator, build_pyramid
from ..eval.visualize import pyramid_grid, save_image
from ..model.fldrnet import forward_train, init_params
from ..ops.block_pca import fit_block_pca
from ..ops.resize import resize_2d
from ..utils.tbevents import EventWriter
from ..weights import named_leaves, params_from_numpy
from .checkpoint import AsyncSaveManager, SaveManager
from .trainer import TrainState, make_train_step


def fit_pca_from_batch(frames: np.ndarray, cfg: FLDRConfig, device=None):
    """The block-PCA fit on the first training batch's frames [B,2,H,W,C]
    (every channel of every frame one image). Returns {"pca": ...}, and
    with exac_one_ev false also per-scale fits {"pca_multi": {"s8", ...}}
    on bicubic-downscaled images (a scale too small for one block reuses
    the scale-8 fit). float32 tensors on `device` (default cuda)."""
    device = resolve_device(device)
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


def train(cfg: FLDRConfig, mesh=None,
          max_steps_per_epoch: Optional[int] = None,
          continue_training: bool = False, seed: int = 0,
          no_validation: bool = False, verbose: bool = True, device=None):
    """Full training run on `device` (default cuda), or with `mesh` one
    rank's part of a sharded run on its mesh device (the process group
    must exist, one rank per place of the mesh; `device` is then unused). Returns (params,
    best_psnr), best_psnr as rank 0 saw it. Without validation
    (no_validation, or no validation data) each epoch records test PSNR
    1.0, so the first epoch's checkpoint is the best one. With
    cfg.use_orbax the checkpoints are written in the background; unlike
    fldrx, train() waits for the last write before it returns, so the files
    exist when it does."""
    if mesh is not None:
        from ..parallel.distributed import broadcast_params, mesh_place
        i, j = mesh_place(mesh)
        rank, dev = i * mesh.shape["sp"] + j, mesh.devices[i, j]
        if dev.type == "cuda":
            torch.cuda.set_device(dev)      # nccl's collectives use it
        sync = broadcast_params
    else:
        rank, dev, sync = 0, resolve_device(device), None
    lead = rank == 0
    verbose = verbose and lead
    no_validation = no_validation or not lead
    SM = AsyncSaveManager(cfg) if cfg.use_orbax and lead else SaveManager(cfg)
    if lead:
        SM.write_config()
    dataset = get_train_dataset(cfg)
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
    if sync:
        sync(params)

    state = TrainState.create(params, cfg, steps_per_epoch)
    # the T-optimisation stage starts a fresh optimiser (new rate, frozen
    # groups), so neither the moments nor the step carry over into it
    if not cfg.t_optimization:
        state.load_optimizer_state(
            opt_state, None if saved_step is None else int(saved_step))
    step_fn = make_train_step(cfg, mesh)

    scalar_log = os.path.join(cfg.text_dir, f"{cfg.model_dir}_scalars.jsonl")
    tb = (EventWriter(os.path.join(cfg.log_dir, f"exp_{cfg.exp_num}"))
          if lead else None)
    if verbose:
        n = sum(p.numel() for _, p in named_leaves(params))
        print(f"Total Parameters: {n}")
        print(f"[*] Training starts: {steps_per_epoch} steps/epoch, "
              f"epochs {start_epoch}..{cfg.epochs - 1}")
        SM.write_info("Epoch\ttrainLoss\tWarpLoss\tValLoss\ttestPSNR\tbest_PSNR")

    try:
        for epoch in range(start_epoch, cfg.epochs):
            losses, warp_loss, batch_psnr = Meter(), Meter(), Meter()
            t_epoch = time.time()
            for i, batch in enumerate(train_batches(dataset, cfg.batch_size,
                                                    seed, epoch)):
                if i >= steps_per_epoch:
                    break
                if not pca_fitted:
                    assign_params(state.params, fit_pca_from_batch(
                        batch["frames"], cfg, dev))
                    if sync:
                        sync(state.params)
                    pca_fitted = True
                batch["epoch"] = np.float32(epoch)
                m = step_fn(state, batch)
                losses.update(float(m["loss"]))
                warp_loss.update(float(m["warp"]))
                batch_psnr.update(float(m["psnr"]))
                if i % cfg.freq_display == 0:
                    if verbose:
                        print(f"Epoch [{epoch}][{i}/{steps_per_epoch}] "
                              f"loss {losses.avg:.4e} "
                              f"warp {warp_loss.avg:.4e} "
                              f"PSNR {batch_psnr.avg:.2f}")
                    if cfg.save_images and lead:
                        _dump_pyramid(cfg, state.params, batch, epoch, i,
                                      dev)
            if verbose:
                print(f"Time needed for epoch (min): "
                      f"{(time.time() - t_epoch) / 60:.2f}")

            # validation (main.py:743-748): X-Test validation crops at
            # multiple=4
            test_psnr, test_loss = 1.0, 1.0
            if not no_validation:
                val_cfg = cfg.replace(phase="train")    # div_pad uses S_trn
                interp = Interpolator(state.params, val_cfg, dev)
                try:
                    res = evaluate(interp, val_cfg, "X4K1000FPS", multiple=4,
                                   validation=True, verbose=False)
                    test_psnr, test_loss = res.psnr, res.rec_loss
                except FileNotFoundError:
                    if verbose:
                        print("validation data unavailable — skipping "
                              "validation")
                    no_validation = True
            best = test_psnr > best_psnr
            best_psnr = max(best_psnr, test_psnr)
            if not lead:
                continue
            SM.save(state.params, {
                "last_epoch": epoch, "batch_size": cfg.batch_size,
                "trainLoss": losses.avg, "testLoss": test_loss,
                "testPSNR": test_psnr, "best_PSNR": best_psnr,
            }, opt_state=state.optimizer_tensors(), step=state.step,
                best=best, epoch=epoch)
            SM.write_info(f"{epoch}\t\t{losses.avg:.4}\t\t"
                          f"{warp_loss.avg:.4}\t\t{test_loss:.4}\t\t"
                          f"{test_psnr:.4}\t\t{best_psnr:.4}")
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
    finally:
        if tb is not None:
            tb.close()
        if isinstance(SM, AsyncSaveManager):
            SM.close()
    return state.params, best_psnr


def _dump_pyramid(cfg: FLDRConfig, params, batch, epoch: int, it: int,
                  dev: torch.device) -> None:
    """The training pyramid image (main.py:683-690 → get_pyramid_images,
    utils.py:945-995): the prediction and flow pyramids, the target and the
    mean image of the batch's first item, under log_dir/exp_<N>/pyramid."""
    frames = torch.as_tensor(batch["frames"][:1], device=dev)
    t = torch.as_tensor(batch["t"][:1], device=dev)
    with torch.inference_mode():
        out = forward_train(params, cfg, build_pyramid(frames, cfg,
                                                       cfg.S_trn + 1), t)
    grid = pyramid_grid(
        [o.float().cpu().numpy() for o in out["out_pyramid"]],
        [f.float().cpu().numpy() for f in out["unrefined_flow_pyramid"]],
        target=np.asarray(batch["target"][:1]),
        mean_img=out["mean_pics"][:1].cpu().numpy(), n_rows=1)
    d = os.path.join(cfg.log_dir, f"exp_{cfg.exp_num}", "pyramid")
    save_image(os.path.join(d, f"{epoch:03d}_{it:04d}_training.png"), grid)


def train_it(cfg: FLDRConfig, toptim: bool = True, **kw):
    """Two stages: the papermodel run, then optionally T-optimisation: 220
    epochs from the best checkpoint at lr 1e-3 with the MSE loss."""
    params, best = train(cfg, **kw)
    if toptim:
        tcfg = cfg.replace(t_optimization=True, init_lr=1e-3, epochs=220)
        params, best = train(tcfg, continue_training=True, **kw)
    return params, best
