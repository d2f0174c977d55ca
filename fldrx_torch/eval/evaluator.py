"""The benchmark evaluation loop (counterpart of fldrx/eval/evaluator.py;
the reference's test(), main.py:784-980), around the port's Interpolator.

Kept from fldrx: items grouped by frame pair, the pair's flow computed once
and its t values synthesised in chunks of cfg.t_chunk; PSNR (data_range
255) and SSIM (Y of BGR); the per-t PSNR of Inter4K; the skip list; the
stop/jump knobs; the prediction-time meter; the prediction, flow and
difference dumps.

Metrics are computed either on the card, per synthesis chunk
(ops/metrics_torch.py: only two numbers per frame leave the device), or on
the host from the fetched frames (ops/metrics.py) on a pool of worker
threads while the card synthesises the next pair. The card path is taken
by default, as in fldrx, when nothing else needs the frames on the host:
no dump (`save_dir`) and no validation loss. The card path asks the
synthesis for plain rows (written so by its blend, ops/blend.py); the host
path fetches u-planes where cfg.planes_out and unpacks them on the worker
threads. Test frames travel to the
device as uint8 and are normalised there, except in validation, whose
L1 loss wants the float frames on the host.
"""

from __future__ import annotations

import os
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from ..config import FLDRConfig
from ..data.datasets import (TEST_MULTIPLES, TestDataset, frames_to_tensor,
                             get_test_dataset)
from ..data.loader import test_samples
from ..ops import metrics
from ..ops.metrics_torch import make_chunk_metrics
from ..ops.repack import planes_to_plain_np
from ..ops.resize import resize_2d
from .pipeline import Interpolator
from .visualize import flow_to_image

__all__ = ["Meter", "ProgressMeter", "EvalResult", "evaluate"]


class Meter:
    """Running average (AverageClass, utils.py:587-611)."""

    def __init__(self, name="", fmt=":f"):
        self.name = name
        self.fmt = fmt
        self.sum = 0.0
        self.count = 0.0
        self.val = 0.0

    def update(self, v, n=1.0):
        self.val = v
        self.sum += v * n
        self.count += n

    @property
    def avg(self):
        return self.sum / self.count if self.count else 0.0

    def __str__(self):
        fmtstr = "{name} {val" + self.fmt + "} (avg:{avg" + self.fmt + "})"
        return fmtstr.format(name=self.name, val=self.val, avg=self.avg)


class ProgressMeter:
    """Console progress printer (utils.py:614-632)."""

    def __init__(self, num_batches, *meters, prefix=""):
        num_digits = len(str(num_batches))
        fmt = "{:" + str(num_digits) + "d}"
        self._batch_fmt = "[" + fmt + "/" + fmt.format(num_batches) + "]"
        self.meters = meters
        self.prefix = prefix

    def print(self, batch):
        entries = [self.prefix + self._batch_fmt.format(batch)]
        entries += [str(m) for m in self.meters]
        print("\t".join(entries))


@dataclass
class EvalResult:
    psnr: float
    ssim: float
    pred_time_avg: float
    frames_per_sec: float
    per_t_psnr: List[float] = field(default_factory=list)
    n_samples: int = 0
    skipped: List[int] = field(default_factory=list)
    rec_loss: float = 0.0     # rec_lambda·L1 on the normalised frames
                              # (validation ValLoss, main.py:874-877)


def evaluate(interp: Interpolator, cfg: FLDRConfig, dataset_name: str,
             multiple: Optional[int] = None, validation: bool = False,
             stop_at: int = -1, save_dir: Optional[str] = None,
             verbose: bool = True, half_res: bool = False,
             jump_to: int = -1, compute_metrics: bool = True,
             xvfi_psnr: bool = False, save_flow: bool = False,
             parallel_eval=None, device_metrics: bool = True,
             dataset: Optional[TestDataset] = None) -> EvalResult:
    """Run the ×N protocol over a test set.

    compute_metrics=False is the reference's test_custom phase (main.py:891:
    predictions written, no PSNR/SSIM); xvfi_psnr selects the XVFI RMSE
    formula (--XVFIPSNR, utils.py:644-659); save_flow (with save_dir)
    writes the colour wheel of the ×upscale-bicubic level-0 flow (channels
    0:2, the t→0 direction) and |gray(pred) − gray(gt)| per target under
    <save_dir>/<dataset>/Test_flow_preds/<scene>/ (main.py:929-952,
    utils.py:998-1022). device_metrics=False keeps the metrics on the host
    even where the card path applies. `dataset` replaces the test set that
    dataset_name names on disk (dataset_name still names the outputs).
    parallel_eval, a multi-device callable (frames [1,2,H,W,3], t_values)
    → [T, H, W, 3] from parallel.spatial.build_parallel_eval, replaces the
    single-device ×N synthesis of each pair; the metrics then run where its
    output lies, or on the host."""
    multiple = multiple or TEST_MULTIPLES.get(dataset_name, cfg.multiple)
    ds = dataset if dataset is not None else get_test_dataset(
        cfg, dataset_name, multiple, validation, half_res=half_res)
    patch = (cfg.validation_patch_size if validation and
             dataset_name in ("X4K1000FPS", "X-Test") else cfg.test_patch_size)

    psnrs, ssims, pred_time, rec_losses = Meter(), Meter(), Meter(), Meter()
    per_t = [Meter() for _ in range(multiple - 1)]
    skipped: List[int] = []
    pool = ThreadPoolExecutor(max_workers=4)
    metric_q: List = []

    def metrics_job(frames, t, scene, pred, flow_img=None):
        if pred.shape[-1] != 3:       # cfg.planes_out: the unpack rides
            pred = planes_to_plain_np(pred)   # this worker thread
        target = frames[2]
        if target.dtype == np.uint8:
            target = frames_to_tensor(target[None])[0]
        out_img = np.around(metrics.denorm255(pred))
        p = s = rec = None
        if compute_metrics:
            if validation:
                rec = float(np.mean(np.abs(pred - target)))
            tgt_img = metrics.denorm255(target)
            p = (metrics.psnr_xvfi(tgt_img, out_img) if xvfi_psnr
                 else metrics.psnr(tgt_img, out_img))
            s = metrics.ssim_bgr(tgt_img, out_img)
        if save_dir:
            from PIL import Image
            d = os.path.join(save_dir, dataset_name,
                             scene.replace(os.sep, "_"))
            os.makedirs(d, exist_ok=True)
            Image.fromarray(out_img[..., ::-1].astype(np.uint8)).save(
                os.path.join(d, f"{t:.4f}.png"))
            if save_flow:
                # gray weights applied to BGR as stored, the reference's
                # channel-order quirk (utils.py:1007-1008)
                fd = os.path.join(save_dir, dataset_name, "Test_flow_preds",
                                  scene.replace(os.sep, "_"))
                os.makedirs(fd, exist_ok=True)
                if flow_img is not None:
                    Image.fromarray(flow_img).save(
                        os.path.join(fd, f"flow{t:.4f}.png"))
                if compute_metrics:
                    w = np.array([0.2989, 0.5870, 0.1140], np.float32)
                    diff = np.abs(out_img @ w - tgt_img @ w)
                    diff = np.clip(diff, 0, 255).astype(np.uint8)
                    Image.fromarray(np.repeat(diff[..., None], 3, -1)).save(
                        os.path.join(fd, f"diff{t:.4f}.png"))
        return p, s, rec

    def record(idx, t, p, s, rec):
        if rec is not None:
            rec_losses.update(rec)
        if p is not None:
            psnrs.update(p)
            ssims.update(s)
            if dataset_name.startswith("Inter4K"):
                per_t[int(round(t * multiple)) - 1].update(p)
        if verbose and idx % (multiple - 1) == multiple - 2:
            print(f"[{idx + 1}/{len(ds)}] PSNR {psnrs.avg:.4f}  "
                  f"SSIM {ssims.avg:.4f}  "
                  f"pred {pred_time.avg * 1000:.1f} ms")

    def drain(limit=0):
        while len(metric_q) > limit:
            idx, t, fut = metric_q.pop(0)
            record(idx, t, *fut.result())

    def process_item(idx, frames, t, scene, pred, flow_img=None):
        metric_q.append((idx, t, pool.submit(metrics_job, frames, t, scene,
                                             pred, flow_img)))
        drain(limit=24)               # bound the queued predictions

    tchunk = max(1, cfg.t_chunk)
    devmet = (device_metrics and compute_metrics and not save_dir
              and not validation)
    metfn = make_chunk_metrics(xvfi_psnr) if devmet else None
    pending: List = []          # buffered (idx, frames, t, scene) of one pair
    pending_key = [None]

    def flow_image(flow, padded, H, W):
        """The pair's flow colour wheel: ×upscale bicubic upsample of the
        t→0 channels, cropped to the frame (main.py:934-937)."""
        Hp, Wp = padded.shape[2], padded.shape[3]
        up = Hp // flow.shape[1]
        with torch.inference_mode():
            fl = up * resize_2d(flow[:1, ..., 0:2].float(), (Hp, Wp),
                                "bicubic", cfg.align_corners)
        return flow_to_image(fl[0, :H, :W].cpu().numpy())

    def flush_group():
        if not pending:
            return
        items = list(pending)
        pending.clear()
        inputs = items[0][1][None, :2]                 # [1,2,H,W,C]
        H, W = inputs.shape[2], inputs.shape[3]
        t0 = time.time()
        ts = [it[2] for it in items]
        if parallel_eval is not None:
            flow_img = None
            starts = [0]
            outs = [torch.as_tensor(parallel_eval(inputs, ts))[:, None]]
        else:
            flow, padded, extras = interp.precompute_flow(inputs)
            flow_img = (flow_image(flow, padded, H, W)
                        if save_flow and save_dir else None)
            # scored on the device: plain rows (written by the blend);
            # fetched to the host: cfg.planes_out, unpacked on the workers
            starts = list(range(0, len(ts), tchunk))
            outs = [interp.synthesize_multi_at(
                flow, padded, ts[k:k + tchunk], (H, W), extras,
                planes_out=False if devmet else None) for k in starts]
        if devmet:
            scores = []
            for k, out in zip(starts, outs):
                tgts = torch.as_tensor(np.stack(
                    [it[1][2] for it in items[k:k + len(out)]], 0)).to(
                        out.device)
                ps, ss = metfn(out[:, 0], tgts)
                scores += zip(ps.tolist(), ss.tolist())
            dt = (time.time() - t0) / len(items)
            for (idx, _, t, _), (p, s) in zip(items, scores):
                pred_time.update(dt)
                record(idx, t, p, s, None)
            return
        preds: List[np.ndarray] = []
        for out in outs:
            preds.extend(out[:, 0].float().cpu().numpy())
        dt = (time.time() - t0) / len(items)
        for (idx, frames, t, scene), pred in zip(items, preds):
            pred_time.update(dt)
            process_item(idx, frames, t, scene, pred, flow_img)

    for idx, (frames, t, scene) in enumerate(
            test_samples(ds, patch, raw=not validation)):
        if jump_to > 1 and idx < jump_to:    # --jumptotest (main.py:817-819)
            continue
        if frames is None or frames.ndim < 4:
            skipped.append(idx)
            continue
        pair_key = ds.items[idx].paths[:2]
        if pending and pending_key[0] != pair_key:
            flush_group()
        pending.append((idx, frames, t, scene))
        pending_key[0] = pair_key
        if stop_at != -1 and idx > stop_at:   # --stoptestat (main.py:972-974)
            break
    flush_group()
    drain()
    pool.shutdown()

    if skipped and verbose:
        print("These indices were skipped:", skipped)
    return EvalResult(
        psnr=psnrs.avg, ssim=ssims.avg, pred_time_avg=pred_time.avg,
        frames_per_sec=(1.0 / pred_time.avg if pred_time.avg else 0.0),
        per_t_psnr=[m.avg for m in per_t], n_samples=int(psnrs.count),
        skipped=skipped, rec_loss=cfg.rec_lambda * rec_losses.avg)
