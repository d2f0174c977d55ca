"""The command line of the port (counterpart of the repository's main.py,
the reference's main.py flag set):

    python -m fldrx_torch --papermodel --test5scales            # eval sweep
    python -m fldrx_torch --phase train --papermodel --exp_num 2 ...
    python -m fldrx_torch --papermodel --test3scales --testsets X4K1000FPS \\
        --x_test_data_path <dir> --device cpu

Every phase runs on `--device` (default cuda; without a GPU pass
`--device cpu`). Unknown reference flags are accepted and ignored with a
warning.

Multi-device: `--mesh t|sp` evaluates over the devices `--mesh_devices`
names: a count of `--device` devices (cuda:0 … cuda:n-1, or n CPU shards
with `--device cpu`) or a comma-separated list, where a device may repeat
(`cuda:0,cuda:0`); by default every visible card, or one CPU shard.
`--phase train` under torchrun trains data-parallel, one rank per device
of the same list (default: card rank mod the card count, or the CPU),
over gloo where a card is shared or a rank is on the CPU, else nccl.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="fLDRnet in PyTorch (fldrx_torch)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device every phase runs on (cuda or cpu)")
    p.add_argument("--gpu", type=int, default=0,
                   help="ignored (use --device cuda:<n>)")
    p.add_argument("--net_type", type=str, default="fLDRnet",
                   choices=["fLDRnet"])
    p.add_argument("--exp_num", type=int, default=1)
    p.add_argument("--phase", type=str, default="test",
                   choices=["train", "test", "test_custom",
                            "metrics_evaluation"])
    p.add_argument("--continue_training", action="store_true")
    p.add_argument("--papermodel", action="store_true")
    for n in (3, 4, 5, 6, 7):
        p.add_argument(f"--test{n}scales", action="store_true")
    p.add_argument("--testsets", nargs="+",
                   default=["Inter4K-S", "Inter4K-L", "X4K1000FPS", "Xiph-4K"])
    p.add_argument("--multiple", type=int, default=8)
    p.add_argument("--dataset", default="X4K1000FPS")
    p.add_argument("--S_trn", type=int, default=3)
    p.add_argument("--S_tst", type=int, default=5)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--epochs", type=int, default=200)
    p.add_argument("--init_lr", type=float, default=1e-4)
    p.add_argument("--TOptimization", action="store_true")
    p.add_argument("--toptim", action="store_true",
                   help="run the T-optimisation stage after training")
    p.add_argument("--test_patch_size", type=int, default=-1)
    p.add_argument("--validation_patch_size", type=int, default=512)
    p.add_argument("--stoptestat", type=int, default=-1)
    p.add_argument("--jumptotest", type=int, default=-1)
    p.add_argument("--xiph2k", action="store_true")
    p.add_argument("--xtest2k", action="store_true")
    p.add_argument("--XVFIPSNR", action="store_true",
                   help="XVFI RMSE-based PSNR formula (reference main.py:169)")
    p.add_argument("--save_images", action="store_true")
    p.add_argument("--testgetflowout", action="store_true",
                   help="with --save_images: also write per-target flow "
                        "colour-wheel and gray-difference images")
    p.add_argument("--no_validation", action="store_true")
    p.add_argument("--checkpoint_dir", type=str, default="./checkpoint_dir")
    p.add_argument("--text_dir", type=str, default="./text_dir")
    p.add_argument("--log_dir", type=str, default="./log_dir")
    p.add_argument("--x_train_data_path", type=str, default=None)
    p.add_argument("--x_val_data_path", type=str, default=None)
    p.add_argument("--x_test_data_path", type=str, default=None)
    p.add_argument("--vimeo_data_path", type=str, default=None)
    p.add_argument("--xiph_data_path", type=str, default=None)
    p.add_argument("--inter4k_data_path", type=str, default=None)
    p.add_argument("--ckpt", type=str, default=None,
                   help="converted .npz checkpoint (default: "
                        "checkpoints/fldrnet_best.npz)")
    p.add_argument("--compute_dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--mesh", type=str, default=None, choices=["t", "sp"],
                   help="multi-device eval: 't' splits the interpolation "
                        "times over the devices, 'sp' the frame's width")
    p.add_argument("--mesh_halo", type=int, default=256,
                   help="halo columns for --mesh sp (a multiple of 32; "
                        "motion beyond halo-32 px reruns on the exact path)")
    p.add_argument("--mesh_devices", type=str, default=None,
                   help="the devices of --mesh and of data-parallel "
                        "training: a count or a comma-separated list")
    p.add_argument("--max_steps_per_epoch", type=int, default=None)
    args, unknown = p.parse_known_args(argv)
    if unknown:
        print(f"# ignoring unsupported reference flags: {unknown}",
              file=sys.stderr)
    return args


def build_config(args):
    """The configuration main.py builds from the same flags."""
    from .config import FLDRConfig, apply_test_scales, papermodel

    cfg = papermodel() if args.papermodel else FLDRConfig()
    for n in (7, 6, 5, 4):
        if getattr(args, f"test{n}scales"):
            cfg = apply_test_scales(cfg, n)
            break
    else:
        if args.test3scales:
            cfg = cfg.replace(phase="test")

    over = dict(
        exp_num=args.exp_num, phase=args.phase if args.phase else cfg.phase,
        dataset=args.dataset, batch_size=args.batch_size, epochs=args.epochs,
        init_lr=args.init_lr, t_optimization=args.TOptimization,
        test_patch_size=args.test_patch_size,
        validation_patch_size=args.validation_patch_size,
        checkpoint_dir=args.checkpoint_dir, text_dir=args.text_dir,
        log_dir=args.log_dir, testsets=tuple(args.testsets),
        multiple=args.multiple, compute_dtype=args.compute_dtype,
    )
    for k in ("x_train_data_path", "x_val_data_path", "x_test_data_path",
              "vimeo_data_path", "xiph_data_path", "inter4k_data_path"):
        v = getattr(args, k)
        if v:
            over[k] = v
    if not (args.papermodel or any(getattr(args, f"test{n}scales")
                                   for n in (3, 4, 5, 6, 7))):
        over.update(S_trn=args.S_trn, S_tst=args.S_tst)
    return cfg.replace(**over)


def mesh_devices(spec, device: str, world_size: int = 0):
    """The device list `--mesh_devices` names (see the module docstring);
    with world_size, one device per rank."""
    import torch

    from .parallel.mesh import visible_devices

    if spec is None:
        if torch.device(device).type == "cpu":
            return ["cpu"] * max(world_size, 1)
        cards = visible_devices()
        return ([cards[i % len(cards)] for i in range(world_size)]
                if world_size else cards)
    if spec.isdigit():
        n = int(spec)
        return (["cpu"] * n if torch.device(device).type == "cpu"
                else [f"cuda:{i}" for i in range(n)])
    return [d.strip() for d in spec.split(",") if d.strip()]


def _train(args, cfg):
    import os

    from .train.loop import train, train_it
    kw = dict(continue_training=args.continue_training,
              max_steps_per_epoch=args.max_steps_per_epoch,
              no_validation=args.no_validation, device=args.device)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world > 1:
        from .parallel.distributed import backend_for, init_from_env
        from .parallel.mesh import make_mesh
        devices = mesh_devices(args.mesh_devices, args.device, world)
        if len(devices) != world:
            raise ValueError(f"{len(devices)} devices for {world} ranks")
        init_from_env(backend_for(devices))
        kw["mesh"] = make_mesh(devices, dp=world, sp=1)
    if args.toptim:
        train_it(cfg, toptim=True, **kw)
    else:
        train(cfg, **kw)


def main(argv=None):
    args = parse_args(argv)
    cfg = build_config(args)
    print(f"Exp: {cfg.exp_num}")
    for k, v in dataclasses.asdict(cfg).items():
        print(f"# {k} : {v}")

    if cfg.phase == "train":
        _train(args, cfg)
        return

    # the eval sweep (main.py:353-374)
    from .api import DEFAULT_NPZ, prepare_model
    from .data.datasets import TEST_MULTIPLES
    from .eval.evaluator import evaluate
    from .train.checkpoint import SaveManager

    interp, cfg, _ = prepare_model(args.ckpt or DEFAULT_NPZ, cfg,
                                   device=args.device)
    SM = SaveManager(cfg)
    if cfg.phase == "metrics_evaluation":
        # the reference loads the model and runs no eval loop in this phase
        # (main.py:353)
        print("metrics_evaluation: model loaded; the reference runs no eval "
              "loop in this phase (main.py:353) — nothing to do")
        return

    # test_custom (main.py:891): predictions written, no metrics
    custom = cfg.phase == "test_custom"
    parallel_eval = None
    if args.mesh:
        from .parallel.spatial import build_parallel_eval
        devices = mesh_devices(args.mesh_devices, args.device)
        parallel_eval = build_parallel_eval(interp.params, cfg,
                                            mode=args.mesh, devices=devices,
                                            halo=args.mesh_halo)
        print(f"# multi-device eval: mode={args.mesh} over "
              f"{[str(d) for d in devices]}")
    print("\n------------------- Final Test starts -------------------")
    for name in cfg.testsets:
        mult = TEST_MULTIPLES.get(name, cfg.multiple)
        half = (args.xiph2k and name.startswith("Xiph")) or (
            args.xtest2k and name in ("X4K1000FPS", "X-Test"))
        res = evaluate(interp, cfg, name, multiple=mult,
                       stop_at=args.stoptestat, half_res=half,
                       jump_to=args.jumptotest,
                       compute_metrics=not custom, xvfi_psnr=args.XVFIPSNR,
                       save_dir=cfg.log_dir if (args.save_images or custom)
                       else None, save_flow=args.testgetflowout,
                       parallel_eval=parallel_eval)
        line = f"Final 4k frames PSNR {name} : {res.psnr:.4}"
        print(line + f"  (SSIM {res.ssim:.4f}, {res.frames_per_sec:.2f} fps)")
        SM.write_info(line)
        if name.startswith("Inter4K"):
            print(" ".join(f"{i}: {v:.4f} ||" for i, v in
                           enumerate(res.per_t_psnr)))


if __name__ == "__main__":
    main()
