"""The port's bench, `python -m fldrx_torch.bench`: without a GPU it exits
nonzero and prints no result; its configuration, frames, protocol and
timed run are bench.py's."""

import dataclasses
import os
import subprocess
import sys
from unittest import mock

import numpy as np
import pytest
import torch

from fldrx import config as jcfg
from fldrx_torch import bench
from fldrx_torch.bench_inputs import bench_frames, deploy_config

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_bench_exits_nonzero_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the bench would run")
    out = subprocess.run([sys.executable, "-m", "fldrx_torch.bench"],
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=REPO), cwd=REPO)
    assert out.returncode == 3
    assert out.stdout == "" and "no CUDA device" in out.stderr
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.run()


def test_bench_config_is_bench_py():
    """bench.py's configuration with its defaults (bench.py:86-108): the
    deploy mix, planes_out and t chunks of 4; 2160×4096, ×8, 3 pairs."""
    ref = jcfg.papermodel_test5().replace(
        compute_dtype="bfloat16", t_chunk=4, flow_dtype="float32",
        unet_dtype="", planes_out=True)
    got = deploy_config()
    ref_d, got_d = dataclasses.asdict(ref), dataclasses.asdict(got)
    assert set(got_d) <= set(ref_d)
    assert {k: ref_d[k] for k in got_d} == got_d
    assert (bench.H, bench.W, bench.MULTIPLE, bench.ITERS) == (2160, 4096,
                                                               8, 3)
    np.testing.assert_array_equal(
        bench.t_values(), np.linspace(1 / 8, 1 - 1 / 8, 7))


def test_bench_frames_are_bench_py():
    """bench.py's content (bench.py:114-138): texture, pan, the uint8
    cast; held at a crop of the 4K frame's grid."""
    H, W = 96, 160
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)

    def tex(px, py):
        return (np.sin((xx + px) / 17) * np.cos((yy + py) / 23)
                + 0.5 * np.sin((xx + py) / 5.3) * np.sin((yy + px) / 7.1)
                + 0.3 * np.sin((xx - px) / 61) * np.cos((yy + py) / 47))

    f0 = np.stack([tex(0, 0), tex(9, 4), tex(3, 11)], -1)
    f1 = np.stack([tex(22, 13), tex(31, 17), tex(25, 24)], -1)
    frames = np.stack([f0, f1], 0)[None].astype(np.float32) * 0.6
    ref = np.clip(np.round((frames + 1.0) * 127.5), 0, 255).astype(np.uint8)
    np.testing.assert_array_equal(bench_frames(H, W), ref)


def test_timed_pairs_protocol():
    """One warm-up pair, the hook, then `iters` timed pairs: each a flow
    run and ceil(7 / t_chunk) synthesis chunks."""
    calls = []

    class Fake:
        cfg = deploy_config()

        def precompute_flow(self, frames):
            calls.append("flow")
            return None, None, None

        def synthesize_multi_at(self, flow, padded, ts, hw, extras):
            calls.append(len(ts))
            return torch.zeros(1)

    with mock.patch.object(torch.cuda, "synchronize", lambda: None):
        res = bench.timed_pairs(Fake(), np.zeros((1, 2, 8, 8, 3)),
                                bench.t_values(), iters=3,
                                before_timed=lambda: calls.append("|"))
    pair = ["flow", 4, 3]
    assert calls == pair + ["|"] + pair * 3
    assert res["fps"] > 0 and set(res) == {"fps", "s_per_pair", "warmup_s",
                                           "out"}
