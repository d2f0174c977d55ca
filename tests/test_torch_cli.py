"""The port's command line, `python -m fldrx_torch`, on the CPU: the eval
sweep and the test_custom phase as subprocesses on a generated X-Test
directory, as tests/test_cli_smoke.py drives main.py, and the
configuration it builds from the reference's flags against main.py's.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _write_xtest_layout(root, H=96, W=128):
    """One 33-frame scene in the X-Test layout from the port's golden-clip
    scene model (smooth analytic motion, so the PSNR means something)."""
    from PIL import Image

    from fldrx_torch.eval.goldenclip import render_golden
    d = os.path.join(root, "Type1", "TEST00")
    os.makedirs(d)
    for i in range(33):
        u8 = np.clip((render_golden(H, W, i / 32.0) + 1) * 127.5, 0, 255)
        Image.fromarray(u8.astype(np.uint8)).save(
            os.path.join(d, f"{i:04d}.png"))


def _run(args, tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "fldrx_torch", "--device", "cpu",
           "--papermodel", "--test3scales", "--testsets", "X4K1000FPS",
           "--x_test_data_path", str(tmp_path / "xtest"),
           "--log_dir", str(tmp_path / "logs"),
           "--text_dir", str(tmp_path / "txt"),
           "--checkpoint_dir", str(tmp_path / "ck"), "--exp_num", "9", *args]
    out = subprocess.run(cmd, capture_output=True, text=True, env=env,
                         cwd=str(tmp_path), timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    return out


@pytest.fixture
def xtest(tmp_path):
    (tmp_path / "xtest").mkdir()
    _write_xtest_layout(str(tmp_path / "xtest"))
    return tmp_path


def test_cli_eval_sweep_end_to_end(xtest):
    out = _run(["--stoptestat", "8", "--save_images", "--testgetflowout"],
               xtest)
    lines = [ln for ln in out.stdout.splitlines()
             if ln.startswith("Final 4k frames PSNR X4K1000FPS")]
    assert lines, out.stdout[-2000:]
    psnr = float(lines[0].split(":")[1].split()[0])
    assert 15.0 < psnr < 100.0, lines[0]
    preds = list((xtest / "logs" / "X4K1000FPS").rglob("*.png"))
    flows = [p for p in preds if "Test_flow_preds" in str(p)]
    assert any(p.name.startswith("flow") for p in flows), preds
    assert any(p.name.startswith("diff") for p in flows), preds
    log = (xtest / "txt" / "fLDRnet_X4K1000FPS_exp9.txt").read_text()
    assert lines[0].split("  (")[0] in log


def test_cli_test_custom_writes_predictions_only(xtest):
    out = _run(["--phase", "test_custom", "--stoptestat", "3"], xtest)
    preds = list((xtest / "logs" / "X4K1000FPS").rglob("*.png"))
    assert len(preds) == 5, out.stdout[-2000:]
    assert not any("Test_flow_preds" in str(p) for p in preds)
    assert "Final 4k frames PSNR X4K1000FPS : 0.0" in out.stdout


@pytest.mark.parametrize("argv", [
    [],
    ["--papermodel", "--test5scales", "--testsets", "X4K1000FPS"],
    ["--papermodel", "--test3scales", "--phase", "test_custom"],
    ["--phase", "train", "--papermodel", "--exp_num", "2", "--epochs", "3",
     "--TOptimization", "--x_train_data_path", "/data/xt"],
    ["--S_trn", "2", "--S_tst", "4", "--compute_dtype", "bfloat16",
     "--multiple", "4", "--validation_patch_size", "256"],
])
def test_build_config_matches_main(argv):
    """The configuration built from the reference's flags equals main.py's,
    field for field."""
    sys.path.insert(0, REPO)
    import main as jmain

    from fldrx_torch import __main__ as tmain
    got = dataclasses.asdict(tmain.build_config(tmain.parse_args(argv)))
    ref = dataclasses.asdict(jmain.build_config(jmain.parse_args(argv)))
    assert got == ref


def test_cli_refusals_and_metrics_evaluation(tmp_path, capsys):
    """--mesh sp refuses a halo that is not a multiple of 32 before any
    data is read; metrics_evaluation loads the model and runs no loop, as
    the reference."""
    from fldrx_torch import __main__ as tmain
    with pytest.raises(ValueError, match="multiple of 32"):
        tmain.main(["--mesh", "sp", "--mesh_halo", "48", "--device", "cpu",
                    "--mesh_devices", "2", "--papermodel", "--test3scales",
                    "--text_dir", str(tmp_path / "txt"),
                    "--checkpoint_dir", str(tmp_path / "ck")])
    tmain.main(["--device", "cpu", "--papermodel", "--test3scales",
                "--phase", "metrics_evaluation",
                "--text_dir", str(tmp_path / "txt"),
                "--checkpoint_dir", str(tmp_path / "ck")])
    assert "metrics_evaluation: model loaded" in capsys.readouterr().out
