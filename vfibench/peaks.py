"""The card's peaks, from its name: NVIDIA's data-sheet dense rates
(without sparsity) at the full power limit, and the HBM bandwidth.

float32 is the rate outside the tensor cores (TF32 off), bfloat16 the
dense tensor-core rate. A card set below its full power limit runs slower
under load; the run prints the limit beside every share.
"""

from __future__ import annotations

import subprocess

# part → (bfloat16 TFLOP/s, float32 TFLOP/s, HBM TB/s)
TABLE = {
    "H100 SXM": (989.0, 67.0, 3.35),
    "H100 NVL": (835.0, 60.0, 3.9),
    "H100 PCIe": (756.0, 51.0, 2.0),
}


def part_of(name: str) -> str:
    """The data-sheet part of a card named as torch.cuda.get_device_name()
    gives it ("NVIDIA H100 80GB HBM3" is the SXM part)."""
    if "H100" not in name:
        raise ValueError(f"no peaks for {name!r}: the table holds the H100")
    if "NVL" in name:
        return "H100 NVL"
    if "PCIe" in name:
        return "H100 PCIe"
    return "H100 SXM"


def peaks(name: str) -> dict:
    part = part_of(name)
    bf16, f32, hbm = TABLE[part]
    return {"part": part, "tflops": {"bfloat16": bf16, "float32": f32},
            "hbm_tb_s": hbm}


def power_limit() -> str:
    """nvidia-smi's name and power limit of the first card, or what went
    wrong reading them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"
