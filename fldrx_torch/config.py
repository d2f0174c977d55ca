"""Configuration for fldrx_torch — the same frozen dataclass and presets as
the JAX package (fldrx/config.py), kept as an independent copy so the port
imports nothing of it.

Only the fields the inference path reads carry meaning here; the training
and path fields are kept so a configuration can be carried across the two
packages field for field. `planes_out`, as in fldrx, makes the ×N synthesis
of the packed path return u-planes [.., 4, H/4, W·3], which the host unpacks
(ops/repack.py).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class FLDRConfig:
    """Model + pipeline configuration (reference: main.py argparse + presets)."""

    # --- core model geometry ---
    img_ch: int = 3
    wiS: int = 8                      # PCA block size
    scales: Tuple[int, ...] = (8, 16, 32, 64)
    fractions: Tuple[int, ...] = (4, 16, 64, 256)
    S_trn: int = 3                    # lowest pyramid level used in training
    S_tst: int = 3                    # lowest pyramid level used at test

    # --- papermodel switches that survive into the forward pass ---
    mean_vector_norm: bool = True
    ref_feat_extrac: bool = True
    exac_one_ev: bool = True          # scale-8 PCA shared by every level
    sminterp: bool = True
    impmasksoftsplat: bool = True
    align_corners: bool = False

    # --- refine UNet ---
    unet_nf: int = 16
    unet_in: int = 26
    unet_out: int = 6

    # --- training hyperparameters (not used by the inference port yet) ---
    epochs: int = 200
    init_lr: float = 1e-4
    evlr: float = 0.1
    lr_milestones: Tuple[int, ...] = (70, 120, 170)
    lr_dec_fac: float = 0.25
    batch_size: int = 8
    weight_decay: float = 0.0
    loss_type: str = "L1"
    rec_lambda: float = 1.0
    smoothness: float = 0.5
    warp_alpha: float = 0.05
    patch_size: int = 512
    validation_patch_size: int = 512
    test_patch_size: int = -1
    t_optimization: bool = False
    no_ev_optimization: bool = False
    warping_loss: bool = False
    orth_loss: bool = False
    save_images: bool = False
    freq_display: int = 100
    use_orbax: bool = False

    # --- eval / data ---
    multiple: int = 8
    t_chunk: int = 4                  # t-values per synthesis chunk
    planes_out: bool = True           # ×N synthesis returns u-planes
    per_item_minmax: bool = False     # PCA min-max per batch item
    padding: str = "reflect"
    dataset: str = "X4K1000FPS"
    testsets: Tuple[str, ...] = ("Inter4K-S", "Inter4K-L", "X4K1000FPS", "Xiph-4K")
    phase: str = "test"

    # --- numerics policy ---
    compute_dtype: str = "float32"    # bfloat16 for the speed path
    flow_dtype: str = ""              # per-stage overrides ("" = compute_dtype)
    unet_dtype: str = ""
    param_dtype: str = "float32"
    fast_warp: bool = True            # hand-written warp kernels + fast algebra
    packed_synth: bool = True         # the packed path's values (needs fast_warp)
    fast_warp_train: bool = True

    # --- paths ---
    checkpoint_dir: str = "./checkpoint_dir"
    text_dir: str = "./text_dir"
    log_dir: str = "./log_dir"
    exp_num: int = 1
    net_type: str = "fLDRnet"
    x_train_data_path: str = "./../../X-Train/train"
    x_val_data_path: str = "./../../X-Train/val"
    x_test_data_path: str = "X_test/test"
    vimeo_data_path: str = "./../../vimeo_triplet"
    xiph_data_path: str = "../XVFI-main/XiphDataset/netflix"
    inter4k_data_path: str = "inter4ktestset/"

    @property
    def dctvfi_nf(self) -> int:
        # number of PCA components kept per image channel
        return self.scales[0] ** 2 // self.fractions[0]

    @property
    def nf(self) -> int:
        return self.dctvfi_nf * self.img_ch

    @property
    def div_pad(self) -> int:
        # test frames are padded to this divisibility
        s = self.S_tst if self.phase == "test" else self.S_trn
        return (2 ** s) * self.wiS

    @property
    def model_dir(self) -> str:
        return f"{self.net_type}_X4K1000FPS_exp{self.exp_num}"

    def replace(self, **kw) -> "FLDRConfig":
        return dataclasses.replace(self, **kw)


def papermodel(**overrides) -> FLDRConfig:
    """The --papermodel preset."""
    cfg = FLDRConfig()
    return cfg.replace(**overrides) if overrides else cfg


_TEST_SCALE_PRESETS = {
    3: ((8, 16, 32, 64), (4, 16, 64, 256)),
    4: ((8, 16, 32, 64, 128), (4, 16, 64, 256, 1024)),
    5: ((8, 16, 32, 64, 128, 256), (4, 16, 64, 256, 1024, 4096)),
    6: ((8, 16, 32, 64, 128, 256, 512), (4, 16, 64, 256, 1024, 4096, 16384)),
    7: ((8, 16, 32, 64, 128, 256, 512, 1024),
        (4, 16, 64, 256, 1024, 4096, 16384, 65536)),
}


def apply_test_scales(cfg: FLDRConfig, n: int) -> FLDRConfig:
    """Apply the --testNscales preset: deepen the pyramid for test only."""
    scales, fractions = _TEST_SCALE_PRESETS[n]
    return cfg.replace(scales=scales, fractions=fractions, S_tst=n, phase="test")


def papermodel_test5() -> FLDRConfig:
    """--papermodel --test5scales: the headline benchmark configuration."""
    return apply_test_scales(papermodel(), 5)
