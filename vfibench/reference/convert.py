"""The reference's state dict from the checkpoint file, read with numpy.

`checkpoints/fldrnet_best.npz` holds the parameters under slash-joined
names with HWIO conv weights ("vfinet/refine/enc1/w"). The reference's
fLDRnet.py names them as its modules do ("vfinet.refine_unet.enc1.weight",
OIHW). This works the mapping out again from the file, independent of the
program's converter (`fldrx_torch/tools/convert_ckpt.py`
`params_to_state_dict`), on the names the reference forward reads.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

# reference module name → checkpoint prefix, for every conv
_CONVS = {"rec_ctx_ds.0": "rec_ctx/conv0", "rec_ctx_ds.2": "rec_ctx/conv1",
          "vfinet.conv_flow1": "vfinet/conv_flow1"}
_CONVS.update({f"vfinet.conv_flow_bottom.{2 * i}": f"vfinet/flow_bottom/{i}"
               for i in range(5)})
_CONVS.update({f"vfinet.conv_flow2.{2 * i}": f"vfinet/conv_flow2/{i}"
               for i in range(5)})
_CONVS.update({f"vfinet.refine_unet.{k}": f"vfinet/refine/{k}"
               for k in ("enc1", "enc2", "enc3", "dec0", "dec1", "dec2",
                         "dec3")})
# reference buffer or parameter name → checkpoint name
_PLAIN = {"vfinet.T_param": "vfinet/T_param", "vfinet.z_alpha": "vfinet/z_alpha",
          "Mean8": "pca/mean", "EV8": "pca/ev", "meanVec8": "pca/mean_vec"}


def state_dict_numpy(path: str) -> Dict[str, np.ndarray]:
    """{reference name: float32 array} from the checkpoint at `path`."""
    sd = {}
    with np.load(path) as z:
        for name, key in _CONVS.items():
            sd[f"{name}.weight"] = np.ascontiguousarray(
                np.transpose(z[f"{key}/w"], (3, 2, 0, 1)), np.float32)
            sd[f"{name}.bias"] = np.asarray(z[f"{key}/b"], np.float32)
        for name, key in _PLAIN.items():
            sd[name] = np.asarray(z[key], np.float32)
    return sd


def checkpoint_name(ref_name: str) -> str:
    """The checkpoint's slash-joined name of a reference leaf
    ("vfinet.refine_unet.enc1.weight" → "vfinet/refine/enc1/w")."""
    if ref_name in _PLAIN:
        return _PLAIN[ref_name]
    module, kind = ref_name.rsplit(".", 1)
    return f"{_CONVS[module]}/{'w' if kind == 'weight' else 'b'}"


def state_dict(path: str, device, requires_grad: bool = False):
    """The state dict as float32 tensors on `device`; with requires_grad
    every leaf but the frozen meanVec8 requires a gradient."""
    out = {}
    for k, v in state_dict_numpy(path).items():
        t = torch.tensor(v, device=device)
        if requires_grad and k != "meanVec8":
            t.requires_grad_(True)
        out[k] = t
    return out
