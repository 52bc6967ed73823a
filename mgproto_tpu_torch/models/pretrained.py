"""Pretrained trunks from local torchvision-layout `.pth` files (counterpart
of mgproto_tpu/models/pretrained.py, local files only).

The reference builds every backbone with `pretrained=True`: CUB-class
accuracy is unreachable from random init. `create_train_state` with
`ModelConfig.pretrained` set calls `load_pretrained_trunk(model.features,
arch)`, which finds the arch's `.pth` on the search path (first hit wins):

    $MGPROTO_PRETRAINED_DIR
    $TORCH_HOME/hub/checkpoints        (default ~/.cache/torch/hub/checkpoints)
    ~/.cache/mgproto_tpu/pretrained

(the JAX package's path and environment names, so one set-up serves both
packages), normalizes its keys to the trunk's torchvision names, checks
every name and shape, and copies the tensors into the trunk. A `.pth` is
already torch, so there is no converted cache (the JAX package keeps one
as `.npz`). Nothing is downloaded: the JAX package's `MGPROTO_AUTO_FETCH`
and its model-zoo table are not ported.
"""

from __future__ import annotations

import glob
import os
import re
from typing import Dict, List, Optional

import torch
from torch import nn

# torchvision publishes files as "{arch}-{hash}.pth". Exception: the
# registry's resnet50 is the BBN-iNaturalist variant (layer4 has 4 blocks),
# so plain torchvision resnet50 files are not matched: their 3-block layer4
# cannot fill this trunk.
_ARCH_PATTERNS = {
    "resnet50": ["*BBN*iNaturalist*res50*.pth", "*iNat*res50*.pth"],
}


def search_dirs() -> List[str]:
    """The directories searched for a `.pth`, in order."""
    dirs = []
    env = os.environ.get("MGPROTO_PRETRAINED_DIR")
    if env:
        dirs.append(env)
    torch_home = os.environ.get(
        "TORCH_HOME", os.path.join(os.path.expanduser("~"), ".cache", "torch"))
    dirs.append(os.path.join(torch_home, "hub", "checkpoints"))
    dirs.append(os.path.join(os.path.expanduser("~"), ".cache", "mgproto_tpu", "pretrained"))
    return dirs


def _patterns(arch: str) -> List[str]:
    return _ARCH_PATTERNS.get(arch, [f"{arch}-*.pth", f"{arch}.pth"])


def find_torch_checkpoint(arch: str) -> Optional[str]:
    """The first `.pth` on the search path matching the arch's file names."""
    for d in search_dirs():
        for pat in _patterns(arch):
            hits = sorted(glob.glob(os.path.join(d, pat)))
            if hits:
                return hits[0]
    return None


def normalize_torch_keys(state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A checkpoint's keys in the modern torchvision trunk layout: the
    `module.` and `backbone.` wrapper prefixes stripped, BBN's `cb_block` /
    `rb_block` as `layer4.2` / `layer4.3`, legacy DenseNet `norm.1` as
    `norm1`, the `features.` prefix of VGG and DenseNet files stripped, and
    the `classifier.` / `fc.` heads dropped (the JAX package's rules)."""
    out = {}
    for k, v in state.items():
        k = re.sub(r"^module\.", "", k)
        k = re.sub(r"^backbone\.", "", k)
        k = k.replace("cb_block", "layer4.2").replace("rb_block", "layer4.3")
        k = re.sub(r"\.(norm|relu|conv)\.(\d)\.", r".\1\2.", k)
        k = re.sub(r"^features\.", "", k)
        if k.startswith(("classifier.", "fc.")):
            continue
        out[k] = v
    return out


def load_torch_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """A `.pth` state_dict (or a dict holding one under `state_dict`) as
    CPU tensors."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj.get("state_dict"), dict):
        obj = obj["state_dict"]
    return {k: v for k, v in obj.items() if isinstance(v, torch.Tensor)}


def load_pretrained_trunk(trunk: nn.Module, arch: str) -> str:
    """Copy the arch's local `.pth` into `trunk` (parameters and BatchNorm
    running statistics; `num_batches_tracked` is left as it is). Every
    trunk tensor must be in the file with the trunk's shape: a mismatch
    raises ValueError, a missing file FileNotFoundError listing the
    directories searched. Returns the file's path."""
    pth = find_torch_checkpoint(arch)
    if pth is None:
        searched = "\n  ".join(search_dirs())
        note = ""
        if arch == "resnet50":
            note = ("\nNOTE: this trunk is the BBN-iNaturalist R50 variant (4-block layer4); "
                    "plain torchvision resnet50 files are incompatible and not accepted.")
        raise FileNotFoundError(
            f"no pretrained checkpoint for {arch!r}: tried patterns [{', '.join(_patterns(arch))}] "
            f"in:\n  {searched}\n(place the torchvision/BBN .pth file in one of those "
            f"directories, e.g. $MGPROTO_PRETRAINED_DIR){note}")
    state = normalize_torch_keys(load_torch_checkpoint(pth))
    target = {k: v for k, v in trunk.state_dict().items()
              if not k.endswith("num_batches_tracked")}
    if target.keys() - state.keys():
        missing = sorted(target.keys() - state.keys())[:5]
        extra = sorted(state.keys() - target.keys())[:5]
        raise ValueError(f"pretrained {arch} ({pth}) does not fit the trunk: "
                         f"missing={missing} extra={extra}")
    for k, v in target.items():
        if tuple(state[k].shape) != tuple(v.shape):
            raise ValueError(f"pretrained {arch}[{k}] shape {tuple(state[k].shape)} != "
                             f"model's {tuple(v.shape)} ({pth})")
    with torch.no_grad():
        for k, v in target.items():
            v.copy_(state[k])
    return pth
