"""VGG feature trunks (counterpart of mgproto_tpu/models/vgg.py).

The reference's quirks, as in the JAX package: the FINAL max-pool of the
standard cfg is removed, so the grid is 14x14 at 224 px; `final_relu=False`
drops the ReLU after the last conv of the non-BN variants (the reference's
`i >= n - 2` test only ever matches the last conv, since the last cfg entry
is always 'M').

Module names are torchvision's: the layers of `vgg*.features` under their
index in its Sequential (conv `0`, its BatchNorm `1`, ...), so a
torchvision state_dict with its `features.` prefix stripped loads as it
is. The JAX package names the same layers `conv{j}` / `bn{j}`;
`torch_indices` maps one onto the other.
"""

from __future__ import annotations

from typing import Dict, Sequence, Union

from torch import nn

from mgproto_tpu_torch.models import common

CFGS = {
    # reference vgg_features.py:18-23
    "A": [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    "B": [64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    "D": [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M",
          512, 512, 512, "M"],
    "E": [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M", 512, 512, 512, 512,
          "M", 512, 512, 512, 512, "M"],
}


def torch_indices(cfg: Sequence[Union[int, str]], batch_norm: bool) -> Dict[str, int]:
    """{flax name: index in torchvision's `features` Sequential} of every
    conv (`conv{j}`) and BatchNorm (`bn{j}`): torchvision's `_make_layers`
    gives each 'M' one index, each conv one, its BatchNorm one and its ReLU
    one."""
    out, seq, j = {}, 0, 0
    for v in cfg:
        if v == "M":
            seq += 1
            continue
        out[f"conv{j}"] = seq
        seq += 1
        if batch_norm:
            out[f"bn{j}"] = seq
            seq += 1
        seq += 1  # the ReLU
        j += 1
    return out


class VGGFeatures(nn.Module):
    """The conv trunk of VGG on NCHW tensors; the convs have a bias."""

    def __init__(self, cfg: Sequence[Union[int, str]], batch_norm: bool = False,
                 final_maxpool: bool = False, final_relu: bool = True):
        super().__init__()
        self.cfg = tuple(cfg)
        self.batch_norm = batch_norm
        self.final_maxpool = final_maxpool
        self.final_relu = final_relu
        names = torch_indices(self.cfg, batch_norm)
        in_ch, j = 3, 0
        for v in self.cfg:
            if v == "M":
                continue
            self.add_module(str(names[f"conv{j}"]), common.conv(in_ch, int(v), 3, 1, 1, bias=True))
            if batch_norm:
                self.add_module(str(names[f"bn{j}"]), common.batch_norm(int(v)))
            in_ch, j = int(v), j + 1
        self.out_channels = in_ch

    def conv_info(self) -> common.ConvInfo:
        """Every 3x3 conv and every 2x2 pool the forward runs (the last
        pool only with `final_maxpool`)."""
        ks, ss, ps = [], [], []
        n = len(self.cfg)
        for i, v in enumerate(self.cfg):
            if v == "M":
                if i == n - 1 and not self.final_maxpool:
                    continue
                ks, ss, ps = ks + [2], ss + [2], ps + [0]
            else:
                ks, ss, ps = ks + [3], ss + [1], ps + [1]
        return ks, ss, ps

    def forward(self, x):
        n = len(self.cfg)
        layers = iter(self.children())
        for i, v in enumerate(self.cfg):
            if v == "M":
                if i == n - 1 and not self.final_maxpool:
                    continue
                x = common.max_pool(x, 2, 2)
                continue
            x = next(layers)(x)
            if self.batch_norm:
                x = nn.functional.relu(next(layers)(x))
            elif not (i >= n - 2 and not self.final_relu):  # reference vgg_features.py:80-82
                x = nn.functional.relu(x)
        return x


# {arch: (its cfg key, batch_norm)}
VARIANTS = {
    "vgg11": ("A", False), "vgg11_bn": ("A", True),
    "vgg13": ("B", False), "vgg13_bn": ("B", True),
    "vgg16": ("D", False), "vgg16_bn": ("D", True),
    "vgg19": ("E", False), "vgg19_bn": ("E", True),
}


def _vgg(arch: str, **kw) -> VGGFeatures:
    key, bn = VARIANTS[arch]
    return VGGFeatures(CFGS[key], batch_norm=bn, **kw)


def vgg11(**kw):
    return _vgg("vgg11", **kw)


def vgg11_bn(**kw):
    return _vgg("vgg11_bn", **kw)


def vgg13(**kw):
    return _vgg("vgg13", **kw)


def vgg13_bn(**kw):
    return _vgg("vgg13_bn", **kw)


def vgg16(**kw):
    return _vgg("vgg16", **kw)


def vgg16_bn(**kw):
    return _vgg("vgg16_bn", **kw)


def vgg19(**kw):
    return _vgg("vgg19", **kw)


def vgg19_bn(**kw):
    return _vgg("vgg19_bn", **kw)


def torch_names(arch: str) -> Dict[str, str]:
    """`torch_indices` of a VGG arch, the indices as module names."""
    key, bn = VARIANTS[arch]
    return {k: str(v) for k, v in torch_indices(CFGS[key], bn).items()}
