"""Closed-form receptive-field arithmetic (the port's own copy of
mgproto_tpu/ops/receptive_field.py, which is framework-neutral).

Standard conv-net RF propagation (size n, jump j, RF extent r, first-center
offset): it maps a prototype's latent (h, w) location back to an
input-pixel box. Host arithmetic, no torch.

The trunks' `conv_info()` (models/) lists the ops the forward runs, so the
skipped stem pool is not in it and `RFInfo.grid_size` equals the real
latent H/W (the reference's ResNet `conv_info` lists the pool it skips).
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class RFInfo:
    """RF state after some prefix of layers."""

    grid_size: int  # spatial size n of this layer's output
    jump: int  # input pixels per unit step in this layer's grid
    rf_size: int  # RF extent r in input pixels
    start: float  # input-pixel center of output position (0, 0)


def propagate(
    rf: RFInfo, kernel: int, stride: int, padding: int | str
) -> RFInfo:
    """Propagate RF info through one conv/pool layer (reference :4-42)."""
    n_in, j_in, r_in, start_in = rf.grid_size, rf.jump, rf.rf_size, rf.start

    if padding == "SAME":
        n_out = math.ceil(n_in / stride)
        if n_in % stride == 0:
            pad = max(kernel - stride, 0)
        else:
            pad = max(kernel - (n_in % stride), 0)
    elif padding == "VALID":
        n_out = math.ceil((n_in - kernel + 1) / stride)
        pad = 0
    else:
        pad = padding * 2
        n_out = (n_in - kernel + pad) // stride + 1

    pad_left = pad // 2
    return RFInfo(
        grid_size=n_out,
        jump=j_in * stride,
        rf_size=r_in + (kernel - 1) * j_in,
        start=start_in + ((kernel - 1) / 2 - pad_left) * j_in,
    )


def proto_layer_rf_info(
    img_size: int,
    kernels: Sequence[int],
    strides: Sequence[int],
    paddings: Sequence[int | str],
    proto_kernel_size: int = 1,
) -> RFInfo:
    """RF info of the prototype layer (reference :111-141): the backbone stack
    followed by the 1x1 (VALID) prototype comparison window."""
    assert len(kernels) == len(strides) == len(paddings)
    rf = RFInfo(grid_size=img_size, jump=1, rf_size=1, start=0.5)
    for k, s, p in zip(kernels, strides, paddings):
        rf = propagate(rf, k, s, p)
    return propagate(rf, proto_kernel_size, 1, "VALID")


def rf_box_at(
    rf: RFInfo, img_size: int, h: int, w: int
) -> Tuple[int, int, int, int]:
    """Input-pixel box (h0, h1, w0, w1) of the RF centered at latent (h, w)
    (reference :44-62)."""
    assert h < rf.grid_size and w < rf.grid_size, (h, w, rf.grid_size)
    ch = rf.start + h * rf.jump
    cw = rf.start + w * rf.jump
    half = rf.rf_size / 2
    return (
        max(int(ch - half), 0),
        min(int(ch + half), img_size),
        max(int(cw - half), 0),
        min(int(cw + half), img_size),
    )


def rf_boxes(
    rf: RFInfo, img_size: int, locations: Sequence[Tuple[int, int, int]]
) -> List[Tuple[int, int, int, int, int]]:
    """Batch version over (img_index, h, w) triples (reference :64-87)."""
    out = []
    for img_index, h, w in locations:
        out.append((img_index, *rf_box_at(rf, img_size, h, w)))
    return out
