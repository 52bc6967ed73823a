"""ImageNet normalization (the port's copy of mgproto_tpu/utils/images.py):
the torchvision statistics the pretrained backbones were trained with.
Arrays are NHWC float32 in [0, 1]."""

from __future__ import annotations

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def preprocess_input(x):
    """[0, 1] NHWC -> ImageNet-normalized (push normalizes its resize-only
    batches with this, engine/push.py)."""
    return (x - IMAGENET_MEAN) / IMAGENET_STD
