"""ImageNet normalization statistics (the port's copy of
mgproto_tpu/utils/images.py): the torchvision statistics the pretrained
backbones were trained with."""

from __future__ import annotations

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)
