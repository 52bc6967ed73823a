"""Datasets for the loader tests that spawn workers must unpickle. They live
in a module that imports only numpy, so a worker starts in well under a
second (a test module importing JAX and torch takes seconds)."""

import os

import numpy as np


class DyingDataset:
    """Loading sample 3 the first time in a worker kills that process
    outright, as an OOM kill would; the marker file makes every later load
    of it succeed. The parent never dies."""

    def __init__(self, marker):
        self.marker = marker
        self.parent = os.getpid()

    def __len__(self):
        return 8

    def load(self, i, rng):
        if i == 3 and os.getpid() != self.parent and not os.path.exists(self.marker):
            open(self.marker, "w").close()
            os._exit(1)
        return np.full((4, 4, 3), i, np.uint8), i % 2, i
