"""Image IO on the host, ported from the JAX package's utils/io.py. The
reference uses cv::imread / imwrite (main/main.cpp:17-18); here the
native loader (utils/native, built from csrc/sba_native.cpp) reads first
where it builds, then PIL."""

from __future__ import annotations

import numpy as np


def load_image(path: str):
    """Load an image file -> (H, W, 3) uint8 RGB numpy array."""
    try:
        from .native import load_image_native

        arr = load_image_native(path)
        if arr is not None:
            return arr
    except Exception:
        pass
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def save_image(arr, path: str):
    from .viz import save_image as _save

    _save(arr, path)
