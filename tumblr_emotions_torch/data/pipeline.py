"""Host-side batch assembly helpers of the input pipeline.

Port of the serving-path part of ``tumblr_emotions_tpu/data/pipeline.py``:
the fixed-size host resize.  The record pipeline itself comes with the
training slice.
"""

from __future__ import annotations

import numpy as np

from tumblr_emotions_torch.data import jpeg


def _host_resize_uint8(img: np.ndarray, size: int) -> np.ndarray:
    """Fixed-size host resize for batch assembly: PIL's ``Image.BILINEAR``
    resize to ``size`` x ``size`` of a uint8 RGB image, bit for bit, without
    PIL (``data/jpeg.resize_bilinear``).  An image already that size is
    returned as it is."""
    if img.shape[0] == size and img.shape[1] == size:
        return img
    return jpeg.resize_bilinear(img, size, size)
