"""Segmentation post-processing on the host (numpy and scipy).

A copy of the JAX package's ``eval/post_process.py`` (the port imports
nothing of the JAX package): connected components of final predictions,
as the reference does it (medseg/common_utils/post_process.py:5-22).
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage


def keep_largest_connected_components(mask: np.ndarray, n_classes: int) -> np.ndarray:
    """Keep only the largest 4-connected component of each foreground class
    (post_process.keep_largest_connected_components:5-22)."""
    out = np.zeros(mask.shape, dtype=np.uint8)
    structure = ndimage.generate_binary_structure(mask.ndim, 1)  # connectivity=1
    for cls in range(1, n_classes):
        binary = mask == cls
        labels, n = ndimage.label(binary, structure=structure)
        if n == 0:
            continue
        sizes = ndimage.sum_labels(binary, labels, index=np.arange(1, n + 1))
        largest = 1 + int(np.argmax(sizes))
        out[labels == largest] = cls
    return out
