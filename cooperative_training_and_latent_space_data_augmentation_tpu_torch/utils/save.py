"""Result-saving utilities: PNG segmentation grids, npy/nrrd dumps.

A copy of the JAX package's ``utils/save.py`` (numpy only; the port
imports nothing of the JAX package), its re-design of
``medseg/common_utils/save.py``: the driver pieces
(save_testing_images_results grid PNG :286-325, save_nrrd_to_disk :351-374)
plus the analysis/notebook helpers (save_dict/load_dict :19-28, save_imgs
:30-72, save_predict/save_numpy_as_nrrd/link_image :119-146,
save_results_as_png :148-233, save_npy2image :338-343).  NRRD goes through
the port's pure-numpy writer (``data/nifti.py:write_nrrd``).  matplotlib
is imported only in :func:`_plt`, when a PNG is drawn (the card's machine
has none: there the PNG functions return None and the data dumps work).
"""

from __future__ import annotations

import os
import pickle
import time
from os.path import join
from typing import Optional, Sequence

import numpy as np

from cooperative_training_and_latent_space_data_augmentation_tpu_torch.data.nifti import (
    write_nrrd,
)


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def save_testing_images_results(images, gts, predicts, save_dir: str,
                                epoch_iter, max_slices: int = 10,
                                file_name: str = "Seg_plots.png") -> Optional[str]:
    """Grid PNG: rows = input / GT / prediction (save.py:286-325).

    ``images``: (N, H, W) floats; ``gts``/``predicts``: (N, H, W) ints.
    """
    try:
        plt = _plt()
    except ImportError:
        return None
    images = np.asarray(images)
    gts = np.asarray(gts)
    predicts = np.asarray(predicts)
    n = min(max_slices, images.shape[0])
    if n == 0:
        return None
    out_dir = join(save_dir, str(epoch_iter))
    os.makedirs(out_dir, exist_ok=True)
    fig, axes = plt.subplots(3, n, figsize=(2 * n, 6), squeeze=False)
    for i in range(n):
        axes[0][i].imshow(images[i], cmap="gray")
        axes[1][i].imshow(gts[i], vmin=0, vmax=max(gts.max(), 1))
        axes[2][i].imshow(predicts[i], vmin=0, vmax=max(gts.max(), 1))
        for r in range(3):
            axes[r][i].axis("off")
    axes[0][0].set_title("image")
    axes[1][0].set_title("GT")
    axes[2][0].set_title("pred")
    path = join(out_dir, file_name)
    fig.savefig(path, bbox_inches="tight", dpi=80)
    plt.close(fig)
    return path


def save_dict(mydict, file_path: str = "./reports/summary_result.pkl") -> str:
    """Pickle a dict (save.py:19-21)."""
    os.makedirs(os.path.dirname(file_path) or ".", exist_ok=True)
    with open(file_path, "wb") as f:
        pickle.dump(mydict, f)
    return file_path


def load_dict(file_path: str = "./reports/summary_result.pkl"):
    """Unpickle a dict (save.py:24-27)."""
    with open(file_path, "rb") as f:
        return pickle.load(f)


def save_imgs(list_of_inputs, is_image: bool = True,
              names: Optional[Sequence[str]] = None,
              cmaps: Optional[Sequence[str]] = None,
              save_dir: str = "./result/log",
              file_name: str = "test_{}.png",
              num_imgs: int = 5) -> Optional[str]:
    """One row per network output: the first ``num_imgs`` samples
    concatenated along width (save.py:30-72).  Inputs are NHWC (or NHW)
    arrays; multi-channel non-image inputs are argmaxed to label maps like
    the reference.  '{}' in file_name takes a timestamp."""
    try:
        plt = _plt()
    except ImportError:
        return None

    def concat(arr):
        arr = np.asarray(arr)
        if arr.ndim == 4:
            if (not is_image) or arr.shape[-1] > 1:
                arr = np.argmax(arr, axis=-1)
            else:
                arr = arr[..., 0]
        n = min(num_imgs, arr.shape[0])
        return np.concatenate([arr[i] for i in range(n)], axis=1)

    fig, axes = plt.subplots(len(list_of_inputs), 1, squeeze=False)
    for i, data in enumerate(list_of_inputs):
        cat = concat(data)
        cmap = cmaps[i] if cmaps is not None and len(cmaps) == len(list_of_inputs) \
            else "gray"
        if cmap == "RdBu":  # symmetric range for signed maps (save.py:59)
            axes[i][0].imshow(cat, cmap=cmap, interpolation="none",
                              vmin=-np.max(cat), vmax=np.max(cat))
        else:
            axes[i][0].imshow(cat, cmap=cmap, interpolation="none")
        if names is not None and len(names) == len(list_of_inputs):
            axes[i][0].set_title(names[i])
        axes[i][0].axis("off")
    plt.tight_layout(pad=0.05)
    os.makedirs(save_dir, exist_ok=True)
    path = join(save_dir, file_name.format(str(np.round(time.time(), 2))))
    fig.savefig(path, dpi=200)
    plt.close(fig)
    return path


def save_predict(array_zyx, root_dir: str, patient_dir: str, file_name: str,
                 spacing=(1.0, 1.0, 1.0)) -> str:
    """Write a prediction volume under {root}/{patient}/{file} (save.py:119-126;
    sitk.WriteImage -> pure-numpy NRRD)."""
    out_dir = join(root_dir, patient_dir)
    os.makedirs(out_dir, exist_ok=True)
    return save_nrrd_to_disk(out_dir, file_name, array_zyx, spacing)


def save_numpy_as_nrrd(numpy_array, img_file_path: str) -> str:
    """save.py:129-131."""
    write_nrrd(img_file_path, np.asarray(numpy_array))
    return img_file_path


def link_image(origin_path: str, root_dir: str, patient_dir: str) -> str:
    """Symlink a source image next to saved predictions (save.py:134-146;
    os.symlink instead of shelling out to `ln -s`)."""
    out_dir = join(root_dir, patient_dir)
    os.makedirs(out_dir, exist_ok=True)
    linked = join(out_dir, os.path.basename(origin_path))
    if not os.path.lexists(linked):
        os.symlink(origin_path, linked)
    return linked


def _norm255(img):
    img = np.asarray(img, np.float64)
    if img.max() - img.min() > 0:
        img = (img - img.min()) / (img.max() - img.min()) * 255
    return np.uint8(np.repeat(img[:, :, None], 3, axis=2))


def save_results_as_png(alist, save_full_path: str,
                        labels: Optional[Sequence[str]] = None) -> Optional[str]:
    """One row of per-image min-max-normalized grayscale panels
    (save.py:148-172)."""
    try:
        plt = _plt()
    except ImportError:
        return None
    fig, ax = plt.subplots(nrows=1, ncols=len(alist), squeeze=False)
    for i, img in enumerate(alist):
        ax[0][i].imshow(_norm255(img))
        ax[0][i].axis("off")
        if labels is not None and len(labels) == len(alist):
            ax[0][i].set_title(labels[i])
    os.makedirs(os.path.dirname(save_full_path) or ".", exist_ok=True)
    fig.savefig(save_full_path)
    plt.close(fig)
    return save_full_path


def save_list_results_as_png(lists, save_full_path: str,
                             labels: Optional[Sequence[str]] = None,
                             add_points=None, which_index: int = 0
                             ) -> Optional[str]:
    """Grid of rows x cols normalized panels with optional landmark points
    drawn on column ``which_index`` (save.py:175-233)."""
    try:
        plt = _plt()
    except ImportError:
        return None
    n_rows = len(lists)
    n_cols = len(lists[0])
    fig, ax = plt.subplots(nrows=n_rows, ncols=n_cols, sharey="row",
                           squeeze=False)
    for j, alist in enumerate(lists):
        for i, img in enumerate(alist):
            ax[j][i].imshow(_norm255(img))
            ax[j][i].axis("off")
            if add_points is not None and i == which_index:
                pts = np.asarray(add_points[j])
                ax[j][i].scatter(pts[:, 1], pts[:, 0], s=4, c="r")
        if labels is not None and len(labels) == n_rows:
            ax[j][0].set_ylabel(labels[j])
    os.makedirs(os.path.dirname(save_full_path) or ".", exist_ok=True)
    fig.savefig(save_full_path, bbox_inches="tight")
    plt.close(fig)
    return save_full_path


def save_results_with_points_as_png(alist, save_full_path: str, points=None,
                                    labels: Optional[Sequence[str]] = None
                                    ) -> Optional[str]:
    """Row of panels, each with its own landmark overlay (save.py:235-273)."""
    try:
        plt = _plt()
    except ImportError:
        return None
    fig, ax = plt.subplots(nrows=1, ncols=len(alist), squeeze=False)
    for i, img in enumerate(alist):
        ax[0][i].imshow(_norm255(img))
        ax[0][i].axis("off")
        if points is not None and points[i] is not None:
            pts = np.asarray(points[i])
            ax[0][i].scatter(pts[:, 1], pts[:, 0], s=4, c="r")
        if labels is not None and len(labels) == len(alist):
            ax[0][i].set_title(labels[i])
    os.makedirs(os.path.dirname(save_full_path) or ".", exist_ok=True)
    fig.savefig(save_full_path)
    plt.close(fig)
    return save_full_path


def save_npy2image(data, file_dir: str, name: str) -> Optional[str]:
    """Save a 2-D array as a grayscale PNG (save.py:338-343)."""
    try:
        plt = _plt()
    except ImportError:
        return None
    os.makedirs(file_dir, exist_ok=True)
    path = join(file_dir, name if name.endswith(".png") else name + ".png")
    plt.imsave(path, np.asarray(data), cmap="gray")
    return path


def save_npy(array, save_dir: str, name: str) -> str:
    os.makedirs(save_dir, exist_ok=True)
    path = join(save_dir, name if name.endswith(".npy") else name + ".npy")
    np.save(path, np.asarray(array))
    return path


def save_nrrd_to_disk(save_dir: str, name: str, array_zyx,
                      spacing=(1.0, 1.0, 1.0)) -> str:
    os.makedirs(save_dir, exist_ok=True)
    path = join(save_dir, name if name.endswith(".nrrd") else name + ".nrrd")
    write_nrrd(path, np.asarray(array_zyx), spacing)
    return path
