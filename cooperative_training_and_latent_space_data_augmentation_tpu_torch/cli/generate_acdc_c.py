"""ACDC-C, the corrupted test set: the generator of the port.

Counterpart of the JAX package's ``cli/generate_acdc_c.py``, the
re-design of ``medseg/dataset_loader/generate_artefacted_data.py``
(:48-110): for each ACDC test patient x frame x corruption model
{RandomBias, RandomSpike, RandomGhosting, RandomMotion} x seed, it crops the
volume to 192x192, rescales each slice to [0, 1] (preprocess3D, :17-35),
applies the corruption on the card (:mod:`..ops.corruptions`, one draw
for the whole volume), pastes the corrupted crop back onto a zero canvas
of the original size (recover_image, basic_operations.py:161-170) and
writes it as ``{attack}/{pid}_{seed}/{frame}_img.nrrd`` with the source
spacing, beside the source label, symlinked (or copied with
``--copy_labels``) as ``{frame}_label`` under its own extension::

    python -m cooperative_training_and_latent_space_data_augmentation_tpu_torch.cli.generate_acdc_c \\
        --acdc_root /tmp/synthetic_ACDC --out_root /tmp/ACDC-C --seeds 0

The source volumes are read without resampling or whole-volume
normalisation (the reference's load_img_label_from_path with defaults,
:70-71).  Each (attack, pid, frame, seed) seeds a CPU ``torch.Generator``
with ``zlib.crc32("{attack}/{pid}/{frame}/{seed}") & 0x7FFFFFFF``, the key
the JAX generator gives ``jax.random.PRNGKey``.  The draws come from
another generator, so the volumes written here are not the JAX
generator's: the same models with other random parameters.  A tree the JAX
package wrote reads as it is through ``cli.test --acdc_c_root``.  The
corruption runs on the card (``--device cuda``, the default) and raises if
there is none, unless ``--device cpu`` asks for the CPU.
"""

from __future__ import annotations

import argparse
import os
import shutil
import zlib
from os.path import join
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from cooperative_training_and_latent_space_data_augmentation_tpu_torch.data.acdc import (
    CardiacACDCDataset,
    _read_volume,
    probe_format_names,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.data.nifti import (
    write_nrrd,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.data.splits import (
    TEST_LIST,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.ops.corruptions import (
    NAMES,
    CorruptionDraws,
    corrupt_volume,
    draw_corruption,
)

# (attack, pid, frame, seed, n_slices, h, w) -> the volume's draws
DrawFn = Callable[[str, str, str, int, int, int, int], CorruptionDraws]


def crop_with_offsets(vol_nhw: np.ndarray, crop: int):
    """Center crop/pad to (crop, crop) returning the reference's recover
    parameters (basic_operations.crop_or_pad:173-219): (cropped, h_s, w_s,
    post_pad_h, post_pad_w).  Padding puts the extra row/col on the
    lower-index side (torch pastes at -h_s = ceil((new-h)/2))."""
    n, h, w = vol_nhw.shape
    if h < crop:
        top = -((h - crop) // 2)
        canvas = np.zeros((n, crop, w), vol_nhw.dtype)
        canvas[:, top:top + h] = vol_nhw
        vol_nhw, h = canvas, crop
    if w < crop:
        left = -((w - crop) // 2)
        canvas = np.zeros((n, h, crop), vol_nhw.dtype)
        canvas[:, :, left:left + w] = vol_nhw
        vol_nhw, w = canvas, crop
    h_s, w_s = (h - crop) // 2, (w - crop) // 2
    return vol_nhw[:, h_s:h_s + crop, w_s:w_s + crop], h_s, w_s, h, w


def recover(vol_nhw: np.ndarray, h_s: int, w_s: int, orig_h: int, orig_w: int):
    """Paste the corrupted crop back onto a zero canvas of the original size
    (recover_image, basic_operations.py:161-170)."""
    n, h, w = vol_nhw.shape
    canvas = np.zeros((n, orig_h, orig_w), vol_nhw.dtype)
    canvas[:, h_s:h_s + h, w_s:w_s + w] = vol_nhw
    return canvas


def per_slice_minmax(vol_nhw: np.ndarray):
    """preprocess3D (generate_artefacted_data.py:17-35): per-slice min-max."""
    flat = vol_nhw.reshape(vol_nhw.shape[0], -1)
    lo = flat.min(axis=1)[:, None, None]
    hi = flat.max(axis=1)[:, None, None]
    return ((vol_nhw - lo) / (hi - lo + 1e-20)).astype(np.float32)


def crc_draws(attack: str, pid: str, frame: str, seed: int, n: int, h: int,
              w: int) -> CorruptionDraws:
    """The volume's draws from a CPU generator seeded by the crc32 of
    ``{attack}/{pid}/{frame}/{seed}`` (stable across processes, unlike
    Python's salted ``hash``)."""
    tag = f"{attack}/{pid}/{frame}/{seed}".encode()
    return draw_corruption(torch.Generator().manual_seed(zlib.crc32(tag) & 0x7FFFFFFF), attack)


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser("ACDC-C generator (PyTorch port)")
    p.add_argument("--acdc_root", type=str, required=True)
    p.add_argument("--out_root", type=str, required=True)
    p.add_argument("--frames", nargs="+", default=["ED", "ES"])
    p.add_argument("--seeds", nargs="+", type=int, default=[0, 1, 2])
    p.add_argument("--attacks", nargs="+", default=list(NAMES), choices=list(NAMES))
    p.add_argument("--crop", type=int, default=192)
    p.add_argument("--copy_labels", action="store_true",
                   help="copy the source label file instead of symlinking")
    p.add_argument("--device", type=str, default="cuda", help="'cuda' (default) or 'cpu'")
    return p.parse_args(argv)


def _place_label(label_src: str, out_dir: str, frame: str, copy: bool) -> None:
    """The original full-size label beside the image (the reference
    symlinks it, generate_artefacted_data.py:103-110), under the source's
    extension so that suffix-dispatching readers parse it."""
    label_ext = next(e for e in (".nii.gz", ".nrrd", ".nii") if label_src.endswith(e))
    label_dst = join(out_dir, f"{frame}_label{label_ext}")
    if os.path.islink(label_dst) or os.path.exists(label_dst):
        os.unlink(label_dst)
    if copy:
        shutil.copyfile(label_src, label_dst)
    else:
        os.symlink(os.path.abspath(label_src), label_dst)


def generate(args: argparse.Namespace, draw_fn: DrawFn = crc_draws) -> List[str]:
    """Write ACDC-C for ``args``; returns the image files written, in order."""
    if args.device != "cpu" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device; pass --device cpu to "
                           f"corrupt on the CPU")
    written, n_done = [], 0
    for frame in args.frames:
        img_fmt, label_fmt = probe_format_names(args.acdc_root, frame)
        ds = CardiacACDCDataset(root_dir=args.acdc_root, frame=frame, split="test",
                                data_setting="standard", cval=0, image_format_name=img_fmt,
                                label_format_name=label_fmt, if_resample=False,
                                normalize=False)
        for pid in ds.patient_ids:
            if pid not in TEST_LIST:
                continue
            vol, src_spacing = _read_volume(ds._img_path(pid))
            cropped, h_s, w_s, oh, ow = crop_with_offsets(np.asarray(vol, np.float32),
                                                          args.crop)
            cropped = per_slice_minmax(cropped)
            on_device = torch.from_numpy(cropped).to(args.device)
            n, h, w = cropped.shape
            for attack in args.attacks:
                for seed in args.seeds:
                    draws = draw_fn(attack, pid, frame, seed, n, h, w).to(args.device)
                    corrupted = corrupt_volume(draws, on_device).cpu().numpy()
                    out_dir = join(args.out_root, attack, f"{pid}_{seed}")
                    os.makedirs(out_dir, exist_ok=True)
                    path = join(out_dir, f"{frame}_img.nrrd")
                    write_nrrd(path, recover(corrupted, h_s, w_s, oh, ow).astype(np.float32),
                               spacing=tuple(float(s) for s in src_spacing))
                    _place_label(ds._label_path(pid), out_dir, frame, args.copy_labels)
                    written.append(path)
            n_done += 1
            print(f"{frame} {pid}: done", flush=True)
    if n_done == 0:
        raise SystemExit(
            f"no ACDC test patients found under {args.acdc_root} — expected "
            f"{{pid}}/{{frame}}_img.nii.gz|.nrrd dirs for the 20-patient test "
            f"list (data/splits.TEST_LIST)")
    return written


def main(argv: Optional[Sequence[str]] = None) -> List[str]:
    return generate(parse_args(argv))


if __name__ == "__main__":
    main()
