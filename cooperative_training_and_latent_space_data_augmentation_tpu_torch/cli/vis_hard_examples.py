"""Hard-example visualization entry of the port.

Counterpart of the JAX package's ``cli/vis_hard_examples.py`` (the
reference's ``visualization/vis_hard_example.ipynb``): load a trained
cooperative model (``--checkpoint``: a directory of the port's ``.pth``
or the JAX package's ``.msgpack`` files) or take weights from ``--seed``
(``--random_init``), run ``--n_samples`` phantom slices through the eval
transform, then every latent-masking method x threshold, and write under
``--out_dir``:

* ``hard_examples.npz``: the arrays of
  ``analysis/visualize.py:hard_example_arrays``, ``{method}_thr{thr}_image``,
  ``_seg_logits`` and ``_entropy`` (NHWC, float32), and the input
  ``images`` and ``labels``;
* ``hard_examples_{method}_thr{thr}.png`` grids, where matplotlib is
  installed (the card's machine has none: there the arrays alone are
  written, and the entry says so).

On the card (``--device cuda``, the default; without one that is an
error) unless ``--device cpu``::

    python -m cooperative_training_and_latent_space_data_augmentation_tpu_torch.cli.vis_hard_examples \\
        --random_init --out_dir /tmp/vis [--device cpu]

The slices are padded to 224x224 and cropped to 192x192, as in the
protocol; the masks' draws come from a generator seeded ``--seed`` + 1.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import numpy as np
import torch

from cooperative_training_and_latent_space_data_augmentation_tpu_torch.analysis.visualize import (
    METHODS,
    hard_example_arrays,
    save_hard_example_grids,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.data.loader import collate
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.data.synthetic import (
    SyntheticSegDataset,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.ops.augment import (
    make_batch_eval_transform,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.train.checkpoint import (
    load_checkpoint_dir,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.train.cooperative import (
    CooperativeTrainer,
)


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser("hard-example visualization (PyTorch port)")
    p.add_argument("--checkpoint", type=str, default=None)
    p.add_argument("--random_init", action="store_true")
    p.add_argument("--network_type", type=str, default="FCN_16_standard")
    p.add_argument("--num_classes", type=int, default=4)
    p.add_argument("--out_dir", type=str, required=True)
    p.add_argument("--thresholds", nargs="+", type=float, default=[0.25, 0.5])
    p.add_argument("--methods", nargs="+", default=list(METHODS), choices=list(METHODS))
    p.add_argument("--n_samples", type=int, default=4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda", help="'cuda' (default) or 'cpu'")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None):
    args = parse_args(argv)
    if not args.checkpoint and not args.random_init:
        raise SystemExit("pass --checkpoint DIR or --random_init")
    if args.device != "cpu" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device; pass --device cpu")
    trainer = CooperativeTrainer(None, device=args.device, seed=args.seed,
                                 num_classes=args.num_classes,
                                 network_type=args.network_type)
    if args.checkpoint:
        load_checkpoint_dir(trainer.model, args.checkpoint)
    pad, crop = (224, 224), (192, 192)
    ds = SyntheticSegDataset(length=args.n_samples, pad_size=pad,
                             num_classes=args.num_classes, seed=args.seed)
    raw = collate(ds, np.arange(args.n_samples))
    images, labels = make_batch_eval_transform(pad, crop)(
        torch.from_numpy(raw["image"]), torch.from_numpy(raw["label"]))
    examples = hard_example_arrays(trainer, images, labels, tuple(args.thresholds),
                                   tuple(args.methods),
                                   generator=torch.Generator().manual_seed(args.seed + 1))
    os.makedirs(args.out_dir, exist_ok=True)
    arrays = {"images": images.cpu().numpy(), "labels": labels.cpu().numpy()}
    for (method, thr), ex in examples.items():
        for key in ("image", "seg_logits", "entropy"):
            arrays[f"{method}_thr{thr}_{key}"] = getattr(ex, key).cpu().numpy()
    npz = os.path.join(args.out_dir, "hard_examples.npz")
    np.savez(npz, **arrays)
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        print(f"wrote {npz}; matplotlib is not installed, so no PNG grids were drawn")
        return [npz]
    paths = save_hard_example_grids(examples, images, args.out_dir, args.num_classes)
    print(f"wrote {npz} and {len(paths)} grids under {args.out_dir}")
    return [npz] + paths


if __name__ == "__main__":
    main()
