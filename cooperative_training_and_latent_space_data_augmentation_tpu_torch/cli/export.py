"""Serving export entry of the port: a checkpoint into one predictor archive.

Counterpart of the JAX package's ``cli/export.py``.  It builds the
FCN_16 predictor, loads a checkpoint directory (the port's per-module
``.pth`` files or the JAX package's ``.msgpack`` files, read through
``convert.load_jax_checkpoint``; without one, weights from seed 0),
writes the archive of :mod:`..utils.serving` (what it holds is said
there) and, with ``--verify_batch``, reloads the archive and calls it on a
random batch of that size::

    python -m cooperative_training_and_latent_space_data_augmentation_tpu_torch.cli.export \\
        --checkpoint /tmp/runs/.../model/best/checkpoints --out /tmp/serving/predictor.pt \\
        --n_iter 2
    # later, with this package installed:
    #   from cooperative_training_and_latent_space_data_augmentation_tpu_torch.utils.serving import load_predictor
    #   probs = load_predictor("/tmp/serving/predictor.pt")(images)

The JAX entry's ``--platforms`` becomes ``--device``: where the
checkpoint is loaded and the verifying call runs (``cuda`` unless
``--device cpu``; without a card that is an error).  The archive itself
holds host tensors and loads on either.  ``--bf16``, ``--conv_s2`` and
``--conv_nl`` set the configuration the archive serves in (default:
float32 on the default kernels, as the JAX entry exports).
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import torch

from cooperative_training_and_latent_space_data_augmentation_tpu_torch.train.checkpoint import (
    load_checkpoint_dir,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.train.predictor import (
    CooperativePredictor,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.utils.serving import (
    export_predictor,
    load_predictor,
)


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--checkpoint", type=str, default=None,
                   help="a directory of per-module .pth (the port's) or .msgpack (the JAX "
                        "package's) files; omit for weights from seed 0 (smoke)")
    p.add_argument("--out", type=str, required=True)
    p.add_argument("--network_type", type=str, default="FCN_16_standard")
    p.add_argument("--num_classes", type=int, default=4)
    p.add_argument("--image_ch", type=int, default=1)
    p.add_argument("--input_hw", nargs=2, type=int, default=[192, 192])
    p.add_argument("--n_iter", type=int, default=2,
                   help="1 = FTN only; k>=2 = FTN + (k-1) STN refinements")
    p.add_argument("--logits", action="store_true",
                   help="emit logits instead of softmax probabilities")
    p.add_argument("--bf16", action="store_true", help="serve with bf16 convs")
    p.add_argument("--conv_s2", action="store_true",
                   help="serve with the encoders' stride-2 downsamples on kernel K4")
    p.add_argument("--conv_nl", action="store_true",
                   help="serve with the residual stages' large-channel convs on kernel K5")
    p.add_argument("--device", type=str, default="cuda", help="'cuda' (default) or 'cpu'")
    p.add_argument("--verify_batch", type=int, default=2,
                   help="call the reloaded archive at this batch size (0 disables)")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> str:
    args = parse_args(argv)
    if args.device != "cpu" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device; pass --device cpu to "
                           f"export on the CPU")
    predictor = CooperativePredictor(
        image_ch=args.image_ch, num_classes=args.num_classes, n_iter=args.n_iter,
        compute_dtype=torch.bfloat16 if args.bf16 else None, device=args.device,
        seed=0, conv_s2=args.conv_s2, conv_nl=args.conv_nl,
        network_type=args.network_type)
    if args.checkpoint:
        load_checkpoint_dir(predictor, args.checkpoint)
    hw = tuple(args.input_hw)
    path = export_predictor(predictor, args.out, input_hw=hw, image_ch=args.image_ch,
                            n_iter=args.n_iter, softmax=not args.logits)
    print(f"exported {args.network_type} n_iter={args.n_iter} "
          f"{'bf16' if args.bf16 else 'float32'} conv_s2={args.conv_s2} "
          f"conv_nl={args.conv_nl} -> {path} ({os.path.getsize(path) / 1e6:.1f} MB)")
    if args.verify_batch:
        served = load_predictor(path, device=args.device)
        gen = torch.Generator().manual_seed(1)
        x = torch.rand((args.verify_batch, *hw, args.image_ch), generator=gen)
        out = served(x)
        print(f"verify: served(batch={args.verify_batch}) -> {tuple(out.shape)} "
              f"{out.dtype} on {out.device}")
    return path


if __name__ == "__main__":
    main()
