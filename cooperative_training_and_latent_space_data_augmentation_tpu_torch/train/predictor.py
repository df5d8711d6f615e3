"""The cooperative FTN+STN predictor: the serving path of the solver.

Counterpart of the eval-mode surface of the JAX package's
``train/cooperative.py:CooperativeTripletSolver``: the module plan of its
``__init__``, ``encode_image``, ``decode_segmentation``, ``fast_predict``,
``encode_shape``, ``decode_shape``, ``recon_shape``, ``predict`` and
``slow_refinement``.

Layouts: ``predict`` and ``slow_refinement`` keep the JAX layout, NHWC
(B, H, W, C) float32 in and out.  The building blocks in between
(``encode_image`` ... ``recon_shape``) take and return NCHW tensors, the
layout the modules compute in, so ``predict`` transposes only at its ends.
"""

from __future__ import annotations

import math
from contextlib import contextmanager
from typing import Dict, Mapping, Optional, Tuple, Union

import torch
import torch.nn as nn

from cooperative_training_and_latent_space_data_augmentation_tpu_torch.models.blocks import (
    BatchNorm,
    ConvTranspose2x2,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.models.encoder_decoder import (
    Decoder,
    DualBranchEncoder,
    Encoder,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.ops.conv_chw import Conv
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.ops.image import (
    construct_input,
)

MODULE_NAMES = (
    "image_encoder",
    "segmentation_decoder",
    "shape_encoder",
    "shape_decoder",
    "image_decoder",
)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2).contiguous()


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1).contiguous()


class CooperativePredictor(nn.Module):
    """The five subnetworks of the cooperative solver (the FCN_16_standard
    plan; the JAX package's two ablation variants are not ported), in eval
    mode, on ``device`` (``"cuda"`` unless the caller asks for ``"cpu"``).

    ``compute_dtype``: the conv stacks' dtype (``torch.bfloat16`` on the
    card; None keeps float32).  ``conv_s2``: the JAX package's
    ``PALLAS_CONV_S2`` configuration, off by default: the encoders'
    stride-2 downsamples with at most 64 channels run on kernel K4.
    ``conv_nl``: its ``PALLAS_CONV_NL`` configuration, off by default: the
    residual stages' 3x3 convs with 64..256 channels (the encoders' last
    two stages and the decoders' first) run on kernel K5; the code
    decoupler's stay on ``F.conv2d``, as in the JAX package.  The two
    combine freely.
    ``seed``: parameters are drawn from it (He normal convs, BN scale 1 +
    0.02 N(0, 1), zero biases, running stats 0 and 1, as the JAX package
    initialises); load trained weights with :meth:`load_state_dicts`.

    :meth:`predict` and :meth:`slow_refinement` always compute in eval mode
    (the JAX package's ``train=False``), whatever mode the modules are in.
    """

    def __init__(self, image_ch: int = 1, num_classes: int = 4, n_iter: int = 1,
                 temperature: float = 2.0, compute_dtype: Optional[torch.dtype] = None,
                 device: Union[str, torch.device] = "cuda", seed: int = 0,
                 conv_s2: bool = False, conv_nl: bool = False):
        super().__init__()
        self.num_classes = num_classes
        self.n_iter = n_iter
        self.temperature = temperature
        f = 4  # FCN_16: feature_reduce 4
        dt = compute_dtype
        self.image_encoder = DualBranchEncoder(image_ch, f, dt, conv_s2, conv_nl)
        self.segmentation_decoder = Decoder(num_classes, f, "NN", None, dt, conv_nl)
        self.shape_encoder = Encoder(num_classes, f, "relu", dt, conv_s2, conv_nl)
        self.shape_decoder = Decoder(num_classes, f, "NN", None, dt, conv_nl)
        self.image_decoder = Decoder(image_ch, f, "Conv2", "sigmoid", dt, conv_nl)
        init_parameters(self, seed)
        self.to(device)
        self.eval()

    def load_state_dicts(self, state_dicts: Mapping[str, Mapping[str, torch.Tensor]]):
        """Load ``{module_name: state_dict}`` (as :func:`..convert.from_jax`
        returns), strictly: every module, every key."""
        missing = set(MODULE_NAMES) - set(state_dicts)
        if missing:
            raise KeyError(f"state dicts missing for {sorted(missing)}")
        for name in MODULE_NAMES:
            getattr(self, name).load_state_dict(state_dicts[name])

    # --------------------------------------------------- NCHW building blocks
    def encode_image(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(z_i, z_s)."""
        return self.image_encoder(x)

    def decode_segmentation(self, z_s: torch.Tensor) -> torch.Tensor:
        return self.segmentation_decoder(z_s)

    def fast_predict(self, x: torch.Tensor):
        """((z_i, z_s), y0): the FTN forward."""
        z_i, z_s = self.encode_image(x)
        return (z_i, z_s), self.decode_segmentation(z_s)

    def encode_shape(self, logits: torch.Tensor) -> torch.Tensor:
        return self.shape_encoder(construct_input(logits, self.temperature))

    def decode_shape(self, z: torch.Tensor) -> torch.Tensor:
        return self.shape_decoder(z)

    def recon_shape(self, logits: torch.Tensor) -> torch.Tensor:
        """STN refinement S -> STN(softmax(S / T))."""
        return self.decode_shape(self.encode_shape(logits))

    # ------------------------------------------------------- NHWC serving
    @contextmanager
    def _eval_mode(self):
        """Every module in eval mode while the block runs (BatchNorm on its
        running statistics, which stay as they are), then each module back
        in its own mode, also when the block raises."""
        modes = [(m, m.training) for m in self.modules()]
        self.eval()
        try:
            yield
        finally:
            for m, training in modes:
                m.training = training

    @torch.inference_mode()
    def predict(self, x: torch.Tensor, n_iter: Optional[int] = None,
                softmax: bool = False) -> torch.Tensor:
        """FTN prediction + (n_iter - 1) STN refinements, in eval mode.

        x: (B, H, W, image_ch) float32 -> (B, H, W, num_classes) logits, or
        probabilities with ``softmax``.  As in the JAX package, each
        refinement re-applies the STN to the previous prediction.
        """
        n_iter = self.n_iter if n_iter is None else n_iter
        with self._eval_mode():
            _, pred = self.fast_predict(_nchw(x))
            for _ in range(max(0, n_iter - 1)):
                pred = self.recon_shape(pred)
        if softmax:
            pred = torch.softmax(pred, dim=1)
        return _nhwc(pred)

    @torch.inference_mode()
    def slow_refinement(self, pred_logit: torch.Tensor, n_steps: int = 1,
                        auto_stop: bool = False, tol: float = 1e-4,
                        save_internal_predicts: bool = False):
        """The reference's literal ``slow_refinement`` (see the JAX
        package's docstring), in eval mode: every step refines the ORIGINAL
        logits, so

        * n_steps == 0: the input;
        * no auto_stop: ``recon_shape(pred_logit)``;
        * auto_stop: the input where RMS(input - refined) < tol, else the
          refined logits.

        pred_logit is NHWC; ``save_internal_predicts`` also returns the
        reference's dict of per-step predictions.
        """
        internal: Dict[int, list] = {0: [pred_logit]}
        if n_steps < 1:
            return (pred_logit, internal) if save_internal_predicts else pred_logit
        with self._eval_mode():
            refined = _nhwc(self.recon_shape(_nchw(pred_logit)))
        if auto_stop:
            diff0 = torch.sqrt(torch.mean((pred_logit - refined) ** 2))
            s_t = torch.where(diff0 < tol, pred_logit, refined)
            internal[0] = [s_t]
            if n_steps >= 2:
                internal[1] = [s_t]
        else:
            s_t = refined
            for i in range(n_steps):
                internal[i] = [refined]
        return (s_t, internal) if save_internal_predicts else s_t


@torch.no_grad()
def init_parameters(model: nn.Module, seed: int) -> None:
    """Draw every parameter from ``seed`` on the CPU: He-normal conv
    kernels (std sqrt(2 / fan_in)), zero biases, BN scale 1 + 0.02 N(0, 1),
    BN bias 0, running mean 0 and variance 1."""
    gen = torch.Generator().manual_seed(seed)
    for m in model.modules():
        if isinstance(m, (Conv, ConvTranspose2x2)):
            w = m.weight
            fan_in = (w.shape[0] if isinstance(m, ConvTranspose2x2) else w.shape[1]) \
                * w.shape[2] * w.shape[3]
            w.copy_(torch.randn(w.shape, generator=gen) * math.sqrt(2.0 / fan_in))
            m.bias.zero_()
        elif isinstance(m, BatchNorm):
            m.weight.copy_(1.0 + 0.02 * torch.randn(m.weight.shape, generator=gen))
            m.bias.zero_()
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
