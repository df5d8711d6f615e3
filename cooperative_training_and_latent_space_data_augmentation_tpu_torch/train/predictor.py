"""The cooperative FTN+STN predictor: the serving path of the solver.

Counterpart of the eval-mode surface of the JAX package's
``train/cooperative.py:CooperativeTripletSolver``: the module plan of its
``__init__``, ``encode_image``, ``decode_segmentation``, ``fast_predict``,
``encode_shape``, ``decode_shape``, ``recon_shape``, ``predict`` and
``slow_refinement``.

Every module forward of the building blocks goes through
:meth:`CooperativePredictor.run`, where a train step hooks in
(``module_call``: dropout masks, rematerialisation).

Layouts: ``predict`` and ``slow_refinement`` keep the JAX layout, NHWC
(B, H, W, C) float32 in and out.  The building blocks in between
(``encode_image`` ... ``recon_shape``) take and return NCHW tensors, the
layout the modules compute in, so ``predict`` transposes only at its ends.
"""

from __future__ import annotations

import math
from contextlib import contextmanager
from typing import Callable, Dict, Mapping, Optional, Tuple, Union

import torch
import torch.nn as nn

from cooperative_training_and_latent_space_data_augmentation_tpu_torch.eval.metrics import (
    confusion_matrix_update,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.models.blocks import (
    BatchNorm,
    ConvTranspose,
    SNConv,
    power_iteration,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.models.encoder_decoder import (
    Decoder,
    DualBranchEncoder,
    Encoder,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.models.layers import (
    BatchInstanceNorm,
    BiasedBatchNorm,
    PlainConv,
    SelfAttention,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.models.unet3d import Conv3d
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.ops.conv_chw import Conv
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.ops.image import (
    construct_input,
    one_hot,
)

MODULE_NAMES = (
    "image_encoder",
    "segmentation_decoder",
    "shape_encoder",
    "shape_decoder",
    "image_decoder",
)

NETWORK_TYPES = (
    "FCN_16_standard",
    "FCN_16_standard_share_code",  # ablation: z_i := z_s
    "FCN_16_standard_w_o_filter",  # ablation: z_s := z_i
)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2).contiguous()


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1).contiguous()


class CooperativePredictor(nn.Module):
    """The five subnetworks of the cooperative solver, in eval mode, on
    ``device`` (``"cuda"`` unless the caller asks for ``"cpu"``).

    ``network_type``: one of :data:`NETWORK_TYPES`, the FCN_16 plan and the
    JAX package's two ablations, which share the modules and differ in
    :meth:`encode_image` only: ``_share_code`` decodes the image from the
    filtered code (z_i := z_s), ``_w_o_filter`` segments from the unfiltered
    one (z_s := z_i).  ``encoder_dropout``, ``decoder_dropout``: the rates of
    the channel dropout after each residual stage of the encoders and of
    the decoders (None: none), active in train mode only.

    ``compute_dtype``: the conv stacks' dtype (``torch.bfloat16`` on the
    card; None keeps float32).  ``conv_s2``: the JAX package's
    ``PALLAS_CONV_S2`` configuration, off by default: the encoders'
    stride-2 downsamples with at most 64 channels run on kernel K4.
    ``conv_nl``: its ``PALLAS_CONV_NL`` configuration, off by default: the
    residual stages' 3x3 convs with 64..256 channels (the encoders' last
    two stages and the decoders' first) run on kernel K5; the code
    decoupler's stay on ``F.conv2d``, as in the JAX package.  The two
    combine freely.
    ``seed``: parameters are drawn from it by :func:`init_parameters`
    (from the JAX package's initial distributions, not from its random
    numbers); load trained weights with :meth:`load_state_dicts`.

    :meth:`predict` and :meth:`slow_refinement` always compute in eval mode
    (the JAX package's ``train=False``), whatever mode the modules are in.
    """

    def __init__(self, image_ch: int = 1, num_classes: int = 4, n_iter: int = 1,
                 temperature: float = 2.0, compute_dtype: Optional[torch.dtype] = None,
                 device: Union[str, torch.device] = "cuda", seed: int = 0,
                 conv_s2: bool = False, conv_nl: bool = False,
                 network_type: str = "FCN_16_standard",
                 encoder_dropout: Optional[float] = None,
                 decoder_dropout: Optional[float] = None):
        super().__init__()
        if network_type not in NETWORK_TYPES:
            raise ValueError(f"network_type {network_type!r}: not one of {NETWORK_TYPES}")
        self.network_type = network_type
        self.image_ch = image_ch
        self.num_classes = num_classes
        self.n_iter = n_iter
        self.temperature = temperature
        self.compute_dtype = compute_dtype
        self.conv_s2 = conv_s2
        self.conv_nl = conv_nl
        f = 4  # FCN_16: feature_reduce 4
        dt, ed, dd = compute_dtype, encoder_dropout, decoder_dropout
        self.image_encoder = DualBranchEncoder(image_ch, f, dt, conv_s2, conv_nl, ed)
        self.segmentation_decoder = Decoder(num_classes, f, "NN", None, dt, conv_nl, dd)
        self.shape_encoder = Encoder(num_classes, f, "relu", dt, conv_s2, conv_nl, ed)
        self.shape_decoder = Decoder(num_classes, f, "NN", None, dt, conv_nl, dd)
        self.image_decoder = Decoder(image_ch, f, "Conv2", "sigmoid", dt, conv_nl, dd)
        # a train step's hook around each module forward: (name, x) -> output
        self.module_call: Optional[Callable] = None
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
    def run(self, name: str, x: torch.Tensor):
        """The module ``name`` on ``x``, through ``module_call`` when a train
        step has set it."""
        if self.module_call is not None:
            return self.module_call(name, x)
        return getattr(self, name)(x)

    def encode_image(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(z_i, z_s), with the network type's code sharing."""
        z_i, z_s = self.run("image_encoder", x)
        if self.network_type == "FCN_16_standard_share_code":
            z_i = z_s
        elif self.network_type == "FCN_16_standard_w_o_filter":
            z_s = z_i
        return z_i, z_s

    def decode_segmentation(self, z_s: torch.Tensor) -> torch.Tensor:
        return self.run("segmentation_decoder", z_s)

    def decode_image(self, z_i: torch.Tensor) -> torch.Tensor:
        return self.run("image_decoder", z_i)

    def fast_predict(self, x: torch.Tensor):
        """((z_i, z_s), y0): the FTN forward."""
        z_i, z_s = self.encode_image(x)
        return (z_i, z_s), self.decode_segmentation(z_s)

    def encode_shape(self, logits: torch.Tensor) -> torch.Tensor:
        return self.run("shape_encoder", construct_input(logits, self.temperature))

    def encode_label(self, labels: torch.Tensor) -> torch.Tensor:
        """The STN encoder on (N, H, W) integer labels, one-hot."""
        return self.run("shape_encoder", one_hot(labels, self.num_classes))

    def decode_shape(self, z: torch.Tensor) -> torch.Tensor:
        return self.run("shape_decoder", z)

    def recon_shape(self, logits: torch.Tensor) -> torch.Tensor:
        """STN refinement S -> STN(softmax(S / T))."""
        return self.decode_shape(self.encode_shape(logits))

    # ------------------------------------------------------- NHWC serving
    @contextmanager
    def in_mode(self, training: bool = False):
        """Every module in train mode (``training``) or eval mode (BatchNorm
        on its running statistics, which stay as they are) while the block
        runs, then each module back in its own mode, also when the block
        raises."""
        modes = [(m, m.training) for m in self.modules()]
        self.train(training)
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
        with self.in_mode():
            _, pred = self.fast_predict(_nchw(x))
            for _ in range(max(0, n_iter - 1)):
                pred = self.recon_shape(pred)
        if softmax:
            pred = torch.softmax(pred, dim=1)
        return _nhwc(pred)

    @torch.inference_mode()
    def validation_confusion(self, images: torch.Tensor, labels: torch.Tensor,
                             real: torch.Tensor, n_iter: int = 2) -> torch.Tensor:
        """Validation over a stacked evaluation epoch, the JAX package's
        ``multi_epoch.py:eval_confusion``: images (Nb, B, H, W, C), labels
        (Nb, B, H, W) integer, real (Nb,) the real rows of each batch (a
        device tensor); ``predict(n_iter)``, the argmax and the confusion
        matrix of the rows below each batch's real count, (C, C) int64 on
        the device.  Reads nothing back, so it can be captured into a CUDA
        graph (``train/graphs.py:ValidationGraph``)."""
        c = self.num_classes
        confusion = torch.zeros((c, c), dtype=torch.int64, device=images.device)
        rows = torch.arange(images.shape[1], device=images.device).view(-1, 1, 1)
        for b in range(images.shape[0]):
            pred = self.predict(images[b], n_iter=n_iter).argmax(-1)
            # wrap-padded rows get label -1, which the update does not count
            label = torch.where(rows < real[b], labels[b], -1)
            confusion = confusion_matrix_update(confusion, label, pred)
        return confusion

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
        with self.in_mode():
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


# flax's he_normal: a normal truncated at +-2 of its std, the std scaled up
# by 1 / 0.87962566..., the std of that truncated unit normal, so that the
# variance stays 2 / fan_in (jax.nn.initializers.variance_scaling)
TRUNC_STD = 0.87962566103423978
TRUNC_CUT = 2.0


def _unit_normal(gen: torch.Generator, shape, cut: Optional[float] = None) -> torch.Tensor:
    """Float64 unit normals by the inverse CDF of float64 uniforms from the
    CPU generator ``gen``, truncated to [-cut, cut] when ``cut`` is given.

    Written out here rather than taken from ``torch.nn.init.trunc_normal_``
    or ``torch.randn``, whose algorithms change between torch releases (a
    rejection sampler in one, an inverse CDF in another): a seed gives the
    same numbers under every torch version, so a model drawn on one machine
    equals the one drawn on another."""
    lo = 0.0 if cut is None else 0.5 * (1.0 + math.erf(-cut / math.sqrt(2.0)))
    hi = 1.0 if cut is None else 0.5 * (1.0 + math.erf(cut / math.sqrt(2.0)))
    u = torch.rand(shape, generator=gen, dtype=torch.float64)
    # keep 2 v - 1 inside (-1, 1): erfinv(-1) is -inf
    v = (lo + (hi - lo) * u).clamp(1e-300, 1.0 - 2.0 ** -53)
    z = math.sqrt(2.0) * torch.erfinv(2.0 * v - 1.0)
    return z if cut is None else z.clamp(-cut, cut)


def _truncated(gen: torch.Generator, w: torch.Tensor, variance: float) -> None:
    """Fill ``w`` from a normal truncated at +-2 of its underlying std,
    scaled so that its variance is ``variance`` (flax's truncated
    ``variance_scaling``)."""
    w.copy_(math.sqrt(variance) / TRUNC_STD * _unit_normal(gen, w.shape, TRUNC_CUT))


@torch.no_grad()
def init_parameters(model: nn.Module, seed: int) -> None:
    """Draw every parameter from ``seed`` on the CPU, module by module, from
    the distributions the JAX package draws from (``models/blocks.py:
    49,79-82`` and flax's defaults):

    * each conv and transposed-conv kernel of the JAX package's
      ``conv_kernel_init`` (:class:`Conv`, :class:`SNConv`,
      :class:`ConvTranspose`, :class:`Conv3d`) from flax's ``he_normal``, a
      normal of std ``s = sqrt(2 / fan_in) / 0.8796...`` truncated at
      +-2 s, so its variance is 2 / fan_in and no weight exceeds 2.274
      sqrt(2 / fan_in) (fan_in = C_in x the kernel's taps for all: flax
      reads a transposed kernel's (..., C_in, C_out) with ``in_axis=-2``);
      a spectrally normalised conv's ``u`` from N(0, 1), its ``sigma`` 1,
      and its kernel divided by the sigma of one power iteration from that
      ``u`` (flax's ``SpectralNorm`` stores the normalised kernel at init,
      with the statistics left as drawn: the JAX solver inits in eval
      mode);
    * each stock flax ``nn.Conv`` or ``nn.Dense`` (:class:`PlainConv`,
      ``nn.Linear``) from flax's ``lecun_normal``, the same truncated
      normal at variance 1 / fan_in;
    * zero biases;
    * the JAX package's BatchNorm (:class:`BatchNorm`): scale 1 + 0.02
      N(0, 1), bias 0, running mean 0 and variance 1;
    * flax's ``nn.BatchNorm`` (:class:`BiasedBatchNorm`): scale 1, bias 0,
      running mean 0 and variance 1; :class:`BatchInstanceNorm`'s rho and
      gamma 1, beta 0; :class:`SelfAttention`'s gamma 0.

    The normals come from :func:`_unit_normal`, so a seed gives the same
    weights under any torch version."""
    gen = torch.Generator().manual_seed(seed)
    for m in model.modules():
        if isinstance(m, (PlainConv, nn.Linear)):
            w = m.weight
            _truncated(gen, w, 1.0 / (w.shape[1] * math.prod(w.shape[2:])))
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (Conv, ConvTranspose, Conv3d)):
            w = m.weight
            c_in = w.shape[0] if isinstance(m, ConvTranspose) else w.shape[1]
            _truncated(gen, w, 2.0 / (c_in * math.prod(w.shape[2:])))
            m.bias.zero_()
            if isinstance(m, SNConv) and m.if_SN:
                m.u.copy_(_unit_normal(gen, m.u.shape))
                m.sigma.fill_(1.0)
                w.div_(power_iteration(w, m.u)[0])
        elif isinstance(m, BatchNorm):
            m.weight.copy_(1.0 + 0.02 * _unit_normal(gen, m.weight.shape))
            m.bias.zero_()
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
        elif isinstance(m, BiasedBatchNorm):
            if m.weight is not None:
                m.weight.fill_(1.0)
                m.bias.zero_()
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
        elif isinstance(m, BatchInstanceNorm):
            m.rho.fill_(1.0)
            m.gamma.fill_(1.0)
            m.beta.zero_()
        elif isinstance(m, SelfAttention):
            m.gamma.zero_()
