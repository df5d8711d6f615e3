"""The cooperative train step: FTN+STN training with latent-space data
augmentation.

Counterpart of the training surface of the JAX package's
``train/cooperative.py:CooperativeTripletSolver``: ``standard_training``,
``_frozen_decoder_fn``, ``hard_example_generation`` (with its
``SALIENCY_BN_UPDATE=1`` arm as the ``saliency_bn_update`` keyword),
``hard_example_training`` and the three loss paths of ``make_train_step``
(the sequential one, and its ``FUSED_STN`` and ``FUSED_FTN`` arms, which
stack passes along the batch axis), for every configuration its
``cli/train.py`` accepts: the three network types, ``separate_training``
(the STN's input detached, so its loss does not train the FTN), layer
dropout and ``remat``.  One
:meth:`CooperativeTrainer.train_step` is one jitted JAX step: input noise
and clip, the four standard losses (BN running statistics updated),
hard-example generation by latent masking through frozen decoders, the
four hard losses (BN statistics frozen), one backward over the sum and one
Adam update of all five subnetworks.

Layouts: :meth:`~CooperativeTrainer.train_step` takes the JAX batch
layout, an (N, H, W, 1) float32 image and (N, H, W) integer labels; the
other methods take NCHW tensors.  Random draws come in as a
:class:`..train.draws.StepDraws`.

Every module forward of a step goes through :meth:`CooperativeTrainer.
_module_call` (the predictor's ``module_call`` hook): it hands the module
its dropout masks, the next ones of ``StepDraws.dropout``, and with
``remat`` wraps the forward in ``torch.utils.checkpoint`` (the JAX
package's ``jax.checkpoint`` around each submodule apply), the recompute
running with BN statistics frozen so that they move once, as the JAX
package's pure recompute leaves them.

Every step on the card runs cuDNN's deterministic algorithms
(``torch.backends.cudnn.deterministic`` for the step's forward and
backward): by default cuDNN may pick backward algorithms that sum with
atomics, and two eager steps on one card then part after the first update
(measured on an H100, ``PERF.md``), so a seed's run would not repeat, no
replay could be held to an eager step, nor a fused epoch to the streaming
loop, bit for bit.  With ``capturable=True`` the step can also be
captured into a CUDA graph (:mod:`.graphs`): Adam keeps its step count and
bias correction on the device, and nothing in
:meth:`CooperativeTrainer.train_step` reads the device back or branches on
a device value.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple, Union

import torch
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from cooperative_training_and_latent_space_data_augmentation_tpu_torch.config import (
    LatentDAConfig,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.convert import TrainState
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.models.blocks import (
    ResCore,
    dropout_masks,
    frozen_stats,
    stacked_flags,
    stacked_passes,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.ops.conv_chw import (
    Conv,
    deterministic_cudnn,
    full_f32,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.ops.image import (
    construct_input,
    one_hot,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.ops.losses import (
    cross_entropy_2d,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.ops.masking import (
    perturb_latent_code,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.train.draws import (
    StepDraws,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.train.predictor import (
    MODULE_NAMES,
    CooperativePredictor,
)


# the step's metrics in the order the fused paths stack them: the nine
# losses the loop logs (train...py:164-166), then their sum
METRIC_KEYS = (
    "loss/standard/total", "loss/standard/seg", "loss/standard/image",
    "loss/standard/shape", "loss/standard/gt_shape",
    "loss/hard/total", "loss/hard/seg", "loss/hard/image", "loss/hard/shape",
    "loss/total",
)


@dataclass
class Generation:
    """What hard-example generation did to one code: the branch (0
    dropout, 1 spatial, 2 channel), the mask broadcast to the code's shape
    and, for a targeted branch, the saliency the mask thresholded."""

    branch: int
    mask: torch.Tensor
    saliency: Optional[torch.Tensor]


class CooperativeTrainer:
    """The five subnetworks of a :class:`CooperativePredictor` in train
    mode and one ``torch.optim.Adam`` over all their parameters (not the BN
    buffers): optax's ``adam(learning_rate)``, whose defaults (b1 0.9, b2
    0.999, eps 1e-8) are torch's.

    ``latent_da``: the latent DA configuration (None trains without hard
    examples).  ``compute_dtype``, ``device`` (``"cuda"`` unless the caller
    asks for ``"cpu"``), ``seed``, ``conv_s2`` (the JAX package's
    ``PALLAS_CONV_S2``: the encoders' stride-2 downsamples on kernel K4),
    ``conv_nl`` (its ``PALLAS_CONV_NL``: the residual stages' large-channel
    3x3 convs on kernel K5), ``network_type``, ``encoder_dropout`` and
    ``decoder_dropout`` are the predictor's.  ``separate_training``: the
    STN reads the FTN's prediction detached, in the standard and the hard
    pass.  ``remat``: rematerialise each module forward in the backward.
    ``saliency_bn_update``: each perturbed code's decoder also runs once on
    the unmasked code with its BN statistics tracked, kept where the branch
    was targeted (the JAX package's ``SALIENCY_BN_UPDATE=1``, the
    reference's raw train-mode saliency forward).  ``capturable``: Adam
    built with ``capturable=True`` (its step on the parameters' device), so
    that :meth:`train_step` can be captured into a CUDA graph
    (:class:`.graphs.StepGraphs`) and its replays give the eager step's
    numbers bit for bit; the card only, since capturable Adam refuses CPU
    parameters.  Every step whose parameters are on the card runs on
    cuDNN's deterministic algorithms, capturable or not.

    ``fused_stn`` (the JAX package's ``FUSED_STN=1``): the STN's passes of
    a step (the ground-truth recon, the predicted recon and, with latent
    DA, the hard prediction's and the perturbed segmentation's recons) run
    as one batch stacked along the batch axis, their BatchNorms on
    per-pass statistics (:func:`..models.blocks.stacked_passes`).
    ``fused_ftn`` (``FUSED_FTN=1``): a value-only encoder pre-pass feeds
    generation, then the standard and the hard FTN pass run as one stacked
    batch of 2N and the STN passes sequentially, JAX's fused order.  As in
    the JAX package, both are off with layer dropout, ``fused_ftn`` needs
    latent DA on the image code, and ``fused_ftn`` wins when both are
    asked for; the attributes hold what is on.  Both draw what the
    sequential step draws.

    ``mesh`` (None; set by ``parallel/mesh.py:shard_train_step``): the
    step is one rank's part of a data-parallel step.  It takes the rank's
    rows of the batch and of the draws (``draws.shard_draws``), its
    BatchNorms reduce over the global batch, the gradients are averaged
    over the ranks (one all-reduce a dtype) after the backward and before
    Adam, the zero-filled ones of unreached modules too, and each metric
    comes back as its mean over the ranks.  Each rank's loss is its
    shard's mean, so the saliency of targeted masking is W times the
    one-process one (see the mesh module) and the masks are the same.

    ``generation`` holds the last step's :class:`Generation` per code.
    Under a CUDA graph it is set once, when the graph is captured, and
    holds that graph's output tensors, which every later replay (of any
    graph sharing its memory pool) overwrites: read it only right after
    an uncaptured step.
    """

    def __init__(self, latent_da: Optional[LatentDAConfig], *, input_noise_std: float = 0.05,
                 learning_rate: float = 1e-4, compute_dtype: Optional[torch.dtype] = None,
                 device: Union[str, torch.device] = "cuda", seed: int = 0,
                 image_ch: int = 1, num_classes: int = 4, temperature: float = 2.0,
                 conv_s2: bool = False, conv_nl: bool = False,
                 network_type: str = "FCN_16_standard",
                 encoder_dropout: Optional[float] = None,
                 decoder_dropout: Optional[float] = None, separate_training: bool = False,
                 remat: bool = False, saliency_bn_update: bool = False,
                 capturable: bool = False, fused_stn: bool = False, fused_ftn: bool = False):
        self.model = CooperativePredictor(image_ch=image_ch, num_classes=num_classes,
                                          temperature=temperature,
                                          compute_dtype=compute_dtype, device=device,
                                          seed=seed, conv_s2=conv_s2, conv_nl=conv_nl,
                                          network_type=network_type,
                                          encoder_dropout=encoder_dropout,
                                          decoder_dropout=decoder_dropout)
        self.model.train()
        self.latent_da = latent_da
        self.input_noise_std = input_noise_std
        self.num_classes = num_classes
        self.separate_training = separate_training
        self.remat = remat
        self.saliency_bn_update = saliency_bn_update
        self.capturable = capturable
        self.optimizer = torch.optim.Adam(self.model.parameters(), lr=learning_rate,
                                          capturable=capturable)
        # the last step's generation per code ("image", "shape"), for checks
        self.generation: Dict[str, Generation] = {}
        # {module: (rate, the channels of each of its dropout sites in forward
        # order)} for the modules with layer dropout: what
        # draw_step(dropout_sites=...) draws masks for
        self.dropout_sites = self._dropout_sites(self.model)
        # JAX's gates (make_train_step): no per-pass dropout draws in the
        # fused arms, the 2N FTN batch only with a hard image pass
        self.fused_ftn = bool(fused_ftn and not self.dropout_sites and self.use_latent_da
                              and latent_da.gen_corrupted_image)
        self.fused_stn = bool(fused_stn and not self.dropout_sites and not self.fused_ftn)
        self._masks: List[torch.Tensor] = []
        self._used = 0
        self.mesh = None

    @property
    def use_latent_da(self) -> bool:
        lda = self.latent_da
        return lda is not None and (lda.gen_corrupted_image or lda.gen_corrupted_seg)

    @staticmethod
    def _dropout_sites(model: CooperativePredictor) -> Dict[str, Tuple[float, List[int]]]:
        out = {}
        for name in MODULE_NAMES:
            cores = [c for c in getattr(model, name).modules()
                     if isinstance(c, ResCore) and c.dropout is not None]
            if cores:
                out[name] = (cores[0].dropout, [c.conv_input.weight.shape[0] for c in cores])
        return out

    def draw_kwargs(self) -> Dict[str, object]:
        """The keywords of ``draw_step`` this trainer's steps need (none on
        the main path)."""
        kw: Dict[str, object] = {}
        if self.dropout_sites:
            kw["dropout_sites"] = self.dropout_sites
        if self.saliency_bn_update:
            kw["saliency_bn_update"] = True
        return kw

    def _zero(self) -> torch.Tensor:
        return torch.zeros((), device=next(self.model.parameters()).device)

    # ------------------------------------------------------ module forwards
    def _take_masks(self, name: str) -> List[torch.Tensor]:
        """The next dropout masks of the step, as many as ``name`` has sites."""
        sites = self.dropout_sites.get(name)
        if sites is None:
            return []
        k = len(sites[1])
        if self._used + k > len(self._masks):
            raise RuntimeError(f"dropout: the step's {len(self._masks)} keep masks ran out at "
                               f"a forward of {name}")
        masks = self._masks[self._used:self._used + k]
        self._used += k
        return masks

    def _module_call(self, name: str, x: torch.Tensor):
        """One module forward of the loss graph: its dropout masks and,
        with ``remat`` where a gradient is taken, the checkpointed forward
        whose recompute leaves the BN statistics alone."""
        module = getattr(self.model, name)
        masks = self._take_masks(name)
        if not (self.remat and torch.is_grad_enabled()):
            with dropout_masks(masks):
                return module(x)
        calls = []
        passes = stacked_flags(module)  # a stacked batch's recompute is stacked too

        def fwd(x):
            calls.append(1)
            with (frozen_stats(module) if len(calls) > 1 else contextlib.nullcontext()), \
                    stacked_passes(module, update_flags=passes), dropout_masks(masks):
                return module(x)

        # the forward draws nothing (draws are operands), so no RNG state is
        # stashed for the recompute, which also keeps it capturable
        return checkpoint(fwd, x, use_reentrant=False, preserve_rng_state=False)

    # ------------------------------------------------------------ losses
    def standard_training(self, clean: torch.Tensor, label: torch.Tensor,
                          perturbed: torch.Tensor, compute_gt_recon: bool = True,
                          update_stats: bool = True):
        """The four standard losses on NCHW images and (N, H, W) labels:
        returns ({"seg", "image", "gt_shape", "shape"}, (z_i, z_s)).  With
        ``update_stats`` the BN running statistics move, the shape encoder
        and decoder twice (ground-truth recon, then predicted recon)."""
        m = self.model
        with contextlib.nullcontext() if update_stats else frozen_stats(m):
            (z_i, z_s), y0 = m.fast_predict(perturbed)
            seg = cross_entropy_2d(y0, label)
            image = 0.5 * torch.mean((m.decode_image(z_i) - clean) ** 2)
            gt_shape = self._zero()
            if compute_gt_recon:
                gt_shape = cross_entropy_2d(m.decode_shape(m.encode_label(label)), label)
            y0_in = y0.detach() if self.separate_training else y0
            shape = cross_entropy_2d(m.recon_shape(y0_in), label)
        return {"seg": seg, "image": image, "gt_shape": gt_shape, "shape": shape}, (z_i, z_s)

    def _frozen_decoder(self, name: str):
        """The decoder ``name`` with detached parameters (no parameter
        gradient, so no K2 launch and no ``.grad``) and frozen BN
        statistics: the JAX package's ``_frozen_decoder_fn``.  Each call
        takes its own dropout masks."""
        module = getattr(self.model, name)
        frozen = {k: v.detach() for k, v in module.named_parameters()}

        def fn(z: torch.Tensor) -> torch.Tensor:
            with frozen_stats(module), dropout_masks(self._take_masks(name)):
                return functional_call(module, frozen, (z,))

        return fn

    def hard_example_generation(self, z_i: torch.Tensor, z_s: torch.Tensor,
                                clean: torch.Tensor, label: torch.Tensor,
                                draws: StepDraws):
        """Perturb the latent codes and decode them: returns
        (perturbed_image or None, perturbed segmentation logits or None),
        both detached, and records each code's :class:`Generation` in
        ``self.generation``."""
        lda = self.latent_da
        self.generation = {}
        perturbed = {"image": None, "shape": None}
        plan = (("image", lda.gen_corrupted_image, "image_decoder", z_i, clean,
                 lda.image_code, draws.image),
                ("shape", lda.gen_corrupted_seg, "segmentation_decoder", z_s, label,
                 lda.shape_code, draws.shape))
        for key, on, decoder, code, target, settings, code_draws in plan:
            if not on:
                continue
            dec = self._frozen_decoder(decoder)
            masked, mask, saliency = perturb_latent_code(
                code.detach(), dec, target, settings, code_draws, self.num_classes)
            with torch.no_grad():
                perturbed[key] = dec(masked)
            if self.saliency_bn_update:
                self._saliency_stats(decoder, code.detach(), code_draws.branch)
            self.generation[key] = Generation(code_draws.branch, mask, saliency)
        return perturbed["image"], perturbed["shape"]

    @torch.no_grad()
    def _saliency_stats(self, name: str, code: torch.Tensor, branch: int) -> None:
        """The ``saliency_bn_update`` arm: the decoder ``name`` once on the
        unmasked code in train mode, its BN running statistics moved where
        ``branch`` was targeted (a dropout branch runs no saliency forward),
        its dropout masks taken either way."""
        module = getattr(self.model, name)
        with (contextlib.nullcontext() if branch != 0 else frozen_stats(module)), \
                dropout_masks(self._take_masks(name)):
            module(code)

    def hard_example_training(self, perturbed_image: Optional[torch.Tensor],
                              clean: torch.Tensor, perturbed_seg: Optional[torch.Tensor],
                              label: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The four hard losses, BN statistics frozen: {"seg", "image",
        "shape", "perturbed_shape"} (zero where no hard example was made)."""
        zero = self._zero()
        out = {"seg": zero, "image": zero, "shape": zero, "perturbed_shape": zero}
        if perturbed_image is not None:
            std, _ = self.standard_training(clean, label, perturbed_image.detach(),
                                            compute_gt_recon=False, update_stats=False)
            out["seg"], out["image"], out["shape"] = std["seg"], std["image"], std["shape"]
        if perturbed_seg is not None:
            with frozen_stats(self.model):
                recon = self.model.recon_shape(perturbed_seg.detach())
            out["perturbed_shape"] = cross_entropy_2d(recon, label)
        return out

    # -------------------------------------------------------------- step
    def train_step(self, image: torch.Tensor, label: torch.Tensor,
                   draws: StepDraws) -> Dict[str, torch.Tensor]:
        """One cooperative step on an (N, H, W, 1) float32 image and (N, H,
        W) integer labels with ``draws`` (on the model's device).  Returns
        the JAX step's metrics under its keys, as 0-d device tensors; reads
        nothing back to the host.  With layer dropout the step uses every
        mask of ``draws.dropout`` (``RuntimeError`` otherwise).  Under a
        ``mesh``: this rank's rows of the batch and of the draws."""
        clean = image.permute(0, 3, 1, 2).contiguous()
        label = label.long()
        noised = torch.clamp(clean + self.input_noise_std * draws.noise, 0.0, 1.0)
        self.optimizer.zero_grad(set_to_none=True)
        if self.dropout_sites and draws.dropout is None:
            raise RuntimeError("layer dropout: the step's draws carry no keep masks "
                               "(draw_step(dropout_sites=trainer.dropout_sites))")
        self._masks, self._used = list(draws.dropout or []), 0
        self.model.module_call = self._module_call
        losses = (self._losses_fused_ftn if self.fused_ftn
                  else self._losses_fused_stn if self.fused_stn else self._losses)
        on_card = clean.is_cuda
        try:
            with deterministic_cudnn(on_card):
                total, metrics = losses(clean, label, noised, draws)
        finally:
            self.model.module_call = None
        if self._used != len(self._masks):
            raise RuntimeError(f"dropout: the step used {self._used} of its "
                               f"{len(self._masks)} keep masks")
        # the backward of the f32 cuDNN convs in full f32, too
        with full_f32(torch.float32), deterministic_cudnn(on_card):
            total.backward()
        for p in self.model.parameters():
            if p.grad is None:  # a module the loss does not reach (the code
                p.grad = torch.zeros_like(p)  # decoupler without a filter): optax's zero step
        if self.mesh is not None:  # the JAX package's gradient psum
            self.mesh.average_([p.grad for p in self.model.parameters()])
        self.optimizer.step()
        metrics = {k: v.detach() for k, v in metrics.items()}
        if self.mesh is not None:
            values = torch.stack([metrics[k] for k in METRIC_KEYS])
            self.mesh.average_([values])
            metrics = dict(zip(METRIC_KEYS, values.unbind()))
        return metrics

    def _losses(self, clean, label, noised, draws):
        std, (z_i, z_s) = self.standard_training(clean, label, noised)
        zero = self._zero()
        hard = {"seg": zero, "image": zero, "shape": zero, "perturbed_shape": zero}
        if self.use_latent_da:
            p_img, p_seg = self.hard_example_generation(z_i, z_s, clean, label, draws)
            hard = self.hard_example_training(p_img, clean, p_seg, label)
        return self._metrics(std["seg"], std["image"], std["shape"], std["gt_shape"],
                             hard["seg"], hard["image"], hard["shape"],
                             hard["perturbed_shape"])

    @staticmethod
    def _metrics(std_seg, std_image, std_shape, std_gt_shape, hard_seg, hard_image,
                 hard_shape, hard_perturbed):
        """(total, metrics) from the eight loss terms (``hard_shape``: the
        hard prediction's recon, ``hard_perturbed``: the perturbed
        segmentation's), summed in the JAX package's order."""
        standard = std_seg + std_image + std_shape + std_gt_shape
        hard = hard_seg + hard_image + hard_shape + hard_perturbed
        total = standard + hard
        return total, {
            "loss/standard/total": standard, "loss/standard/seg": std_seg,
            "loss/standard/image": std_image, "loss/standard/shape": std_shape,
            "loss/standard/gt_shape": std_gt_shape, "loss/hard/total": hard,
            "loss/hard/seg": hard_seg, "loss/hard/image": hard_image,
            "loss/hard/shape": hard_shape + hard_perturbed, "loss/total": total}

    def _stn_input(self, logits: torch.Tensor) -> torch.Tensor:
        """The STN's input from FTN logits (detached under
        ``separate_training``)."""
        return construct_input(logits.detach() if self.separate_training else logits,
                               self.model.temperature)

    def _losses_fused_stn(self, clean, label, noised, draws):
        """The JAX package's ``loss_fn_fused``: the standard FTN pass
        (statistics moved), generation, the hard FTN pass (statistics
        frozen), then every STN pass [ground truth, prediction, hard
        prediction, perturbed segmentation] as one stacked batch, flags
        (True, True, False, False).  No STN input depends on an STN output,
        and the hard passes move no statistics, so the sums and the
        statistics are the sequential path's."""
        m = self.model
        (z_i, z_s), y0 = m.fast_predict(noised)
        std_seg = cross_entropy_2d(y0, label)
        std_image = 0.5 * torch.mean((m.decode_image(z_i) - clean) ** 2)
        p_img = p_seg = None
        if self.use_latent_da:
            p_img, p_seg = self.hard_example_generation(z_i, z_s, clean, label, draws)
        hard_seg = hard_image = self._zero()
        passes, flags = [one_hot(label, self.num_classes), self._stn_input(y0)], [True, True]
        if p_img is not None:
            with frozen_stats(m):
                (zi_h, _), y0_h = m.fast_predict(p_img.detach())
                hard_seg = cross_entropy_2d(y0_h, label)
                hard_image = 0.5 * torch.mean((m.decode_image(zi_h) - clean) ** 2)
            passes.append(self._stn_input(y0_h))
            flags.append(False)
        if p_seg is not None:
            passes.append(construct_input(p_seg.detach(), m.temperature))
            flags.append(False)
        with stacked_passes(m.shape_encoder, m.shape_decoder, update_flags=flags):
            recons = m.decode_shape(m.run("shape_encoder", torch.cat(passes)))
        ce = [cross_entropy_2d(r, label) for r in recons.chunk(len(passes))]
        zero = self._zero()
        hard_shape = ce[2] if p_img is not None else zero
        hard_perturbed = ce[-1] if p_seg is not None else zero
        return self._metrics(std_seg, std_image, ce[1], ce[0], hard_seg, hard_image,
                             hard_shape, hard_perturbed)

    def _losses_fused_ftn(self, clean, label, noised, draws):
        """The JAX package's ``loss_fn_fused_ftn``, in its order: a
        value-only encoder pre-pass (statistics frozen) whose latents feed
        generation (which moves the decoders' statistics first under
        ``saliency_bn_update``), the standard and the hard FTN pass as one
        stacked batch of 2N, flags (True, False), then the STN passes
        sequentially.  The pre-pass latents equal the standard half's to
        f32 reordering only, so a targeted mask next to its threshold may
        differ from the sequential step's."""
        m = self.model
        with torch.no_grad(), frozen_stats(m.image_encoder):
            z_i0, z_s0 = m.encode_image(noised)
        p_img, p_seg = self.hard_example_generation(z_i0, z_s0, clean, label, draws)
        ftn = (m.image_encoder, m.segmentation_decoder, m.image_decoder)
        with stacked_passes(*ftn, update_flags=(True, False)):
            (z_i, _), y = m.fast_predict(torch.cat([noised, p_img.detach().to(noised.dtype)]))
            recon = m.decode_image(z_i)
        y0, y0_h = y.chunk(2)
        std_image, hard_image = (0.5 * torch.mean((r - clean) ** 2) for r in recon.chunk(2))
        std_gt_shape = cross_entropy_2d(m.decode_shape(m.encode_label(label)), label)
        std_shape = cross_entropy_2d(m.decode_shape(m.run("shape_encoder",
                                                          self._stn_input(y0))), label)
        with frozen_stats(m):
            hard_shape = cross_entropy_2d(m.decode_shape(m.run("shape_encoder",
                                                               self._stn_input(y0_h))), label)
            hard_perturbed = (cross_entropy_2d(m.recon_shape(p_seg.detach()), label)
                              if p_seg is not None else self._zero())
        return self._metrics(cross_entropy_2d(y0, label), std_image, std_shape, std_gt_shape,
                             cross_entropy_2d(y0_h, label), hard_image, hard_shape,
                             hard_perturbed)

    # ------------------------------------------------------------- state
    def load_train_state(self, state: TrainState) -> None:
        """Load parameters, running statistics and Adam's moments and step
        (as :func:`..convert.train_state_from_jax` gives them); the step
        on the parameters' device when ``capturable``, else on the host."""
        self.model.load_state_dicts(state.state_dicts)
        self.optimizer.state.clear()
        if state.step == 0:
            return
        for name in MODULE_NAMES:
            params = dict(getattr(self.model, name).named_parameters())
            if set(params) != set(state.exp_avg[name]) or set(params) != set(
                    state.exp_avg_sq[name]):
                raise KeyError(f"Adam moments of {name} do not match its parameters")
            for key, p in params.items():
                self.optimizer.state[p] = {
                    "step": torch.tensor(float(state.step), device=self._step_device(p)),
                    "exp_avg": state.exp_avg[name][key].to(p.device, p.dtype).clone(),
                    "exp_avg_sq": state.exp_avg_sq[name][key].to(p.device, p.dtype).clone(),
                }

    def _step_device(self, p: torch.Tensor) -> torch.device:
        return p.device if self.capturable else torch.device("cpu")

    def place_optimizer_state(self) -> None:
        """Put Adam's step counts where this trainer keeps them (the
        parameters' device when ``capturable``, else the host) and its
        ``capturable`` flag back on every group: ``load_state_dict`` takes
        both from the state it loads, which another trainer may have
        written."""
        for group in self.optimizer.param_groups:
            group["capturable"] = self.capturable
            for p in group["params"]:
                st = self.optimizer.state.get(p)
                if st and "step" in st:
                    st["step"] = st["step"].to(self._step_device(p), torch.float32)

    def adam_moments(self):
        """Adam's (exp_avg, exp_avg_sq), each ``{module: {parameter name:
        tensor}}``; empty before the first step."""
        mu, nu = {}, {}
        for name in MODULE_NAMES:
            for key, p in getattr(self.model, name).named_parameters():
                st = self.optimizer.state.get(p)
                if st:
                    mu.setdefault(name, {})[key] = st["exp_avg"]
                    nu.setdefault(name, {})[key] = st["exp_avg_sq"]
        return mu, nu

    # ---------------------------------------------------------- launches
    def expected_launches(self, branches: Dict[str, int]) -> Dict[str, int]:
        """Kernel launches one :meth:`train_step` makes on the card, by
        wrapper (``conv3x3_chw``: K1 forward, ``conv3x3_chw_dx``: K1 on
        flipped weights, ``conv3x3_chw_dw``: K2, ``percentile_mask``: K3,
        ``conv3x3s2``, ``conv3x3s2_dx``, ``conv3x3s2_dw``: K4, K4dx, K4dw,
        ``conv3x3_nl``, ``conv3x3_nl_dx``, ``conv3x3_nl_dw``: K5 forward, K5
        on flipped weights, K5dw), for the branches drawn (``{"image": b,
        "shape": b}``).

        Every K1 conv of the loss graph launches forward and K2; all but
        those whose input needs no gradient (an encoder's first conv on an
        image, a label or a detached segmentation) launch dx.  Generation
        decodes each code once, and a targeted branch adds a saliency
        forward and backward (dx only) and one K3.  K5 convs (under
        ``conv_nl``) count by the same rule; none is an encoder's first
        conv, so each launches dx wherever it runs in the loss graph.  A K4
        conv (an encoder's downsample under ``conv_s2``) launches K4, K4dx
        and K4dw once per encoder pass: its input comes after the encoder's
        ``inc`` block, so it always needs a gradient, and generation runs no
        encoder.  The image encoder runs once per FTN pass, the shape
        encoder once per recon.  Under ``separate_training`` a predicted
        recon's first conv launches no dx.  ``saliency_bn_update`` adds one forward of
        each perturbed code's decoder; ``remat`` one more forward (K1, K4,
        K5) of every conv of the loss graph, its recompute in the
        backward.  A stacked batch (``fused_stn``'s STN passes,
        ``fused_ftn``'s two FTN passes) is one pass: each conv launches its
        forward and K2 once, and dx once if any stacked pass needs a
        gradient.  ``fused_ftn``'s pre-pass adds one forward of the image
        encoder, outside the loss graph (no dx, no dw, no recompute)."""
        m = self.model
        lda = self.latent_da
        gen_img = bool(self.use_latent_da and lda.gen_corrupted_image)
        gen_seg = bool(self.use_latent_da and lda.gen_corrupted_seg)
        # the loss graph's passes: FTN passes, and per STN pass whether its
        # first conv's input needs a gradient (ground truth, prediction,
        # hard prediction, perturbed segmentation)
        pred = not self.separate_training
        stn_passes = [False, pred] + [pred] * gen_img + [False] * gen_seg
        ftn_passes = 1 + gen_img
        if self.fused_stn:
            stn_passes = [any(stn_passes)]
        if self.fused_ftn:
            ftn_passes = 1
        pre_pass = int(self.fused_ftn)

        def count(name, uses):
            return sum(isinstance(c, Conv) and uses(c) for c in getattr(m, name).modules())

        def stride1(uses):
            """(forward, dx, dw) launches of the stride-1 convs that ``uses``
            picks."""
            k = {name: count(name, uses) for name in MODULE_NAMES}
            img_first = int(uses(m.image_encoder.general_encoder.inc[0]))
            shp_first = int(uses(m.shape_encoder.inc[0]))
            ftn = k["image_encoder"] + k["segmentation_decoder"] + k["image_decoder"]
            stn = k["shape_encoder"] + k["shape_decoder"]
            fwd = ftn * ftn_passes + stn * len(stn_passes)
            dx = (ftn - img_first) * ftn_passes + sum(stn - shp_first * (not grad)
                                                      for grad in stn_passes)
            dw = fwd
            if self.remat:
                fwd += dw
            fwd += k["image_encoder"] * pre_pass
            for key, on, dec in (("image", gen_img, "image_decoder"),
                                 ("shape", gen_seg, "segmentation_decoder")):
                if on:
                    targeted = branches[key] != 0
                    fwd += k[dec] * (1 + targeted + self.saliency_bn_update)
                    dx += k[dec] if targeted else 0
            return fwd, dx, dw

        mask = sum(int(on and branches[key] != 0)
                   for key, on in (("image", gen_img), ("shape", gen_seg)))
        k4 = {name: count(name, Conv.uses_k4) for name in ("image_encoder", "shape_encoder")}
        s2 = ftn_passes * k4["image_encoder"] + len(stn_passes) * k4["shape_encoder"]
        k1, k5 = stride1(Conv.uses_k1), stride1(Conv.uses_k5)
        return {"conv3x3_chw": k1[0], "conv3x3_chw_dx": k1[1], "conv3x3_chw_dw": k1[2],
                "percentile_mask": mask,
                "conv3x3s2": s2 * (1 + self.remat) + pre_pass * k4["image_encoder"],
                "conv3x3s2_dx": s2, "conv3x3s2_dw": s2, "conv3x3_nl": k5[0],
                "conv3x3_nl_dx": k5[1], "conv3x3_nl_dw": k5[2]}
