"""The cooperative train step: FTN+STN training with latent-space data
augmentation.

Counterpart of the training surface of the JAX package's
``train/cooperative.py:CooperativeTripletSolver``: ``standard_training``,
``_frozen_decoder_fn``, ``hard_example_generation`` (its default arm),
``hard_example_training`` and the sequential loss path of
``make_train_step`` with ``separate_training=False`` (the configuration's;
the STN's loss trains the FTN through its prediction).  One :meth:`CooperativeTrainer.train_step` is one
jitted JAX step: input noise and clip, the four standard losses (BN
running statistics updated), hard-example generation by latent masking
through frozen decoders, the four hard losses (BN statistics frozen), one
backward over the sum and one Adam update of all five subnetworks.

Layouts: :meth:`~CooperativeTrainer.train_step` takes the JAX batch
layout, an (N, H, W, 1) float32 image and (N, H, W) integer labels; the
other methods take NCHW tensors.  Random draws come in as a
:class:`..train.draws.StepDraws`.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Dict, Optional, Union

import torch
from torch.func import functional_call

from cooperative_training_and_latent_space_data_augmentation_tpu_torch.config import (
    LatentDAConfig,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.convert import TrainState
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.models.blocks import (
    frozen_stats,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.ops.conv_chw import (
    Conv,
    full_f32,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.ops.image import one_hot
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
    asks for ``"cpu"``) and ``seed`` are the predictor's.
    """

    def __init__(self, latent_da: Optional[LatentDAConfig], *, input_noise_std: float = 0.05,
                 learning_rate: float = 1e-4, compute_dtype: Optional[torch.dtype] = None,
                 device: Union[str, torch.device] = "cuda", seed: int = 0,
                 image_ch: int = 1, num_classes: int = 4, temperature: float = 2.0):
        self.model = CooperativePredictor(image_ch=image_ch, num_classes=num_classes,
                                          temperature=temperature,
                                          compute_dtype=compute_dtype, device=device,
                                          seed=seed)
        self.model.train()
        self.latent_da = latent_da
        self.input_noise_std = input_noise_std
        self.num_classes = num_classes
        self.optimizer = torch.optim.Adam(self.model.parameters(), lr=learning_rate)
        # the last step's generation per code ("image", "shape"), for checks
        self.generation: Dict[str, Generation] = {}

    @property
    def use_latent_da(self) -> bool:
        lda = self.latent_da
        return lda is not None and (lda.gen_corrupted_image or lda.gen_corrupted_seg)

    def _zero(self) -> torch.Tensor:
        return torch.zeros((), device=next(self.model.parameters()).device)

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
            image = 0.5 * torch.mean((m.image_decoder(z_i) - clean) ** 2)
            gt_shape = self._zero()
            if compute_gt_recon:
                gt_recon = m.decode_shape(m.shape_encoder(one_hot(label, self.num_classes)))
                gt_shape = cross_entropy_2d(gt_recon, label)
            shape = cross_entropy_2d(m.recon_shape(y0), label)
        return {"seg": seg, "image": image, "gt_shape": gt_shape, "shape": shape}, (z_i, z_s)

    def _frozen_decoder(self, name: str):
        """The decoder ``name`` with detached parameters (no parameter
        gradient, so no K2 launch and no ``.grad``) and frozen BN
        statistics: the JAX package's ``_frozen_decoder_fn``."""
        module = getattr(self.model, name)
        frozen = {k: v.detach() for k, v in module.named_parameters()}

        def fn(z: torch.Tensor) -> torch.Tensor:
            with frozen_stats(module):
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
            self.generation[key] = Generation(code_draws.branch, mask, saliency)
        return perturbed["image"], perturbed["shape"]

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
        nothing back to the host."""
        clean = image.permute(0, 3, 1, 2).contiguous()
        label = label.long()
        noised = torch.clamp(clean + self.input_noise_std * draws.noise, 0.0, 1.0)
        self.optimizer.zero_grad(set_to_none=True)
        std, (z_i, z_s) = self.standard_training(clean, label, noised)
        standard = std["seg"] + std["image"] + std["shape"] + std["gt_shape"]
        metrics = {
            "loss/standard/total": standard,
            "loss/standard/seg": std["seg"],
            "loss/standard/image": std["image"],
            "loss/standard/shape": std["shape"],
            "loss/standard/gt_shape": std["gt_shape"],
        }
        if self.use_latent_da:
            p_img, p_seg = self.hard_example_generation(z_i, z_s, clean, label, draws)
            hard = self.hard_example_training(p_img, clean, p_seg, label)
            hard_loss = hard["seg"] + hard["image"] + hard["shape"] + hard["perturbed_shape"]
            metrics.update({
                "loss/hard/total": hard_loss,
                "loss/hard/seg": hard["seg"],
                "loss/hard/image": hard["image"],
                "loss/hard/shape": hard["shape"] + hard["perturbed_shape"],
            })
        else:
            hard_loss = self._zero()
            metrics.update({k: hard_loss for k in (
                "loss/hard/total", "loss/hard/seg", "loss/hard/image", "loss/hard/shape")})
        total = standard + hard_loss
        metrics["loss/total"] = total
        with full_f32(torch.float32):  # the backward of the f32 cuDNN convs, too
            total.backward()
        self.optimizer.step()
        return {k: v.detach() for k, v in metrics.items()}

    # ------------------------------------------------------------- state
    def load_train_state(self, state: TrainState) -> None:
        """Load parameters, running statistics and Adam's moments and step
        (as :func:`..convert.train_state_from_jax` gives them)."""
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
                    "step": torch.tensor(float(state.step)),
                    "exp_avg": state.exp_avg[name][key].to(p.device, p.dtype).clone(),
                    "exp_avg_sq": state.exp_avg_sq[name][key].to(p.device, p.dtype).clone(),
                }

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
        flipped weights, ``conv3x3_chw_dw``: K2, ``percentile_mask``: K3),
        for the branches drawn (``{"image": b, "shape": b}``).

        Every K1 conv of the loss graph launches forward and K2; all but
        those whose input needs no gradient (an encoder's first conv on an
        image, a label or a detached segmentation) launch dx.  Generation
        decodes each code once, and a targeted branch adds a saliency
        forward and backward (dx only) and one K3."""
        m = self.model
        k1 = {name: sum(isinstance(c, Conv) and c.uses_k1()
                        for c in getattr(m, name).modules()) for name in MODULE_NAMES}
        img_first = int(m.image_encoder.general_encoder.inc[0].uses_k1())
        shp_first = int(m.shape_encoder.inc[0].uses_k1())
        ftn = k1["image_encoder"] + k1["segmentation_decoder"] + k1["image_decoder"]
        stn = k1["shape_encoder"] + k1["shape_decoder"]
        # standard pass: FTN, ground-truth recon, predicted recon
        fwd = ftn + 2 * stn
        dx = (ftn - img_first) + (stn - shp_first) + stn
        mask = 0
        lda = self.latent_da
        if self.use_latent_da:
            if lda.gen_corrupted_image:  # hard FTN + its predicted recon
                fwd += ftn + stn
                dx += (ftn - img_first) + stn
            if lda.gen_corrupted_seg:    # recon of the perturbed segmentation
                fwd += stn
                dx += stn - shp_first
        dw = fwd
        if self.use_latent_da:
            for key, on, dec in (("image", lda.gen_corrupted_image, "image_decoder"),
                                 ("shape", lda.gen_corrupted_seg, "segmentation_decoder")):
                if on:
                    targeted = branches[key] != 0
                    fwd += k1[dec] * (2 if targeted else 1)
                    dx += k1[dec] if targeted else 0
                    mask += int(targeted)
        return {"conv3x3_chw": fwd, "conv3x3_chw_dx": dx, "conv3x3_chw_dw": dw,
                "percentile_mask": mask}
