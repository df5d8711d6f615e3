"""The plain single-network segmentation solver of the baselines.

Counterpart of the JAX package's ``train/segmentation.py`` (the
reference's ``base_segmentation_model.SegmentationModel``): the registry of
ten baseline networks and :class:`SegmentationSolver`, with one Adam
optimizer ('Adam', or 'AdaAdam': x0.5 every 50 epochs), the optional
Adam-bound clip, an optional EMA of the parameters updated in the step, a
train step, ``predict``, ``evaluate`` into a ``RunningScore`` and
checkpoints.

The solver owns its network's state: the parameters, the BatchNorm
statistics and the spectral norms' ``u``/``sigma`` live in ``self.model``,
Adam's state in ``self.optimizer`` and the EMA in ``self.ema_params``.
Images and outputs at the solver's surface are NHWC (N, H, W, C) as in the
JAX package; the networks compute in NCHW.  It runs on the card unless
built with ``device="cpu"``.
"""

from __future__ import annotations

import os
from contextlib import contextmanager
from os.path import exists, join
from typing import Callable, Dict, Optional

import torch
import torch.nn as nn

from cooperative_training_and_latent_space_data_augmentation_tpu_torch import convert
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.models.unet import (
    FCN,
    ResConvUNet,
    UNet,
    UNetv2,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.ops import losses as L
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.ops.conv_chw import (
    Conv,
    full_f32,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.train.checkpoint import (
    host_copy,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.train.predictor import (
    init_parameters,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.utils.schedulers import (
    make_optimizer,
)

# the reference's registry; ``dtype`` is the conv compute dtype (bf16 mixed
# precision: norms and logits stay float32)
NETWORK_REGISTRY: Dict[str, Callable[..., nn.Module]] = {
    "UNet_16": lambda num_classes, image_ch, dtype=None: UNet(
        image_ch, num_classes, 4, dtype=dtype),
    "UNet_32": lambda num_classes, image_ch, dtype=None: UNet(
        image_ch, num_classes, 2, dtype=dtype),
    "UNet_64": lambda num_classes, image_ch, dtype=None: UNet(
        image_ch, num_classes, 1, dtype=dtype),
    "UNetv2_16": lambda num_classes, image_ch, dtype=None: UNetv2(
        image_ch, num_classes, 4, dtype=dtype),
    "SN_UNet_16": lambda num_classes, image_ch, dtype=None: UNet(
        image_ch, num_classes, 4, if_SN=True, dtype=dtype),
    "IN_SN_UNet_16": lambda num_classes, image_ch, dtype=None: UNet(
        image_ch, num_classes, 4, norm="instance", if_SN=True, dtype=dtype),
    "FCN_16": lambda num_classes, image_ch, dtype=None: FCN(
        image_ch, num_classes, 4, dtype=dtype),
    "FCN_64": lambda num_classes, image_ch, dtype=None: FCN(
        image_ch, num_classes, 1, dtype=dtype),
    "ResUNet_16": lambda num_classes, image_ch, dtype=None: ResConvUNet(
        image_ch, num_classes, 4, dtype=dtype),
    "ResUNet_64": lambda num_classes, image_ch, dtype=None: ResConvUNet(
        image_ch, num_classes, 1, dtype=dtype),
}

AUX_WEIGHT = 0.5  # a deeply supervised network's auxiliary losses


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2).contiguous()


class SegmentationSolver:
    """One network, one optimizer: ``train_step``, ``predict``,
    ``evaluate`` and checkpoints.

    ``optimizer_name`` 'Adam' is plain Adam; 'AdaAdam' halves the learning
    rate every 50 epochs of ``steps_per_epoch`` updates.  ``clip_grad`` puts
    the Adam-bound clip in front.  ``use_ema`` keeps ``ema_params``, moved
    by ``ema_decay`` after each update (``d e + (1 - d) p``).
    ``compute_dtype`` bfloat16 runs the convs in bf16.  The weights are
    drawn from ``seed`` (:meth:`init_state`)."""

    def __init__(self, network_type: str = "UNet_16", image_ch: int = 1, num_classes: int = 4,
                 learning_rate: float = 1e-4, loss_type: str = "cross entropy",
                 use_ema: bool = False, ema_decay: float = 0.999,
                 compute_dtype: Optional[torch.dtype] = None, optimizer_name: str = "Adam",
                 steps_per_epoch: int = 1, clip_grad: bool = False,
                 device: str = "cuda", seed: int = 0):
        if network_type not in NETWORK_REGISTRY:
            raise ValueError(f"unknown network {network_type}; have {sorted(NETWORK_REGISTRY)}")
        if optimizer_name not in ("Adam", "AdaAdam"):
            raise NotImplementedError(f"optimizer {optimizer_name!r}; have Adam | AdaAdam")
        if loss_type not in L.LOSS_TYPES:
            raise NotImplementedError(loss_type)
        self.network_type = network_type
        self.image_ch = image_ch
        self.num_classes = num_classes
        self.learning_rate = learning_rate
        self.loss_type = loss_type
        self.use_ema = use_ema
        self.ema_decay = ema_decay
        self.optimizer_name = optimizer_name
        self.steps_per_epoch = steps_per_epoch
        self.clip_grad = clip_grad
        self.device = torch.device(device)
        self.model = NETWORK_REGISTRY[network_type](num_classes, image_ch, dtype=compute_dtype)
        self.init_state(seed)

    def init_state(self, seed: int) -> None:
        """Draw the weights from ``seed`` (``init_parameters``: JAX's
        initial distributions), and start the optimizer and the EMA afresh."""
        init_parameters(self.model.to("cpu"), seed)
        self.model.to(self.device)
        kw = (dict(policy="step", lr_decay_iters=50, steps_per_epoch=self.steps_per_epoch)
              if self.optimizer_name == "AdaAdam" else {})
        self.optimizer = make_optimizer(self.model.parameters(), self.learning_rate,
                                        clip=self.clip_grad, **kw)
        self.ema_params = ({n: p.detach().clone() for n, p in self.model.named_parameters()}
                           if self.use_ema else None)

    def _loss(self, out, label: torch.Tensor) -> torch.Tensor:
        if isinstance(out, tuple):  # deeply supervised: (main, auxiliaries)
            main, auxs = out
            loss = L.basic_loss_fn(main, label, self.loss_type)
            for a in auxs:
                loss = loss + AUX_WEIGHT * L.basic_loss_fn(a, label, self.loss_type)
            return loss
        return L.basic_loss_fn(out, label, self.loss_type)

    def train_step(self, image: torch.Tensor, label: torch.Tensor) -> Dict[str, torch.Tensor]:
        """One update on NHWC ``image`` and (N, H, W) integer ``label``, in
        train mode (batch statistics, BN running statistics and SN ``u``/
        ``sigma`` updated); returns ``{"loss/total": loss}`` (a 0-d tensor
        on the device, not read back)."""
        self.model.train()
        self.optimizer.zero_grad()
        x = _nchw(image.to(self.device, torch.float32))
        loss = self._loss(self.model(x), label.to(self.device).long())
        with full_f32(torch.float32):  # the float32 convs' backward without TF32
            loss.backward()
        self.optimizer.step()
        if self.use_ema:
            d = self.ema_decay
            with torch.no_grad():
                for n, p in self.model.named_parameters():
                    self.ema_params[n].mul_(d).add_(p, alpha=1.0 - d)
        return {"loss/total": loss.detach()}

    @contextmanager
    def _eval_mode(self):
        modes = [(m, m.training) for m in self.model.modules()]
        self.model.eval()
        try:
            yield
        finally:
            for m, mode in modes:
                m.training = mode

    @torch.no_grad()
    def predict(self, x: torch.Tensor, softmax: bool = False,
                use_ema_params: bool = False) -> torch.Tensor:
        """NHWC logits (or probabilities with ``softmax``) of NHWC ``x`` in
        eval mode, with the EMA parameters when ``use_ema_params`` (and the
        solver keeps them); every module's mode is restored after."""
        x = _nchw(x.to(self.device, torch.float32))
        with self._eval_mode():
            if self.use_ema and use_ema_params:
                out = torch.func.functional_call(self.model, self.ema_params, (x,), strict=False)
            else:
                out = self.model(x)
        if isinstance(out, tuple):
            out = out[0]
        out = out.permute(0, 2, 3, 1)
        return torch.softmax(out, dim=-1) if softmax else out

    def evaluate(self, x: torch.Tensor, targets: torch.Tensor, running_metric) -> torch.Tensor:
        """The argmax prediction of NHWC ``x`` (N, H, W), added with
        ``targets`` to ``running_metric`` (``eval.metrics.RunningScore``)."""
        pred = torch.argmax(self.predict(x), dim=-1)
        running_metric.update(label_trues=targets, label_preds=pred)
        return pred

    def expected_launches(self) -> Dict[str, int]:
        """K1, K1 dx and K2 launches of one train step: K1 and K2 once for
        each conv routed to K1, K1 dx for those of them whose input needs a
        gradient (all but the ones reading the image).  A ``predict``
        launches the K1 count alone."""
        k1 = [m for m in self.model.modules() if isinstance(m, Conv) and m.uses_k1()]
        entry = {id(m) for m in self.model.input_convs()}
        n_entry = sum(id(m) in entry for m in k1)
        return {"conv3x3_chw": len(k1), "conv3x3_chw_dx": len(k1) - n_entry,
                "conv3x3_chw_dw": len(k1)}

    # ------------------------------------------------------------ checkpoints
    def _host_state(self) -> Dict[str, object]:
        state = {"model": host_copy(self.model.state_dict())}
        if self.use_ema:
            state["ema"] = host_copy(self.ema_params)
        return state

    def _load_host_state(self, state: Dict[str, object]) -> None:
        self.model.load_state_dict(state["model"])
        if self.use_ema:
            for k, v in state.get("ema", state["model"]).items():
                if k in self.ema_params:
                    self.ema_params[k].copy_(v)

    def save_model(self, save_dir: str, epoch_iter) -> str:
        """Write the network's state dict (and the EMA parameters) to
        ``{save_dir}/{epoch_iter}/checkpoints/{network_type}.pth``."""
        path = join(save_dir, str(epoch_iter), "checkpoints")
        os.makedirs(path, exist_ok=True)
        fname = join(path, f"{self.network_type}.pth")
        torch.save(self._host_state(), fname)
        return fname

    def load_model(self, path: str) -> None:
        """Load a :meth:`save_model` file, or a JAX solver's ``save_model``
        ``.msgpack`` (``{"params", "batch_stats"}``, params split into
        ``online``/``ema`` under EMA) through ``convert``."""
        if path.endswith(".msgpack"):
            tree = convert.read_flax_msgpack(path)
            params, stats = tree["params"], tree["batch_stats"]
            online = params["online"] if "online" in params else params
            state = {"model": convert.baseline_from_jax(self.model, online, stats)}
            if "ema" in params:
                names = dict(self.model.named_parameters())
                state["ema"] = {k: v for k, v in convert.baseline_from_jax(
                    self.model, params["ema"], stats).items() if k in names}
            self._load_host_state(state)
            return
        self._load_host_state(torch.load(path, map_location="cpu", weights_only=True))

    def load_train_state(self, state: convert.BaselineTrainState) -> None:
        """Load a JAX solver's whole state (``convert.
        baseline_train_state_from_jax``): weights, statistics, EMA, Adam's
        moments and count, the clip's moments."""
        self._load_host_state({"model": state.state_dict,
                               **({"ema": state.ema} if state.ema is not None else {})})
        adam = self.optimizer.adam
        adam.state.clear()
        for n, p in self.model.named_parameters():
            adam.state[p] = {"step": torch.tensor(float(state.step)),
                             "exp_avg": state.exp_avg[n].to(p.device).clone(),
                             "exp_avg_sq": state.exp_avg_sq[n].to(p.device).clone()}
        self.optimizer.count = state.step
        if self.optimizer.clip is not None:
            for (n, _), v in zip(self.model.named_parameters(), self.optimizer.clip.nu):
                v.copy_(state.clip_nu[n])

    def save_snapshots(self, save_dir: str, epoch: int) -> str:
        """The resumable snapshot ``{save_dir}/{network_type}_snapshot.pth``:
        network type, epoch, weights, EMA and the optimizer's state."""
        os.makedirs(save_dir, exist_ok=True)
        path = join(save_dir, f"{self.network_type}_snapshot.pth")
        torch.save({"network_type": self.network_type, "epoch": int(epoch),
                    **self._host_state(), "optimizer": host_copy(self.optimizer.state_dict())},
                   path)
        return path

    def load_snapshots(self, path: Optional[str]) -> int:
        """Load a :meth:`save_snapshots` file; returns its epoch, or 0 when
        ``path`` is empty or missing."""
        if not path or not exists(path):
            return 0
        payload = torch.load(path, map_location="cpu", weights_only=True)
        if payload["network_type"] != self.network_type:
            raise ValueError(f"snapshot of {payload['network_type']}, solver of "
                             f"{self.network_type}")
        self._load_host_state(payload)
        self.optimizer.load_state_dict(payload["optimizer"])
        return int(payload["epoch"])

