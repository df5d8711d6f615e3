"""The experiment configuration.

A copy of the JAX package's ``config.py`` dataclasses (the port imports
nothing of the JAX package), which mirror the reference's JSON layout,
``configs/ACDC/cooperative_training.json``: ``DataConfig``,
``SegmentationModelConfig``, ``LearningConfig``, ``MaskConfig``,
``LatentDAConfig``, ``OutputConfig`` and ``ExperimentConfig`` with
``from_dict``, ``from_json``, ``to_dict`` and ``save``.  The JAX package's
``ParallelConfig`` (its device mesh) is left out: the port has no mesh, and
``from_dict`` ignores a ``parallel`` section.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Sequence, Tuple


def _filter_kwargs(cls, d: Dict[str, Any]) -> Dict[str, Any]:
    names = {f.name for f in dataclasses.fields(cls)}
    return {k: v for k, v in d.items() if k in names}


@dataclass
class DataConfig:
    """Mirrors the reference config's ``data`` section (cooperative_training.json:3-36)."""

    dataset_name: str = "ACDC"
    root_dir: str = ""
    frame: Sequence[str] = ("ES", "ED")
    image_size: Sequence[int] = (224, 224, 1)
    label_size: Sequence[int] = (224, 224)
    pad_size: Sequence[int] = (224, 224, 1)
    crop_size: Sequence[int] = (192, 192, 1)
    data_aug_policy: str = "ACDC_affine_elastic_intensity"
    image_format_name: str = "{p_id}/{frame}_img.nii.gz"
    label_format_name: str = "{p_id}/{frame}_seg.nii.gz"
    num_classes: int = 4
    use_cache: bool = True
    keep_orig_image_label_pair_for_training: bool = True
    myocardium_only: bool = False
    right_ventricle_only: bool = False
    new_spacing: Optional[Sequence[float]] = (1.36719, 1.36719, -1.0)

    @property
    def crop_hw(self) -> Tuple[int, int]:
        return int(self.crop_size[0]), int(self.crop_size[1])

    @property
    def pad_hw(self) -> Tuple[int, int]:
        return int(self.pad_size[0]), int(self.pad_size[1])


@dataclass
class SegmentationModelConfig:
    """Mirrors ``segmentation_model`` (cooperative_training.json:37-40)."""

    network_type: str = "FCN_16_standard"
    num_classes: int = 4
    image_ch: int = 1
    encoder_dropout: Optional[float] = None
    decoder_dropout: Optional[float] = None


@dataclass
class LearningConfig:
    """Mirrors ``learning`` (cooperative_training.json:41-49)."""

    latent_DA: bool = True
    separate_training: bool = False
    lr: float = 1e-4
    n_epochs: int = 600
    max_iteration: int = 50000
    batch_size: int = 20
    use_gpu: bool = True  # kept for config parity; the device is chosen by the caller
    input_noise_std: float = 0.05
    compute_dtype: str = "float32"


@dataclass
class MaskConfig:
    """One latent-code masking config (cooperative_training.json:54-66).

    ``loss_name``: task loss whose gradient drives targeted masking
    (mse | ce | corr).  ``mask_type``: random | dropout | spatial | channel;
    "random" draws uniformly among the latter three each step.
    """

    loss_name: str = "mse"
    mask_type: str = "random"
    max_threshold: float = 0.5
    random_threshold: bool = True
    if_soft: bool = True


@dataclass
class LatentDAConfig:
    """Mirrors ``latent_DA`` (cooperative_training.json:51-67)."""

    mask_scope: Sequence[str] = ("image code", "shape code")
    image_code: MaskConfig = field(default_factory=lambda: MaskConfig(loss_name="mse"))
    shape_code: MaskConfig = field(default_factory=lambda: MaskConfig(loss_name="ce"))

    @property
    def gen_corrupted_image(self) -> bool:
        return "image code" in self.mask_scope

    @property
    def gen_corrupted_seg(self) -> bool:
        return "shape code" in self.mask_scope


@dataclass
class OutputConfig:
    save_epoch_every_num_epochs: int = 100


@dataclass
class ExperimentConfig:
    name: str = "cooperative training"
    data: DataConfig = field(default_factory=DataConfig)
    segmentation_model: SegmentationModelConfig = field(default_factory=SegmentationModelConfig)
    learning: LearningConfig = field(default_factory=LearningConfig)
    latent_DA: LatentDAConfig = field(default_factory=LatentDAConfig)
    output: OutputConfig = field(default_factory=OutputConfig)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ExperimentConfig":
        lda_raw = dict(d.get("latent_DA", {}))
        lda = LatentDAConfig(
            mask_scope=tuple(lda_raw.get("mask_scope", ("image code", "shape code"))),
            image_code=MaskConfig(**_filter_kwargs(MaskConfig, lda_raw.get("image code", {}))),
            shape_code=MaskConfig(**_filter_kwargs(MaskConfig, lda_raw.get("shape code", {}))),
        )
        return cls(
            name=d.get("name", "experiment"),
            data=DataConfig(**_filter_kwargs(DataConfig, d.get("data", {}))),
            segmentation_model=SegmentationModelConfig(
                **_filter_kwargs(SegmentationModelConfig, d.get("segmentation_model", {}))),
            learning=LearningConfig(**_filter_kwargs(LearningConfig, d.get("learning", {}))),
            latent_DA=lda,
            output=OutputConfig(**_filter_kwargs(OutputConfig, d.get("output", {}))),
        )

    @classmethod
    def from_json(cls, path: str) -> "ExperimentConfig":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    def to_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "data": dataclasses.asdict(self.data),
            "segmentation_model": dataclasses.asdict(self.segmentation_model),
            "learning": dataclasses.asdict(self.learning),
            "latent_DA": {
                "mask_scope": list(self.latent_DA.mask_scope),
                "image code": dataclasses.asdict(self.latent_DA.image_code),
                "shape code": dataclasses.asdict(self.latent_DA.shape_code),
            },
            "output": dataclasses.asdict(self.output),
        }

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2, default=list)
