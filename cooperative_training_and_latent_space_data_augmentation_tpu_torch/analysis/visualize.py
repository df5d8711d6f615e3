"""Analysis and visualization extras: confusion matrix, embedding and
intensity plots, and the hard-example grids.

Counterpart of the JAX package's ``analysis/visualize.py`` (the re-design
of the reference's ``medseg/analysis/`` and of its hard-example notebook
``visualization/vis_hard_example.ipynb``).  matplotlib is imported only
inside the functions that draw (the card's machine has none), and
scikit-learn only inside :func:`plot_embedding`.

The hard-example visualization comes in two halves:

* :func:`hard_example_arrays` computes, for every masking method x
  threshold, what the JAX package's jitted ``corrupt`` returns: the image
  decoded from the masked image code, the segmentation logits decoded from
  the masked shape code, and their entropy map, with each code's mask and
  saliency.  The codes come from ``fast_predict`` in train mode (batch
  statistics, running statistics left alone), the decoders are the
  trainer's frozen ones (detached parameters: no weight-gradient kernel),
  and the masks come from ``ops/masking.py:perturb_latent_code`` with
  ``random_threshold=False`` and soft masks; the draws (the dropout keep
  masks and the soft values) come from a ``torch.Generator``
  (:func:`draw_hard_examples`).  On the card the channel and spatial
  methods run K1 forward and K1 dx through the saliency gradient and K3
  for the threshold;
* :func:`save_hard_example_grids` draws one PNG grid per method x
  threshold from those arrays; :func:`visualize_hard_examples` runs both.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from os.path import join
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from cooperative_training_and_latent_space_data_augmentation_tpu_torch.config import MaskConfig
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.models.blocks import (
    frozen_stats,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.ops.masking import (
    perturb_latent_code,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.train.cooperative import (
    CooperativeTrainer,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.train.draws import (
    CodeDraws,
    draw_code,
)

METHODS = ("dropout", "channel", "spatial")
THRESHOLDS = (0.25, 0.5)


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_confusion_matrix(cm: np.ndarray, class_names: Sequence[str],
                          save_path: Optional[str] = None, normalize: bool = True):
    """Heatmap of a confusion matrix (analysis/confusion_matrix.py:9-57)."""
    plt = _plt()
    cm = np.asarray(cm, np.float64)
    if normalize:
        cm = cm / (cm.sum(axis=1, keepdims=True) + 1e-12)
    fig, ax = plt.subplots(figsize=(5, 4))
    im = ax.imshow(cm, cmap="Blues")
    ax.set_xticks(range(len(class_names)), class_names, rotation=45)
    ax.set_yticks(range(len(class_names)), class_names)
    for i in range(cm.shape[0]):
        for j in range(cm.shape[1]):
            ax.text(j, i, f"{cm[i, j]:.2f}", ha="center", va="center",
                    color="white" if cm[i, j] > 0.5 else "black")
    ax.set_xlabel("predicted")
    ax.set_ylabel("true")
    fig.colorbar(im)
    if save_path:
        fig.savefig(save_path, bbox_inches="tight", dpi=100)
        plt.close(fig)
        return save_path
    return fig


def plot_embedding(features: np.ndarray, labels: np.ndarray,
                   save_path: Optional[str] = None, method: str = "pca"):
    """2-D embedding scatter of latent codes (analysis/visual_embedding.py:16-95);
    scikit-learn's PCA or TSNE in place of UMAP, as in the JAX package."""
    plt = _plt()
    feats = np.asarray(features).reshape(len(features), -1)
    if method == "tsne":
        from sklearn.manifold import TSNE

        emb = TSNE(n_components=2, init="pca",
                   perplexity=min(30, max(2, len(feats) // 3))).fit_transform(feats)
    else:
        from sklearn.decomposition import PCA

        emb = PCA(n_components=2).fit_transform(feats)
    fig, ax = plt.subplots(figsize=(5, 5))
    sc = ax.scatter(emb[:, 0], emb[:, 1], c=np.asarray(labels), cmap="tab10", s=12)
    fig.colorbar(sc)
    if save_path:
        fig.savefig(save_path, bbox_inches="tight", dpi=100)
        plt.close(fig)
        return save_path
    return fig


def plot_intensity_distributions(volumes: Dict[str, np.ndarray],
                                 save_path: Optional[str] = None, bins: int = 50):
    """Overlaid intensity histograms across domains
    (analysis/vis_intensity_distribution.py:14-37)."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(6, 4))
    for name, vol in volumes.items():
        ax.hist(np.asarray(vol).ravel(), bins=bins, density=True, alpha=0.5, label=name)
    ax.legend()
    ax.set_xlabel("intensity")
    ax.set_ylabel("density")
    if save_path:
        fig.savefig(save_path, bbox_inches="tight", dpi=100)
        plt.close(fig)
        return save_path
    return fig


def plot_image(data, ax=None, font_size: int = 12, title: str = "before"):
    """Grayscale 2-D image panel (vis.plot_image:49-63)."""
    return plot_general(data, ax=ax, font_size=font_size, title=title, cmap="gray")


def plot_general(data, ax=None, font_size: int = 12, title: str = "", cmap: str = "gray"):
    """Generic 2-D array panel (vis.plot_general:66-80)."""
    plt = _plt()
    if ax is None:
        ax = plt.gca()
    ax.imshow(np.asarray(data), cmap=cmap)
    ax.set_title(title, size=font_size, weight="bold")
    ax.set_axis_off()
    ax.grid(False)
    return ax


def prediction_entropy(logits_nhwc: torch.Tensor) -> torch.Tensor:
    """Per-pixel predictive entropy over the last (class) axis, divided by
    log(num_classes) (common_utils/uncertainty.py:7-54), in float32."""
    p = torch.softmax(logits_nhwc.float(), dim=-1)
    ent = -torch.sum(p * torch.log(p + 1e-12), dim=-1)
    return ent / float(np.log(logits_nhwc.shape[-1]))


# ------------------------------------------------------------ hard examples
def mask_settings(method: str, threshold: float, loss_name: str) -> MaskConfig:
    """The visualization's mask config: ``method`` always (no random
    branch), the threshold fixed, soft masks."""
    return MaskConfig(loss_name=loss_name, mask_type=method, max_threshold=threshold,
                      random_threshold=False, if_soft=True)


def draw_hard_examples(generator: torch.Generator, n: int, latent: Tuple[int, int, int],
                       methods: Sequence[str] = METHODS,
                       thresholds: Sequence[float] = THRESHOLDS
                       ) -> Dict[Tuple[str, float], Tuple[CodeDraws, CodeDraws]]:
    """The draws of every method x threshold, in that order, from a CPU
    ``generator``: (image code's, shape code's) for codes of ``n`` x
    ``latent`` (C, h, w)."""
    c, h, w = latent
    return {(m, t): (draw_code(generator, mask_settings(m, t, "mse"), n, c, (h, w)),
                     draw_code(generator, mask_settings(m, t, "ce"), n, c, (h, w)))
            for m in methods for t in thresholds}


@dataclass
class HardExamples:
    """One method x threshold: the corrupted image (N, H, W, image_ch) and
    segmentation logits (N, H, W, C), float32; the entropy map (N, H, W) of
    the logits; each code's mask (broadcast to the code's NCHW shape) and
    saliency ((N, C) or (N, h*w); None for dropout)."""

    image: torch.Tensor
    seg_logits: torch.Tensor
    entropy: torch.Tensor
    image_mask: torch.Tensor
    shape_mask: torch.Tensor
    image_saliency: Optional[torch.Tensor]
    shape_saliency: Optional[torch.Tensor]


def as_trainer(trainer: Union[CooperativeTrainer, Mapping],
               device: Union[str, torch.device] = "cuda") -> CooperativeTrainer:
    """A trainer, or ``{module: state_dict}`` (a checkpoint's state) loaded
    into a float32 trainer without latent DA on ``device``."""
    if isinstance(trainer, CooperativeTrainer):
        return trainer
    out = CooperativeTrainer(None, device=device)
    out.model.load_state_dicts(trainer)
    return out


def hard_example_arrays(trainer: CooperativeTrainer, images_nhwc: torch.Tensor,
                        labels_nhw: torch.Tensor, thresholds: Sequence[float] = THRESHOLDS,
                        methods: Sequence[str] = METHODS,
                        draws: Optional[Dict[Tuple[str, float],
                                             Tuple[CodeDraws, CodeDraws]]] = None,
                        generator: Optional[torch.Generator] = None
                        ) -> Dict[Tuple[str, float], HardExamples]:
    """The corrupted images and segmentations of every method x threshold
    (see the module docstring), on the trainer's device.  ``draws``:
    :func:`draw_hard_examples`'s, or drawn from ``generator`` (default
    seed 0).  The trainer's parameters, statistics and module modes are
    left as they were.  A trainer with layer dropout is refused: as in the
    JAX package, the visualization draws no dropout masks."""
    if trainer.dropout_sites:
        raise ValueError("hard_example_arrays: the trainer has layer dropout; the "
                         "visualization draws no dropout masks")
    model = trainer.model
    device = next(model.parameters()).device
    x = torch.as_tensor(images_nhwc, dtype=torch.float32).to(device)
    x = x.permute(0, 3, 1, 2).contiguous()
    labels = torch.as_tensor(labels_nhw).to(device).long()
    out: Dict[Tuple[str, float], HardExamples] = {}
    with model.in_mode(training=True), frozen_stats(model):
        with torch.no_grad():
            (z_i, z_s), _ = model.fast_predict(x)
        if draws is None:
            gen = generator if generator is not None else torch.Generator().manual_seed(0)
            draws = draw_hard_examples(gen, x.shape[0], tuple(z_i.shape[1:]), methods,
                                       thresholds)
        img_dec = trainer._frozen_decoder("image_decoder")
        seg_dec = trainer._frozen_decoder("segmentation_decoder")
        for method in methods:
            for thr in thresholds:
                d_img, d_seg = (d.to(device) for d in draws[(method, thr)])
                zi, mask_i, sal_i = perturb_latent_code(
                    z_i, img_dec, x, mask_settings(method, thr, "mse"), d_img,
                    model.num_classes)
                zs, mask_s, sal_s = perturb_latent_code(
                    z_s, seg_dec, labels, mask_settings(method, thr, "ce"), d_seg,
                    model.num_classes)
                with torch.no_grad():
                    image = img_dec(zi).float().permute(0, 2, 3, 1)
                    seg = seg_dec(zs).float().permute(0, 2, 3, 1)
                out[(method, thr)] = HardExamples(image, seg, prediction_entropy(seg),
                                                  mask_i, mask_s, sal_i, sal_s)
    return out


def save_hard_example_grids(examples: Dict[Tuple[str, float], HardExamples],
                            images_nhwc, out_dir: str, num_classes: int,
                            n_show: int = 4) -> List[str]:
    """One PNG a method x threshold, ``hard_examples_{method}_thr{thr}.png``
    under ``out_dir``: rows input, corrupted image, corrupted segmentation
    (argmax) and entropy, for the first ``n_show`` samples (the JAX
    package's grid).  Returns the paths written."""
    plt = _plt()
    os.makedirs(out_dir, exist_ok=True)
    images = np.asarray(torch.as_tensor(images_nhwc).float().cpu())
    n = min(n_show, images.shape[0])
    paths = []
    for (method, thr), ex in examples.items():
        img = ex.image.cpu().numpy()
        seg = ex.seg_logits.cpu().numpy()
        ent = ex.entropy.cpu().numpy()
        fig, axes = plt.subplots(4, n, figsize=(2.4 * n, 9), squeeze=False)
        for i in range(n):
            axes[0][i].imshow(images[i, :, :, 0], cmap="gray")
            axes[1][i].imshow(img[i, :, :, 0], cmap="gray")
            axes[2][i].imshow(np.argmax(seg[i], -1), vmin=0, vmax=num_classes - 1)
            axes[3][i].imshow(ent[i], cmap="magma")
            for r in range(4):
                axes[r][i].axis("off")
        for r, title in enumerate(["input", "corrupted image", "corrupted seg", "entropy"]):
            pos = axes[r][0].get_position()
            fig.text(0.02, (pos.y0 + pos.y1) / 2, title, rotation=90, va="center",
                     ha="center", fontsize=9)
        path = join(out_dir, f"hard_examples_{method}_thr{thr}.png")
        fig.suptitle(f"method={method} threshold={thr}")
        fig.savefig(path, bbox_inches="tight", dpi=80)
        plt.close(fig)
        paths.append(path)
    return paths


def visualize_hard_examples(trainer: Union[CooperativeTrainer, Mapping], images_nhwc,
                            labels_nhw, out_dir: str,
                            thresholds: Sequence[float] = THRESHOLDS,
                            methods: Sequence[str] = METHODS,
                            generator: Optional[torch.Generator] = None,
                            device: Union[str, torch.device] = "cuda") -> List[str]:
    """Hard-example grids (vis_hard_example.ipynb cells 0-13): the arrays
    of :func:`hard_example_arrays`, drawn by
    :func:`save_hard_example_grids`.  ``trainer``: a
    :class:`CooperativeTrainer`, or a checkpoint's ``{module: state_dict}``
    loaded onto ``device``.  Returns the PNG paths."""
    trainer = as_trainer(trainer, device)
    examples = hard_example_arrays(trainer, images_nhwc, labels_nhw, thresholds, methods,
                                   generator=generator)
    return save_hard_example_grids(examples, images_nhwc, out_dir,
                                   trainer.model.num_classes)
