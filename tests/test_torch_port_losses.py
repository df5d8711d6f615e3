"""The port's loss zoo (``ops/losses.py``) against the JAX package's, on the
CPU.

Every loss and every ``basic_loss_fn`` type on the same inputs, made with
numpy from a seed (logits 2 x 4 x 32 x 32, 3-D 2 x 4 x 4 x 32 x 32; the JAX
side channels-last, jitted), with the gradient of each float input.
Tolerances, f32: the loss within 1e-5 of its value (plus 1e-7 for a loss
near 0); each gradient within 1e-4 of its largest |g|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cooperative_training_and_latent_space_data_augmentation_tpu.ops import losses as J
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.ops import losses as P
from torch_port_util import one_torch_thread  # noqa: F401

N, C, HW = 2, 4, 32
RNG = np.random.RandomState(11)
LOGITS = RNG.normal(0.0, 2.0, (N, C, HW, HW)).astype(np.float32)
REF = RNG.normal(0.0, 2.0, (N, C, HW, HW)).astype(np.float32)
PROBS = np.exp(REF) / np.exp(REF).sum(1, keepdims=True)
LABELS = RNG.randint(0, C, (N, HW, HW)).astype(np.int32)
LOGITS3 = RNG.normal(0.0, 2.0, (N, C, 4, HW, HW)).astype(np.float32)
LABELS3 = RNG.randint(0, C, (N, 4, HW, HW)).astype(np.int32)
FEATS = RNG.normal(0.0, 1.0, (N, 8, 16, 16)).astype(np.float32)
FEATS2 = RNG.normal(0.0, 1.0, (N, 8, 16, 16)).astype(np.float32)
FEATS3 = RNG.normal(0.0, 1.0, (N, 8, 16, 16)).astype(np.float32)
TEMPLATE = RNG.normal(0.0, 1.0, (1, 8, 16, 16)).astype(np.float32)
PAIR = np.array([1.0, 0.0], np.float32)
WEIGHTS = [0.1, 0.2, 0.3, 0.4]


def last(a):
    """Channels-first -> channels-last (any rank >= 3)."""
    return np.moveaxis(a, 1, -1)


# name -> (JAX function, port function, float inputs (channels-first)); the
# JAX function takes them channels-last
CASES = {
    "cross_entropy_2d": (lambda x: J.cross_entropy_2d(x, LABELS),
                         lambda x: P.cross_entropy_2d(x, torch.from_numpy(LABELS)), [LOGITS]),
    "cross_entropy_2d_weighted": (
        lambda x: J.cross_entropy_2d(x, LABELS, weight=WEIGHTS),
        lambda x: P.cross_entropy_2d(x, torch.from_numpy(LABELS), weight=WEIGHTS), [LOGITS]),
    "cross_entropy_2d_soft": (lambda x, r: J.cross_entropy_2d(x, r),
                              lambda x, r: P.cross_entropy_2d(x, r), [LOGITS, REF]),
    "cross_entropy_2d_soft_weighted": (
        lambda x, r: J.cross_entropy_2d(x, r, weight=WEIGHTS),
        lambda x, r: P.cross_entropy_2d(x, r, weight=WEIGHTS), [LOGITS, REF]),
    "cross_entropy_3d": (lambda x: J.cross_entropy_3d(x, LABELS3, weight=WEIGHTS),
                         lambda x: P.cross_entropy_3d(x, torch.from_numpy(LABELS3),
                                                      weight=WEIGHTS), [LOGITS3]),
    "cross_entropy_3d_sum": (lambda x: J.cross_entropy_3d(x, LABELS3, size_average=False),
                             lambda x: P.cross_entropy_3d(x, torch.from_numpy(LABELS3),
                                                          size_average=False), [LOGITS3]),
    "soft_dice_loss": (lambda x: J.soft_dice_loss(x, LABELS),
                       lambda x: P.soft_dice_loss(x, torch.from_numpy(LABELS)), [LOGITS]),
    "soft_dice_loss_probs_square_weight": (
        lambda x, p: J.soft_dice_loss(x, p, square_denom=True, weight=WEIGHTS),
        lambda x, p: P.soft_dice_loss(x, p, square_denom=True, weight=WEIGHTS), [LOGITS, PROBS]),
    "soft_dice_loss_soft_logits": (
        lambda x, r: J.soft_dice_loss(x, r, target_is_soft_logits=True),
        lambda x, r: P.soft_dice_loss(x, r, target_is_soft_logits=True), [LOGITS, REF]),
    "soft_dice_loss_3d": (lambda x: J.soft_dice_loss_3d(x, LABELS3),
                          lambda x: P.soft_dice_loss_3d(x, torch.from_numpy(LABELS3)), [LOGITS3]),
    "selective_soft_dice_loss": (
        lambda x: J.selective_soft_dice_loss(x, LABELS, [1, 3]),
        lambda x: P.selective_soft_dice_loss(x, torch.from_numpy(LABELS), [1, 3]), [LOGITS]),
    "focal_loss": (lambda x: J.focal_loss(x, LABELS, gamma=2.0),
                   lambda x: P.focal_loss(x, torch.from_numpy(LABELS), gamma=2.0), [LOGITS]),
    "focal_loss_alpha": (lambda x: J.focal_loss(x, LABELS, gamma=1.5, alpha=WEIGHTS),
                         lambda x: P.focal_loss(x, torch.from_numpy(LABELS), gamma=1.5,
                                                alpha=WEIGHTS), [LOGITS]),
    "entropy_loss": (lambda x: J.entropy_loss(x), lambda x: P.entropy_loss(x), [LOGITS]),
    "entropy_loss_normalized": (lambda x: J.entropy_loss(x, normalize=True),
                                lambda x: P.entropy_loss(x, normalize=True), [LOGITS]),
    "kl_divergence": (J.kl_divergence, P.kl_divergence, [LOGITS, REF]),
    "brier_loss": (lambda x: J.brier_loss(x, LABELS),
                   lambda x: P.brier_loss(x, torch.from_numpy(LABELS)), [LOGITS]),
    "smooth_l1_loss": (J.smooth_l1_loss, P.smooth_l1_loss, [FEATS, FEATS2]),
    "calc_angular_loss": (J.calc_angular_loss, P.calc_angular_loss, [FEATS, FEATS2]),
    "calc_correlation_loss": (J.calc_correlation_loss, P.calc_correlation_loss,
                              [FEATS, FEATS2]),
    "gram_matrix": (lambda a: jnp.sum(J.gram_matrix(a) * jnp.arange(64.0).reshape(8, 8)),
                    lambda a: torch.sum(P.gram_matrix(a) * torch.arange(64.0).reshape(8, 8)),
                    [FEATS]),
    "style_loss": (J.style_loss, P.style_loss, [FEATS, FEATS2]),
    "contour_loss": (lambda p: J.contour_loss(p, LABELS, C),
                     lambda p: P.contour_loss(p, torch.from_numpy(LABELS), C), [PROBS]),
    # classes 0 and 1 of soft maps (over all C classes they sum to 1: no edges)
    "contour_loss_soft_all": (
        lambda p, q: J.contour_loss(p, q, 2, foreground_only=False, one_hot_target=False),
        lambda p, q: P.contour_loss(p, q, 2, foreground_only=False, one_hot_target=False),
        [PROBS, PROBS[::-1].copy()]),
    "calc_triplet_loss": (J.calc_triplet_loss, P.calc_triplet_loss, [FEATS, FEATS2, FEATS3]),
    "contrastive_loss": (lambda a, b: J.contrastive_loss(a, b, PAIR, margin=60.0),
                         lambda a, b: P.contrastive_loss(a, b, torch.from_numpy(PAIR),
                                                         margin=60.0), [FEATS, FEATS2]),
    "nt_xent_loss": (J.nt_xent_loss, P.nt_xent_loss, [FEATS, FEATS2]),
    "mse_segmentation_consistency": (J.mse_segmentation_consistency,
                                     P.mse_segmentation_consistency, [LOGITS, REF]),
    "calc_segmentation_consistency": (
        lambda x, r: J.calc_segmentation_consistency(
            x, r, ("kl", "ce", "mse", "Dice", "contour"), (1.0, 0.5, 0.3, 0.2, 0.1), C, (0, 1)),
        lambda x, r: P.calc_segmentation_consistency(
            x, r, ("kl", "ce", "mse", "Dice", "contour"), (1.0, 0.5, 0.3, 0.2, 0.1), C, (0, 1)),
        [LOGITS, REF]),
    "hierarchical_loss": (
        lambda a, b, c: J.hierarchical_loss([a, b, c], LABELS, (1.0, 0.5, 2.0)),
        lambda a, b, c: P.hierarchical_loss([a, b, c], torch.from_numpy(LABELS), (1.0, 0.5, 2.0)),
        [LOGITS[:, :2].copy(), LOGITS[:, 1:].copy(), REF]),
    "intra_subject_latent_consistency_loss": (
        lambda a, b, c: J.intra_subject_latent_consistency_loss([a, b, c]),
        lambda a, b, c: P.intra_subject_latent_consistency_loss([a, b, c]),
        [FEATS, FEATS2, FEATS3]),
    "inter_template_consistency_loss": (
        lambda a: J.inter_template_consistency_loss(a, 0.7),
        lambda a: P.inter_template_consistency_loss(a, 0.7), [FEATS]),
    "laplacian_smoothness_loss": (
        lambda p: J.laplacian_smoothness_loss(p, LABELS, C),
        lambda p: P.laplacian_smoothness_loss(p, torch.from_numpy(LABELS), C), [PROBS]),
    "zncc_loss": (J.zncc_loss, P.zncc_loss, [TEMPLATE, FEATS]),
    "zncc_loss_zero_mean": (lambda t, x: J.zncc_loss(t, x, zero_mean=True),
                            lambda t, x: P.zncc_loss(t, x, zero_mean=True), [TEMPLATE, FEATS]),
}
for _t in P.LOSS_TYPES:
    CASES[f"basic_loss_fn[{_t}]"] = (
        lambda x, t=_t: J.basic_loss_fn(x, LABELS, t),
        lambda x, t=_t: P.basic_loss_fn(x, torch.from_numpy(LABELS), t), [LOGITS])


@pytest.mark.parametrize("name", sorted(CASES))
def test_loss_and_gradients_match_jax(name):
    jfn, pfn, inputs = CASES[name]
    jax_inputs = [jnp.asarray(last(a)) for a in inputs]
    want, grads = jax.jit(jax.value_and_grad(jfn, argnums=tuple(range(len(inputs)))))(*jax_inputs)
    ts = [torch.from_numpy(a.copy()).requires_grad_(True) for a in inputs]
    got = pfn(*ts)
    got.backward()
    want = float(want)
    got = float(got.detach())
    assert abs(got - want) <= 1e-5 * abs(want) + 1e-7, (name, got, want)
    for i, (t, g) in enumerate(zip(ts, grads)):
        g = np.asarray(g)
        top = float(np.abs(g).max())
        err = float(np.abs(last(t.grad.numpy()) - g).max())
        assert err <= 1e-4 * top, (name, i, err, top)


def test_weighted_dice_trains_like_dice():
    """'weighted dice' is 'dice' (the reference's Dice ignores its weight);
    'weighted cross entropy' weights each class 1/C, which normalises to
    the unweighted loss."""
    x, y = torch.from_numpy(LOGITS), torch.from_numpy(LABELS)
    assert torch.equal(P.basic_loss_fn(x, y, "weighted dice"), P.basic_loss_fn(x, y, "dice"))
    torch.testing.assert_close(P.basic_loss_fn(x, y, "weighted cross entropy"),
                               P.basic_loss_fn(x, y, "cross entropy"), rtol=1e-6, atol=0)
    with pytest.raises(NotImplementedError):
        P.basic_loss_fn(x, y, "hinge")
