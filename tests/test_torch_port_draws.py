"""The port's own random draws against the JAX package's distributions.

Every parity test feeds the port JAX's replayed draws
(``torch_port_util.replay_draws``, ``replay_augment_draws``), so the
port's own draw sources are held nowhere else: ``ops/augment.py:
draw_augment`` (with the stages that turn its raw uniforms into
parameters), ``train/draws.py:draw_step`` (with the masking that reads its
branch, keep mask, percentile and soft values) and ``train/predictor.py:
init_parameters``.  Here each is sampled many times (``N`` = 2000 a field)
beside the JAX package's own ``jax.random`` draws through its own
functions, and the two samples are compared:

- a two-sample Kolmogorov-Smirnov statistic D within ``ks_limit(n, m)``,
  the critical value at significance ``ALPHA`` = 1e-4,
  ``sqrt(-ln(ALPHA / 2) / 2) sqrt((n + m) / (n m))`` (0.070 at 2000 a
  side); one-sample tests against an exact distribution use
  ``sqrt(-ln(ALPHA / 2) / 2) / sqrt(n)``;
- rates (gates, flips, branches, keep masks) within ``N_SE`` = 5 standard
  errors of the difference of two binomial proportions;
- means within ``N_SE`` standard errors of their difference.

The draws are made from fixed seeds and keys, so each comparison is one
fixed number.  A wrong range, gate probability, scale or shape moves D or
a rate by far more than these limits.

The initial weights: per layer, the port's kernels (over ``INIT_SEEDS``)
and JAX's (over as many keys, through ``convert.from_jax``, so each JAX
kernel lands on the port's layer) against flax's ``he_normal`` exactly
(z = w / sqrt(2 / fan_in) times 0.8796... is the unit normal truncated at
+-2), the BN scales of each module against N(1, 0.02^2).  And the cause
of the seed-band gap: ``init_parameters`` drew with
``torch.nn.init.trunc_normal_`` and ``torch.randn``, whose algorithms
change between torch releases, so a seed gave other weights on the card's
torch than here; :func:`test_init_draws_do_not_depend_on_torch_samplers`
pins the weights of seed 40 to their values (sums recorded once) and to
the port's own inverse-CDF sampler, without calling torch's samplers.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats
from torch_port_util import one_torch_thread  # noqa: F401 - a fixture

from cooperative_training_and_latent_space_data_augmentation_tpu.ops import augment as JA
from cooperative_training_and_latent_space_data_augmentation_tpu.ops import masking as JM
from cooperative_training_and_latent_space_data_augmentation_tpu.train.cooperative import (
    CooperativeTripletSolver,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch import convert
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.config import (
    ExperimentConfig,
    LatentDAConfig,
    MaskConfig,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.ops import augment as A
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.ops.masking import (
    perturb_latent_code,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.train import predictor
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.train.draws import (
    draw_code,
    draw_step,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.train.predictor import (
    TRUNC_STD,
    CooperativePredictor,
)

N = 2000
ALPHA = 1e-4
N_SE = 5.0
C_ALPHA = math.sqrt(-math.log(ALPHA / 2.0) / 2.0)
CONFIG = "configs/ACDC/cooperative_training.json"
INIT_SEEDS = (0, 1, 2)


def ks_limit(n: int, m: int = None) -> float:
    return C_ALPHA * (1.0 / math.sqrt(n) if m is None else math.sqrt((n + m) / (n * m)))


def assert_same_distribution(got, want, what):
    got, want = np.ravel(got).astype(np.float64), np.ravel(want).astype(np.float64)
    d = stats.ks_2samp(got, want).statistic
    assert d <= ks_limit(got.size, want.size), (what, d, ks_limit(got.size, want.size))
    se = math.sqrt(got.var() / got.size + want.var() / want.size)
    assert abs(got.mean() - want.mean()) <= N_SE * se + 1e-12, (what, got.mean(), want.mean())


def assert_same_rate(got, want, what):
    got, want = np.ravel(got).astype(np.float64), np.ravel(want).astype(np.float64)
    p = (got.sum() + want.sum()) / (got.size + want.size)
    se = math.sqrt(max(p * (1 - p), 1e-12) * (1.0 / got.size + 1.0 / want.size))
    assert abs(got.mean() - want.mean()) <= N_SE * se, (what, got.mean(), want.mean())


def _config():
    return ExperimentConfig.from_json(CONFIG)


# ------------------------------------------------------------- augmentation
@pytest.fixture(scope="module")
def augment_samples():
    """The parameters of N samples under the configuration's policy, from
    JAX's keys through its own stage functions and from ``draw_augment``
    through the port's."""
    name = _config().data.data_aug_policy
    jp, tp = JA.get_policy(name), A.get_policy(name)
    h = w = 224
    eh = ew = 32  # the elastic fields at a small size; their scale is h * U
    probe = jnp.linspace(0.0, 1.0, 16, dtype=jnp.float32).reshape(4, 4, 1)
    keys = jax.random.split(jax.random.PRNGKey(0), N)

    def one(key):
        (k_flip, _, _, k_bc, k_gamma, k_affine, k_elastic, _, _, _, k_pbc, k_pg, k_pe,
         _) = jax.random.split(key, 14)
        corner = jnp.arange(16.0).reshape(4, 4, 1)
        flipped, _ = JA.random_flip(k_flip, corner, jnp.zeros((4, 4), jnp.int32), jp)
        mat, trans = JA._affine_inverse_matrix(k_affine, jp, h, w)
        dy, dx = JA._elastic_field(k_elastic, eh, ew, jp)
        return {"corner": flipped[0, 0, 0],
                "mat": mat.reshape(4), "trans": trans,
                "elastic_rms": jnp.stack([jnp.sqrt(jnp.mean(dy ** 2)),
                                          jnp.sqrt(jnp.mean(dx ** 2))]),
                "contrast": JA.brightness_contrast(k_bc, probe, jp).ravel(),
                "gamma": JA.random_gamma(k_gamma, probe, jp).ravel(),
                "gate_intensity": jax.random.uniform(k_pbc, ()) < jp.intensity_prob,
                "gate_gamma": jax.random.uniform(k_pg, ()) < jp.gamma_prob,
                "gate_elastic": jax.random.uniform(k_pe, ()) < jp.elastic_prob}

    want = jax.device_get(jax.jit(jax.vmap(one))(keys))
    gen = torch.Generator().manual_seed(0)
    d = A.draw_augment(gen, tp, N, (h, w))
    de = A.draw_augment(gen, tp, N, (eh, ew))
    corner = torch.arange(16.0).reshape(1, 4, 4, 1).expand(N, 4, 4, 1)
    flipped, _ = A.random_flip(d, corner, torch.zeros(N, 4, 4, dtype=torch.int64), tp)
    mat, trans = A._affine_inverse_matrix(d, tp, h, w)
    dy, dx = A._elastic_field(de, eh, ew)
    tprobe = torch.from_numpy(np.asarray(probe)).reshape(1, 4, 4, 1).expand(N, 4, 4, 1)
    got = {"corner": flipped[:, 0, 0, 0], "mat": mat.reshape(N, 4), "trans": trans,
           "elastic_rms": torch.stack([dy.square().mean((1, 2)).sqrt(),
                                       dx.square().mean((1, 2)).sqrt()], 1),
           "contrast": A.brightness_contrast(d, tprobe, tp).reshape(N, -1)}
    if tp.gamma_prob > 0:
        got["gamma"] = A.random_gamma(d, tprobe, tp).reshape(N, -1)
    for gate, prob in A.GATES.items():
        if gate.startswith("gate_") and getattr(d, gate) is not None:
            got[gate] = getattr(d, gate) < getattr(tp, prob)
    return {k: np.asarray(v) for k, v in got.items()}, {k: np.asarray(v) for k, v in
                                                           want.items()}, tp


def test_policy_is_the_jax_policy():
    name = _config().data.data_aug_policy
    assert name == "ACDC_affine_elastic_intensity"
    jp, tp = JA.get_policy(name), A.get_policy(name)
    for f in ("flip_h", "flip_v", "flip_p", "shift_val", "rotate_val", "scale_val",
              "shear_val", "rotate_groups", "intensity_prob", "gamma_prob", "elastic_prob",
              "elastic_prob_v2", "perturb_prob", "perturb_v2_prob", "contrast_range",
              "brightness_range", "gamma_range"):
        assert tuple(np.ravel(getattr(tp, f))) == tuple(np.ravel(getattr(jp, f))), f


def test_augment_gates_and_flips_match_jax_rates(augment_samples):
    got, want, policy = augment_samples
    gates = [k for k in got if k.startswith("gate_")]
    assert sorted(gates) == sorted(k for k in want if k.startswith("gate_")
                                   and getattr(policy, A.GATES[k]) > 0)
    for gate in gates:
        assert_same_rate(got[gate], want[gate], gate)
    # the probe's corner after the flips: 0 (none), 3 (W), 12 (H), 15 (both)
    for corner in (0.0, 3.0, 12.0, 15.0):
        assert_same_rate(got["corner"] == corner, want["corner"] == corner, ("flip", corner))
    assert set(np.unique(got["corner"])) <= {0.0, 3.0, 12.0, 15.0}


@pytest.mark.parametrize("field", ["mat", "trans", "elastic_rms", "contrast", "gamma"])
def test_augment_parameters_match_jax_distribution(augment_samples, field):
    """Each entry of the inverse affine matrix and shift (rotation with its
    group, shear, zoom, shift), the elastic field's RMS per axis
    (amplitude and smoothing), and brightness/contrast and gamma on a probe
    image, entry by entry (gamma only where the policy has it: the
    configuration's has not, and then the port draws nothing for it)."""
    got, want, policy = augment_samples
    if field == "gamma" and policy.gamma_prob == 0:
        assert "gamma" not in got and "gate_gamma" not in got
        return
    assert got[field].shape == want[field].shape, field
    for j in range(got[field].shape[1]):
        assert_same_distribution(got[field][:, j], want[field][:, j], (field, j))


# --------------------------------------------------------------- the step
LATENT = (2, 8, 3, 3)  # n, c, h, w of a small code


def _decoders():
    """A small decoder in both packages (NHWC in JAX, NCHW in the port):
    a weighted channel sum for an image code, four for a shape code (so no
    two channels tie in saliency)."""
    w = np.random.RandomState(3).normal(size=(LATENT[1], 5)).astype(np.float32)
    return ({"image": lambda z: z @ jnp.asarray(w[:, :1]),
             "shape": lambda z: z @ jnp.asarray(w[:, 1:])},
            {"image": lambda z: torch.einsum("nchw,ck->nkhw", z, torch.from_numpy(w[:, :1])),
             "shape": lambda z: torch.einsum("nchw,ck->nkhw", z, torch.from_numpy(w[:, 1:]))})


@pytest.fixture(scope="module")
def step_samples(one_torch_thread):  # noqa: F811
    """Branches and masks of N perturbations of each code under the
    configuration's settings, on one fixed code and target a code: JAX's
    ``perturb_latent_code`` from N keys, the port's from ``draw_step``."""
    cfg = _config()
    lda = cfg.latent_DA
    n, c, h, w = LATENT
    rs = np.random.RandomState(5)
    code = rs.normal(size=(n, h, w, c)).astype(np.float32)
    targets = {"image": rs.uniform(size=(n, h, w, 1)).astype(np.float32),
               "shape": rs.randint(0, 4, (n, h, w)).astype(np.int32)}
    jdec, tdec = _decoders()
    out = {}
    for key_name, mc in (("image", lda.image_code), ("shape", lda.shape_code)):
        settings = JM.MaskSettings(mc.loss_name, mc.mask_type, mc.max_threshold,
                                   mc.random_threshold, mc.if_soft)

        def one(k, settings=settings, key_name=key_name):
            _, mask, branch = JM.perturb_latent_code(
                jnp.asarray(code), jdec[key_name], jnp.asarray(targets[key_name]), k,
                settings, num_classes=4, return_branch=True)
            return mask, branch

        mask, branch = jax.device_get(jax.jit(jax.vmap(one))(
            jax.random.split(jax.random.PRNGKey(1), N)))
        out[key_name] = {"jax_branch": np.asarray(branch),
                         "jax_mask": np.asarray(mask).transpose(0, 1, 4, 2, 3)}
    gen = torch.Generator().manual_seed(1)
    tcode = torch.from_numpy(code).permute(0, 3, 1, 2).contiguous()
    ttargets = {"image": torch.from_numpy(targets["image"]).permute(0, 3, 1, 2).contiguous(),
                "shape": torch.from_numpy(targets["shape"]).long()}
    branches, masks, noise = {"image": [], "shape": []}, {"image": [], "shape": []}, []
    for _ in range(N):
        d = draw_step(gen, n, (16 * h, 16 * w), lda, latent_ch=c)
        noise.append(d.noise[0, 0, :4, :4].numpy().ravel())
        for key_name, mc, cd in (("image", lda.image_code, d.image),
                                 ("shape", lda.shape_code, d.shape)):
            _, mask, _ = perturb_latent_code(tcode, tdec[key_name], ttargets[key_name], mc, cd)
            branches[key_name].append(cd.branch)
            masks[key_name].append(mask.numpy())
    for key_name in ("image", "shape"):
        out[key_name]["branch"] = np.asarray(branches[key_name])
        out[key_name]["mask"] = np.stack(masks[key_name])
    out["noise"] = np.concatenate(noise)
    keys = jax.random.split(jax.random.PRNGKey(2), N)
    out["jax_noise"] = np.asarray(jax.vmap(
        lambda k: jax.random.normal(jax.random.split(k, 3)[0], (1, 4, 4, 1)).ravel())(keys))
    return out


@pytest.mark.parametrize("code", ["image", "shape"])
def test_step_branch_rates_match_jax(step_samples, code):
    s = step_samples[code]
    for b in range(3):
        assert_same_rate(s["branch"] == b, s["jax_branch"] == b, (code, b))


@pytest.mark.parametrize("code", ["image", "shape"])
def test_step_masks_match_jax_distribution(step_samples, code):
    """Dropout: the keep rate of each channel; targeted branches: the
    fraction of the code masked (set by p = U(0, 1) max_threshold through
    the percentile) and the soft values written there (0.5 U(0, 1))."""
    s = step_samples[code]
    for b in range(3):
        got, want = s["mask"][s["branch"] == b], s["jax_mask"][s["jax_branch"] == b]
        assert len(got) > N // 5 and len(want) > N // 5, (code, b, len(got), len(want))
        if b == 0:
            assert set(np.unique(got)) <= {0.0, 1.0}
            assert_same_rate(got[:, :, :, 0, 0], want[:, :, :, 0, 0], (code, "keep"))
            continue
        # the mask before its broadcast: (n, h, w) for spatial, (n, c) for channel
        got, want = (x[:, :, 0] if b == 1 else x[:, :, :, 0, 0] for x in (got, want))
        axes = tuple(range(1, got.ndim))
        assert_same_distribution((got < 1).mean(axes), (want < 1).mean(axes),
                                 (code, b, "masked share"))
        assert_same_distribution(got[got < 1], want[want < 1], (code, b, "soft values"))


def test_step_noise_matches_jax_distribution(step_samples):
    assert_same_distribution(step_samples["noise"], step_samples["jax_noise"], "noise")
    d = stats.kstest(step_samples["noise"], "norm").statistic
    assert d <= ks_limit(step_samples["noise"].size), d


def test_draw_code_fields_follow_the_settings():
    """Shapes and ranges of each branch's fields (dropout keep 0/1 at
    1 - max_threshold; p in [0, max_threshold); soft in [0, 0.5); hard
    masks write zeros; fixed thresholds give p = max_threshold)."""
    gen = torch.Generator().manual_seed(4)
    for mask_type, branch in (("dropout", 0), ("spatial", 1), ("channel", 2)):
        for soft, rand in ((True, True), (False, False)):
            cfg = MaskConfig(mask_type=mask_type, max_threshold=0.3, random_threshold=rand,
                             if_soft=soft)
            cd = draw_code(gen, cfg, 5, 8, (3, 4))
            assert cd.branch == branch
            if branch == 0:
                assert cd.keep.shape == (5, 8) and set(cd.keep.unique().tolist()) <= {0.0, 1.0}
                continue
            assert cd.soft.shape == (5, 8 if branch == 2 else 12)
            assert 0.0 <= float(cd.p) <= np.float32(0.3) and (rand or float(cd.p) == pytest.approx(0.3))
            assert (cd.soft < 0.5).all() and (cd.soft >= 0).all() and (soft or not cd.soft.any())


# ------------------------------------------------------ initial weights
@pytest.fixture(scope="module")
def init_samples():
    """{port state-dict key of every module: (port values, JAX values)},
    each pooled over INIT_SEEDS."""
    solver = CooperativeTripletSolver(input_hw=(32, 32))
    port, jaxs = {}, {}
    for seed in INIT_SEEDS:
        model = CooperativePredictor(device="cpu", seed=seed)
        state = solver.init_state(jax.random.PRNGKey(seed))
        sds = convert.from_jax(jax.device_get(state.params), jax.device_get(state.batch_stats))
        for name in predictor.MODULE_NAMES:
            for k, v in getattr(model, name).state_dict().items():
                port.setdefault(f"{name}.{k}", []).append(v.numpy().ravel())
                jaxs.setdefault(f"{name}.{k}", []).append(sds[name][k].numpy().ravel())
    shapes = {k: getattr(CooperativePredictor(device="cpu"), k.split(".")[0]).state_dict()[
        k.split(".", 1)[1]].shape for k in port}
    return {k: (np.concatenate(port[k]), np.concatenate(jaxs[k]), shapes[k]) for k in port}


def _kernel_keys(samples):
    return [k for k in samples if k.endswith(".weight") and len(samples[k][2]) == 4]


def test_init_has_the_jax_layers(init_samples):
    """Every JAX kernel lands on a port kernel of its size (``from_jax``
    fills every key of the port's state dicts)."""
    state = CooperativeTripletSolver(input_hw=(32, 32)).init_state(jax.random.PRNGKey(0))
    kernels = [leaf for path, leaf in jax.tree_util.tree_flatten_with_path(state.params)[0]
               if getattr(path[-1], "key", None) == "kernel"]
    assert len(_kernel_keys(init_samples)) == len(kernels)
    for k, (p, j, _) in init_samples.items():
        assert p.shape == j.shape, k


def test_init_kernels_per_layer_are_he_normal(init_samples):
    """Per layer: z = w / sqrt(2 / fan_in) times 0.8796 against the unit
    normal truncated at +-2 (one-sample KS for the port, and for JAX's as a
    check of the rule), port against JAX (two-sample KS), both under the
    cut."""
    cut = 2.0 / TRUNC_STD
    tn = stats.truncnorm(-2.0, 2.0)
    for k in _kernel_keys(init_samples):
        p, j, shape = init_samples[k]
        transposed = "up.weight" in k
        fan_in = (shape[0] if transposed else shape[1]) * shape[2] * shape[3]
        zp, zj = (x.astype(np.float64) / math.sqrt(2.0 / fan_in) for x in (p, j))
        assert np.abs(zp).max() <= cut * (1 + 1e-6) and np.abs(zj).max() <= cut * (1 + 1e-6), k
        for z, who in ((zp, "port"), (zj, "jax")):
            d = stats.kstest(z * TRUNC_STD, tn.cdf).statistic
            assert d <= ks_limit(z.size), (k, who, d, ks_limit(z.size))
        assert stats.ks_2samp(zp, zj).statistic <= ks_limit(zp.size, zj.size), k


def test_init_biases_bn_and_running_stats_match_jax(init_samples):
    """Zero biases and BN shifts, zero running means, unit running
    variances in both; the BN scales of each module, pooled, against
    N(1, 0.02^2) and against JAX's."""
    scales = {}
    for k, (p, j, shape) in init_samples.items():
        if k.endswith(".bias") or k.endswith("running_mean"):
            assert not p.any() and not j.any(), k
        elif k.endswith("running_var"):
            assert (p == 1).all() and (j == 1).all(), k
        elif k.endswith(".weight") and len(shape) == 1:
            s = scales.setdefault(k.split(".")[0], ([], []))
            s[0].append(p)
            s[1].append(j)
    assert len(scales) == 5
    for module, (p, j) in scales.items():
        p, j = np.concatenate(p).astype(np.float64), np.concatenate(j).astype(np.float64)
        d = stats.kstest((p - 1.0) / 0.02, "norm").statistic
        assert d <= ks_limit(p.size), (module, d)
        assert_same_distribution(p, j, (module, "bn scale"))


def test_init_draws_do_not_depend_on_torch_samplers(monkeypatch):
    """The cause of the card's other start: the weights a seed gives must
    not come from torch's ``trunc_normal_`` or ``randn`` (their algorithms
    differ between torch releases: a rejection sampler in 2.13, the inverse
    CDF in 2.11).  With both refused the predictor still builds, its
    kernels equal the port's own inverse-CDF draws of the seed, and the
    per-module sums equal the ones recorded for seed 40 (within 1e-9,
    relative)."""
    def refuse(*a, **k):
        raise AssertionError("initial weights drawn by a torch sampler")

    monkeypatch.setattr(torch.nn.init, "trunc_normal_", refuse)
    monkeypatch.setattr(torch, "randn", refuse)
    monkeypatch.setattr(torch.Tensor, "normal_", refuse)
    model = CooperativePredictor(device="cpu", seed=40)
    for name, (s, a) in SEED40_WEIGHTS.items():
        ps = [p.detach().double() for p in getattr(model, name).parameters()]
        assert sum(float(p.sum()) for p in ps) == pytest.approx(s, rel=1e-9, abs=1e-9), name
        assert sum(float(p.abs().sum()) for p in ps) == pytest.approx(a, rel=1e-9), name
    gen = torch.Generator().manual_seed(40)
    first = model.image_encoder.general_encoder.inc[0].weight
    fan_in = first.shape[1] * 9
    want = math.sqrt(2.0 / fan_in) / TRUNC_STD * predictor._unit_normal(gen, first.shape, 2.0)
    assert torch.equal(first.detach(), want.float())


# per module [sum, sum of magnitudes] of seed 40's parameters
# (cli/fingerprint.py on this tree; tests/test_torch_port_cuda.py holds the
# card's to the same numbers)
SEED40_WEIGHTS = {
    "image_encoder": [1174.6895386615265, 47123.90627765826],
    "segmentation_decoder": [250.83442858121276, 8428.824090746222],
    "shape_encoder": [891.244073824254, 36820.035105427545],
    "shape_decoder": [275.2300761273185, 8412.937298341498],
    "image_decoder": [228.19469987941488, 13517.991796717994],
}


def test_unit_normal_is_the_truncated_normal():
    gen = torch.Generator().manual_seed(9)
    z = predictor._unit_normal(gen, (200_000,), 2.0).numpy()
    assert np.abs(z).max() <= 2.0
    assert stats.kstest(z, stats.truncnorm(-2.0, 2.0).cdf).statistic <= ks_limit(z.size)
    z = predictor._unit_normal(gen, (200_000,)).numpy()
    assert np.isfinite(z).all()
    assert stats.kstest(z, "norm").statistic <= ks_limit(z.size)


def test_latent_da_config_is_the_json_one():
    lda = _config().latent_DA
    assert isinstance(lda, LatentDAConfig)
    assert lda.gen_corrupted_image and lda.gen_corrupted_seg
    for mc, loss in ((lda.image_code, "mse"), (lda.shape_code, "ce")):
        assert (mc.loss_name, mc.mask_type, mc.max_threshold, mc.random_threshold,
                mc.if_soft) == (loss, "random", 0.5, True, True)
