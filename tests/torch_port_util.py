"""Shared set-up of the PyTorch port's parity tests (not a test module).

Parameters of the JAX solver are drawn with numpy from a seed, in the
shapes of its flax parameter tree (found with ``jax.eval_shape``, which
traces without compiling), so both packages get the same weights without
running the JAX initialisers.  :func:`replay_draws` replays the JAX train
step's key schedule into the port's :class:`StepDraws`, so both packages
see the same random numbers.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cooperative_training_and_latent_space_data_augmentation_tpu.train.cooperative import (
    MODULE_NAMES,
    CooperativeTripletSolver,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.ops.masking import (
    BRANCHES,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.train.draws import (
    CodeDraws,
    StepDraws,
)

HW = 32
BATCH = 2


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU work on one thread, for a test module that imports
    this fixture.  With torch's OpenMP pool on every core, the loop test's
    train steps ran about 10x slower on a loaded machine (a snapshot test:
    145 s against 17 s with one thread, 8 busy processes beside it); the
    parallel test run is such a machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_solver(compute_dtype=None) -> CooperativeTripletSolver:
    return CooperativeTripletSolver(input_hw=(HW, HW), compute_dtype=compute_dtype)


def _draw(path, shape, rng):
    leaf = path[-1]
    if leaf == "kernel":
        fan_in = int(np.prod(shape[:-1]))
        return rng.normal(0.0, np.sqrt(2.0 / fan_in), shape)
    if leaf == "scale":
        return rng.uniform(0.8, 1.2, shape)
    if leaf == "bias":
        return rng.normal(0.0, 0.05, shape)
    if leaf == "mean":
        return rng.normal(0.0, 0.1, shape)
    if leaf == "var":
        return rng.uniform(0.5, 1.5, shape)
    raise KeyError(path)


def _fill(tree, rng, path=()):
    if isinstance(tree, dict) or hasattr(tree, "items"):
        return {k: _fill(v, rng, path + (k,)) for k, v in sorted(tree.items())}
    return _draw(path, tree.shape, rng).astype(np.float32)


def random_variables(solver: CooperativeTripletSolver, seed: int = 0):
    """(params, batch_stats) for every module, numpy, from ``seed``."""
    h, w = solver.input_hw
    lh, lw = solver.latent_hw
    sample = {
        "image_encoder": (1, h, w, solver.image_ch),
        "segmentation_decoder": (1, lh, lw, solver.latent_ch),
        "image_decoder": (1, lh, lw, solver.latent_ch),
        "shape_encoder": (1, h, w, solver.num_classes),
        "shape_decoder": (1, lh, lw, solver.latent_ch),
    }
    rng = np.random.RandomState(seed)
    params, stats = {}, {}
    for name in MODULE_NAMES:
        shapes = jax.eval_shape(
            lambda m=solver.modules[name], s=sample[name]: m.init(
                jax.random.PRNGKey(0), jnp.zeros(s), train=False))
        params[name] = _fill(shapes["params"], rng)
        stats[name] = _fill(shapes["batch_stats"], rng)
    return params, stats


@contextlib.contextmanager
def pallas_interpret(s2: bool = False, nl: bool = False, max_ch: int = None):
    """Run the JAX package's Pallas paths in interpret mode on the CPU (the
    switch is read when a function is traced); with ``s2`` also its
    ``PALLAS_CONV_S2=1`` configuration (the stride-2 phase kernel and CHW
    stage chaining), with ``nl`` its ``PALLAS_CONV_NL=1`` configuration (the
    NL-sublanes kernel on the large-channel convs); both need the Pallas
    path.  ``max_ch`` sets ``PALLAS_CONV_MAX_CH``, the CHW kernel's channel
    cutoff (0 leaves every conv it would take to XLA)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PALLAS_CONV_INTERPRET", "1")
        if s2:
            mp.setenv("PALLAS_CONV_S2", "1")
        if nl:
            mp.setenv("PALLAS_CONV_NL", "1")
        if max_ch is not None:
            mp.setenv("PALLAS_CONV_MAX_CH", str(max_ch))
        yield


def bf16_ulp(scale: float) -> float:
    """One bf16 ulp at magnitude ``scale`` (8 significant bits)."""
    return float(2.0 ** (np.floor(np.log2(scale)) - 7))


def assert_bf16_close(got, want_bf16, want_f32, what=""):
    """bf16 parity, held to the JAX package's own bf16 precision.

    Both packages round at the same points, but they sum in other orders,
    so single activations land one bf16 ulp apart and these random
    networks amplify such flips layer by layer.  The bound is what bf16
    itself costs the JAX package: the port may differ from JAX's bf16
    result by at most twice as much as that result differs from JAX's f32
    one, in the largest and in the mean absolute difference; and for class
    scores its argmax may disagree with JAX's bf16 argmax on at most twice
    the share of pixels where JAX's bf16 and f32 argmaxes disagree, plus
    0.5 %.
    """
    got = np.asarray(got, np.float32)
    want_bf16 = np.asarray(want_bf16, np.float32)
    want_f32 = np.asarray(want_f32, np.float32)
    assert got.shape == want_bf16.shape == want_f32.shape, what
    own = np.abs(want_bf16 - want_f32)
    diff = np.abs(got - want_bf16)
    assert diff.max() <= 2 * own.max(), (what, diff.max(), own.max())
    assert diff.mean() <= 2 * own.mean(), (what, diff.mean(), own.mean())
    if got.shape[-1] > 1:
        own_flip = np.mean(want_bf16.argmax(-1) != want_f32.argmax(-1))
        flip = np.mean(got.argmax(-1) != want_bf16.argmax(-1))
        assert flip <= 2 * own_flip + 0.005, (what, flip, own_flip)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def replay_code_draws(key, cfg, n: int, c: int, latent_hw) -> CodeDraws:
    """The draws ``ops/masking.py:perturb_latent_code`` makes from ``key``
    for one (n, h, w, c) code under the mask config ``cfg``:
    ``k_branch, k_op = split(key)``, the branch ``randint(k_branch, (), 0,
    3)`` under "random"; dropout's keep mask ``bernoulli(k_op, 1 - thr,
    (n, 1, 1, c))``; a targeted branch's ``k_thr, k_soft = split(k_op)``,
    ``p = uniform(k_thr) * thr`` and soft values ``0.5 * uniform(k_soft,
    (n, D))`` (zeros for hard masks)."""
    k_branch, k_op = jax.random.split(key)
    if cfg.mask_type == "random":
        branch = int(jax.random.randint(k_branch, (), 0, 3))
    else:
        branch = BRANCHES.index(cfg.mask_type)
    thr = cfg.max_threshold
    if branch == 0:
        keep = jax.random.bernoulli(k_op, 1.0 - thr, (n, 1, 1, c)).astype(jnp.float32)
        return CodeDraws(branch, keep=_t(keep).reshape(n, c))
    k_thr, k_soft = jax.random.split(k_op)
    p = jax.random.uniform(k_thr, ()) * thr if cfg.random_threshold else jnp.float32(thr)
    d = c if branch == 2 else latent_hw[0] * latent_hw[1]
    soft = (0.5 * jax.random.uniform(k_soft, (n, d), jnp.float32) if cfg.if_soft
            else jnp.zeros((n, d), jnp.float32))
    return CodeDraws(branch, p=_t(p), soft=_t(soft))


@contextlib.contextmanager
def record_jax_dropout():
    """Record the layer-dropout keep masks the JAX package draws, in the
    order its step runs them: flax's ``nn.Dropout`` is replaced by a class
    of the same name (so flax's module paths, and so its dropout keys, stay
    the same) that computes the same mask from the same ``make_rng`` and
    hands it to the host with an ordered ``jax.debug.callback``.  Yields
    the list the masks land in, each as an (N, C) float32 array; clear it
    before a step and read it after ``jax.effects_barrier()``."""
    import flax.linen as nn
    from flax.linen.module import merge_param

    masks = []

    def record(mask):
        m = np.asarray(mask, np.float32)
        masks.append(m.reshape(m.shape[0], -1))

    class Dropout(nn.Dropout):
        @nn.compact
        def __call__(self, inputs, deterministic=None, rng=None):
            deterministic = merge_param("deterministic", self.deterministic, deterministic)
            if self.rate == 0.0 or deterministic:
                return inputs
            keep_prob = 1.0 - self.rate
            if rng is None:
                rng = self.make_rng(self.rng_collection)
            shape = list(inputs.shape)
            for d in self.broadcast_dims:
                shape[d] = 1
            mask = jax.random.bernoulli(rng, p=keep_prob, shape=shape)
            jax.debug.callback(record, mask, ordered=True)
            mask = jnp.broadcast_to(mask, inputs.shape)
            return jax.lax.select(mask, inputs / keep_prob, jnp.zeros_like(inputs))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(nn, "Dropout", Dropout)
        yield masks


def replay_draws(key, latent_da, n: int, hw, latent_ch: int = 128,
                 image_ch: int = 1, dropout=None) -> StepDraws:
    """The draws of ``CooperativeTripletSolver.make_train_step``'s step
    with key ``key``: ``k_noise, k_da, k_drop = split(key, 3)``, the unit
    normal noise ``normal(k_noise, (n, H, W, image_ch))`` (as NCHW), and
    ``k_img, k_seg = split(k_da)`` for the two codes.  ``dropout``: the
    layer-dropout masks the JAX step drew from ``k_drop``, as
    :func:`record_jax_dropout` recorded them."""
    h, w = hw
    k_noise, k_da, _ = jax.random.split(key, 3)
    noise = jax.random.normal(k_noise, (n, h, w, image_ch), jnp.float32)
    k_img, k_seg = jax.random.split(k_da)
    latent_hw = (h // 16, w // 16)
    image = shape = None
    if latent_da is not None and latent_da.gen_corrupted_image:
        image = replay_code_draws(k_img, latent_da.image_code, n, latent_ch, latent_hw)
    if latent_da is not None and latent_da.gen_corrupted_seg:
        shape = replay_code_draws(k_seg, latent_da.shape_code, n, latent_ch, latent_hw)
    masks = None if dropout is None else [_t(m) for m in dropout]
    return StepDraws(_t(noise).permute(0, 3, 1, 2).contiguous(), image, shape, masks)


def jax_train_state(solver: CooperativeTripletSolver, params, stats):
    """A fresh JAX ``TrainState`` (step 0, zero Adam moments) on the numpy
    ``params`` and ``stats``."""
    from cooperative_training_and_latent_space_data_augmentation_tpu.train.state import (
        TrainState,
    )

    params = jax.tree.map(jnp.asarray, params)
    return TrainState(params=params, batch_stats=jax.tree.map(jnp.asarray, stats),
                      opt_state=solver.tx.init(params), step=jnp.zeros((), jnp.int32))


def saliency_of(grad_nhwc, branch: int) -> np.ndarray:
    """The JAX package's saliency from the code gradient (N, h, w, C):
    channel (branch 2) the mean over (h, w), spatial (branch 1) the mean
    over C in (h, w) order."""
    g = np.asarray(grad_nhwc, np.float64)
    n, h, w, c = g.shape
    return g.reshape(n, h * w, c).mean(1) if branch == 2 else g.mean(-1).reshape(n, h * w)


def assert_masks_agree(got_mask, want_mask, got_sal, want_sal, p: float, what=""):
    """Masks (N, D) equal, or swapped only near the threshold: where an
    element is masked in one and not in the other, its saliency lies
    within twice the largest saliency difference of its row from the
    row's threshold value (the ``int(D * p)``-th largest), so f32 rounding
    of the saliency explains the swap."""
    got_mask, want_mask = np.asarray(got_mask), np.asarray(want_mask)
    differ = got_mask != want_mask
    if not differ.any():
        return
    got_sal, want_sal = np.asarray(got_sal, np.float64), np.asarray(want_sal, np.float64)
    d = want_sal.shape[1]
    idx = int(np.clip(np.floor(np.float32(d) * np.float32(p)), 0, d - 1))
    thresh = -np.sort(-want_sal, axis=1)[:, idx:idx + 1]
    tol = 2 * np.abs(got_sal - want_sal).max(axis=1, keepdims=True)
    near = np.abs(want_sal - thresh) <= tol
    assert near[differ].all(), (what, np.argwhere(differ & ~near))


# ------------------------------------------------ whole-step comparison
STEP_KEYS = (11, 12)
LR, B1 = 1e-4, 0.9
SENSITIVITY = 1e-6   # per-pixel relative move of the input image, +-, for JAX's own sensitivity
N_MOVES = 6


def step_configs(mask_type: str):
    """(JAX, port) latent-DA configs of the main path with ``mask_type`` on
    both codes: image code ``mse``, shape code ``ce``."""
    from cooperative_training_and_latent_space_data_augmentation_tpu import config as jcfg
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch import config as pcfg

    return (jcfg.LatentDAConfig(image_code=jcfg.MaskConfig("mse", mask_type),
                                shape_code=jcfg.MaskConfig("ce", mask_type)),
            pcfg.LatentDAConfig(image_code=pcfg.MaskConfig("mse", mask_type),
                                shape_code=pcfg.MaskConfig("ce", mask_type)))


def jax_generation(solver, lda, params, stats, batch, key):
    """What the JAX step's hard-example generation makes from ``key``
    (``cooperative.py:383-423``, default arm): per code the mask and the
    code gradient its saliency is the mean of, and the latents (z_i, z_s)."""
    from cooperative_training_and_latent_space_data_augmentation_tpu.ops import masking
    from cooperative_training_and_latent_space_data_augmentation_tpu.train.cooperative import (
        _mask_settings,
    )

    image, label = batch["image"], batch["label"]
    k_noise, k_da, _ = jax.random.split(key, 3)
    noised = jnp.clip(image + 0.05 * jax.random.normal(k_noise, image.shape, image.dtype),
                      0.0, 1.0)
    _, (z_i, z_s), stats = solver.standard_training(params, stats, image, label, noised)
    k_img, k_seg = jax.random.split(k_da)
    out = {}
    for name, dec_name, code, target, cfg, k in (
            ("image", "image_decoder", z_i, image, lda.image_code, k_img),
            ("shape", "segmentation_decoder", z_s, label, lda.shape_code, k_seg)):
        dec = solver._frozen_decoder_fn(dec_name, params, stats)
        code = jax.lax.stop_gradient(code)
        _, mask = masking.perturb_latent_code(code, dec, target, k, _mask_settings(cfg),
                                              num_classes=solver.num_classes)
        grad = jax.grad(lambda z: masking._task_loss(dec, z, target, cfg.loss_name,
                                                     solver.num_classes))(code)
        out[name] = (mask, grad)
    out["latents"] = (z_i, z_s)
    return out


def _host(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def run_step_case(mask_type: str, seed: int = 0, conv_s2: bool = False,
                  conv_nl: bool = False, keys=STEP_KEYS, max_ch: int = None):
    """JAX's steps with ``mask_type``, one for each of ``keys`` (and the same
    steps on N_MOVES images moved by +-SENSITIVITY per pixel, and its
    generation), then the port's from the same states with the replayed
    draws.  f32, HW x HW, batch BATCH.  With ``conv_s2`` (``conv_nl``) JAX
    runs its ``PALLAS_CONV_S2=1`` (``PALLAS_CONV_NL=1``) configuration in
    interpret mode and the port its ``conv_s2=True`` (``conv_nl=True``);
    ``max_ch`` is JAX's ``PALLAS_CONV_MAX_CH`` (:func:`pallas_interpret`).
    Returns one record per step."""
    if conv_s2 or conv_nl:
        with pallas_interpret(s2=conv_s2, nl=conv_nl, max_ch=max_ch):
            return _run_step_case(mask_type, seed, conv_s2, conv_nl, keys)
    return _run_step_case(mask_type, seed, conv_s2, conv_nl, keys)


def _run_step_case(mask_type: str, seed: int, conv_s2: bool, conv_nl: bool, keys):
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch import convert
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.train.cooperative import (
        CooperativeTrainer,
    )

    solver = make_solver()
    params, stats = random_variables(solver, seed=seed)
    rng = np.random.RandomState(seed + 1)
    image = rng.uniform(0, 1, (BATCH, HW, HW, 1)).astype(np.float32)
    label = rng.randint(0, 4, (BATCH, HW, HW)).astype(np.int32)
    jlda, lda = step_configs(mask_type)
    step = solver.make_train_step(latent_da=jlda, donate=False)
    gen = jax.jit(lambda p, s, b, k: jax_generation(solver, jlda, p, s, b, k))
    batch = {"image": jnp.asarray(image), "label": jnp.asarray(label)}
    moves = [{"image": jnp.asarray((image * (1 + SENSITIVITY * rng.choice([-1, 1], image.shape)))
                                   .astype(np.float32)), "label": batch["label"]}
             for _ in range(N_MOVES)]
    state = jax_train_state(solver, params, stats)
    trainer = CooperativeTrainer(lda, device="cpu", conv_s2=conv_s2, conv_nl=conv_nl)
    steps = []
    for key_seed in keys:
        key = jax.random.PRNGKey(key_seed)
        new, metrics = step(state, batch, key)
        rec = {"before": _host(state), "after": _host(new), "metrics": _host(metrics),
               "moved": [_host(step(state, m, key)[0]) for m in moves],
               "gen": _host(gen(state.params, state.batch_stats, batch, key))}
        start = convert.train_state_from_jax(rec["before"].params, rec["before"].batch_stats,
                                             rec["before"].opt_state)
        trainer.load_train_state(start)
        rec["draws"] = replay_draws(key, lda, BATCH, (HW, HW))
        rec["gap_scale"] = _latent_gap_scale(
            trainer, image, rec["draws"],
            rec["gen"]["latents"],
            [_host(gen(state.params, state.batch_stats, m, key))["latents"] for m in moves])
        rec["port_metrics"] = trainer.train_step(torch.from_numpy(image),
                                                 torch.from_numpy(label), rec["draws"])
        rec["port_moments"] = trainer.adam_moments()
        rec["port_state"] = {name: {k: v.clone() for k, v in getattr(trainer.model, name)
                                    .state_dict().items()} for name in MODULE_NAMES}
        rec["port_generation"] = dict(trainer.generation)
        steps.append(rec)
        state = new
    return steps


def _latent_gap_scale(trainer, image, draws, jax_latents, moved_latents):
    """How far the port's latents lie from JAX's, over how far JAX's move
    under the input moves (at least 1): the factor by which the port's
    rounding exceeds the moves that measure JAX's own sensitivity."""
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.models.blocks import (
        frozen_stats,
    )

    clean = torch.from_numpy(image).permute(0, 3, 1, 2)
    noised = torch.clamp(clean + 0.05 * draws.noise, 0.0, 1.0)
    with torch.no_grad(), frozen_stats(trainer.model):
        z = torch.cat([t.flatten() for t in trainer.model.encode_image(noised)]).double()

    def flat(latents):
        return torch.cat([torch.from_numpy(np.array(t)).permute(0, 3, 1, 2).flatten()
                          for t in latents]).double()

    want = flat(jax_latents)
    moved = np.mean([float((flat(m) - want).norm()) for m in moved_latents])
    return max(1.0, float((z - want).norm()) / moved)


def _moments(state):
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch import convert

    ts = convert.train_state_from_jax(state.params, state.batch_stats, state.opt_state)
    return ts.exp_avg, ts.exp_avg_sq


def _pairs(got, want):
    for name in want:
        for k in want[name]:
            yield f"{name}.{k}", np.asarray(got[name][k].detach(), np.float64), \
                np.asarray(want[name][k], np.float64)


def check_step_metrics(rec, what=""):
    """Metrics within 1e-4 of their value (f32 sums in another order)."""
    got, want = rec["port_metrics"], rec["metrics"]
    assert set(got) == set(want)
    for key, w in want.items():
        w = float(w)
        assert abs(float(got[key]) - w) <= 1e-4 * abs(w) + 1e-7, (what, key, float(got[key]), w)


def check_step_masks(rec, mask_type, what=""):
    """Each code's branch and mask: equal, or swapped only near the
    threshold (:func:`assert_masks_agree`)."""
    for name in ("image", "shape"):
        code_draws = getattr(rec["draws"], name)
        gen = rec["port_generation"][name]
        assert gen.branch == code_draws.branch
        if mask_type != "random":
            assert BRANCHES[gen.branch] == mask_type
        want_mask, want_grad = rec["gen"][name]
        got_mask = gen.mask.permute(0, 2, 3, 1).numpy()
        if gen.branch == 0:
            np.testing.assert_array_equal(got_mask, want_mask)
            continue
        n, h, w, c = want_mask.shape
        if gen.branch == 2:
            g2d, w2d = got_mask[:, 0, 0, :], want_mask[:, 0, 0, :]
        else:
            g2d, w2d = got_mask[..., 0].reshape(n, h * w), want_mask[..., 0].reshape(n, h * w)
        assert_masks_agree(g2d, w2d, gen.saliency.numpy(), saliency_of(want_grad, gen.branch),
                           float(code_draws.p), f"{what} {name}")


def check_step_running_stats(rec, what=""):
    """Running statistics within 1e-4 of each tensor's scale."""
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch import convert

    want = convert.from_jax(rec["after"].params, rec["after"].batch_stats)
    for name, sd in want.items():
        for k, w in sd.items():
            if "running_" in k:
                torch.testing.assert_close(rec["port_state"][name][k], w, rtol=0,
                                           atol=1e-4 * float(w.abs().max()),
                                           msg=f"{what} {name}.{k}")


def check_step_moments_and_update(rec, what=""):
    """Adam's ``mu`` and ``nu`` and the update ``u = p_new - p_old``, per
    tensor in the Frobenius norm: within 1e-3 of the tensor's norm or
    twice JAX's own move under the N_MOVES input moves (scaled up by how
    much farther the port's latents lie from JAX's than the moved ones
    do), whichever is larger.  An element whose ``mu`` lies within that bound of 0 has no
    determined sign, and Adam's first steps move it by about lr one way or
    the other: the update may differ by 2 lr more for each such element
    (in quadrature)."""
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch import convert

    got_mu, got_nu = rec["port_moments"]
    want_mu, want_nu = _moments(rec["after"])
    moved = [_moments(m) for m in rec["moved"]]
    own_scale = 2 * rec["gap_scale"]
    mu_bound = {}
    for j, (got, want) in enumerate(((got_mu, want_mu), (got_nu, want_nu))):
        top = max(float(v.abs().max()) for sd in want.values() for v in sd.values())
        for (name, g, w), *ms in zip(_pairs(got, want), *[_pairs(m[j], want) for m in moved]):
            own = max(np.linalg.norm(m[1] - w) for m in ms)
            bound = max(1e-3 * np.linalg.norm(w), own_scale * own, 1e-6 * top * np.sqrt(w.size))
            assert np.linalg.norm(g - w) <= bound, (what, ("mu", "nu")[j], name,
                                                   np.linalg.norm(g - w), bound)
            if j == 0:
                mu_bound[name] = bound
    before = convert.from_jax(rec["before"].params, rec["before"].batch_stats)
    after = convert.from_jax(rec["after"].params, rec["after"].batch_stats)
    after_moved = [convert.from_jax(m.params, m.batch_stats) for m in rec["moved"]]
    for name, sd in after.items():
        for k, w in sd.items():
            if "running_" in k:
                continue
            old = before[name][k].double()
            u_jax = (w.double() - old).numpy()
            u_port = (rec["port_state"][name][k].double() - old).numpy()
            own = max(np.linalg.norm((m[name][k].double() - old).numpy() - u_jax)
                      for m in after_moved)
            undetermined = int((want_mu[name][k].abs() <= mu_bound[f"{name}.{k}"]).sum())
            bound = (max(1e-3 * np.linalg.norm(u_jax), own_scale * own)
                     + 2 * LR * np.sqrt(undetermined))
            assert np.linalg.norm(u_port - u_jax) <= bound, (what, name, k,
                                                             np.linalg.norm(u_port - u_jax),
                                                             bound)


# ------------------------------------------------ augmentation draws
def replay_augment_draws(key, policy, n: int, pad_hw, image_ch: int = 1):
    """The draws the JAX package's ``augment_batch`` makes from ``key`` for
    ``n`` samples padded to ``pad_hw`` under ``policy``, as the port's
    :class:`AugmentDraws`: ``split(key, n)``, then each sample's
    ``split(k, 14)`` (``ops/augment.py:759-760``), then each stage's own
    splits.  Uniforms are replayed raw (``uniform(k, shape)`` on [0, 1)),
    which the stages scale as ``jax.random.uniform`` does; the shift x draw
    comes from ``fold_in(k_shift, 1)`` and the group index from
    ``randint(k_group, (), 0, len(rotate_groups))``."""
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.ops import (
        augment as port_augment,
    )

    h, w = pad_hw
    rows = [_replay_augment_one(k, policy, h, w, image_ch, port_augment)
            for k in jax.random.split(key, n)]
    kw = {}
    for name in rows[0]:
        if isinstance(rows[0][name], tuple):
            kw[name] = tuple(torch.from_numpy(np.stack([r[name][i] for r in rows]))
                             for i in range(len(rows[0][name])))
        else:
            kw[name] = torch.from_numpy(np.stack([r[name] for r in rows]))
    return port_augment.AugmentDraws(**kw)


def _replay_augment_one(key, policy, h: int, w: int, image_ch: int, port_augment):
    def u(k, shape=()):
        return np.asarray(jax.random.uniform(k, shape), np.float32)

    def g(k, shape):
        return np.asarray(jax.random.normal(k, shape), np.float32)

    (k_flip, k_b1, k_b2, k_bc, k_gamma, k_affine, k_elastic, k_coarse,
     k_p1, k_p2, k_pbc, k_pg, k_pe, k_pe2) = jax.random.split(key, 14)
    d = {}
    if policy.flip_p > 0:
        k_h, k_v = jax.random.split(k_flip)
        if policy.flip_h:
            d["flip_h"] = u(k_h)
        if policy.flip_v:
            d["flip_v"] = u(k_v)
    if policy.perturb_prob > 0:
        k_field, k_noise = jax.random.split(k_b1)
        keys = jax.random.split(k_field, len(policy.multi_control_points))
        d["bias1_grids"] = tuple(u(keys[i], (cp, cp))
                                 for i, cp in enumerate(sorted(policy.multi_control_points)))
        if policy.add_noise:
            d["bias1_noise"] = g(k_noise, (h, w, image_ch))
        d["gate_bias1"] = u(k_p1)
    if policy.perturb_v2_prob > 0:
        k_field, k_noise = jax.random.split(k_b2)
        _, _, _, n_h, n_w = port_augment._v2_geometry(h, w, policy)
        d["bias2_knots"] = u(k_field, (n_h, n_w))
        if policy.perturb_v2_add_noise:
            d["bias2_noise"] = g(k_noise, (h, w, image_ch))
        d["gate_bias2"] = u(k_p2)
    if policy.intensity_prob > 0:
        k_s, k_b = jax.random.split(k_bc)
        d.update(contrast=u(k_s), brightness=u(k_b), gate_intensity=u(k_pbc))
    if policy.gamma_prob > 0:
        d.update(gamma=u(k_gamma), gate_gamma=u(k_pg))
    if port_augment._needs_geometry(policy):
        k_rot, k_shift, k_shear, k_zoom, k_group = jax.random.split(k_affine, 5)
        d.update(rotation=u(k_rot), shift_y=u(k_shift),
                 shift_x=u(jax.random.fold_in(k_shift, 1)), shear=u(k_shear), zoom=u(k_zoom))
        if policy.rotate_groups:
            d["group"] = np.asarray(jax.random.randint(k_group, (), 0,
                                                       len(policy.rotate_groups)), np.int64)
        if policy.elastic_prob > 0:
            k_a, k_s, k_dx, k_dy = jax.random.split(k_elastic, 4)
            d.update(elastic_alpha=u(k_a), elastic_sigma=u(k_s), elastic_dx=u(k_dx, (h, w)),
                     elastic_dy=u(k_dy, (h, w)), gate_elastic=u(k_pe))
        if policy.elastic_prob_v2 > 0:
            k1, k2 = jax.random.split(k_coarse)
            d.update(coarse_dx=g(k1, (3, 3)), coarse_dy=g(k2, (3, 3)), gate_coarse=u(k_pe2))
    return d


class JaxKeys:
    """JAX's ``train_network`` key schedule as a draw source: an epoch key
    splits off ``PRNGKey(seed + 1)`` at each epoch's first batch, each
    batch's key off the epoch key, each step's key off ``PRNGKey(seed +
    1)``; the draws behind each key are replayed.  Keeps what it drew."""

    def __init__(self, seed):
        self.rng = jax.random.PRNGKey(seed + 1)
        self.epoch = None
        self.drawn, self.steps = [], []

    def augment(self, epoch, policy, n, pad_hw):
        if epoch != self.epoch:
            self.rng, self.epoch_key = jax.random.split(self.rng)
            self.epoch = epoch
        self.epoch_key, key = jax.random.split(self.epoch_key)
        self.drawn.append(replay_augment_draws(key, policy, n, pad_hw))
        return self.drawn[-1]

    def step(self, n, hw, latent_da):
        self.rng, key = jax.random.split(self.rng)
        self.steps.append(replay_draws(key, latent_da, n, hw))
        return self.steps[-1]


def bf16_close_sets(triples, what):
    """bf16 parity over a whole set: over all (got, want16, want32) triples
    together, the largest and the mean |got - want16| at most twice those
    of |want16 - want32|."""
    got, want16, want32 = (np.concatenate([np.asarray(t[j], np.float64).ravel()
                                           for t in triples]) for j in range(3))
    own, diff = np.abs(want16 - want32), np.abs(got - want16)
    assert diff.max() <= 2 * own.max(), (what, diff.max(), own.max())
    assert diff.mean() <= 2 * own.mean(), (what, diff.mean(), own.mean())


# ------------------------------------------- the step's other configurations
# The step files of the configurations (test_torch_port_step_variants.py,
# _separate.py, _dropout.py, _remat.py) each import the four
# ``test_variant_*`` checks below, which pytest then collects there, and
# define a module fixture ``variant`` over their configurations:
# ``(name, run_variant(name))``.
DROPOUT = {"encoder_dropout": 0.3, "decoder_dropout": 0.2}
# per configuration: the JAX solver's and make_train_step's keywords, the
# environment JAX reads, and the port trainer's keywords
VARIANTS = {
    "separate_training": {"step": {"separate_training": True},
                          "trainer": {"separate_training": True}},
    "share_code": {"solver": {"network_type": "FCN_16_standard_share_code"},
                   "trainer": {"network_type": "FCN_16_standard_share_code"}},
    "w_o_filter": {"solver": {"network_type": "FCN_16_standard_w_o_filter"},
                   "trainer": {"network_type": "FCN_16_standard_w_o_filter"}},
    "dropout": {"solver": DROPOUT, "trainer": DROPOUT},
    "remat": {"solver": {"remat": True}, "trainer": {"remat": True}},
    "saliency_bn_update": {"env": {"SALIENCY_BN_UPDATE": "1"},
                           "trainer": {"saliency_bn_update": True}},
}


def _data():
    rng = np.random.RandomState(1)
    image = rng.uniform(0, 1, (BATCH, HW, HW, 1)).astype(np.float32)
    label = rng.randint(0, 4, (BATCH, HW, HW)).astype(np.int32)
    return image, label, rng


def _port_state(trainer):
    return {name: {k: v.clone() for k, v in getattr(trainer.model, name).state_dict().items()}
            for name in MODULE_NAMES}


def run_variant(name: str):
    """JAX's two steps under the configuration ``name`` (with its own
    sensitivity: the same steps on N_MOVES moved images), then the port's
    from the same states on the replayed draws; one record per step, as
    ``torch_port_util.run_step_case`` makes them."""
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch import convert
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.train.cooperative import (
        CooperativeTrainer,
    )

    v = VARIANTS[name]
    dropout = "encoder_dropout" in v.get("solver", {})
    with pytest.MonkeyPatch.context() as mp, record_jax_dropout() as recorded:
        for k, val in v.get("env", {}).items():
            mp.setenv(k, val)
        solver = CooperativeTripletSolver(input_hw=(HW, HW), **v.get("solver", {}))
        params, stats = random_variables(solver, seed=0)
        image, label, rng = _data()
        jlda, lda = step_configs("random")
        step = solver.make_train_step(latent_da=jlda, donate=False, **v.get("step", {}))
        gen = None if dropout else jax.jit(
            lambda p, s, b, k: jax_generation(solver, jlda, p, s, b, k))
        batch = {"image": jnp.asarray(image), "label": jnp.asarray(label)}
        moves = [{"image": jnp.asarray((image * (1 + SENSITIVITY * rng.choice([-1, 1],
                                                                              image.shape)))
                                       .astype(np.float32)), "label": batch["label"]}
                 for _ in range(N_MOVES)]
        state = jax_train_state(solver, params, stats)
        trainer = CooperativeTrainer(lda, device="cpu", **v.get("trainer", {}))
        steps = []
        for key_seed in STEP_KEYS:
            key = jax.random.PRNGKey(key_seed)
            recorded.clear()
            new, metrics = step(state, batch, key)
            jax.effects_barrier()
            masks = list(recorded)
            rec = {"before": _host(state), "after": _host(new), "metrics": _host(metrics),
                   "moved": [_host(step(state, m, key)[0]) for m in moves]}
            jax.effects_barrier()
            rec["draws"] = replay_draws(key, lda, BATCH, (HW, HW),
                                        dropout=masks if dropout else None)
            trainer.load_train_state(convert.train_state_from_jax(
                rec["before"].params, rec["before"].batch_stats, rec["before"].opt_state))
            if gen is not None:
                rec["gen"] = _host(gen(state.params, state.batch_stats, batch, key))
                rec["gap_scale"] = _latent_gap_scale(
                    trainer, image, rec["draws"], rec["gen"]["latents"],
                    [_host(gen(state.params, state.batch_stats, m, key))["latents"]
                     for m in moves])
            else:
                rec["gap_scale"] = 1.0
            rec["port_metrics"] = trainer.train_step(torch.from_numpy(image),
                                                     torch.from_numpy(label), rec["draws"])
            rec["port_moments"] = trainer.adam_moments()
            rec["port_state"] = _port_state(trainer)
            rec["port_generation"] = dict(trainer.generation)
            rec["masks"] = (len(masks), trainer._used)
            steps.append(rec)
            state = new
    return steps



def _masks_equal(rec) -> bool:
    """Whether the port's generation drew JAX's masks exactly (a swap near
    the threshold, which ``check_step_masks`` allows, makes another hard
    example)."""
    return all(np.array_equal(rec["port_generation"][k].mask.permute(0, 2, 3, 1).numpy(),
                              rec["gen"][k][0]) for k in ("image", "shape"))


def test_variant_metrics_match_jax(variant):
    """All metrics; the four hard losses (and the totals they enter) only at
    steps whose masks equal JAX's, the loop test's rule (at a swap the five
    standard losses are held)."""
    name, steps = variant
    held = 0
    for i, rec in enumerate(steps):
        if "gen" in rec and not _masks_equal(rec):
            rec = dict(rec, metrics={k: v for k, v in rec["metrics"].items()
                                     if "hard" not in k and k != "loss/total"},
                       port_metrics={k: v for k, v in rec["port_metrics"].items()
                                     if "hard" not in k and k != "loss/total"})
        else:
            held += 1
        check_step_metrics(rec, f"{name} step {i}")
    assert held >= 1, name


def test_variant_masks_match_jax(variant):
    name, steps = variant
    for i, rec in enumerate(steps):
        if "gen" in rec:
            check_step_masks(rec, "random", f"{name} step {i}")
        want, used = rec["masks"]
        if name == "dropout":
            from cooperative_training_and_latent_space_data_augmentation_tpu_torch.train.draws import (  # noqa: E501
                forward_plan,
            )

            branches = {k: getattr(rec["draws"], k).branch for k in ("image", "shape")}
            plan = forward_plan(step_configs("random")[1], branches)
            # 4 residual stages a module, each with a rate
            assert want == used == 4 * len(plan), (i, want, used, len(plan))
        else:
            assert want == used == 0


def test_variant_running_stats_match_jax(variant):
    name, steps = variant
    for i, rec in enumerate(steps):
        check_step_running_stats(rec, f"{name} step {i}")


def test_variant_moments_and_update_match_jax(variant):
    name, steps = variant
    for i, rec in enumerate(steps):
        check_step_moments_and_update(rec, f"{name} step {i}")
