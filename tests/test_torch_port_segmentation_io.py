"""The port's ``SegmentationSolver`` checkpoints and its deep-supervision
loss against the JAX package's, on the CPU.

``save_model``/``load_model`` (.pth) and ``save_snapshots``/
``load_snapshots`` round trips; a JAX solver's ``save_model`` ``.msgpack``
loaded by the port (online and EMA parameters) and predicted to JAX's
output within ``2e-4 + 4e-6 max|ref|``; the flax-layout writer the card
tests use; a network returning (main, auxiliaries) trained on the main
loss plus 0.5 x each auxiliary's, its loss within 1e-5 of JAX's.  Shapes
and weights as in ``test_torch_port_segmentation.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cooperative_training_and_latent_space_data_augmentation_tpu.train.segmentation import (
    SegmentationSolver as JaxSolver,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch import convert
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.train.segmentation import (
    SegmentationSolver,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.utils import schedulers
from test_torch_port_baselines import random_variables
from test_torch_port_segmentation import BATCH, CLASSES, HW, LR, _batch, make_pair
from torch_port_util import one_torch_thread  # noqa: F401


def test_checkpoints_round_trip(tmp_path):
    """``save_model``/``load_model`` (.pth) into a solver drawn from another
    seed predicts bit for bit alike; ``save_snapshots``/``load_snapshots``
    resumes the optimizer: a step after the load equals the step without
    one; a missing snapshot gives epoch 0."""
    a = SegmentationSolver("SN_UNet_16", device="cpu", seed=1, use_ema=True, clip_grad=True)
    b = _batch(3)
    x, y = torch.from_numpy(b["image"]), torch.from_numpy(b["label"])
    a.train_step(x, y)
    path = a.save_model(str(tmp_path / "m"), "best")
    assert path.endswith("best/checkpoints/SN_UNet_16.pth")
    c = SegmentationSolver("SN_UNet_16", device="cpu", seed=2, use_ema=True, clip_grad=True)
    c.load_model(path)
    assert torch.equal(c.predict(x), a.predict(x))
    assert torch.equal(c.predict(x, use_ema_params=True), a.predict(x, use_ema_params=True))
    snap = a.save_snapshots(str(tmp_path / "s"), epoch=7)
    assert c.load_snapshots(snap) == 7
    assert c.load_snapshots(str(tmp_path / "none.pth")) == 0
    a.train_step(x, y)
    c.train_step(x, y)
    for (k, v), w in zip(a.model.state_dict().items(), c.model.state_dict().values()):
        assert torch.equal(v, w), k


@pytest.mark.parametrize("use_ema", [False, True])
def test_jax_msgpack_loads_and_predicts(tmp_path, use_ema):
    """A JAX solver's ``save_model`` ``.msgpack`` (after two steps, so the
    statistics and SN vectors moved) loaded by the port's ``load_model``
    predicts JAX's output, online and EMA."""
    js, state, port = make_pair("SN_UNet_16", use_ema=use_ema)
    step = js.make_train_step(donate=False)
    for i in range(2):
        b = _batch(i)
        state, _ = step(state, {k: jnp.asarray(v) for k, v in b.items()}, jax.random.PRNGKey(0))
    path = js.save_model(state, str(tmp_path), "best")
    fresh = SegmentationSolver("SN_UNet_16", num_classes=CLASSES, device="cpu", seed=5,
                               use_ema=use_ema)
    fresh.load_model(path)
    x = _batch(4)["image"]
    for ema in ([False, True] if use_ema else [False]):
        want = np.asarray(js.predict(state, jnp.asarray(x), use_ema_params=ema))
        got = fresh.predict(torch.from_numpy(x), use_ema_params=ema).numpy()
        assert np.abs(got - want).max() <= 2e-4 + 4e-6 * np.abs(want).max(), ema


def test_deep_supervision_tuple_loss():
    """A network returning (main, auxiliaries) trains on the main loss plus
    0.5 x each auxiliary's: DeeplySupervisedUNet (base 8) as (final,
    (out, mixed)), one step against JAX's solver on the same network."""
    import flax.linen as fnn

    from cooperative_training_and_latent_space_data_augmentation_tpu.models import unet as junet
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.models import unet

    class JaxTuple(fnn.Module):
        @fnn.compact
        def __call__(self, x, train=False):
            out, mixed, final = junet.DeeplySupervisedUNet(CLASSES, base_n_filters=8)(
                x, train, multi_out=True)
            return final, (out, mixed)

    class PortTuple(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.net = unet.DeeplySupervisedUNet(1, CLASSES, base_n_filters=8)

        def forward(self, x):
            out, mixed, final = self.net(x, multi_out=True)
            return final, (out, mixed)

    js = JaxSolver("UNet_16", num_classes=CLASSES, learning_rate=LR)
    js.model = JaxTuple()
    params, stats = random_variables(js.model, (1, HW, HW, 1), seed=6, train=False)
    state = js.init_state(jax.random.PRNGKey(0), input_hw=(HW, HW))
    state = state.replace(params=jax.tree.map(jnp.asarray, params),
                          batch_stats=jax.tree.map(jnp.asarray, stats))
    port = SegmentationSolver("UNet_16", num_classes=CLASSES, learning_rate=LR, device="cpu")
    port.model = PortTuple()
    port.model.net.load_state_dict(convert.baseline_from_jax(
        port.model.net, params["DeeplySupervisedUNet_0"], stats["DeeplySupervisedUNet_0"]))
    port.optimizer = schedulers.make_optimizer(port.model.parameters(), LR)
    b = _batch(1)
    state, m = js.make_train_step(donate=False)(state, {k: jnp.asarray(v) for k, v in b.items()},
                                                jax.random.PRNGKey(0))
    got = float(port.train_step(torch.from_numpy(b["image"]),
                                torch.from_numpy(b["label"]))["loss/total"])
    want = float(m["loss/total"])
    assert abs(got - want) <= 1e-5 * abs(want), (got, want)
    with torch.no_grad():
        final, (out, mixed) = port.model.eval()(torch.from_numpy(np.moveaxis(b["image"], -1, 1)))
    assert final.shape == out.shape == mixed.shape == (BATCH, CLASSES, HW, HW)


@pytest.mark.parametrize("network", ["SN_UNet_16", "ResUNet_16"])
def test_flax_layout_writer_matches_flax(tmp_path, network):
    """``torch_port_flax.baseline_to_flax`` and ``write_flax_msgpack`` (what
    the card tests use to make a JAX checkpoint without JAX) give the JAX
    network's tree, which flax reads back and the JAX solver loads, and the
    port loads it back to its own state."""
    from flax import serialization

    from torch_port_flax import baseline_to_flax, write_flax_msgpack

    port = SegmentationSolver(network, num_classes=CLASSES, device="cpu", seed=8)
    params, stats = baseline_to_flax(port.model)
    js = JaxSolver(network, num_classes=CLASSES)
    shapes = jax.eval_shape(lambda: js.model.init(jax.random.PRNGKey(0),
                                                  jnp.zeros((1, HW, HW, 1)), train=False))
    assert jax.tree.map(np.shape, {"params": params, "batch_stats": stats}) == jax.tree.map(
        lambda a: a.shape, {"params": shapes["params"], "batch_stats": shapes["batch_stats"]})
    path = str(tmp_path / f"{network}.msgpack")
    write_flax_msgpack(path, {"params": params, "batch_stats": stats})
    with open(path, "rb") as f:
        restored = serialization.msgpack_restore(f.read())
    jax.tree.map(np.testing.assert_array_equal, restored, {"params": params, "batch_stats": stats})
    state = js.load_model(js.init_state(jax.random.PRNGKey(0), input_hw=(HW, HW)), path)
    x = _batch(6)["image"]
    want = np.asarray(js.predict(state, jnp.asarray(x)))
    got = port.predict(torch.from_numpy(x)).numpy()
    assert np.abs(got - want).max() <= 2e-4 + 4e-6 * np.abs(want).max()
    other = SegmentationSolver(network, num_classes=CLASSES, device="cpu", seed=9)
    other.load_model(path)
    for (k, v), w in zip(port.model.state_dict().items(), other.model.state_dict().values()):
        assert torch.equal(v, w), k
