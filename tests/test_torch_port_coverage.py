"""The port covers the JAX package: every module, every public top-level
name, every environment knob of its registry and every entry of the root
``cli/`` has a counterpart in the port, or an entry with its reason here.

Read by ``ast`` from the sources, importing nothing.  A JAX name has a
counterpart when the port's module of the same path defines it or
imports it at top level; otherwise :data:`NAMES` (or, for a whole
module, :data:`MODULES`) must map it to ``"port.module:name"``, which must
exist, or to ``"reason: ..."``.  Every key of the maps must exist on the
JAX side, so the maps cannot go stale.
"""

import ast
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG = os.path.join(REPO, "cooperative_training_and_latent_space_data_augmentation_tpu")
PORT = JAX_PKG + "_torch"

QUEUE_3A = ("two NCCL ranks on two cards, unrun: the card's machine has one card (ROADMAP.md, "
            "the benchmark's candidate multi-card cell)")

STAIRCASE = ("reason: the staircase conv is ported as ops/fast_conv.py:staircase_conv3x3 and "
             "pick_pack_factor, but no conv routes to it: on the H100 it takes 7.3-10.0x "
             "F.conv2d's time at 64->128 @ 48x48, batch 20, bf16 (PERF.md section 5)")

# whole JAX modules without a module of the same path in the port
MODULES = {
    "ops.pallas_conv": "reason: the Pallas kernels; their hand-written sm_90a counterparts are "
                       "csrc/ (K1, K2, K4, K5) behind ops/conv_chw.py, conv_s2.py and conv_nl.py",
    "ops.pallas_conv_blocked": "reason: the Pallas kernel K6; csrc/conv3x3_b8.cu behind "
                               "ops/conv_b8.py",
    "ops.pallas_kernels": "reason: the Pallas kernel K3; csrc/percentile_mask.cu behind "
                          "ops/percentile_mask.py",
    "train.state": "train.cooperative:CooperativeTrainer",
    "utils.cache": "reason: the XLA compilation cache; kernels.py caches its nvcc builds by "
                   "source hash",
}

# single JAX names without a counterpart of the same name and module
NAMES = {
    "models.blocks:ConvBlock": "models.blocks:conv_bn_stack",
    "models.blocks:Norm": "models.blocks:norm_layer",
    "models.blocks:bn_scale_init": "train.predictor:init_parameters",
    "models.blocks:conv_kernel_init": "train.predictor:init_parameters",
    "models.blocks:chw_chain_ok": "ops.conv_chw:eligible_channels",
    "models.blocks:s2_chain_ok": "models.blocks:ResConvDown",
    "models.blocks:upsample_bilinear_chw": "models.blocks:upsample_bilinear",
    "models.blocks:upsample_nearest_chw": "models.blocks:upsample_nearest",
    "models.encoder_decoder:CodeDecoupler": "models.encoder_decoder:code_decoupler",
    "ops.augment:augment_sample": "ops.augment:make_batch_train_pipeline",
    "ops.augment:warp_label": "ops.augment:warp_label_batch",
    "ops.corruptions:corrupt_volume_jit": "ops.corruptions:corrupt_volume",
    "ops.fast_conv:Conv": STAIRCASE,
    "ops.fast_conv:fast_conv_enabled": STAIRCASE,
    "ops.masking:MaskSettings": "config:MaskConfig",
    "ops.masking:USE_PALLAS_MASK": "reason: K3 always thresholds on the card "
                                   "(ops/percentile_mask.py); its plain version on the CPU",
    "train.cooperative:CooperativeTripletSolver": "train.cooperative:CooperativeTrainer",
    "train.cooperative:NETWORK_TYPES": "train.predictor:NETWORK_TYPES",
    "train.multi_epoch:make_window_runner": "train.multi_epoch:WindowRunner",
    "utils.profiling:V5E_PEAK_FLOPS_BF16": "utils.profiling:PEAK_FLOPS",
    "utils.profiling:V5E_PEAK_HBM_BYTES": "utils.profiling:HBM_BYTES_PER_S",
    "utils.schedulers:clip_grad_by_adam_bound": "utils.schedulers:AdamBoundClip",
    "utils.flags:current": "reason: no code of the port reads a knob by name; cli.train's "
                           "namespace and the keywords carry each knob to where it is read",
}

# the JAX registry's environment knobs (utils/flags.py) -> the port's knob or a reason
KNOBS = {
    "PALLAS_CONV": "reason: the port's default route: K1 on every eligible conv",
    "PALLAS_VJP": "reason: the port's default backward: K1 on flipped weights and K2",
    "PALLAS_CONV_MAX_CH": "ops.conv_chw:MAX_CH",
    "PALLAS_CONV_S2": "flag:conv_s2",
    "PALLAS_CONV_NL": "flag:conv_nl",
    "PALLAS_CONV_NL_MAX_CH": "ops.conv_nl:eligible_channels_nl",
    "PALLAS_CONV_INTERPRET": "reason: the port's wrappers run their plain versions on CPU "
                             "tensors",
    "FAST_CONV": STAIRCASE,
    "FUSED_WARP": "flag:warp",
    "TILED_WARP": "reason: not a fault: a TPU rewrite of the gather; the port mirrors the "
                  "gather (ROADMAP.md queue 3)",
    "SEQ_WARP": "flag:warp",
    "SALIENCY_BN_UPDATE": "flag:saliency_bn_update",
    "FUSED_STN": "flag:fused_stn",
    "FUSED_FTN": "flag:fused_ftn",
    "FUSED_EPOCH": "flag:fused_epoch",
    "PIPELINE_EPOCH": "flag:pipeline_epoch",
    "MULTI_EPOCH": "flag:multi_epoch",
    "FULL_SHAPE_SHARDING": "reason: the gate of JAX's 192^2 sharded-against-one-device test; "
                           "the port's full-shape sharded fused epoch runs in chip_smoke.py's "
                           "sharded phase (FCN_16_standard at 192^2, bf16, batch 20, one NCCL "
                           "rank); " + QUEUE_3A,
    "BENCH_BATCH": "reason: the JAX bench's harness knob; the port's benchmark is not written "
                   "yet (ROADMAP.md)",
    "BENCH_DTYPE": "flag:bf16",
    "BENCH_REMAT": "flag:remat",
    "DRYRUN_REAL_DEVICES": "reason: the JAX entry's virtual CPU mesh; the port's ranks are "
                           "processes (parallel/mesh.py)",
}

# the root cli/ entries -> the port's module or a reason
ENTRIES = {
    "aggregate_seed_sweep": "cli.seed_band",
    "bench_b8_conv": "bench_b8_conv",
    "bench_fast_conv": "reason: chip_smoke.py's tools phase times the staircase conv against "
                       "F.conv2d",
    "bench_inference": "profile_predict",
    "bench_nl_conv": "reason: chip_smoke.py's kernels phase times K5 against cuDNN",
    "bench_pallas_conv": "reason: chip_smoke.py's kernels phase times K1, K1 dx and K2 "
                         "against cuDNN",
    "bench_tiled_warp": "reason: TILED_WARP is a TPU rewrite, not ported (not a fault)",
    "bench_warp_formulations": "reason: chip_smoke.py's arms and augment phases time the "
                               "warp's arms",
    "check_pallas_values": "reason: chip_smoke.py and tests/test_torch_port_cuda.py hold every "
                           "kernel and the step against their plain versions",
    "diag_grad_chaos": "reason: the JAX step's own sensitivity, which the port's step tests "
                       "measure (tests/torch_port_util.py:SENSITIVITY)",
    "export": "cli.export",
    "generate_acdc_c": "cli.generate_acdc_c",
    "make_synthetic_acdc": "cli.make_synthetic_acdc",
    "preprocess": "cli.preprocess",
    "probe_myo": "reason: a one-off probe of the JAX augmentation's label warp; the port's "
                 "warp is held to JAX's (tests/test_torch_port_augment.py)",
    "profile_augment": "reason: chip_smoke.py's augment phase",
    "profile_fused_epoch": "reason: chip_smoke.py's fused phase",
    "profile_layers": "profile_train",
    "profile_step_knockout": "profile_train",
    "test": "cli.test",
    "train": "cli.train",
    "train_torch_reference": "reason: trains the reference's own PyTorch solver, which is not "
                             "this port",
    "validate_dataset": "cli.validate_dataset",
    "vis_hard_examples": "cli.vis_hard_examples",
}


def _modules(root):
    """{dotted module: its source path} of a package."""
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(dirpath, f)
            mod = os.path.relpath(path, root)[:-3].replace(os.sep, ".")
            out[mod] = path
    return out


def _names(path, imports=False):
    """The public top-level names a module defines; with ``imports``, also
    those its top-level imports bind."""
    with open(path) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            names.add(node.target.id)
        elif imports and isinstance(node, (ast.Import, ast.ImportFrom)):
            names.update((a.asname or a.name).split(".")[0] for a in node.names)
    return {n for n in names if not n.startswith("_")}


JAX_MODULES = _modules(JAX_PKG)
PORT_MODULES = _modules(PORT)


def _port_has(target):
    module, _, name = target.partition(":")
    return module in PORT_MODULES and (not name or name in _names(PORT_MODULES[module], True))


def _check(target, what):
    if target.startswith("reason: "):
        assert len(target) > len("reason: ") + 10, what
    else:
        assert _port_has(target), f"{what}: the port has no {target}"


@pytest.mark.parametrize("module", sorted(JAX_MODULES))
def test_every_jax_module_and_name_has_a_counterpart(module):
    if module not in PORT_MODULES:
        assert module in MODULES, f"{module}: no port module and no entry in MODULES"
        _check(MODULES[module], module)
        return
    port_names = _names(PORT_MODULES[module], imports=True)
    missing = []
    for name in sorted(_names(JAX_MODULES[module])):
        if name in port_names:
            continue
        key = f"{module}:{name}"
        if key not in NAMES:
            missing.append(key)
            continue
        _check(NAMES[key], key)
    assert not missing, f"no counterpart and no entry in NAMES: {missing}"


def test_maps_name_only_what_exists_in_jax():
    for module in MODULES:
        assert module in JAX_MODULES and module not in PORT_MODULES, module
    for key in NAMES:
        module, _, name = key.partition(":")
        assert name in _names(JAX_MODULES[module]), key
        if module in PORT_MODULES:
            assert name not in _names(PORT_MODULES[module], True), f"{key}: drop the entry"


def _jax_knobs():
    with open(os.path.join(JAX_PKG, "utils", "flags.py")) as f:
        tree = ast.parse(f.read())
    return {node.args[0].value for node in ast.walk(tree)
            if isinstance(node, ast.Call) and getattr(node.func, "id", None) == "Flag"
            and node.args and isinstance(node.args[0], ast.Constant)}


def test_every_jax_knob_has_a_counterpart():
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.utils import flags

    knobs = _jax_knobs()
    assert knobs == set(KNOBS), sorted(knobs ^ set(KNOBS))
    for knob, target in KNOBS.items():
        if target.startswith("flag:"):
            flags.lookup(target[len("flag:"):])
        else:
            _check(target, knob)


def test_every_root_entry_has_a_counterpart():
    entries = {f[:-3] for f in os.listdir(os.path.join(REPO, "cli")) if f.endswith(".py")}
    assert entries == set(ENTRIES), sorted(entries ^ set(ENTRIES))
    for entry, target in ENTRIES.items():
        _check(target, entry)
