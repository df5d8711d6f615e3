"""The port and chip_smoke.py import without JAX, as on the GPU machine,
which has PyTorch but no jax, flax or optax (nor scikit-learn or
matplotlib; the port relies on neither pandas nor msgpack either).

A fresh interpreter refuses every import of jax, flax, optax, orbax, the JAX
package, scikit-learn, pandas, matplotlib and msgpack, then imports every
module of the port (``parallel/*``, ``utils/*``, ``analysis/*``,
``ops/fast_conv.py`` and the entries ``cli/export.py``,
``cli/vis_hard_examples.py``, ``cli/preprocess.py`` and
``cli/validate_dataset.py`` among them) and ``chip_smoke``.  Nothing may be
built or launched by importing, no process group started, and TensorBoard
not imported (the scalar logger imports it when it opens a log).
"""

import os
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = textwrap.dedent("""
    import importlib, importlib.abc, pkgutil, sys

    BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax",
               "cooperative_training_and_latent_space_data_augmentation_tpu",
               "sklearn", "pandas", "matplotlib", "msgpack")

    class Refuse(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if any(name == b or name.startswith(b + ".") for b in BLOCKED):
                raise ImportError(f"refused import of {name}")
            return None

    sys.meta_path.insert(0, Refuse())
    import cooperative_training_and_latent_space_data_augmentation_tpu_torch as port

    names = [m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + ".")]
    for name in names:
        importlib.import_module(name)
    import chip_smoke

    from cooperative_training_and_latent_space_data_augmentation_tpu_torch import kernels
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.ops import conv_chw
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.ops import conv_s2
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.ops import conv_nl
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.ops import conv_b8
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.ops import (
        percentile_mask,
    )
    expected = {"config", "convert", "kernels", "ops.conv_chw", "ops.conv_s2", "ops.conv_nl",
                "ops.conv_b8", "bench_b8_conv", "ops.image", "ops.augment", "ops.spline",
                "ops.losses",
                "ops.masking", "ops.percentile_mask", "models.blocks",
                "models.encoder_decoder", "train.cooperative", "train.draws",
                "train.predictor", "profile_predict", "profile_train", "data.synthetic",
                "data.base", "data.loader", "eval.metrics", "utils.logging", "train.checkpoint",
                "train.driver", "cli.train", "data.nifti", "data.preprocess", "data.splits",
                "data.acdc", "data.mnm", "eval.post_process", "eval.pairwise_measures",
                "eval.tester", "cli.make_synthetic_acdc", "cli.test", "models.layers",
                "models.unet", "models.unet3d", "train.segmentation", "utils.schedulers",
                "utils.ema", "data.prostate", "data.host_transforms", "parallel",
                "parallel.mesh", "utils.checkpoint", "utils.seed", "analysis",
                "analysis.visualize", "utils.serving", "utils.estimate", "utils.profiling",
                "utils.flags", "utils.save", "ops.fast_conv", "cli.export",
                "cli.vis_hard_examples", "cli.preprocess", "cli.validate_dataset"}
    missing = {port.__name__ + "." + m for m in expected} - set(names)
    assert not missing, missing
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.config import (
        ParallelConfig, Params,
    )
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.parallel import (
        Mesh, batch_sharding, launch, make_mesh, pad_batch_to_multiple, replicate, shard_batch,
        shard_train_step,
    )
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.utils.checkpoint import (
        latest_step, restore_checkpoint, save_checkpoint,
    )
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.utils.seed import (
        set_seed,
    )
    import torch.distributed as dist
    assert not dist.is_initialized(), "a process group was started at import"
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.data import (
        ProstateDecathlonDataset,
    )
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.ops.augment import (
        Transformations, clahe, draw_motion, eval_transform_sample, motion_estimation,
    )
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.analysis.visualize import (
        hard_example_arrays, plot_confusion_matrix, prediction_entropy, save_hard_example_grids,
        visualize_hard_examples,
    )
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.utils.serving import (
        export_predictor, load_predictor,
    )
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.utils.estimate import (
        count_params, estimate_size, extract_features, param_bytes,
    )
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.utils.profiling import (
        HBM_BYTES_PER_S, PEAK_FLOPS, cost_summary, device_time, fused_scan_marginal,
        serialize_scan, time_fn, trace,
    )
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.utils.flags import (
        REGISTRY, lookup, markdown_table,
    )
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.utils.save import (
        save_testing_images_results,
    )
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.ops.fast_conv import (
        pick_pack_factor, staircase_conv3x3,
    )
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.ops.image import (
        center_crop_or_pad, center_crop_or_pad_nhwc, filter_unlabelled_predictions,
        random_inpainting, random_outpainting, recover_image, rescale_intensity,
        sharpen_predictions, shuffle_tensor, unit_norm, z_score_intensity,
    )
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.data.base import (
        CombinedDataset, get_all_image_array_from_dataset, get_mean_image,
    )
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.eval.tester import (
        TestSegmentationNetwork,
    )
    assert hasattr(TestSegmentationNetwork, "save_top_k_result")
    assert "tensorboard" not in sys.modules, "tensorboard was imported at import time"
    assert not kernels._libs, "a kernel library was loaded at import"
    assert set(kernels.SOURCES) == {"conv3x3_chw", "conv3x3_chw_dw", "conv3x3s2",
                                    "conv3x3_nl", "conv3x3_b8", "percentile_mask"}
    for fn in (conv_chw.conv3x3_chw, conv_chw.conv3x3_chw_dx, conv_chw.conv3x3_chw_dw,
               conv_s2.conv3x3s2, conv_s2.conv3x3s2_dx, conv_s2.conv3x3s2_dw,
               conv_nl.conv3x3_nl, conv_nl.conv3x3_nl_dx, conv_nl.conv3x3_nl_dw,
               conv_b8.conv3x3_b8, conv_b8.conv3x3_b8_dx, conv_b8.conv3x3_b8_dw,
               percentile_mask.percentile_mask):
        assert fn.launches == 0
    leaked = sorted(m for m in sys.modules if any(m == b or m.startswith(b + ".") for b in BLOCKED))
    assert not leaked, leaked
    print("imported", len(names), "modules")
""")


def test_port_imports_without_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    n = int(proc.stdout.split("imported")[1].split()[0])
    assert n >= 51, proc.stdout
