"""PyTorch/CUDA port of ``cooperative_training_and_latent_space_data_augmentation_tpu``.

The JAX package is the reference; this package computes the same functions
in PyTorch, NCHW inside, with the TPU package's Pallas kernels rewritten by
hand for NVIDIA Hopper (``csrc/``, built by :mod:`.kernels`).  It imports
``torch`` and numpy, never JAX or the JAX package.

Ported so far: the eval-mode FTN+STN predictor
(:class:`.train.predictor.CooperativePredictor`), the cooperative train step
with latent masking (:class:`.train.cooperative.CooperativeTrainer`), the
kernels K1 (the CHW 3x3 conv and its input gradient, :mod:`.ops.conv_chw`),
K2 (its weight gradient) and K3 (the masking threshold,
:mod:`.ops.percentile_mask`), the stride-2, large-channel and blocked
conv kernels K4-K6, the on-device training augmentation
(:mod:`.ops.augment`, :mod:`.ops.spline`; plain PyTorch ops), the training
loop (:func:`.train.driver.train_network`: the datasets, batchers,
validation metric and checkpoints around the train step) and its
``--synthetic`` command line (:mod:`.cli.train`), the held-out evaluation
(the NIfTI/NRRD readers, the split policies and the ACDC and M&Ms
datasets in :mod:`.data`, the volume metrics and the tester in
:mod:`.eval`, the synthetic ACDC tree's writer
:mod:`.cli.make_synthetic_acdc` and the test entry :mod:`.cli.test`), and
the converters in :mod:`.convert`, a reader of the JAX package's
checkpoints among them.
"""

__version__ = "0.1.0"
