"""Datasets: synthetic phantoms made from a seed, ACDC-layout volume
trees read from NIfTI or NRRD files, and the Decathlon prostate task."""

from cooperative_training_and_latent_space_data_augmentation_tpu_torch.data.prostate import (  # noqa: F401
    ProstateDecathlonDataset,
    get_prostate_split_policy,
)
