from cooperative_training_and_latent_space_data_augmentation_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    batch_sharding,
    launch,
    make_mesh,
    pad_batch_to_multiple,
    replicate,
    shard_batch,
    shard_train_step,
)
