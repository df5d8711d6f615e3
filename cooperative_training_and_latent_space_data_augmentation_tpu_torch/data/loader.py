"""Host -> device input pipeline: samplers and batchers.

Counterpart of the JAX package's ``data/loader.py`` (``BatchSampler``,
``collate``, ``prefetch``, ``CooperativeBatcher``, ``EvalBatcher``) and of
``parallel/mesh.py:pad_batch_to_multiple``, per batch, on one device.  The
host only collates raw fixed-shape numpy samples; the augmentation runs on
the device (:mod:`..ops.augment`) with its random draws taken from the
caller's draw source (see :mod:`..train.driver`), where the JAX package
splits a key.  Its fused epoch (``fused_epoch_runner``), the stacked
validation epoch and every ``sharding`` argument are left out.

``CooperativeBatcher`` keeps the batch-halving of
``keep_orig_image_label_pair_for_training``: each raw sample gives an
augmented view and its centre-cropped original, so the effective batch is
twice the sampled one.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional, Tuple, Union

import numpy as np
import torch

from cooperative_training_and_latent_space_data_augmentation_tpu_torch.data.base import (
    SegDatasetBase,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.ops.augment import (
    get_policy,
    make_batch_eval_transform,
    make_batch_train_pipeline,
    make_batch_train_pipeline_indexed,
)

# Datasets up to this many bytes of padded image + label data are kept on
# the device, so a batch costs one small index transfer (the JAX package's
# limit; the 70-subject ACDC slice set at 224^2 is about 0.5 GB).
DEVICE_CACHE_LIMIT_BYTES = 2 * 1024 ** 3

Device = Union[str, torch.device]


class BatchSampler:
    """Shuffled epoch iterator over dataset indices, from
    ``np.random.RandomState(seed)`` (the JAX package's orders, bit for bit).

    ``wrap=True`` keeps every batch at ``batch_size`` by tiling from the
    start of the permutation (training); ``wrap=False`` yields the ragged
    tail (evaluation, where duplicates would be counted twice).
    """

    def __init__(self, n: int, batch_size: int, shuffle: bool = True,
                 drop_last: bool = False, seed: Optional[int] = None,
                 wrap: bool = True):
        self.n = n
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.wrap = wrap
        self.rng = np.random.RandomState(seed)

    def __len__(self) -> int:
        if self.drop_last:
            return self.n // self.batch_size
        return (self.n + self.batch_size - 1) // self.batch_size

    def epoch(self) -> Iterator[np.ndarray]:
        order = (self.rng.permutation(self.n) if self.shuffle
                 else np.arange(self.n))
        for i in range(0, self.n, self.batch_size):
            batch = order[i:i + self.batch_size]
            if self.drop_last and len(batch) < self.batch_size:
                break
            if self.wrap and len(batch) < self.batch_size:
                # tile (np.resize) so shortfalls larger than n still fill
                extra = np.resize(order, self.batch_size - len(batch))
                batch = np.concatenate([batch, extra])
            yield batch


def collate(dataset: SegDatasetBase, indices: np.ndarray) -> Dict[str, np.ndarray]:
    images, labels = [], []
    for i in indices:
        s = dataset[int(i)]
        images.append(s["image"])
        labels.append(s["label"])
    return {"image": np.stack(images).astype(np.float32),
            "label": np.stack(labels).astype(np.int32)}


def prefetch(iterator: Iterator, size: int = 2) -> Iterator:
    """Run ``iterator`` on a background thread with a bounded queue, so host
    collation overlaps device work.  The producer gives up when the consumer
    abandons the iterator (a ``max_iteration`` stop mid-epoch), and an
    exception in it is raised on the consumer's side."""
    q: "queue.Queue" = queue.Queue(maxsize=size)
    end = object()
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for item in iterator:
                if not put(item):
                    return
            put(end)
        except Exception as e:  # noqa: BLE001 -- handed to the consumer, which raises it
            put(e)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is end:
                return
            if isinstance(item, Exception):
                raise item
            yield item
    finally:
        stop.set()


def pad_batch_to_multiple(batch: Dict[str, np.ndarray], multiple: int
                          ) -> Tuple[Dict[str, np.ndarray], int]:
    """Pad axis 0 of every array of ``batch`` by wrap-tiling to a multiple of
    ``multiple``; returns (batch, real_count).  A copy of the JAX package's
    ``parallel/mesh.py:pad_batch_to_multiple``."""
    n = next(iter(batch.values())).shape[0]
    rem = n % multiple
    out = {k: np.asarray(v) for k, v in batch.items()}
    if rem == 0:
        return out, n
    pad = multiple - rem
    for k, v in out.items():
        idx = np.resize(np.arange(n), pad)
        out[k] = np.concatenate([v, v[idx]], axis=0)
    return out, n


class CooperativeBatcher:
    """Training batches at crop resolution on ``device``.

    ``batch_size`` is the effective batch (the configuration's
    ``learning.batch_size``); with ``keep_orig`` the sampler draws
    ``batch_size // 2`` raw slices and a batch is [augmented || original]
    (train...py:48-60,103-108).  A dataset of at most
    ``DEVICE_CACHE_LIMIT_BYTES`` (or ``device_cache=True``) is put on the
    device once, images float32 and labels uint8, and a batch is gathered
    there by index; otherwise batches are collated on a background thread
    (:func:`prefetch`) and copied up one by one.
    """

    def __init__(self, dataset: SegDatasetBase, batch_size: int, policy_name: str,
                 pad_hw=(224, 224), crop_hw=(192, 192), num_classes: int = 4,
                 keep_orig: bool = True, shuffle: bool = True, seed: Optional[int] = 0,
                 device: Device = "cuda", device_cache: Optional[bool] = None):
        self.dataset = dataset
        self.keep_orig = keep_orig
        self.raw_bs = max(batch_size // 2, 1) if keep_orig else batch_size
        self.sampler = BatchSampler(len(dataset), self.raw_bs, shuffle=shuffle, seed=seed)
        self.policy = get_policy(policy_name)
        self.pad_hw = tuple(pad_hw)
        self.pipeline = make_batch_train_pipeline(policy_name, pad_hw, crop_hw, num_classes,
                                                  keep_orig)
        self.pipeline_idx = make_batch_train_pipeline_indexed(policy_name, pad_hw, crop_hw,
                                                              num_classes, keep_orig)
        self.device = torch.device(device)
        if device_cache is None:
            # ~5 bytes a pixel: f32 image + uint8 label, padded resolution
            device_cache = len(dataset) * pad_hw[0] * pad_hw[1] * 5 <= DEVICE_CACHE_LIMIT_BYTES
        self.device_cache = device_cache
        self._cached = None

    def __len__(self) -> int:
        return len(self.sampler)

    def device_dataset(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The whole padded dataset on the device, uploaded on first use:
        (images (S, H, W, C) float32, labels (S, H, W) uint8)."""
        if self._cached is None:
            raw = collate(self.dataset, np.arange(len(self.dataset)))
            self._cached = (torch.from_numpy(raw["image"]).to(self.device),
                            torch.from_numpy(raw["label"].astype(np.uint8)).to(self.device))
        return self._cached

    def raw_epoch(self) -> Iterator[Dict[str, np.ndarray]]:
        """Numpy-only collation, safe to run on a prefetch thread."""
        for indices in self.sampler.epoch():
            yield collate(self.dataset, indices)

    def epoch(self, draws, prefetch_size: int = 2) -> Iterator[Dict[str, torch.Tensor]]:
        """One epoch of batches on the device, {'image' (B, h, w, C) float32,
        'label' (B, h, w) int32}.  ``draws(policy, n, pad_hw)`` gives each
        batch's :class:`..ops.augment.AugmentDraws` for its ``n`` raw
        samples, on the device, in batch order."""
        if self.device_cache:
            img_all, lbl_all = self.device_dataset()
            for indices in self.sampler.epoch():
                d = draws(self.policy, len(indices), self.pad_hw)
                idx = torch.from_numpy(indices.astype(np.int64)).to(self.device)
                yield self.pipeline_idx(d, img_all, lbl_all, idx)
            return
        raw_it = self.raw_epoch()
        if prefetch_size:
            raw_it = prefetch(raw_it, prefetch_size)
        for raw in raw_it:
            d = draws(self.policy, raw["image"].shape[0], self.pad_hw)
            img = torch.from_numpy(raw["image"]).to(self.device)
            lbl = torch.from_numpy(raw["label"].astype(np.uint8)).to(self.device)
            yield self.pipeline(d, img, lbl)


class EvalBatcher:
    """Validation batches through the eval transform (pad, centre crop,
    min-max normalise), no augmentation, on ``device``.

    A ragged tail is padded by wrap-tiling to ``batch_size`` and each batch
    carries ``'real_count'``, a host int: consumers count only the rows
    below it, so no sample is counted twice and predict sees one shape.
    The transform is deterministic, so with ``device_cache`` (default: a
    validation set of at most ``DEVICE_CACHE_LIMIT_BYTES`` at 8 bytes a crop
    pixel) the batches stay on the device after the first pass.
    """

    def __init__(self, dataset: SegDatasetBase, batch_size: int, pad_hw=(224, 224),
                 crop_hw=(192, 192), device: Device = "cuda",
                 device_cache: Optional[bool] = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.sampler = BatchSampler(len(dataset), batch_size, shuffle=False, wrap=False)
        self.eval_transform = make_batch_eval_transform(pad_hw, crop_hw)
        self.device = torch.device(device)
        if device_cache is None:
            device_cache = len(dataset) * crop_hw[0] * crop_hw[1] * 8 <= DEVICE_CACHE_LIMIT_BYTES
        self.device_cache = device_cache
        self._cached_batches = None

    def __len__(self) -> int:
        return len(self.sampler)

    def _build_epoch(self):
        for indices in self.sampler.epoch():
            raw, real_count = pad_batch_to_multiple(collate(self.dataset, indices),
                                                    self.batch_size)
            img, lbl = self.eval_transform(torch.from_numpy(raw["image"]).to(self.device),
                                           torch.from_numpy(raw["label"]).to(self.device))
            yield {"image": img, "label": lbl, "real_count": real_count}

    def epoch(self) -> Iterator[Dict[str, torch.Tensor]]:
        if not self.device_cache:
            yield from self._build_epoch()
            return
        if self._cached_batches is None:
            cached = []
            for batch in self._build_epoch():
                cached.append(batch)
                yield batch
            self._cached_batches = cached
        else:
            yield from self._cached_batches
