"""Host -> device input pipeline: samplers and batchers.

Counterpart of the JAX package's ``data/loader.py`` (``BatchSampler``,
``collate``, ``prefetch``, ``CooperativeBatcher``, ``EvalBatcher``) and of
``parallel/mesh.py:pad_batch_to_multiple``, per batch.  The host only
collates raw fixed-shape numpy samples; the augmentation runs on the
device (:mod:`..ops.augment`) with its random draws taken from the
caller's draw source (see :mod:`..train.driver`), where the JAX package
splits a key.  The fused epoch (``CooperativeBatcher.epoch_index_matrix``
and ``fused_epoch_runner``) and the stacked validation epoch
(``EvalBatcher.stacked_epoch``) run on the device, one or one a rank.

Under a data-parallel ``mesh`` (``parallel/mesh.py``; the JAX package's
``sharding`` argument) both batchers yield this rank's rows of the global
batch: every rank samples the same global indices from the same seed,
augments the whole batch with the same draws and keeps its rows (JAX's
order: with ``keep_orig`` the augmented half goes to the first ranks),
and a validation batch, wrap-padded to ``batch_size``, carries the rank's
count of real rows beside the global one.  The fused epoch does the same
inside each step's graph (the JAX package's ``fused_epoch_runner(mesh=)``,
whose sharding constraint on the index vector partitions the same global
computation), and the stacked validation epoch stacks the rank's rows.

``CooperativeBatcher`` keeps the batch-halving of
``keep_orig_image_label_pair_for_training``: each raw sample gives an
augmented view and its centre-cropped original, so the effective batch is
twice the sampled one.
"""

from __future__ import annotations

import queue
import threading
from typing import TYPE_CHECKING, Dict, Iterator, Optional, Tuple, Union

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

if TYPE_CHECKING:
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.train.graphs import (
        StepGraphs,
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
    (:func:`prefetch`) and copied up one by one.  ``warp``: the
    augmentation's geometric warp arm (``ops/augment.py:WARPS``).  With a
    ``mesh`` each batch is this rank's rows of the global batch, which
    must divide over the ranks.
    """

    def __init__(self, dataset: SegDatasetBase, batch_size: int, policy_name: str,
                 pad_hw=(224, 224), crop_hw=(192, 192), num_classes: int = 4,
                 keep_orig: bool = True, shuffle: bool = True, seed: Optional[int] = 0,
                 device: Device = "cuda", device_cache: Optional[bool] = None,
                 warp: str = "composed", mesh=None):
        self.dataset = dataset
        self.keep_orig = keep_orig
        self.raw_bs = max(batch_size // 2, 1) if keep_orig else batch_size
        self.sampler = BatchSampler(len(dataset), self.raw_bs, shuffle=shuffle, seed=seed)
        self.policy = get_policy(policy_name)
        self.pad_hw = tuple(pad_hw)
        self.pipeline = make_batch_train_pipeline(policy_name, pad_hw, crop_hw, num_classes,
                                                  keep_orig, warp)
        self.pipeline_idx = make_batch_train_pipeline_indexed(policy_name, pad_hw, crop_hw,
                                                              num_classes, keep_orig, warp)
        self.device = torch.device(device)
        if device_cache is None:
            # ~5 bytes a pixel: f32 image + uint8 label, padded resolution
            device_cache = len(dataset) * pad_hw[0] * pad_hw[1] * 5 <= DEVICE_CACHE_LIMIT_BYTES
        self.device_cache = device_cache
        self._cached = None
        self.mesh = mesh
        if mesh is not None and self.step_batch % mesh.size:
            raise ValueError(f"a train batch of {self.step_batch} does not divide over the "
                             f"{mesh.size}-rank mesh")

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

    @property
    def step_batch(self) -> int:
        """Samples a train step sees: ``raw_bs``, twice that with
        ``keep_orig``."""
        return self.raw_bs * (2 if self.keep_orig else 1)

    def epoch_index_matrix(self) -> np.ndarray:
        """(K, raw_bs) int64 indices of one epoch's batches, the host side
        of the fused epoch: it takes the sampler's next epoch, as
        :meth:`epoch` does, so fused and streaming epochs see the same
        batch orders."""
        return np.stack(list(self.sampler.epoch())).astype(np.int64)

    def fused_epoch_runner(self, trainer) -> StepGraphs:
        """The JAX package's ``fused_epoch_runner``: every (gather +
        augment + train step) of an epoch against the dataset on the
        device, one CUDA graph replay a step on the card, no read back.
        Under the batcher's ``mesh`` (``mesh=`` there), each step trains
        the trainer (in data-parallel mode on the mesh) on this rank's rows
        of the augmented global batch, its collectives inside the graph;
        on the card a mesh whose collectives cannot be captured (gloo) is
        refused.  Needs the dataset on the device (``device_cache``);
        raises otherwise.  Returns the epoch's ``train/graphs.py:StepGraphs``,
        whose ``run_epoch(idx_mat, steps) -> (K, 10) metrics`` is the run."""
        if not self.device_cache:
            raise ValueError("the fused epoch gathers its batches from the dataset on the "
                             "device, and this dataset is over DEVICE_CACHE_LIMIT_BYTES; "
                             "train it without --fused_epoch")
        mesh = self.mesh
        if self.device.type == "cuda" and mesh is not None and not mesh.capturable:
            raise ValueError(f"the fused epoch over {mesh.size} ranks captures the sharded "
                             f"step's collectives into CUDA graphs, and the mesh's "
                             f"{mesh.backend} collectives cannot be captured: train over NCCL "
                             f"ranks, a card each, or without --fused_epoch")
        from cooperative_training_and_latent_space_data_augmentation_tpu_torch.train.graphs import (
            StepGraphs,
        )

        return StepGraphs(trainer, self.pipeline_idx, *self.device_dataset(), mesh=mesh)

    def raw_epoch(self) -> Iterator[Dict[str, np.ndarray]]:
        """Numpy-only collation, safe to run on a prefetch thread."""
        for indices in self.sampler.epoch():
            yield collate(self.dataset, indices)

    def epoch(self, draws, prefetch_size: int = 2) -> Iterator[Dict[str, torch.Tensor]]:
        """One epoch of batches on the device, {'image' (B, h, w, C) float32,
        'label' (B, h, w) int32}.  ``draws(policy, n, pad_hw)`` gives each
        batch's :class:`..ops.augment.AugmentDraws` for its ``n`` raw
        samples, on the device, in batch order (under a ``mesh``, the
        global batch's draws; the batch is this rank's rows)."""
        for batch in self._global_epoch(draws, prefetch_size):
            yield batch if self.mesh is None else {k: self.mesh.rows(v)
                                                   for k, v in batch.items()}

    def _global_epoch(self, draws, prefetch_size: int):
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
    ``'local_count'`` is the real rows among the batch's own: under a
    ``mesh`` (``batch_size`` must divide over its ranks, as the JAX
    package asserts) the batch is this rank's rows of the padded global
    batch, and ``local_count`` those whose global index lies below
    ``real_count``; without one it equals ``real_count``.  The transform
    is deterministic, so with ``device_cache`` (default: a validation set
    of at most ``DEVICE_CACHE_LIMIT_BYTES`` at 8 bytes a crop pixel) the
    batches stay on the device after the first pass.
    """

    def __init__(self, dataset: SegDatasetBase, batch_size: int, pad_hw=(224, 224),
                 crop_hw=(192, 192), device: Device = "cuda",
                 device_cache: Optional[bool] = None, mesh=None):
        if mesh is not None and batch_size % mesh.size:
            raise ValueError(f"eval batch_size {batch_size} must divide over the "
                             f"{mesh.size}-rank mesh")
        self.dataset = dataset
        self.batch_size = batch_size
        self.mesh = mesh
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
            if self.mesh is None:
                yield {"image": img, "label": lbl, "real_count": real_count,
                       "local_count": real_count}
                continue
            yield {"image": self.mesh.rows(img), "label": self.mesh.rows(lbl),
                   "real_count": real_count,
                   "local_count": self.mesh.local_count(real_count, self.batch_size)}

    def stacked_epoch(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The whole validation epoch stacked on the device: images (Nb, B,
        h, w, C) float32, labels (Nb, B, h, w) int32 and real counts (Nb,)
        int32, the input of ``train/graphs.py:ValidationGraph`` (the JAX
        package's ``stacked_epoch``, the K-epoch window's format).  Under a
        ``mesh``, B is this rank's rows and the counts its ``local_count``s."""
        batches = list(self.epoch())
        reals = np.asarray([b["local_count"] for b in batches], np.int32)
        return (torch.stack([b["image"] for b in batches]),
                torch.stack([b["label"].to(torch.int32) for b in batches]),
                torch.from_numpy(reals).to(self.device))

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
