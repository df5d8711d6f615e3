"""Volume-wise evaluation: the patient loop, the cross-domain driver and
the methods x cvals table.

Counterpart of the JAX package's ``eval/tester.py`` (``TestSegmentationNetwork``,
``evaluate_cross_domain``, ``evaluate_methods_across_cvals`` and
``aggregate_across_cvals``), the re-design of
``medseg/test_basic_segmentation_solver.py`` (TestSegmentationNetwork:29-199:
patient-wise volume iteration, chunked inference at <= 10 slices,
spacing-aware metric updates, CSV reports, top-k/worst-k and their PNG
grids) and of the
per-dataset loop of ``medseg/test_ACDC_triplet_segmentation.py`` (:80-158)
and of its results loop over methods and cvals (:115-158).

A volume's slices are padded to a multiple of ``chunk_size`` by repeating
the last one, as the JAX package pads them for its jitted predict (the
pad slices are dropped before the metrics).  Each chunk goes to the
device once; the logits stay there, and only their argmax comes back to
the host.
"""

from __future__ import annotations

import math
import os
from os.path import join
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from cooperative_training_and_latent_space_data_augmentation_tpu_torch.data.nifti import (
    write_nrrd,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.eval.metrics import (
    RunningSegmentationScore,
    write_csv,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.utils.save import (
    save_testing_images_results,
)

IDX2CLS = {0: "BG", 1: "LV", 2: "MYO", 3: "RV"}  # test_ACDC...py:25-30
AGG_COLUMNS = ("dataset", "method", "metric", "mean", "std", "n_cvals")


class TestSegmentationNetwork:
    """Patient-wise evaluator.

    ``predict_fn(images_nhwc) -> logits_nhwc`` takes and returns torch
    tensors on ``device`` (float32 (B, H, W, C_in) in, (B, H, W, C) out);
    chunks are ``chunk_size`` slices (the reference caps them at 10,
    test_basic_segmentation_solver.py:97-102).
    """

    def __init__(self, test_dataset, predict_fn: Callable[[torch.Tensor], torch.Tensor],
                 crop_size: Tuple[int, int] = (192, 192),
                 num_classes: int = 4,
                 idx2cls_dict: Optional[Dict[int, str]] = None,
                 metrics_list: Sequence[str] = ("Dice",),
                 foreground_only: bool = False,
                 chunk_size: int = 10,
                 save_path: Optional[str] = None,
                 save_predict: bool = False,
                 save_soft_prediction: bool = False,
                 device: Union[str, torch.device] = "cuda"):
        self.dataset = test_dataset
        self.predict_fn = predict_fn
        self.crop_size = crop_size
        self.num_classes = num_classes
        self.chunk_size = chunk_size
        self.save_path = save_path
        self.save_predict = save_predict
        self.save_soft_prediction = save_soft_prediction
        self.device = torch.device(device)
        self.metric = RunningSegmentationScore(
            n_classes=num_classes,
            idx2cls_dict=idx2cls_dict or
            {k: v for k, v in IDX2CLS.items() if k < num_classes},
            metrics_list=list(metrics_list), foreground_only=foreground_only)
        self.patient_results: List[Dict] = []
        self.rows: List[List] = []

    def predict_volume(self, images_nhwc: np.ndarray) -> torch.Tensor:
        """Chunked inference: (n, H, W, C) logits on the device."""
        n = images_nhwc.shape[0]
        cs = self.chunk_size
        pad = (-n) % cs
        if pad:
            images_nhwc = np.concatenate(
                [images_nhwc, np.repeat(images_nhwc[-1:], pad, axis=0)], axis=0)
        x = torch.from_numpy(np.ascontiguousarray(images_nhwc, dtype=np.float32))
        logits = [self.predict_fn(x[i:i + cs].to(self.device))
                  for i in range(0, x.shape[0], cs)]
        return torch.cat(logits, dim=0)[:n]

    def run(self) -> Dict[str, float]:
        """Evaluate all patients (test_basic_segmentation_solver.run:63-83)."""
        self.metric.reset()
        self.patient_results = []
        for pid_index in range(self.dataset.get_patient_num()):
            img, gt = self.dataset.get_patient_data_for_testing(
                pid_index, crop_size=self.crop_size)
            pid = self.dataset.get_id(pid_index)
            logits = self.predict_volume(np.asarray(img))
            pred = logits.argmax(dim=-1).to(torch.int32).cpu().numpy()
            spacing = self.dataset.get_voxel_spacing(pid_index)
            self.metric.update(pid, pred, np.asarray(gt), voxel_spacing=spacing)
            mean_fg_dice = float(np.nanmean(
                [self.metric.multi_scores[k][-1]
                 for k in self.metric.multi_scores if k.endswith("_Dice")]))
            self.patient_results.append(
                {"pid": pid, "dice": mean_fg_dice, "pred": pred, "gt": np.asarray(gt),
                 "image": np.asarray(img)})
            if self.save_path and self.save_predict:
                os.makedirs(join(self.save_path, "pred"), exist_ok=True)
                write_nrrd(join(self.save_path, "pred", f"{pid}_pred.nrrd"),
                           pred.astype(np.int16), spacing=spacing)
                if self.save_soft_prediction:
                    os.makedirs(join(self.save_path, "soft"), exist_ok=True)
                    np.save(join(self.save_path, "soft", f"{pid}_soft.npy"),
                            torch.softmax(logits.float(), dim=-1).cpu().numpy())
        summary, _, _ = self.metric.get_scores(
            save_path=join(self.save_path, "summary.csv") if self.save_path else None)
        self.rows = self.metric.save_patient_wise_result_to_csv(
            join(self.save_path, "detail.csv") if self.save_path else None)
        return summary

    # top-k / worst-k reports (test_basic_segmentation_solver.py:182-256)
    def top_k(self, k: int = 5) -> List[Dict]:
        return sorted(self.patient_results, key=lambda r: -r["dice"])[:k]

    def worst_k(self, k: int = 5) -> List[Dict]:
        return sorted(self.patient_results, key=lambda r: r["dice"])[:k]

    def save_top_k_result(self, save_dir: str, k: int = 5,
                          worst: bool = False) -> List[Optional[str]]:
        """PNG grids (input/GT/pred, the first 5 slices) for the k best or
        worst patients of the last :meth:`run`, under
        ``{save_dir}/{top|worst}_{rank}_{pid}_dice_{dice:.3f}/``
        (test_basic_segmentation_solver.save_top_k_result:202-256).  A path
        is None where matplotlib is not installed."""
        chosen = self.worst_k(k) if worst else self.top_k(k)
        tag = "worst" if worst else "top"
        paths = []
        for rank, rec in enumerate(chosen):
            name = f"{tag}_{rank}_{rec['pid']}_dice_{rec['dice']:.3f}"
            paths.append(save_testing_images_results(
                rec["image"][:, :, :, 0], rec["gt"], rec["pred"], save_dir, name,
                max_slices=5))
        return paths


def evaluate_cross_domain(predict_fn: Callable[[torch.Tensor], torch.Tensor],
                          datasets: Dict[str, object],
                          save_dir: Optional[str] = None,
                          crop_size: Tuple[int, int] = (192, 192),
                          num_classes: int = 4,
                          metrics_list: Sequence[str] = ("Dice",),
                          device: Union[str, torch.device] = "cuda") -> Dict[str, Dict]:
    """Per-dataset evaluation loop (test_ACDC_triplet_segmentation.py:80-158):
    {dataset_name: summary_dict}; CSVs per dataset under save_dir."""
    results = {}
    for name, dataset in datasets.items():
        sub_dir = join(save_dir, name) if save_dir else None
        if sub_dir:
            os.makedirs(sub_dir, exist_ok=True)
        tester = TestSegmentationNetwork(
            dataset, predict_fn, crop_size=crop_size, num_classes=num_classes,
            metrics_list=metrics_list, save_path=sub_dir, device=device)
        results[name] = tester.run()
        print(f"[{name}] " + " ".join(
            f"{k}={v:.4f}" for k, v in results[name].items() if k.endswith("_mean")))
    return results


def evaluate_methods_across_cvals(
        make_predict_fn: Callable[[str, int], Optional[Callable]],
        dataset_builder: Callable[[int], Dict[str, object]],
        methods: Sequence[str],
        cvals: Sequence[int],
        save_dir: Optional[str] = None,
        crop_size: Tuple[int, int] = (192, 192),
        num_classes: int = 4,
        metrics_list: Sequence[str] = ("Dice",),
        device: Union[str, torch.device] = "cuda"):
    """The reference's full results loop
    (test_ACDC_triplet_segmentation.py:115-158): methods x cvals x datasets.

    ``make_predict_fn(method, cval)`` returns a predict function (or None
    to skip, e.g. a missing checkpoint: the reference prints and goes on,
    :137-139); ``dataset_builder(cval)`` returns the {name: dataset}
    registry of that fold.  Returns ``(per_run, aggregated)``: per_run maps
    (method, cval, dataset) -> summary dict (each run writes its CSVs under
    ``{save_dir}/{method}/cv{cval}/{dataset}/``), aggregated is
    :func:`aggregate_across_cvals`'s table, written to
    ``{save_dir}/aggregated.csv``."""
    per_run: Dict[Tuple[str, int, str], Dict] = {}
    for cval in cvals:
        predicts = {}
        for method in methods:
            fn = make_predict_fn(method, cval)
            if fn is None:
                print(f"{method}: cval {cval} unavailable, skipped")
                continue
            predicts[method] = fn
        if not predicts:
            continue
        datasets = dataset_builder(cval)
        for method, predict_fn in predicts.items():
            sub = join(save_dir, method, f"cv{cval}") if save_dir else None
            results = evaluate_cross_domain(
                predict_fn, datasets, save_dir=sub, crop_size=crop_size,
                num_classes=num_classes, metrics_list=metrics_list, device=device)
            for ds_name, summary in results.items():
                per_run[(method, cval, ds_name)] = summary
    aggregated = aggregate_across_cvals(per_run)
    if save_dir is not None and aggregated is not None:
        os.makedirs(save_dir, exist_ok=True)
        write_csv(join(save_dir, "aggregated.csv"), AGG_COLUMNS, aggregated)
    return per_run, aggregated


def _group_mean(values: Sequence[float]) -> float:
    """pandas' groupby mean: a Kahan-compensated sum over the count."""
    total = compensation = 0.0
    for v in values:
        y = v - compensation
        t = total + y
        compensation = t - total - y
        if compensation != compensation:  # inf - inf
            compensation = 0.0
        total = t
    return total / len(values) if values else math.nan


def _group_std(values: Sequence[float]) -> float:
    """pandas' groupby std (1 degree of freedom): Welford's online update."""
    mean = m2 = 0.0
    for n, v in enumerate(values, start=1):
        old = mean
        mean += (v - old) / n
        m2 += (v - mean) * (v - old)
    return math.sqrt(m2 / (len(values) - 1)) if len(values) > 1 else math.nan


def aggregate_across_cvals(per_run: Dict[Tuple[str, int, str], Dict]) -> Optional[List[Tuple]]:
    """{(method, cval, dataset) -> summary} to the tidy mean/std-across-cvals
    table, one row (dataset, method, metric, mean, std, n_cvals) per
    dataset x method x ``*_mean`` metric, sorted by those three; None when
    there is no run.  The arithmetic is pandas' groupby's, so the CSV is
    the JAX package's byte for byte: NaN values are left out, std is NaN
    (an empty field) at n_cvals 1."""
    groups: Dict[Tuple[str, str, str], List[float]] = {}
    for (method, _cval, ds_name), summary in per_run.items():
        for key, value in summary.items():
            if key.endswith("_mean"):
                groups.setdefault((ds_name, method, key[:-len("_mean")]), []).append(
                    float(value))
    if not groups:
        return None
    rows = []
    for key in sorted(groups):
        values = [v for v in groups[key] if not math.isnan(v)]
        rows.append((*key, _group_mean(values), _group_std(values), len(values)))
    return rows
