"""Segmentation metrics: the validation metric, a confusion matrix on the
device with its IoU and accuracy scores on the host, and the held-out
evaluation's volume metrics on the host.

Counterpart of the JAX package's ``eval/metrics.py``: its device side
(``confusion_matrix_update``, ``scores_from_confusion``, ``RunningScore``;
the reference's ``medseg/common_utils/metrics.py:runningScore:12-54``)
and a copy of its host side (numpy and scipy: ``dc`` ... ``obj_tpr``, the
medpy-style suite of ``medseg/common_utils/measure.py``, and
``RunningSegmentationScore``, ``print_metric``,
``write_eval_scores_to_disk``), whose CSVs are written with the ``csv``
module, byte for byte in the layout pandas gives them there.
"""

from __future__ import annotations

import csv
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from scipy.ndimage import (
    binary_erosion,
    distance_transform_edt,
    generate_binary_structure,
)


def confusion_matrix_update(confusion: torch.Tensor, label_true: torch.Tensor,
                            label_pred: torch.Tensor) -> torch.Tensor:
    """``confusion`` (C, C) int64 plus the counts of (true, predicted)
    pairs of two integer label maps, on their device, without reading
    anything back to the host.  Pixels whose true label lies outside
    ``[0, C)`` are not counted; the flat bin is clipped to ``[0, C * C]`` as
    ``jnp.bincount(..., length=C * C + 1)`` clips it.  (``torch.bincount``
    reads its input's minimum and maximum back to the host on a CUDA
    tensor, so the counts are one ``index_add_`` instead.)"""
    n = confusion.shape[0]
    lt = label_true.reshape(-1).long()
    lp = label_pred.reshape(-1).long()
    valid = (lt >= 0) & (lt < n)
    idx = torch.where(valid, lt * n + lp, n * n).clamp(0, n * n)
    counts = torch.zeros(n * n + 1, dtype=torch.int64, device=idx.device)
    counts.index_add_(0, idx, torch.ones_like(idx))
    return confusion + counts[:-1].view(n, n)


def scores_from_confusion(hist) -> Tuple[Dict[str, float], Dict[int, float]]:
    """IoU/acc summary with the reference's exact dict keys
    (metrics.py:30-52), in float64."""
    hist = np.asarray(hist, np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        acc = np.diag(hist).sum() / hist.sum()
        acc_cls = np.nanmean(np.diag(hist) / hist.sum(axis=1))
        iu = np.diag(hist) / (hist.sum(axis=1) + hist.sum(axis=0) - np.diag(hist))
        mean_iu = np.nanmean(iu)
        freq = hist.sum(axis=1) / hist.sum()
        fwavacc = (freq[freq > 0] * iu[freq > 0]).sum()
    return {
        "Overall Acc: \t": acc,
        "Mean Acc : \t": acc_cls,
        "FreqW Acc : \t": fwavacc,
        "Mean IoU : \t": mean_iu,
    }, dict(zip(range(hist.shape[0]), iu))


class RunningScore:
    """Confusion-matrix mean IoU and accuracy (metrics.runningScore:12-54).
    The matrix accumulates on ``device`` in int64 (exact counts);
    :meth:`get_scores` is its only read back to the host."""

    def __init__(self, n_classes: int, device: Union[str, torch.device] = "cuda"):
        self.n_classes = n_classes
        self.device = torch.device(device)
        self.reset()

    def update(self, label_trues, label_preds) -> None:
        lt = torch.as_tensor(label_trues, device=self.device)
        lp = torch.as_tensor(label_preds, device=self.device)
        self.confusion_matrix = confusion_matrix_update(self.confusion_matrix, lt, lp)

    def get_scores(self):
        return scores_from_confusion(self.confusion_matrix.cpu().numpy())

    def reset(self) -> None:
        self.confusion_matrix = torch.zeros((self.n_classes, self.n_classes),
                                            dtype=torch.int64, device=self.device)


# alias with the reference's class name
runningScore = RunningScore


# ----------------------------------------------------------------- host side


def dc(result, reference) -> float:
    """Dice coefficient on binarized inputs (measure.dc:52-101)."""
    result = np.atleast_1d(np.asarray(result).astype(bool))
    reference = np.atleast_1d(np.asarray(reference).astype(bool))
    intersection = np.count_nonzero(result & reference)
    size = np.count_nonzero(result) + np.count_nonzero(reference)
    if size == 0:
        return np.nan
    return 2.0 * intersection / float(size)


def jc(result, reference) -> float:
    """Jaccard coefficient (measure.jc)."""
    result = np.atleast_1d(np.asarray(result).astype(bool))
    reference = np.atleast_1d(np.asarray(reference).astype(bool))
    inter = np.count_nonzero(result & reference)
    union = np.count_nonzero(result | reference)
    return inter / float(union) if union else np.nan


def precision(result, reference) -> float:
    result = np.asarray(result).astype(bool)
    reference = np.asarray(reference).astype(bool)
    tp = np.count_nonzero(result & reference)
    den = np.count_nonzero(result)
    return tp / float(den) if den else 0.0


def recall(result, reference) -> float:
    result = np.asarray(result).astype(bool)
    reference = np.asarray(reference).astype(bool)
    tp = np.count_nonzero(result & reference)
    den = np.count_nonzero(reference)
    return tp / float(den) if den else 0.0


sensitivity = recall


def specificity(result, reference) -> float:
    result = np.asarray(result).astype(bool)
    reference = np.asarray(reference).astype(bool)
    tn = np.count_nonzero(~result & ~reference)
    den = np.count_nonzero(~reference)
    return tn / float(den) if den else 0.0


def surface_distances(result, reference, voxelspacing=None, connectivity=1):
    """Distances from surface voxels of `result` to the surface of `reference`
    (measure.__surface_distances:1096-1131): 1-px border via binary erosion,
    euclidean distance transform with physical spacing."""
    result = np.atleast_1d(np.asarray(result).astype(bool))
    reference = np.atleast_1d(np.asarray(reference).astype(bool))
    if voxelspacing is not None:
        voxelspacing = np.broadcast_to(
            np.atleast_1d(np.asarray(voxelspacing, np.float64)), (result.ndim,)
        ).copy()
    footprint = generate_binary_structure(result.ndim, connectivity)
    if np.count_nonzero(result) == 0:
        raise RuntimeError("the first supplied array is empty")
    if np.count_nonzero(reference) == 0:
        raise RuntimeError("the second supplied array is empty")
    result_border = result ^ binary_erosion(result, structure=footprint, iterations=1)
    reference_border = reference ^ binary_erosion(reference, structure=footprint,
                                                  iterations=1)
    dt = distance_transform_edt(~reference_border, sampling=voxelspacing)
    return dt[result_border]


def hd(result, reference, voxelspacing=None, connectivity=1) -> float:
    """Symmetric Hausdorff distance (measure.hd:333-378)."""
    hd1 = surface_distances(result, reference, voxelspacing, connectivity).max()
    hd2 = surface_distances(reference, result, voxelspacing, connectivity).max()
    return max(hd1, hd2)


def hd95(result, reference, voxelspacing=None, connectivity=1) -> float:
    """95th-percentile symmetric Hausdorff distance (measure.hd95)."""
    d1 = surface_distances(result, reference, voxelspacing, connectivity)
    d2 = surface_distances(reference, result, voxelspacing, connectivity)
    return np.percentile(np.hstack((d1, d2)), 95)


def hd_2D_stack(result, reference, pixelspacing=None, connectivity=1) -> float:
    """Mean slicewise symmetric HD over slices where both masks are nonempty;
    -1 if no such slice (measure.hd_2D_stack:381-400)."""
    total, c = 0.0, 0
    for i in range(result.shape[0]):
        if np.sum(result[i]) > 0 and np.sum(reference[i]) > 0:
            total += hd(result[i], reference[i], voxelspacing=pixelspacing,
                        connectivity=connectivity)
            c += 1
    return total / c if c else -1.0


def asd(result, reference, voxelspacing=None, connectivity=1) -> float:
    """Average (directed) surface distance (measure.asd:458-533)."""
    return surface_distances(result, reference, voxelspacing, connectivity).mean()


def assd(result, reference, voxelspacing=None, connectivity=1) -> float:
    """Average symmetric surface distance (measure.assd)."""
    return float(np.mean((asd(result, reference, voxelspacing, connectivity),
                          asd(reference, result, voxelspacing, connectivity))))


def ravd(result, reference) -> float:
    """Relative absolute volume difference (pred-gt)/gt (measure.ravd)."""
    v1 = np.count_nonzero(result)
    v2 = np.count_nonzero(reference)
    if v2 == 0:
        raise RuntimeError("reference is empty")
    return (v1 - v2) / float(v2)


def volumesimilarity(result, reference) -> float:
    """2*(v1-v2)/(v1+v2) (measure.volumesimilarity:611-665)."""
    v1 = np.count_nonzero(result)
    v2 = np.count_nonzero(reference)
    if v2 == 0:
        raise RuntimeError("reference is empty")
    return 2 * (v1 - v2) / float(v1 + v2)


def volume_sim_index(result, reference) -> float:
    """1 - |v1-v2|/(v1+v2) (measure.VolumeSimIndex:668-700)."""
    v1 = np.count_nonzero(result)
    v2 = np.count_nonzero(reference)
    if v1 + v2 == 0:
        return np.nan
    return 1.0 - abs(v1 - v2) / float(v1 + v2)


VolumeSimIndex = volume_sim_index


# --------------------------------------------- per-object (connected-component)
# metrics (measure.obj_*:700-1090).  The reference vendors a python-2 medpy
# copy (`.iteritems()`, list-`filter`) that cannot run under py3 and is used
# by no reference driver; these are working re-implementations following
# medpy's documented semantics.


def _binary_object_correspondences(result, reference, connectivity: int = 1):
    """Label distinct binary objects in both masks and build the unique
    1-to-1 mapping {reference object id -> overlapping result object id}
    (one-voxel overlap suffices; ambiguous one-to-many relationships are
    resolved smallest-candidate-set-first, like
    measure.__distinct_binary_object_correspondences:1038-1093).

    Returns (labeled_result, labeled_reference, n_result, n_reference,
    mapping)."""
    from scipy.ndimage import find_objects, label

    result = np.atleast_1d(np.asarray(result).astype(bool))
    reference = np.atleast_1d(np.asarray(reference).astype(bool))
    footprint = generate_binary_structure(result.ndim, connectivity)
    lab_res, n_res = label(result, footprint)
    lab_ref, n_ref = label(reference, footprint)

    mapping = {}
    used = set()
    one_to_many = []
    for ref_id, slicer in enumerate(find_objects(lab_ref), start=1):
        obj = lab_ref[slicer] == ref_id
        res_ids = np.unique(lab_res[slicer][obj])
        res_ids = set(int(i) for i in res_ids if i != 0)
        if len(res_ids) == 1:
            (res_id,) = res_ids
            if res_id not in used:
                mapping[ref_id] = res_id
                used.add(res_id)
        elif len(res_ids) > 1:
            one_to_many.append((ref_id, res_ids))
    while True:
        one_to_many = [(rid, ids - used) for rid, ids in one_to_many]
        one_to_many = sorted((x for x in one_to_many if x[1]),
                             key=lambda x: len(x[1]))
        if not one_to_many:
            break
        ref_id, ids = one_to_many[0]
        res_id = min(ids)  # deterministic pick (ref pops an arbitrary one)
        mapping[ref_id] = res_id
        used.add(res_id)
        one_to_many = one_to_many[1:]
    return lab_res, lab_ref, n_res, n_ref, mapping


def obj_asd(result, reference, voxelspacing=None, connectivity=1) -> float:
    """Average surface distance between CORRESPONDING objects only
    (measure.obj_asd:851-919)."""
    from scipy.ndimage import find_objects

    lab_res, lab_ref, _, _, mapping = _binary_object_correspondences(
        result, reference, connectivity)
    res_windows = find_objects(lab_res)
    ref_windows = find_objects(lab_ref)
    sds = []
    for ref_id, res_id in mapping.items():
        window = tuple(
            slice(min(a.start, b.start), max(a.stop, b.stop))
            for a, b in zip(res_windows[res_id - 1], ref_windows[ref_id - 1]))
        obj_res = lab_res[window] == res_id
        obj_ref = lab_ref[window] == ref_id
        sds.extend(surface_distances(obj_res, obj_ref, voxelspacing,
                                     connectivity))
    return float(np.mean(sds)) if sds else np.nan


def obj_assd(result, reference, voxelspacing=None, connectivity=1) -> float:
    """Symmetric per-object average surface distance (measure.obj_assd:799-848)."""
    return float(np.mean((obj_asd(result, reference, voxelspacing, connectivity),
                          obj_asd(reference, result, voxelspacing, connectivity))))


def obj_fpr(result, reference, connectivity=1) -> float:
    """Fraction of distinct objects in `result` with NO correspondence in
    `reference` — 0 is ideal (measure.obj_fpr:922-977)."""
    _, _, _, n_res_objects, mapping = _binary_object_correspondences(
        reference, result, connectivity)
    if n_res_objects == 0:
        raise RuntimeError("result contains no binary objects")
    return (n_res_objects - len(mapping)) / float(n_res_objects)


def obj_tpr(result, reference, connectivity=1) -> float:
    """Fraction of distinct objects in `reference` detected (>=1 voxel
    overlap) by `result` — 1 is ideal (measure.obj_tpr:980-1035)."""
    _, _, _, n_ref_objects, mapping = _binary_object_correspondences(
        result, reference, connectivity)
    if n_ref_objects == 0:
        raise RuntimeError("reference contains no binary objects")
    return len(mapping) / float(n_ref_objects)


def _csv_field(v):
    """A cell as ``DataFrame.to_csv`` writes it: NaN as an empty field,
    floats by their shortest round-trip ``repr``, the rest by ``str``."""
    if isinstance(v, (float, np.floating)):
        return "" if np.isnan(v) else repr(float(v))
    return v


def write_csv_rows(f, header: Sequence[str], rows: Sequence[Sequence]) -> None:
    """``rows`` under ``header`` to the open text stream ``f``, as
    :func:`write_csv` lays them out."""
    w = csv.writer(f, lineterminator="\n")
    w.writerow(header)
    for row in rows:
        w.writerow([_csv_field(v) for v in row])


def write_csv(path: str, header: Sequence[str], rows: Sequence[Sequence]) -> None:
    """``rows`` under ``header``, laid out byte for byte as the JAX
    package's ``pd.DataFrame(rows, columns=header).to_csv(path,
    index=False)`` writes them (the csv module's minimal quoting, ``\\n``
    line ends)."""
    with open(path, "w", newline="") as f:
        write_csv_rows(f, header, rows)


SUPPORTED_METRICS = ("Dice", "HD", "ASD", "VolError", "VolSim")


class RunningSegmentationScore:
    """Patient-wise per-class {Dice, HD, ASD, VolError, VolSim} accumulation
    with CSV export (metrics.runningMySegmentationScore:139-296)."""

    def __init__(self, n_classes: int, idx2cls_dict: Optional[Dict[int, str]] = None,
                 metrics_list: Sequence[str] = ("Dice",), foreground_only: bool = False):
        self.n_classes = n_classes
        self.metrics = list(metrics_list)
        self.foreground_only = foreground_only
        if idx2cls_dict is None:
            idx2cls_dict = ({1: "foreground"} if foreground_only
                            else {i: str(i) for i in range(n_classes)})
        self.idx2cls_dict = idx2cls_dict
        self.multi_scores: Dict[str, List[float]] = {}
        header = ["patient_id"]
        for c_index, class_name in self.idx2cls_dict.items():
            if c_index > 0:
                for m in self.metrics:
                    assert m in SUPPORTED_METRICS, m
                    self.multi_scores[f"{class_name}_{m}"] = []
                    header.append(f"{class_name}_{m}")
        self.header = header
        self.tables: List[List] = []

    def update(self, pid, preds: np.ndarray, gts: np.ndarray,
               voxel_spacing=None):
        preds = np.asarray(preds)
        gts = np.asarray(gts)
        assert preds.shape == gts.shape, (pid, preds.shape, gts.shape)
        if voxel_spacing is not None:
            assert len(voxel_spacing) == 3, voxel_spacing
        n, h, w = preds.shape
        row: List = [str(pid)]
        for c, class_name in self.idx2cls_dict.items():
            if c == 0:
                continue
            if self.foreground_only:
                gt_c = (gts > 0).astype(np.uint8)
                pr_c = (preds > 0).astype(np.uint8)
            else:
                gt_c = (gts == c).astype(np.uint8)
                pr_c = (preds == c).astype(np.uint8)
            for metric in self.metrics:
                if metric == "Dice":
                    score = dc(pr_c, gt_c)
                elif metric == "HD":
                    assert voxel_spacing is not None
                    # 2-D stack HD with in-plane spacing, 8-connectivity
                    # (metrics.py:226-236)
                    score = hd_2D_stack(pr_c, gt_c, pixelspacing=voxel_spacing[:2],
                                        connectivity=2)
                    if score < 0:
                        # the -1 'no valid slice' sentinel (parity with
                        # measure.hd_2D_stack:397-398) must not drag the
                        # nanmean summary negative -> exclude as nan
                        score = np.nan
                elif metric == "ASD":
                    assert voxel_spacing is not None
                    # arrays are (slices, h, w) but spacing is ITK-ordered
                    # (sx, sy, sz): reorder so each array axis gets its own
                    # spacing (the reference passes the tuple through
                    # unreordered, metrics.py:236-238 — a latent bug we fix;
                    # sz<=0 means 'unknown thickness' -> 1.0).
                    sx, sy = voxel_spacing[0], voxel_spacing[1]
                    sz = voxel_spacing[2] if len(voxel_spacing) > 2 else -1.0
                    ordered = (sz if sz > 0 else 1.0, sy, sx)
                    try:
                        score = asd(pr_c, gt_c, voxelspacing=ordered,
                                    connectivity=2)
                    except RuntimeError:
                        score = np.nan
                elif metric == "VolSim":
                    score = volume_sim_index(pr_c, gt_c)
                elif metric == "VolError":
                    denom = np.count_nonzero(gt_c)
                    score = ((np.count_nonzero(pr_c) - denom) / denom
                             if denom else np.nan)
                else:
                    raise NotImplementedError(metric)
                self.multi_scores[f"{class_name}_{metric}"].append(score)
                row.append(score)
        self.tables.append(row)
        return row

    def get_scores(self, save_path: Optional[str] = None):
        """mean/std summary (+ optional CSV) (metrics.py:255-277)."""
        summary_dict = {}
        summary_list: List[List[str]] = [[], []]
        header = []
        for k, vals in self.multi_scores.items():
            mean, std = float(np.nanmean(vals)), float(np.nanstd(vals))
            summary_dict[f"{k}_mean"] = mean
            summary_dict[f"{k}_std"] = std
            summary_list[0].append(f"{mean:.3f}")
            summary_list[1].append(f"{std:.3f}")
            header.append(k)
        if save_path is not None:
            write_csv(save_path, header, summary_list)
        return summary_dict, summary_list, header

    def save_patient_wise_result_to_csv(self, save_path: Optional[str]) -> List[List]:
        """The patient-wise rows (under :attr:`header`), written to
        ``save_path`` as ``detail.csv`` unless it is None."""
        if save_path is not None:
            write_csv(save_path, self.header, self.tables)
        return self.tables

    def reset(self):
        for k in self.multi_scores:
            self.multi_scores[k] = []
        self.tables = []


# alias with the reference's class name
runningMySegmentationScore = RunningSegmentationScore


def print_metric(running_metric: RunningScore, name: str = "") -> Dict[str, float]:
    """Print + return the IoU score dict (metrics.print_metric:372-378)."""
    score, class_iou = running_metric.get_scores()
    print(f"==> {name}")
    for k, v in score.items():
        print(k, v)
    return score


def write_eval_scores_to_disk(running_metrics_groups: Dict[str, "RunningSegmentationScore"],
                              txt_path: str, views: Sequence[str],
                              metrics: Sequence[str] = ("Dice", "HD")) -> str:
    """Cross-view text report (metrics.write_eval_scores_to_disk:381-408):
    one header line of '<view> [<metric>]' columns, one line of
    'mean (std)' cells, aggregated over all patients/classes per view."""
    with open(txt_path, "w") as f:
        header = [f"{view} [{m}]  , " for m in metrics for view in views]
        f.writelines(header + ["\n"])
        cells = []
        for m in metrics:
            for view in views:
                rm = running_metrics_groups[view]
                arrays = [np.asarray(v, np.float64)
                          for k, v in rm.multi_scores.items()
                          if k.endswith(f"_{m}")]
                # metric not tracked by this RunningSegmentationScore -> nan
                vals = np.concatenate(arrays) if arrays else np.asarray([np.nan])
                cells.append(f"{np.nanmean(vals):.3f} ({np.nanstd(vals):.3f}), ")
        f.writelines(cells + ["\n"])
    return txt_path
