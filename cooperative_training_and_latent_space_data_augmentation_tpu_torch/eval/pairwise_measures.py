"""NiftyNet-style pairwise segmentation and regression measures.

A copy of the JAX package's ``eval/pairwise_measures.py`` (numpy and
scipy; the port imports nothing of the JAX package), its working
re-design of the reference's vendored ``PairwiseMeasures`` suite
(``medseg/common_utils/hausdorff_util.py:14-609``), which is dead code
under Python 3 in the reference.  It provides:

  * :class:`MorphologyOps` -- border map (6-neighborhood) + connected
    components (``hausdorff_util.py:14-41``);
  * :class:`PairwiseMeasures` -- binary overlap counts, rates, Dice/IoU,
    informedness/markedness, volume difference, border-EDT average/Hausdorff
    distances, centre-of-mass distances, connected-component TP/FP/FN,
    Wack outline/detection errors (``hausdorff_util.py:92-580``);
  * :class:`PairwiseMeasuresRegression` -- MSE/RMSE/MAE/R^2
    (``hausdorff_util.py:583-609``).

Two deviations from the reference's copy, both fixes of code it never
ran: ``connected_elements``/``connected_errormaps`` iterate over all
component labels (the reference's ``range(1, n_labels)`` dropped the last
one), and the EDT border distances honour ``pixdim`` (the reference
accepted it and ignored it; at the default (1, 1, 1) the two agree).
Everything runs on the host at evaluation time.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
from scipy import ndimage


class MorphologyOps:
    """Morphological helpers on a binary volume (hausdorff_util.py:14-41)."""

    def __init__(self, binary_img: np.ndarray, neigh: int = 8):
        if binary_img.ndim != 3:
            raise ValueError("MorphologyOps supports 3-D inputs only, got "
                             f"shape {binary_img.shape}")
        self.binary_map = np.asarray(binary_img > 0.5, dtype=np.int8)
        self.neigh = neigh

    def border_map(self) -> np.ndarray:
        """Foreground voxels with at least one 6-neighborhood background
        neighbor (zero-padded shifts, hausdorff_util.py:25-38)."""
        b = self.binary_map
        cumulative = np.zeros_like(b, dtype=np.int32)
        for axis in range(3):
            for direction in (-1, 1):
                shifted = np.zeros_like(b)
                src = [slice(None)] * 3
                dst = [slice(None)] * 3
                if direction == 1:
                    src[axis], dst[axis] = slice(None, -1), slice(1, None)
                else:
                    src[axis], dst[axis] = slice(1, None), slice(None, -1)
                shifted[tuple(dst)] = b[tuple(src)]
                cumulative += shifted
        return np.logical_and(cumulative < 6, b == 1)

    def foreground_component(self):
        """(labels, n_components) via scipy.ndimage.label."""
        return ndimage.label(self.binary_map)


class PairwiseMeasures:
    """Pairwise measures between one binary segmentation and one binary
    reference (hausdorff_util.py:92-580).

    Args:
      seg_img, ref_img: binary arrays of the same shape (3-D required for
        the border-distance and connected-component measures).
      measures: optional sequence of measure keys (default: all).
      num_neighbors: neighborhood for connected components (kept for API
        parity; scipy's default cross-connectivity is used).
      pixdim: voxel spacing used by the distance measures.
      empty: if True, measures that are undefined on an empty segmentation
        (ppv, com_dist, com_seg) return -1 as in the reference.
    """

    def __init__(self, seg_img: np.ndarray, ref_img: np.ndarray,
                 measures: Optional[Sequence[str]] = None,
                 num_neighbors: int = 8,
                 pixdim: Sequence[float] = (1, 1, 1),
                 empty: bool = False,
                 list_labels: Optional[Sequence[int]] = None):
        self.seg = np.asarray(seg_img)
        self.ref = np.asarray(ref_img)
        self._labels = list_labels
        self.flag_empty = empty
        self.neigh = num_neighbors
        self.pixdim = tuple(pixdim)
        self._cache: Dict[str, object] = {}
        self.m_dict = {
            'ref volume': (self.n_pos_ref, 'Volume (Ref)'),
            'seg volume': (self.n_pos_seg, 'Volume (Seg)'),
            'ref bg volume': (self.n_neg_ref, 'Volume (Ref bg)'),
            'seg bg volume': (self.n_neg_seg, 'Volume (Seg bg)'),
            'list_labels': (self.list_labels, 'List Labels Seg'),
            'fp': (self.fp, 'FP'), 'fn': (self.fn, 'FN'),
            'tp': (self.tp, 'TP'), 'tn': (self.tn, 'TN'),
            'n_intersection': (self.n_intersection, 'Intersection'),
            'n_union': (self.n_union, 'Union'),
            'sensitivity': (self.sensitivity, 'Sens'),
            'specificity': (self.specificity, 'Spec'),
            'accuracy': (self.accuracy, 'Acc'),
            'fpr': (self.false_positive_rate, 'FPR'),
            'ppv': (self.positive_predictive_values, 'PPV'),
            'npv': (self.negative_predictive_values, 'NPV'),
            'dice': (self.dice_score, 'Dice'),
            'IoU': (self.intersection_over_union, 'IoU'),
            'jaccard': (self.jaccard, 'Jaccard'),
            'informedness': (self.informedness, 'Informedness'),
            'markedness': (self.markedness, 'Markedness'),
            'vol_diff': (self.vol_diff, 'VolDiff'),
            'ave_dist': (self.measured_average_distance, 'AveDist'),
            'haus_dist': (self.measured_hausdorff_distance, 'HausDist'),
            'connected_elements': (self.connected_elements, 'TPc,FPc,FNc'),
            'outline_error': (self.outline_error, 'OER,OEFP,OEFN'),
            'detection_error': (self.detection_error, 'DE,DEFP,DEFN'),
            'com_dist': (self.com_dist, 'COM distance'),
            'com_ref': (self.com_ref, 'COM reference'),
            'com_seg': (self.com_seg, 'COM segmentation'),
        }
        self.measures = tuple(measures) if measures is not None \
            else tuple(self.m_dict)

    # --------------------------------------------------------------- plumbing
    def _memo(self, key, fn):
        if key not in self._cache:
            self._cache[key] = fn()
        return self._cache[key]

    def check_binary(self):
        """Overlap counts only make sense on binary maps
        (hausdorff_util.py:138-150)."""
        for name, x in (("seg", self.seg), ("ref", self.ref)):
            if not (((x > 0.5) == x).all()):
                raise ValueError(
                    f"the {name} image must be binary for this measure")

    # ------------------------------------------------------------- raw counts
    def n_pos_ref(self):
        return self._memo('n_pos_ref', lambda: float(np.sum(self.ref)))

    def n_neg_ref(self):
        self.check_binary()
        return self._memo('n_neg_ref', lambda: float(np.sum(self.ref == 0)))

    def n_pos_seg(self):
        return self._memo('n_pos_seg', lambda: float(np.sum(self.seg)))

    def n_neg_seg(self):
        return self._memo('n_neg_seg', lambda: float(np.sum(1 - self.seg)))

    def fp(self):
        self.check_binary()
        return self._memo('fp', lambda: float(
            np.sum((self.seg - self.ref) > 0)))

    def fn(self):
        self.check_binary()
        return self._memo('fn', lambda: float(
            np.sum((self.ref - self.seg) > 0)))

    def tp(self):
        self.check_binary()
        return self._memo('tp', lambda: float(
            np.sum(np.logical_and(self.ref > 0.5, self.seg > 0.5))))

    def tn(self):
        self.check_binary()
        return self._memo('tn', lambda: float(
            np.sum(np.logical_and(self.ref < 0.5, self.seg < 0.5))))

    def n_intersection(self):
        self.check_binary()
        return self._memo('n_intersection', lambda: float(
            np.sum(self.ref * self.seg)))

    def n_union(self):
        self.check_binary()
        return self._memo('n_union', lambda: float(
            np.sum(np.logical_or(self.ref, self.seg))))

    def list_labels(self) -> Tuple:
        return () if self._labels is None else tuple(np.unique(self._labels))

    # ------------------------------------------------------------ ratio stats
    def sensitivity(self):
        return self.tp() / self.n_pos_ref()

    def specificity(self):
        return self.tn() / self.n_neg_ref()

    def accuracy(self):
        return (self.tn() + self.tp()) / (
            self.tn() + self.tp() + self.fn() + self.fp())

    def false_positive_rate(self):
        return self.fp() / self.n_neg_ref()

    def positive_predictive_values(self):
        if self.flag_empty:
            return -1
        return self.tp() / (self.tp() + self.fp())

    def negative_predictive_values(self):
        return self.tn() / (self.fn() + self.tn())

    def dice_score(self):
        return 2 * self.tp() / float(np.sum(self.ref + self.seg))

    def intersection_over_union(self):
        return self.n_intersection() / self.n_union()

    def jaccard(self):
        return self.intersection_over_union()

    def informedness(self):
        return self.sensitivity() + self.specificity() - 1

    def markedness(self):
        return (self.positive_predictive_values()
                + self.negative_predictive_values() - 1)

    def vol_diff(self):
        """|V_ref - V_seg| / V_ref (hausdorff_util.py:361-368)."""
        return np.abs(self.n_pos_ref() - self.n_pos_seg()) / self.n_pos_ref()

    # ------------------------------------------------------ distance measures
    def border_distance(self):
        """(EDT(ref) on seg border, EDT(seg) on ref border, borders)
        (hausdorff_util.py:381-398; EDT honors pixdim here)."""
        def compute():
            border_ref = MorphologyOps(self.ref, self.neigh).border_map()
            border_seg = MorphologyOps(self.seg, self.neigh).border_map()
            distance_ref = ndimage.distance_transform_edt(
                 1 - (self.ref > 0.5), sampling=self.pixdim)
            distance_seg = ndimage.distance_transform_edt(
                 1 - (self.seg > 0.5), sampling=self.pixdim)
            distance_border_seg = border_ref * distance_seg
            distance_border_ref = border_seg * distance_ref
            return (distance_border_ref, distance_border_seg,
                    border_ref, border_seg)
        return self._memo('border_distance', compute)

    def measured_distance(self):
        """(hausdorff, average) border distance (hausdorff_util.py:400-415).

        NOTE the average's denominator is sum(ref)+sum(seg) (total foreground
        voxels), as in the reference — NOT the medpy ASSD border-count
        denominator (see eval/metrics.py:assd for that one).
        """
        ref_border_dist, seg_border_dist, _, _ = self.border_distance()
        average_distance = (np.sum(ref_border_dist)
                            + np.sum(seg_border_dist)) / np.sum(
                                (self.ref > 0.5) + (self.seg > 0.5))
        hausdorff_distance = max(np.max(ref_border_dist),
                                 np.max(seg_border_dist))
        return hausdorff_distance, average_distance

    def measured_average_distance(self):
        return self.measured_distance()[1]

    def measured_hausdorff_distance(self):
        return self.measured_distance()[0]

    def com_dist(self):
        """pixdim-weighted distance between centres of mass
        (hausdorff_util.py:321-335)."""
        if self.flag_empty:
            return -1
        com_ref = np.asarray(ndimage.center_of_mass(self.ref))
        com_seg = np.asarray(ndimage.center_of_mass(self.seg))
        return float(np.sqrt(np.dot(np.square(com_ref - com_seg),
                                    np.square(np.asarray(self.pixdim)))))

    def com_ref(self):
        return tuple(np.asarray(ndimage.center_of_mass(self.ref))
                     * np.asarray(self.pixdim))

    def com_seg(self):
        if self.flag_empty:
            return -1
        return tuple(ndimage.center_of_mass(self.seg))

    # ------------------------------------------- connected-component measures
    def _connected_components(self):
        def compute():
            init = (self.seg > 0.5) & (self.ref > 0.5)
            blobs_ref = MorphologyOps(self.ref, self.neigh).foreground_component()
            blobs_seg = MorphologyOps(self.seg, self.neigh).foreground_component()
            return blobs_ref, blobs_seg, init
        return self._memo('connected_components', compute)

    def _component_tp_lists(self):
        """Labels of ref/seg components that touch the intersection, and the
        FN (ref) / FP (seg) component labels (hausdorff_util.py:460-480,
        off-by-one fixed: ALL labels 1..n are considered)."""
        (lab_ref, n_ref), (lab_seg, n_seg), init = self._connected_components()
        tp_ref = np.unique(lab_ref[init & (lab_ref > 0)])
        tp_seg = np.unique(lab_seg[init & (lab_seg > 0)])
        fn_list = np.setdiff1d(np.arange(1, n_ref + 1), tp_ref)
        fp_list = np.setdiff1d(np.arange(1, n_seg + 1), tp_seg)
        return tp_ref, tp_seg, fn_list, fp_list

    def connected_elements(self):
        """(#TP, #FP, #FN) in connected components
        (hausdorff_util.py:460-480)."""
        tp_ref, _, fn_list, fp_list = self._component_tp_lists()
        return len(tp_ref), len(fp_list), len(fn_list)

    def connected_errormaps(self):
        """(TPc, FNc, FPc) component maps (hausdorff_util.py:482-512)."""
        def compute():
            (lab_ref, _), (lab_seg, _), _ = self._connected_components()
            tp_ref, tp_seg, fn_list, fp_list = self._component_tp_lists()
            tpc_map = (np.isin(lab_ref, tp_ref) & (lab_ref > 0)) | \
                      (np.isin(lab_seg, tp_seg) & (lab_seg > 0))
            fnc_map = np.isin(lab_ref, fn_list) & (lab_ref > 0)
            fpc_map = np.isin(lab_seg, fp_list) & (lab_seg > 0)
            return (tpc_map.astype(np.float64), fnc_map.astype(np.float64),
                    fpc_map.astype(np.float64))
        return self._memo('connected_errormaps', compute)

    def outline_error(self):
        """Wack outline error (OER, OEFP, OEFN)
        (hausdorff_util.py:514-532)."""
        tpc_map, _, _ = self.connected_errormaps()
        oef_map = self.ref - tpc_map * self.seg
        oefn = float(np.sum(oef_map == 1))
        oefp = float(np.sum(oef_map == -1))
        oer = 2 * (oefn + oefp) / (self.n_pos_seg() + self.n_pos_ref())
        return oer, oefp, oefn

    def detection_error(self):
        """Wack detection error (DE, DEFP, DEFN)
        (hausdorff_util.py:534-545)."""
        _, fnc_map, fpc_map = self.connected_errormaps()
        defn = float(np.sum(fnc_map))
        defp = float(np.sum(fpc_map))
        return defn + defp, defp, defn

    # ---------------------------------------------------------------- output
    def header_str(self) -> str:
        return ',' + ','.join(self.m_dict[key][1] for key in self.measures)

    def to_string(self, fmt: str = '{:.4f}') -> str:
        list_space = ('com_ref', 'com_seg', 'list_labels')
        parts = []
        for key in self.measures:
            result = self.m_dict[key][0]()
            sep = ' ' if key in list_space else ','
            parts.append(sep.join(fmt.format(x) for x in result)
                         if isinstance(result, tuple) else fmt.format(result))
        return ','.join(parts)


class PairwiseMeasuresRegression:
    """MSE/RMSE/MAE/R² between a regression output and its reference
    (hausdorff_util.py:583-609)."""

    def __init__(self, reg_img: np.ndarray, ref_img: np.ndarray,
                 measures: Optional[Sequence[str]] = None):
        self.reg = np.asarray(reg_img, dtype=np.float64)
        self.ref = np.asarray(ref_img, dtype=np.float64)
        self.m_dict = {
            'mse': (self.mse, 'MSE'), 'rmse': (self.rmse, 'RMSE'),
            'mae': (self.mae, 'MAE'), 'r2': (self.r2, 'R2'),
        }
        self.measures = tuple(measures) if measures is not None \
            else tuple(self.m_dict)

    def mse(self):
        return float(np.mean(np.square(self.reg - self.ref)))

    def rmse(self):
        return float(np.sqrt(self.mse()))

    def mae(self):
        return float(np.mean(np.abs(self.ref - self.reg)))

    def r2(self):
        ref_var = np.sum(np.square(self.ref - np.mean(self.ref)))
        reg_var = np.sum(np.square(self.reg - np.mean(self.reg)))
        cov = np.sum((self.reg - np.mean(self.reg))
                     * (self.ref - np.mean(self.ref)))
        return float(np.square(cov / np.sqrt(ref_var * reg_var + 1e-5)))

    def header_str(self) -> str:
        return ',' + ','.join(self.m_dict[key][1] for key in self.measures)

    def to_string(self, fmt: str = '{:.4f}') -> str:
        parts = []
        for key in self.measures:
            result = self.m_dict[key][0]()
            parts.append(','.join(fmt.format(x) for x in result)
                         if isinstance(result, tuple) else fmt.format(result))
        return ','.join(parts)
