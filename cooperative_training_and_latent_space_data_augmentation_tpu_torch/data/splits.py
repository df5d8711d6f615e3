"""Cross-validation split policies for ACDC and UKBB.

A copy of the JAX package's ``data/splits.py`` (the port imports nothing of
the JAX package) without scikit-learn, which the card's machine lacks: the
reference's patient-ID lists and sampling
(medseg/dataset_loader/ACDC_few_shot_cv_settings.py:10-210), the setting of
"Semi-Supervised and Task-Driven Data Augmentation" (arXiv:1902.05396).
Numeric identifiers (e.g. "10") subsample a fixed 40-patient pool as
``sklearn.train_test_split(random_state=cval)`` does; :func:`train_subset`
draws the same permutation with numpy, so the chosen patients are the
reference's.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
from numpy.random import RandomState

TEST_LIST = ["007", "008", "009", "010",
             "027", "028", "029", "030",
             "047", "048", "049", "050",
             "067", "068", "069", "070",
             "087", "088", "089", "090"]

UNLABELLED_LIST = [
    "016", "017", "018", "019", "020",
    "036", "037", "038", "039", "040",
    "056", "057", "058", "059", "060",
    "076", "077", "078", "079", "080",
    "096", "097", "098", "099", "100"]

LABELLED_POOL_40 = [
    "001", "002", "003", "004", "005", "006", "012", "013",
    "021", "022", "023", "024", "025", "026", "032", "033",
    "041", "042", "043", "044", "045", "046", "052", "053",
    "061", "062", "063", "064", "065", "066", "072", "073",
    "081", "082", "083", "084", "085", "086", "092", "093"]

STANDARD_TRAIN = [
    "001", "002", "003", "004", "006", "011", "012", "013", "014", "015",
    "016", "017", "018", "019", "021", "022", "024", "025", "026", "031",
    "032", "033", "034", "035", "036", "038", "039", "040", "041", "043",
    "044", "045", "051", "052", "053", "054", "055", "056", "057", "058",
    "059", "060", "061", "062", "063", "064", "065", "071", "072", "073",
    "074", "075", "076", "077", "079", "080", "081", "083", "084", "085",
    "086", "091", "092", "093", "094", "095", "096", "098", "099", "100"]

STANDARD_VALIDATE = ["005", "020", "023", "037", "042", "046", "066", "078",
                     "082", "097"]

_FEWSHOT_VALIDATION_SETS = {
    0: ["062", "095", "082"],
    1: ["002", "022", "095"],
    2: ["002", "062", "095"],
    3: ["022", "062", "095"],
    4: ["022", "062", "082"],
}

_ONE_SHOT_TRAIN = {
    0: ["002"], 1: ["042"], 2: ["022"], 3: ["062"], 4: ["095"],
}
_ONE_SHOT_APPEND_VAL = {
    0: ["042", "022", "062", "095"],
    1: ["002", "022", "062", "095"],
    2: ["002", "042", "062", "095"],
    3: ["002", "042", "022", "095"],
    4: ["002", "042", "022", "062"],
}
_THREE_SHOT_TRAIN = {
    0: ["002", "022", "042"],
    1: ["042", "062", "082"],
    2: ["022", "042", "082"],
    3: ["002", "042", "082"],
    4: ["002", "042", "095"],
}


def train_subset(ids: List[str], train_size, seed: int) -> List[str]:
    """The train part of scikit-learn's ``train_test_split(ids,
    train_size=train_size, random_state=seed)`` (shuffled, unstratified),
    in numpy: ``n_train`` is ``train_size`` for an int and
    ``floor(train_size * n)`` for a fraction, ``n_test = n - n_train``; the
    permutation ``RandomState(seed).permutation(n)`` gives its first
    ``n_test`` indices to the test part and the next ``n_train``, in that
    order, to the train part (``ShuffleSplit._iter_indices``)."""
    n = len(ids)
    n_train = int(np.floor(train_size * n)) if isinstance(train_size, float) else train_size
    if not 0 < n_train < n:
        raise ValueError(f"train_size {train_size} of {n} ids leaves an empty part")
    n_test = n - n_train
    perm = RandomState(seed).permutation(n)
    return [ids[i] for i in perm[n_test:n_test + n_train]]


def get_ACDC_split_policy(identifier, cval: int) -> Dict[str, List[str]]:
    """Split dict {name, train, validate, test, unlabelled, test+unlabelled}
    (ACDC_few_shot_cv_settings.get_ACDC_split_policy:10-159)."""
    assert 0 <= cval < 5, f"five-fold CV only, got {cval}"
    identifier = str(identifier)

    if identifier == "standard":
        return {
            "name": f"standard_cv_{cval}",
            "train": list(STANDARD_TRAIN),
            "validate": list(STANDARD_VALIDATE),
            "test": list(TEST_LIST),
            "unlabelled": [],
            "test+unlabelled": list(TEST_LIST),
        }

    validate_list = ["011", "071"] + list(_FEWSHOT_VALIDATION_SETS[cval])

    if "shot" not in identifier:
        value = float(identifier)
        labelled = list(LABELLED_POOL_40)
        if 0 < value < 1:
            labelled = train_subset(labelled, value, cval)
        elif value >= 1:
            n = int(value)
            if 0 < n < len(labelled):
                labelled = train_subset(labelled, n, cval)
            elif n != len(labelled):
                raise NotImplementedError(identifier)
        name = str(int(value)) if value >= 1 else str(value)
        return {
            "name": f"{name}_cv_{cval}",
            "train": labelled,
            "validate": validate_list,
            "test": list(TEST_LIST),
            "unlabelled": list(UNLABELLED_LIST),
            "test+unlabelled": list(TEST_LIST) + list(UNLABELLED_LIST),
        }

    if identifier in ("one_shot", "one_shot_upperbound"):
        labelled = list(_ONE_SHOT_TRAIN[cval])
        for sid in _ONE_SHOT_APPEND_VAL[cval]:
            if sid not in validate_list:
                validate_list.append(sid)
    elif identifier == "25_shot_upperbound":
        labelled = train_subset(list(LABELLED_POOL_40), 25, cval)
        labelled = labelled + list(UNLABELLED_LIST)
    elif identifier in ("three_shot", "three_shot_upperbound"):
        labelled = list(_THREE_SHOT_TRAIN[cval])
    else:
        raise NotImplementedError(identifier)

    if identifier in ("three_shot_upperbound", "one_shot_upperbound"):
        labelled = labelled + list(UNLABELLED_LIST)

    return {
        "name": f"{identifier}_cv_{cval}",
        "train": labelled,
        "validate": validate_list,
        "test": list(TEST_LIST),
        "unlabelled": list(UNLABELLED_LIST),
        "test+unlabelled": list(TEST_LIST) + list(UNLABELLED_LIST),
    }


def get_UKBB_split_policy(identifier: str, cval: int) -> Dict[str, List[str]]:
    """UKBB splits (ACDC_few_shot_cv_settings.get_UKBB_split_policy:162-210)."""
    id_list = np.arange(1, 501)
    train_list = id_list[: int(500 * 0.7)]
    unlabelled_list = train_list[150:]
    validate_ind = id_list[int(500 * 0.7):int(500 * 0.8)]
    test_ind = id_list[int(500 * 0.8):]
    validate_list = [f"{i:03d}" for i in validate_ind]
    test_list = [f"{i:03d}" for i in test_ind]
    labelled_pool = train_list[:150]
    prng = RandomState(cval)
    rand_index_list = prng.permutation(len(labelled_pool))
    n_by_id = {"15_shot": 15, "five_shot": 5, "three_shot": 3, "one_shot": 1,
               "full": len(rand_index_list)}
    if identifier not in n_by_id:
        raise NotImplementedError(identifier)
    # NOTE: formats permutation INDICES (0..149) as patient ids — exactly
    # what the reference does (cv_settings.py:188-199: '{:03d}'.format(id)
    # for id in rand_index_list), reproduced verbatim for split parity.
    labelled = [f"{i:03d}" for i in rand_index_list[: n_by_id[identifier]]]
    return {
        "name": f"{identifier}_cv_{cval}",
        "train": labelled,
        "validate": validate_list,
        "test": test_list,
        "unlabelled": [f"{i:03d}" for i in unlabelled_list],
    }
