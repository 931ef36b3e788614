"""Label-list discovery and FreeSurfer-order sorting: the port's own copy of
``synthsr_tpu/io/labels.py``.

Re-implements the behavior of ``ext/lab2im/utils.py:209-284``
(``get_list_labels``): collect the unique labels across a set of label maps
and, when ``FS_sort`` is on, order them neutral-first / left / right according
to the FreeSurfer label classification so that RandomFlip can swap sided
structures.  The numeric tables below are FreeSurfer LUT constants
(public anatomical label ids), not code.
"""

from __future__ import annotations

import numpy as np

from ..utils.misc import LoopInfo, list_images_in_folder, reformat_to_list
from .volume import load_volume

# FreeSurfer label ids that are not sided (utils.py:248-253 constants).
NEUTRAL_FS_LABELS = frozenset(
    [0, 14, 15, 16, 21, 22, 23, 24, 72, 77, 80, 85, 100, 101, 102, 103, 104, 105,
     106, 107, 108, 109, 165, 200, 201, 202, 203, 204, 205, 206, 207, 208, 209, 210,
     251, 252, 253, 254, 255, 258, 259, 260, 331, 332, 333, 334, 335, 336, 337, 338,
     339, 340, 502, 506, 507, 508, 509, 511, 512, 514, 515, 516, 517, 530, 531, 532,
     533, 534, 535, 536, 537]
)


def _is_left(la: int) -> bool:
    return ((0 < la < 14) or (16 < la < 21) or (24 < la < 40) or (135 < la < 139)
            or (1000 <= la <= 1035) or la == 865 or (20100 < la < 20110))


def _is_right(la: int) -> bool:
    return ((39 < la < 72) or (162 < la < 165) or (2000 <= la <= 2035)
            or (20000 < la < 20010) or la in (139, 866))


def get_list_labels(label_list=None, labels_dir=None, save_label_list=None,
                    FS_sort=False):
    """Read or compute the list of labels; optionally FreeSurfer-sort it.

    Returns ``(label_list, n_neutral_labels)`` when ``FS_sort`` else
    ``(label_list, None)`` — same contract as the reference (utils.py:209-284).
    """
    if label_list is not None:
        label_list = np.array(reformat_to_list(label_list, load_as_numpy=True, dtype="int"))
    elif labels_dir is not None:
        print("Compiling list of unique labels")
        paths = list_images_in_folder(labels_dir)
        label_list = np.empty(0, dtype=np.int64)
        loop_info = LoopInfo(len(paths), 10, "processing", print_time=True)
        for idx, path in enumerate(paths):
            loop_info.update(idx)
            y = load_volume(path, dtype="int32")
            label_list = np.unique(np.concatenate([label_list, np.unique(y).astype(np.int64)]))
        label_list = label_list.astype(int)
    else:
        raise ValueError("either label_list or labels_dir should be provided")

    n_neutral_labels = 0
    if FS_sort:
        neutral, left, right = [], [], []
        for la in label_list:
            la = int(la)
            if la in NEUTRAL_FS_LABELS:
                if la not in neutral:
                    neutral.append(la)
            elif _is_left(la):
                if la not in left:
                    left.append(la)
            elif _is_right(la):
                if la not in right:
                    right.append(la)
            else:
                raise ValueError(
                    f"label {la} not in our current FS classification, "
                    "please update get_list_labels")
        label_list = np.concatenate([sorted(neutral), sorted(left), sorted(right)])
        if (len(left) > 0) == (len(right) > 0):
            n_neutral_labels = len(neutral)
        else:
            n_neutral_labels = len(label_list)

    if save_label_list is not None:
        np.save(save_label_list, np.int32(label_list))

    if FS_sort:
        return np.int32(label_list), n_neutral_labels
    return np.int32(label_list), None
