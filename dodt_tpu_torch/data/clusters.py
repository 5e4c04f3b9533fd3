"""Anchor size clusters (the port's copy of the size tables in
dodt_tpu/data/clusters.py; the dataset-scanning k-means is not copied:
the port takes its clusters as an argument).
"""
from __future__ import annotations

import numpy as np

# KITTI Car clusters from the reference's cached values are near these;
# used when no dataset is available (e.g. synthetic smoke tests).
DEFAULT_CAR_CLUSTERS = ((3.513, 1.581, 1.511), (4.234, 1.653, 1.546))

# Per-class (l, w, h) size priors for datasets with too few labels of a
# class to cluster (the reference's published cluster caches / configs,
# label_cluster_utils.py:146 outputs for the KITTI training split).
SIZE_PRIORS = {
    "Car": DEFAULT_CAR_CLUSTERS,
    "Van": ((4.73, 1.90, 2.11),),
    "Truck": ((10.0, 2.58, 3.25),),
    "Pedestrian": ((0.825, 0.657, 1.746),),
    "Person_sitting": ((0.80, 0.60, 1.29),),
    "Cyclist": ((1.771, 0.570, 1.723),),
    "Tram": ((16.2, 2.61, 3.53),),
}


def size_priors(class_name: str, k: int) -> np.ndarray:
    """(k, 3) prior sizes for a class; pads by repeating the largest."""
    base = SIZE_PRIORS.get(class_name, DEFAULT_CAR_CLUSTERS)
    rows = [base[min(i, len(base) - 1)] for i in range(k)]
    return np.asarray(rows, np.float64)
