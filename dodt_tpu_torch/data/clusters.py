"""Label size clustering (anchor sizes per class).

Parity target: reference label_cluster_utils.get_clusters:146 — KMeans
over (l, w, h) of all training labels per class, cached to a txt file.
Plain numpy Lloyd iterations (no sklearn dependency on the hot path).

Works over BOTH dataset families: paired/stacked tracking datasets
(`.couples`) and the single-frame detection dataset (`.sample_names`),
matching the reference where LabelClusterUtils serves KittiDataset and
KittiTrackingDataset alike.

The port's copy of dodt_tpu/data/clusters.py.
"""
from __future__ import annotations

import os
from typing import Iterator, Tuple

import numpy as np

# KITTI Car clusters from the reference's cached values are near these;
# used when no dataset is available (e.g. synthetic smoke tests).
DEFAULT_CAR_CLUSTERS = ((3.513, 1.581, 1.511), (4.234, 1.653, 1.546))

# Per-class (l, w, h) size priors for datasets with too few labels of a
# class to cluster (the reference KMeans would simply crash there;
# tiny fixtures need a deterministic fallback that is still the RIGHT
# size family — a Pedestrian config must never get Car-sized anchors).
# Values match the reference's published cluster caches / configs
# (label_cluster_utils.py:146 outputs for the KITTI training split).
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


def kmeans(points: np.ndarray, k: int, iters: int = 100,
           seed: int = 0) -> np.ndarray:
    rng = np.random.RandomState(seed)
    centers = points[rng.choice(len(points), k, replace=False)]
    for _ in range(iters):
        d = ((points[:, None] - centers[None]) ** 2).sum(-1)
        assign = d.argmin(1)
        new = np.stack([
            points[assign == j].mean(0) if np.any(assign == j)
            else centers[j] for j in range(k)])
        if np.allclose(new, centers, atol=1e-6):
            break
        centers = new
    order = np.argsort(centers.prod(axis=1))  # small to large volume
    return centers[order]


def iter_label_arrays(dataset) -> Iterator:
    """Yield each unique frame's LabelArray, for either dataset family:
    tracking datasets expose `.couples` + `.labels(vid, frame)`;
    the single-frame KittiDataset exposes `.sample_names` + dirs."""
    if not getattr(dataset, "has_labels", True):
        return
    if hasattr(dataset, "couples"):
        seen = set()
        for cp in dataset.couples:
            for frame in (cp.frame_a, cp.frame_b):
                key = (cp.video_id, frame)
                if key in seen:
                    continue
                seen.add(key)
                yield dataset.labels(cp.video_id, frame)
    elif hasattr(dataset, "sample_names"):
        from dodt_tpu_torch.data import kitti
        for name in dataset.sample_names:
            yield kitti.filter_labels(
                kitti.read_labels(dataset.label_dir, name),
                dataset.cfg.classes)
    else:
        raise TypeError(f"unsupported dataset type {type(dataset)}")


def compute_clusters(dataset, num_clusters: int, class_name: str
                     ) -> np.ndarray:
    """Gather (l, w, h) from all training labels and cluster. With
    fewer labels than clusters, fall back to the CLASS's size priors
    (never another class's)."""
    sizes = []
    for lab in iter_label_arrays(dataset):
        for i, t in enumerate(lab.types):
            if t == class_name:
                sizes.append(lab.box_3d[i, 3:6])
    sizes = np.asarray(sizes)
    if len(sizes) == 0:
        return size_priors(class_name, num_clusters)
    if len(sizes) < num_clusters:
        pad = size_priors(class_name, num_clusters)[len(sizes):]
        out = np.concatenate([sizes, pad])
        return out[np.argsort(out.prod(axis=1))]
    return kmeans(sizes, num_clusters)


def get_clusters(dataset, cfg, cache_dir: str | None = None
                 ) -> Tuple[Tuple[float, ...], ...]:
    """Clusters for every configured class, with txt caching like the
    reference (label_cluster_utils caches under data/label_clusters)."""
    out = []
    for cls, k in zip(cfg.dataset.classes, cfg.dataset.num_clusters):
        cache = None
        if cache_dir:
            cache = os.path.join(cache_dir,
                                 f"{cls}_{k}_clusters.txt")
            if os.path.exists(cache):
                arr = np.loadtxt(cache).reshape(-1, 3)
                out.extend(map(tuple, arr))
                continue
        arr = compute_clusters(dataset, k, cls)
        if cache:
            os.makedirs(cache_dir, exist_ok=True)
            np.savetxt(cache, arr)
        out.extend(map(tuple, arr))
    return tuple(out)
