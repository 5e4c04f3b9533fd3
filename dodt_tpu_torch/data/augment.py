"""Training augmentations (host-side numpy).

Parity: reference avod/datasets/kitti/kitti_aug.py (flipping + PCA
color jitter).

The port's copy of dodt_tpu/data/augment.py.
"""
from __future__ import annotations

import numpy as np

AUG_FLIPPING = "flipping"
AUG_PCA_JITTER = "pca_jitter"


def flip_image(image: np.ndarray) -> np.ndarray:
    return np.fliplr(image)


def flip_points(points: np.ndarray) -> np.ndarray:
    """(N, 3) camera-frame points: negate x."""
    out = np.copy(points)
    out[:, 0] = -points[:, 0]
    return out


def flip_boxes_3d(boxes_3d: np.ndarray, flip_ry: bool = True) -> np.ndarray:
    """box_3d (N, >=7): negate x; ry -> pi - ry (or -pi - ry below zero)."""
    out = np.copy(boxes_3d)
    if flip_ry and len(boxes_3d):
        above = boxes_3d[:, 6] >= 0
        out[above, 6] = np.pi - boxes_3d[above, 6]
        out[~above, 6] = -np.pi - boxes_3d[~above, 6]
    if len(boxes_3d):
        out[:, 0] = -boxes_3d[:, 0]
    return out


def flip_ground_plane(plane: np.ndarray) -> np.ndarray:
    out = np.copy(plane)
    out[0] = -plane[0]
    return out


def flip_calib_p2(p2: np.ndarray, image_shape) -> np.ndarray:
    out = np.copy(p2)
    out[0, 2] = image_shape[1] - p2[0, 2]
    out[0, 3] = -p2[0, 3]
    return out


def pca_jitter(image: np.ndarray, rng: np.random.RandomState,
               sigma: float = 0.1) -> np.ndarray:
    """PCA color jitter over one image (reference apply_pca_jitter
    computes per-image PCA on normalized pixels, perturbs along the
    principal axes with N(0, 0.1) weights, clips to [0, 1])."""
    img = image.astype(np.float32)
    if img.max() > 1.5:
        img = img / 255.0
    flat = img.reshape(-1, 3)
    cov = np.cov(flat, rowvar=False)
    eigval, eigvec = np.linalg.eigh(cov)
    alpha = rng.normal(0.0, sigma, 3)
    delta = eigvec @ (alpha * eigval)
    out = np.clip(flat + delta, 0.0, 1.0).reshape(img.shape)
    if image.dtype == np.uint8:
        return (out * 255.0).astype(np.uint8)
    return out
