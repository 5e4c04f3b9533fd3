"""The port's last device ops and profiling helpers against the JAX
package's, from the same seeded numpy inputs on the CPU: the rotated and
3D IoU matrices and their helpers (tests/test_iou.py's cases plus seeded
random boxes), the 3D integral image and its query (test_voxel.py's case
plus random boxes), point projection, the area mask, the BEV-border
offsets (the JAX package's numpy module), the metric-to-BEV-pixel map
and the metrics helpers.

Tolerances: IoU 2e-6 absolute (float32 trigonometry and shoelace sums in
both; IoU lies in [0, 1]); areas 1e-5 relative + 1e-6 absolute; integral
sums of integer counts and the masks and border offsets exact; projected
pixels 1e-5 relative; BEV pixels exact (the same float32 arithmetic)."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dodt_tpu.ops import anchors as janchors
from dodt_tpu.ops import iou as jiou
from dodt_tpu.ops import label_offset as jlabel
from dodt_tpu.ops import projection as jproj
from dodt_tpu.ops import voxel as jvoxel
from dodt_tpu.ops import warp as jwarp
from dodt_tpu.utils import metrics as jmetrics
from dodt_tpu_torch.ops import (anchors, iou, label_offset, projection,
                                 voxel, warp)
from dodt_tpu_torch.utils import metrics


def _bev_boxes(rng, n):
    return np.stack([rng.uniform(-2, 2, n), rng.uniform(-2, 2, n),
                     rng.uniform(1, 5, n), rng.uniform(1, 3, n),
                     rng.uniform(-np.pi, np.pi, n)], axis=1).astype(np.float32)


def _boxes_3d(rng, n):
    bev = _bev_boxes(rng, n)
    return np.stack([bev[:, 0], rng.uniform(0.5, 2.0, n), bev[:, 1],
                     bev[:, 2], bev[:, 3], rng.uniform(1.0, 2.0, n),
                     bev[:, 4]], axis=1).astype(np.float32)


# tests/test_iou.py's pairs, and seeded random sets
BEV_CASES = {
    "identical": ([[1.0, 2.0, 4.0, 2.0, 0.7]], [[1.0, 2.0, 4.0, 2.0, 0.7]]),
    "disjoint": ([[0.0, 0.0, 2.0, 2.0, 0.3]], [[10.0, 10.0, 2.0, 2.0, 1.0]]),
    "axis_aligned": ([[0.0, 0.0, 4.0, 2.0, 0.0]], [[1.0, 0.5, 4.0, 2.0, 0.0]]),
    "cross_45": ([[0.0, 0.0, 2.0, 2.0, 0.0]],
                 [[0.0, 0.0, 2.0, 2.0, np.pi / 4]]),
    "random": (_bev_boxes(np.random.RandomState(3), 12),
               _bev_boxes(np.random.RandomState(4), 9)),
}
BOX3D_CASES = {
    "stacked": ([[0.0, 1.0, 10.0, 4.0, 2.0, 2.0, 0.3]],
                [[0.0, 0.0, 10.0, 4.0, 2.0, 2.0, 0.3]]),
    "identical": ([[1.0, 1.5, 20.0, 3.9, 1.6, 1.5, -0.4]],
                  [[1.0, 1.5, 20.0, 3.9, 1.6, 1.5, -0.4]]),
    "random": (_boxes_3d(np.random.RandomState(5), 10),
               _boxes_3d(np.random.RandomState(6), 7)),
}


def _pair(case):
    a, b = (np.asarray(x, np.float32) for x in case)
    return a, b


@pytest.mark.parametrize("case", sorted(BEV_CASES))
def test_rotated_iou_matrix_matches_jax(case):
    a, b = _pair(BEV_CASES[case])
    want = np.asarray(jiou.rotated_iou_matrix(jnp.asarray(a),
                                              jnp.asarray(b)))
    got = iou.rotated_iou_matrix(torch.from_numpy(a),
                                 torch.from_numpy(b)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)


@pytest.mark.parametrize("case", sorted(BOX3D_CASES))
def test_iou_3d_matrix_matches_jax(case):
    a, b = _pair(BOX3D_CASES[case])
    want = np.asarray(jiou.iou_3d_matrix(jnp.asarray(a), jnp.asarray(b)))
    got = iou.iou_3d_matrix(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)
    if case == "stacked":
        np.testing.assert_allclose(got[0, 0], 8.0 / 24.0, rtol=1e-4)


def test_rect_helpers_match_jax_per_pair():
    """Each helper, batched over pairs in the port, against the JAX
    helper on one pair: corners, point-in-quad, the 16 edge
    intersections, the polygon area and the intersection area."""
    a = _bev_boxes(np.random.RandomState(7), 6)
    b = np.concatenate([a[:2], _bev_boxes(np.random.RandomState(8), 4)])
    b[0, 4] += np.pi / 4
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    qa, qb = iou._rect_corners_xz(ta), iou._rect_corners_xz(tb)
    in_b = iou._point_in_quad(qa, qb)
    pts, valid = iou._edge_intersections(qa, qb)
    cand = torch.cat([qa, qb, pts], dim=-2)
    mask = torch.cat([in_b, iou._point_in_quad(qb, qa), valid], dim=-1)
    area = iou._polygon_area(cand, mask)
    inter = iou._rect_intersection_area(ta, tb)
    for i in range(len(a)):
        ja, jb = jnp.asarray(a[i]), jnp.asarray(b[i])
        jqa, jqb = jiou._rect_corners_xz(ja), jiou._rect_corners_xz(jb)
        np.testing.assert_allclose(qa[i].numpy(), np.asarray(jqa),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(
            in_b[i].numpy(), np.asarray(jiou._point_in_quad(jqa, jqb)))
        jpts, jvalid = jiou._edge_intersections(jqa, jqb)
        np.testing.assert_array_equal(valid[i].numpy(), np.asarray(jvalid))
        v = np.asarray(jvalid)
        np.testing.assert_allclose(pts[i].numpy()[v], np.asarray(jpts)[v],
                                   rtol=1e-5, atol=1e-5)
        jarea = jiou._polygon_area(jnp.asarray(cand[i].numpy()),
                                   jnp.asarray(mask[i].numpy()))
        np.testing.assert_allclose(area[i].item(), float(jarea),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(
            inter[i].item(), float(jiou._rect_intersection_area(ja, jb)),
            rtol=1e-5, atol=1e-6)
    assert (inter > 0).sum() >= 2          # overlapping pairs are covered


@pytest.mark.parametrize("seed", [9, 10])
def test_integral_image_3d_and_query_match_jax(seed):
    rng = np.random.RandomState(seed)
    grid = rng.randint(0, 3, (10, 8, 12)).astype(np.float32)
    lo = np.stack([rng.randint(0, s // 2, 5) for s in grid.shape], 1)
    hi = np.stack([rng.randint(s // 2, s + 1, 5) for s in grid.shape], 1)
    lo, hi = np.concatenate([[[2, 1, 3], [0, 0, 0]], lo]), \
        np.concatenate([[[7, 5, 9], [10, 8, 12]], hi])
    want_int = np.asarray(janchors.integral_image_3d(jnp.asarray(grid)))
    got_int = anchors.integral_image_3d(torch.from_numpy(grid))
    np.testing.assert_array_equal(got_int.numpy(), want_int)
    want = np.asarray(janchors.query_integral_3d(
        jnp.asarray(want_int), jnp.asarray(lo), jnp.asarray(hi)))
    got = anchors.query_integral_3d(got_int, torch.from_numpy(lo),
                                    torch.from_numpy(hi)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[0], grid[2:7, 1:5, 3:9].sum())
    np.testing.assert_array_equal(got[1], grid.sum())


def test_project_points_to_image_matches_jax():
    rng = np.random.RandomState(11)
    pts = np.stack([rng.uniform(-20, 20, (4, 50)), rng.uniform(-2, 2, (4, 50)),
                    rng.uniform(5, 60, (4, 50))], -1).astype(np.float32)
    p2 = np.array([[721.5, 0, 609.5, 44.9], [0, 721.5, 172.8, 0.2],
                   [0, 0, 1.0, 0.003]], np.float32)
    want = np.asarray(jproj.project_points_to_image(jnp.asarray(pts), p2))
    got = projection.project_points_to_image(torch.from_numpy(pts), p2)
    assert got.shape == (4, 50, 2)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("offset_dist", [2.0, 0.5])
def test_points_in_area_mask_matches_jax(offset_dist):
    rng = np.random.RandomState(12)
    ae = ((-4.0, 4.0), (-5.0, 3.0), (0.0, 7.0))
    pts = np.stack([rng.uniform(-6, 6, 500), rng.uniform(-6, 4, 500),
                    rng.uniform(-1, 8, 500)], 1).astype(np.float32)
    pts[:3] = [[-4.0, 0.0, 1.0], [0.0, 3.0, 1.0], [1.0, 1.0, 7.0]]  # borders
    valid = rng.rand(500) < 0.9
    gp = np.array([0.0, -1.0, 0.05, 1.65], np.float32)
    want = np.asarray(jvoxel.points_in_area_mask(
        jnp.asarray(pts), jnp.asarray(valid), gp, ae, offset_dist))
    got = voxel.points_in_area_mask(torch.from_numpy(pts),
                                    torch.from_numpy(valid), gp, ae,
                                    offset_dist).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < valid.sum()


BEV = ((-4.0, 4.0), (0.0, 7.0))


@pytest.mark.parametrize("seed", range(4))
def test_border_offset_matches_jax(seed):
    """ray_to_border and border_offset against the JAX package's numpy
    module: boxes moving inside, out through each side and a corner, and
    standing still."""
    rng = np.random.RandomState(seed)
    a = np.zeros(7)
    a[[0, 2]] = rng.uniform([-3.5, 0.5], [3.5, 6.5])
    targets = [a[[0, 2]], a[[0, 2]] + rng.uniform(-0.5, 0.5, 2),
               [-9.0, 3.0], [9.0, 3.0], [0.0, -5.0], [0.0, 12.0],
               [10.0, 10.0]]
    for t in targets:
        b = a.copy()
        b[[0, 2]] = t
        np.testing.assert_array_equal(label_offset.border_offset(a, b, BEV),
                                      jlabel.border_offset(a, b, BEV))
        v = np.asarray(t, np.float64) - a[[0, 2]]
        np.testing.assert_array_equal(
            label_offset.ray_to_border(a[[0, 2]], v, BEV),
            jlabel.ray_to_border(a[[0, 2]], v, BEV))


def test_metrics_helpers_match_jax(tmp_path):
    """device_sync returns once a nested tree is ready (CPU tensors here;
    the card's path is chip_smoke.py phase 18), and profile_trace writes a
    chrome trace."""
    tree = {"a": [torch.ones(3), (torch.zeros(2),)], "b": torch.ones(1)}
    assert metrics.device_sync(tree) is None
    assert jmetrics.device_sync({"a": jnp.ones(3)}) is None
    with metrics.profile_trace(str(tmp_path / "trace")):
        (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    assert os.path.getsize(tmp_path / "trace" / "trace.json") > 0
    with metrics.profile_trace(str(tmp_path / "off"), enabled=False):
        pass
    assert not (tmp_path / "off").exists()


# tests/test_warp.py's extents on its 32 x 32 map, and a non-square map
# over the BEV area above
@pytest.mark.parametrize("ext,h,w", [
    (((-8.0, 8.0), (0.0, 16.0)), 32, 32),
    (((-40.0, 40.0), (0.0, 70.0)), 350, 400)])
def test_bev_pixel_from_xz_matches_jax(ext, h, w):
    """Metric (x, z) -> (row, col) on tensors and on floats, against
    JAX's on the same float32 numbers: the map's corners and centre go
    to the half-pixel edges and centre, and seeded points inside and
    outside the map agree with JAX."""
    rng = np.random.RandomState(8)
    ae = np.asarray(ext, np.float32)
    (x0, x1), (z0, z1) = ext
    x = rng.uniform(x0 - 3, x1 + 3, 50).astype(np.float32)
    z = rng.uniform(z0 - 3, z1 + 3, 50).astype(np.float32)
    got = warp.bev_pixel_from_xz(torch.as_tensor(x), torch.as_tensor(z), ae,
                                 h, w)
    want = jwarp.bev_pixel_from_xz(jnp.asarray(x), jnp.asarray(z), ae, h, w)
    for g, j in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(j))
    for xs, zs, rc in ((x0, z1, (-0.5, -0.5)), (x1, z0, (h - 0.5, w - 0.5)),
                       ((x0 + x1) / 2, (z0 + z1) / 2,
                        ((h - 1) / 2, (w - 1) / 2))):
        got_f = warp.bev_pixel_from_xz(xs, zs, ext, h, w)
        assert got_f == pytest.approx(rc, abs=1e-9)
        assert got_f == pytest.approx(jwarp.bev_pixel_from_xz(xs, zs, ext,
                                                              h, w), abs=1e-9)
