"""The port's BEV rasterization and anchor-occupancy quotients against
jitted JAX on points placed exactly on cell and slice edges, in a jitted
forward and in a jitted ``value_and_grad`` program as the train step
builds it (the same forms, ROADMAP C24).

Jitted XLA divides by a constant as a multiply by the constant's f32
reciprocal: ``(x + 40) / 0.1`` is ``(x + 40) * 10``, which differs from
the true quotient for some edges, and a floor then puts the point in the
neighbouring cell (ROADMAP C22). The port multiplies by the same
reciprocal, so its maps are bit-equal to the JAX model's. Every point
below lies on an edge (the f32 nearest to it): each 0.1 m x edge of a
strip at fixed z, each z edge of a strip at fixed x, each at every
height-slice edge of the ground plane and between them. On a tilted
ground plane XLA contracts the plane offset's multiply-adds into FMAs,
as the port's ``plane_offset`` does.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dodt_tpu import config as cfg_mod
from dodt_tpu.ops import anchors as janchors
from dodt_tpu.ops import voxel as jvoxel
from chip_smoke import EDGE_PLANE as PLANE
from chip_smoke import voxel_edge_points
from dodt_tpu_torch.ops import anchors as tanchors
from dodt_tpu_torch.ops import voxel as tvoxel

KU = cfg_mod.cars_dt_tracking().dataset.kitti_utils
TILTED = np.float32([-0.0077, -0.9999, 0.0116, 1.6512])
BG = KU.bev_generator
AREA = np.asarray(KU.area_extents, np.float32)
VS = KU.voxel_size


def _edges(lo, hi, step):
    """The f32 nearest to each edge strictly inside (lo, hi)."""
    n = int(round((hi - lo) / step))
    return np.float32(lo + step * np.arange(1, n, dtype=np.float64))


def edge_points():
    """chip_smoke.py's edge points (phase 20 holds the card to the CPU on
    them): every x edge at z = 35.05 and every z edge at x = 0.05, each
    at the slice edges' heights and at their middles."""
    return voxel_edge_points(KU)


@functools.lru_cache(maxsize=None)
def _jax_rasterize():
    return jax.jit(functools.partial(
        jvoxel.bev_maps_from_points, area_extents=AREA, voxel_size=VS,
        height_lo=BG.height_lo, height_hi=BG.height_hi,
        num_slices=BG.num_slices))


def test_edge_points_include_quotients_xla_rounds_differently():
    """The edges exercise the fault: for some of them the floor of the
    true quotient (numpy's, the CPU's) is not that of XLA's multiply."""
    pts = edge_points()
    for axis in (0, 2):
        v = pts[:, axis] - AREA[axis, 0]
        true_q = np.floor(v / np.float32(VS))
        xla_q = np.floor(v * (np.float32(1.0) / np.float32(VS)))
        assert (true_q != xla_q).sum() > 0, axis


@pytest.mark.parametrize("shift", [0.0, 1e-3])
def test_bev_maps_on_cell_and_slice_edges_match_jitted_jax(shift):
    """Features (height slices and density) and occupancy bit-equal to
    jitted JAX ``bev_maps_from_points``, on the edges and 1 mm past
    them, every point valid and in the band."""
    pts = edge_points() + np.float32(shift)
    valid = np.ones(len(pts), bool)
    want = _jax_rasterize()(jnp.asarray(pts), jnp.asarray(valid),
                            jnp.asarray(PLANE))
    got = tvoxel.bev_maps_from_points(
        torch.from_numpy(pts), torch.from_numpy(valid),
        torch.from_numpy(PLANE), KU.area_extents, VS, BG.height_lo,
        BG.height_hi, BG.num_slices)
    occ = np.asarray(want.occupancy)
    assert occ.sum() > 1000
    np.testing.assert_array_equal(got.occupancy.numpy(), occ)
    np.testing.assert_array_equal(got.features.numpy(),
                                  np.asarray(want.features))


def test_anchor_occupancy_on_cell_edges_matches_jitted_jax():
    """``bev_occupancy_counts`` (the per-anchor empty-anchor filter) on
    anchors whose footprint corners lie on cell edges, over a seeded
    occupancy grid: counts equal to jitted JAX's."""
    rs = np.random.RandomState(3)
    nx, nz = 800, 700
    occ = (rs.rand(nx, nz) < 0.3).astype(np.float32)
    ext = np.asarray(KU.bev_extents, np.float32)
    half = np.float32([0.8, 1.95, 0.3])
    xs = _edges(ext[0, 0] + 2.0, ext[0, 1] - 2.0, VS)
    zs = _edges(ext[1, 0] + 2.0, ext[1, 1] - 2.0, VS)
    n = 4000
    anchors = np.zeros((n, 6), np.float32)
    hx, hz = half[rs.randint(0, 3, n)], half[rs.randint(0, 3, n)]
    anchors[:, 0] = xs[rs.randint(0, len(xs), n)] + hx
    anchors[:, 2] = zs[rs.randint(0, len(zs), n)] + hz
    anchors[:, 3], anchors[:, 4], anchors[:, 5] = 2 * hx, 1.5, 2 * hz
    want = jax.jit(lambda ii, a: janchors.bev_occupancy_counts(
        ii, a, ext, VS))(janchors.integral_image_2d(jnp.asarray(occ)),
                         jnp.asarray(anchors))
    got = tanchors.bev_occupancy_counts(
        tanchors.integral_image_2d(torch.from_numpy(occ)),
        torch.from_numpy(anchors), ext, VS)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@functools.lru_cache(maxsize=None)
def _jax_train_rasterize():
    """A jitted value_and_grad program that rasterizes as the model's
    train step does: vmapped over (batch, frame), the points passed in,
    the maps feeding a loss differentiated with respect to a weight."""
    rasterize = functools.partial(
        jvoxel.bev_maps_from_points, area_extents=AREA, voxel_size=VS,
        height_lo=BG.height_lo, height_hi=BG.height_hi,
        num_slices=BG.num_slices)

    def loss(w, pts, valid, gp):
        maps = jax.vmap(jax.vmap(rasterize))(pts, valid, gp)
        return jnp.sum(maps.features * w), maps
    return jax.jit(jax.value_and_grad(loss, has_aux=True))


@pytest.mark.parametrize("plane", ["flat", "tilted"])
@pytest.mark.parametrize("shift", [0.0, 1e-3])
def test_bev_maps_on_edges_match_the_jax_train_program(shift, plane):
    """Features and occupancy bit-equal to the train-step form of JAX's
    rasterization on the edges and 1 mm past them, on the edges' plane
    and on a tilted one."""
    pts = edge_points() + np.float32(shift)
    valid = np.ones(len(pts), bool)
    gp = PLANE if plane == "flat" else TILTED
    w = np.ones((1, 1, 700, 800, BG.num_slices + 1), np.float32)
    (_, maps), _ = _jax_train_rasterize()(w, pts[None, None],
                                           valid[None, None], gp[None, None])
    got = tvoxel.bev_maps_from_points(
        torch.from_numpy(pts), torch.from_numpy(valid), torch.from_numpy(gp),
        KU.area_extents, VS, BG.height_lo, BG.height_hi, BG.num_slices)
    assert np.asarray(maps.occupancy).sum() > 1000
    np.testing.assert_array_equal(got.occupancy.numpy(),
                                  np.asarray(maps.occupancy)[0, 0])
    np.testing.assert_array_equal(got.features.numpy(),
                                  np.asarray(maps.features)[0, 0])


def test_bev_maps_on_a_tilted_plane_match_jitted_jax():
    """bench-like random points over a tilted plane: the heights and
    slices of the FMA-contracted plane offset, bit for bit."""
    rs = np.random.RandomState(4)
    n = 65536
    pts = np.stack([rs.uniform(-40, 40, n), rs.uniform(-2.0, 2.5, n),
                    rs.uniform(0, 70, n)], -1).astype(np.float32)
    valid = rs.rand(n) < 0.95
    want = _jax_rasterize()(jnp.asarray(pts), jnp.asarray(valid),
                            jnp.asarray(TILTED))
    got = tvoxel.bev_maps_from_points(
        torch.from_numpy(pts), torch.from_numpy(valid),
        torch.from_numpy(TILTED), KU.area_extents, VS, BG.height_lo,
        BG.height_hi, BG.num_slices)
    np.testing.assert_array_equal(got.occupancy.numpy(),
                                  np.asarray(want.occupancy))
    np.testing.assert_array_equal(got.features.numpy(),
                                  np.asarray(want.features))


def test_density_table_matches_jitted_jax():
    """Cells of 1 to 40 points: the density table against jitted JAX's
    min(1, log(n + 1) / log 16)."""
    counts = np.arange(1, 41)
    cells = np.repeat(np.arange(40), counts)
    pts = np.stack([np.float32(-39.95 + 0.2 * cells),
                    np.full(len(cells), 1.0, np.float32),
                    np.full(len(cells), 10.05, np.float32)], -1)
    valid = np.ones(len(pts), bool)
    want = np.asarray(_jax_rasterize()(jnp.asarray(pts), jnp.asarray(valid),
                                       jnp.asarray(PLANE)).features)[..., -1]
    got = tvoxel.bev_maps_from_points(
        torch.from_numpy(pts), torch.from_numpy(valid),
        torch.from_numpy(PLANE), KU.area_extents, VS, BG.height_lo,
        BG.height_hi, BG.num_slices).features.numpy()[..., -1]
    assert sorted(np.unique(want[want > 0]))[:3] == sorted(
        tvoxel.DENSITY[1:4])
    assert (want == 1.0).sum() == 26           # 15 or more points
    np.testing.assert_array_equal(got, want)
