"""The port's blur form of B3 (``corr_bottleneck_blur``) and B3's backward
(``corr_bottleneck_vjp``) against the JAX package, from the same seeded
numpy inputs on the CPU.

The blur is the form the JAX model computes (``corr_bottleneck`` without
``use_pallas``); ``corr_bottleneck_xla`` is the form the JAX custom_vjp
differentiates. Tolerances: f32 1e-5 against JAX's blur (one depthwise
conv and one reduce in both, sums in another order) and 1e-4 against
``corr_bottleneck_xla`` (the bound tests/test_ops.py holds between the
two JAX forms); bf16 2e-2 of the output's range (the blur and the
output are rounded to bf16 in both, a few ulps apart); gradients 1e-4 of
the largest gradient (the bound tests/test_torch_kernels.py holds the
twin's gradients to).

Where max_displacement % stride_2 != 0 JAX's blur pads
max_displacement before the map, so its displacement grid sits
max_displacement - r * stride_2 pixels off the correlation's (ROADMAP
C20); the port keeps the correlation's grid, which JAX's blur has at
max_displacement = r * stride_2 (the same r, D and displacements). The
asymmetric case (5, 2) is held against JAX's blur there and against
``corr_bottleneck_xla`` at (5, 2), and JAX's blur at (5, 2) is pinned
as off the grid. The ``_CorrBottleneck`` route's wiring (its backward
goes through ``corr_bottleneck_vjp``) is held in
tests/test_torch_kernels.py, beside the twin's autograd and jax.vjp.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dodt_tpu.ops import correlation as jcorr
from dodt_tpu_torch.ops import correlation as tcorr

GRIDS = [(2, 1), (4, 2), (5, 2)]       # (max_displacement, stride_2)


def _on_grid(md, s2):
    """The max_displacement at which JAX's blur has the correlation's
    displacement grid for (md, s2)."""
    radius, _ = jcorr._disp_grid(md, s2)
    return radius * s2


def _inputs(seed, md, s2, cb, batched, c=8):
    rng = np.random.RandomState(seed)
    shape = (2, 11, 13, c) if batched else (11, 13, c)
    _, d = jcorr._disp_grid(md, s2)
    a = rng.randn(*shape).astype(np.float32)
    b = rng.randn(*shape).astype(np.float32)
    w = (rng.randn(d * d, cb) / d).astype(np.float32)
    return a, b, w


def _jax_fn(form, md, s2, batched):
    """A JAX form as fn(a, b, w), vmapped over a batch."""
    def fn(a, b, w):
        return form(a, b, w, md, s2)
    if batched:
        return jax.vmap(fn, in_axes=(0, 0, None))
    return fn


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("cb", [1, 3])
@pytest.mark.parametrize("md,s2", GRIDS)
def test_blur_forward_matches_jax(md, s2, cb, batched, dtype):
    a, b, w = _inputs(1, md, s2, cb, batched)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    got = tcorr.corr_bottleneck_blur(
        torch.from_numpy(a).to(tdt), torch.from_numpy(b).to(tdt),
        torch.from_numpy(w), md, s2)
    assert got.dtype == tdt
    assert tuple(got.shape) == (((2,) if batched else ()) + (cb, 11, 13))
    ja, jb, jw = jnp.asarray(a, jdt), jnp.asarray(b, jdt), jnp.asarray(w)
    blur = np.asarray(_jax_fn(jcorr.corr_bottleneck_blur, _on_grid(md, s2),
                              s2, batched)(ja, jb, jw), np.float32)
    got = got.float().numpy()
    if dtype == "bfloat16":
        assert np.abs(got - blur).max() <= 2e-2 * np.abs(blur).max()
        return
    np.testing.assert_allclose(got, blur, rtol=1e-5, atol=1e-5)
    xla = np.asarray(_jax_fn(jcorr.corr_bottleneck_xla, md, s2, batched)(
        ja, jb, jw))
    np.testing.assert_allclose(got, xla, rtol=1e-4, atol=1e-4)
    if md != _on_grid(md, s2):
        off = np.asarray(_jax_fn(jcorr.corr_bottleneck_blur, md, s2,
                                 batched)(ja, jb, jw))
        assert np.abs(off - xla).max() > 0.1 * np.abs(xla).max()


def test_blur_has_no_kernel_flip():
    """One weight at displacement (dy, dx) = (-1, +2) with stride_2 1:
    out[y, x] = (1 / C) sum_c a[y, x, c] b[y - 1, x + 2, c] (a
    cross-correlation, as the kernels' and JAX's)."""
    md, c = 2, 4
    rng = np.random.RandomState(3)
    a = rng.randn(9, 10, c).astype(np.float32)
    b = rng.randn(9, 10, c).astype(np.float32)
    w = np.zeros((25, 1), np.float32)
    w[(-1 + 2) * 5 + (2 + 2), 0] = 1.0
    got = tcorr.corr_bottleneck_blur(torch.from_numpy(a), torch.from_numpy(b),
                                     torch.from_numpy(w), md)[0].numpy()
    b_shift = np.zeros_like(b)
    b_shift[1:, :-2] = b[:-1, 2:]
    np.testing.assert_allclose(got, (a * b_shift).sum(-1) / c, rtol=1e-6,
                               atol=1e-6)


def _jax_grads(form, md, s2, batched, a, b, w, cot):
    _, vjp = jax.vjp(_jax_fn(form, md, s2, batched), jnp.asarray(a),
                     jnp.asarray(b), jnp.asarray(w))
    return [np.asarray(g) for g in vjp(jnp.asarray(cot))]


def _hold_grads(got, want):
    for g, ref in zip(got, want):
        g = g.numpy() if isinstance(g, torch.Tensor) else g
        assert g.shape == ref.shape
        assert np.abs(g - ref).max() <= 1e-4 * np.abs(ref).max()


@pytest.mark.parametrize("md,s2,cb,batched", [
    (2, 1, 1, False), (4, 2, 3, True), (5, 2, 3, True)])
def test_vjp_matches_jax(md, s2, cb, batched):
    """corr_bottleneck_vjp against jax.vjp of JAX's blur (on the grid) and
    of corr_bottleneck_xla, for a, b and the weights."""
    a, b, w = _inputs(2, md, s2, cb, batched)
    cot = np.random.RandomState(9).randn(
        *(((2,) if batched else ()) + (cb, 11, 13))).astype(np.float32)
    got = tcorr.corr_bottleneck_vjp(
        *(torch.from_numpy(t) for t in (a, b, w, cot)), md, s2)
    _hold_grads(got, _jax_grads(jcorr.corr_bottleneck_blur,
                                _on_grid(md, s2), s2, batched, a, b, w, cot))
    _hold_grads(got, _jax_grads(jcorr.corr_bottleneck_xla, md, s2, batched,
                                a, b, w, cot))
