"""The port's correlation + bottleneck forms against their JAX namesakes,
from the same seeded numpy inputs on the CPU, forward and VJP:

  port                               JAX
  corr_bottleneck (the model's)      corr_bottleneck (no use_pallas)
  corr_bottleneck_blur               corr_bottleneck_blur
  corr_bottleneck_vjp (B3's backward) jax.vjp of corr_bottleneck_blur
  corr_bottleneck_plain, origin 0    corr_bottleneck_xla

at (max_displacement, stride_2) = (2, 1), (4, 2), (5, 2) and (3, 2).
Where max_displacement % stride_2 != 0 the two grids part: JAX's blur
(and so the JAX model) pads max_displacement before the map, so it reads
B grid_origin = max_displacement - r * stride_2 pixels up and left of
the correlation's grid, which corr_bottleneck_xla keeps. Each port form
equals its namesake there, and the two grids are pinned apart (ROADMAP
C20, fixed). Tolerances: f32 1e-5 of the output's range between the
same algorithm's two implementations (one depthwise conv and one reduce
in both; or one loop over the displacements against a scan) and 1e-4
between the blur and the displacement loop (the bound tests/test_ops.py
holds between the two JAX forms); bf16 2e-2 of the output's range (the
blur and the output are rounded to bf16 in both, a few ulps apart);
gradients 1e-4 of the largest gradient (the bound
tests/test_torch_kernels.py holds the twin's gradients to). The
``_CorrBottleneck`` route's wiring (its backward goes through
``corr_bottleneck_vjp`` at the forward's grid) is held in
tests/test_torch_kernels.py, beside the twin's autograd and jax.vjp.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dodt_tpu.ops import correlation as jcorr
from dodt_tpu_torch.ops import correlation as tcorr

GRIDS = [(2, 1), (4, 2), (5, 2), (3, 2)]  # (max_displacement, stride_2)


def _off_grid(md, s2):
    return tcorr.grid_origin(md, s2) != 0


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
    """The blur against JAX's blur at the given max_displacement (its own
    grid); where the grids agree, also against corr_bottleneck_xla, and
    where they part, pinned off corr_bottleneck_xla."""
    a, b, w = _inputs(1, md, s2, cb, batched)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    got = tcorr.corr_bottleneck_blur(
        torch.from_numpy(a).to(tdt), torch.from_numpy(b).to(tdt),
        torch.from_numpy(w), md, s2)
    assert got.dtype == tdt
    assert tuple(got.shape) == (((2,) if batched else ()) + (cb, 11, 13))
    ja, jb, jw = jnp.asarray(a, jdt), jnp.asarray(b, jdt), jnp.asarray(w)
    blur = np.asarray(_jax_fn(jcorr.corr_bottleneck_blur, md, s2,
                              batched)(ja, jb, jw), np.float32)
    got = got.float().numpy()
    if dtype == "bfloat16":
        assert np.abs(got - blur).max() <= 2e-2 * np.abs(blur).max()
        return
    np.testing.assert_allclose(got, blur, rtol=1e-5, atol=1e-5)
    xla = np.asarray(_jax_fn(jcorr.corr_bottleneck_xla, md, s2, batched)(
        ja, jb, jw))
    if _off_grid(md, s2):
        assert np.abs(got - xla).max() > 0.1 * np.abs(xla).max()
    else:
        np.testing.assert_allclose(got, xla, rtol=1e-4, atol=1e-4)


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
    (2, 1, 1, False), (4, 2, 3, True), (5, 2, 3, True), (3, 2, 1, True)])
def test_vjp_matches_jax(md, s2, cb, batched):
    """corr_bottleneck_vjp against jax.vjp of JAX's blur at the given
    max_displacement, for a, b and the weights; where the grids agree,
    also against jax.vjp of corr_bottleneck_xla (the JAX custom_vjp's
    backward)."""
    a, b, w = _inputs(2, md, s2, cb, batched)
    cot = _cotangent(md, s2, cb, batched)
    got = tcorr.corr_bottleneck_vjp(
        *(torch.from_numpy(t) for t in (a, b, w, cot)), md, s2)
    _hold_grads(got, _jax_grads(jcorr.corr_bottleneck_blur, md, s2,
                                batched, a, b, w, cot))
    if not _off_grid(md, s2):
        _hold_grads(got, _jax_grads(jcorr.corr_bottleneck_xla, md, s2,
                                    batched, a, b, w, cot))


def _cotangent(md, s2, cb, batched):
    return np.random.RandomState(9).randn(
        *(((2,) if batched else ()) + (cb, 11, 13))).astype(np.float32)


def _torch_grads(fn, a, b, w, cot):
    """fn's output and the gradients of <fn(a, b, w), cot> by autograd."""
    leaves = [torch.from_numpy(t).requires_grad_() for t in (a, b, w)]
    out = fn(*leaves)
    (out * torch.from_numpy(cot)).sum().backward()
    return out.detach().numpy(), [t.grad for t in leaves]


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("md,s2", GRIDS + [(5, 1)])
def test_corr_bottleneck_matches_jax(md, s2, batched):
    """The model's op, ``corr_bottleneck`` (on the CPU its twin on the
    blur's grid), against JAX's ``corr_bottleneck`` as the JAX model
    calls it (no use_pallas: the blur), forward within 1e-5 and the VJP
    within 1e-4 of the largest gradient, on either grid."""
    a, b, w = _inputs(3, md, s2, 2, batched)
    cot = _cotangent(md, s2, 2, batched)
    got, grads = _torch_grads(
        lambda x, y, z: tcorr.corr_bottleneck(x, y, z, md, s2), a, b, w, cot)
    fn = _jax_fn(jcorr.corr_bottleneck, md, s2, batched)
    want = np.asarray(fn(jnp.asarray(a), jnp.asarray(b), jnp.asarray(w)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    _hold_grads(grads, _jax_grads(jcorr.corr_bottleneck, md, s2, batched,
                                  a, b, w, cot))
    if _off_grid(md, s2):
        xla = np.asarray(_jax_fn(jcorr.corr_bottleneck_xla, md, s2, batched)(
            jnp.asarray(a), jnp.asarray(b), jnp.asarray(w)))
        assert np.abs(got - xla).max() > 0.1 * np.abs(xla).max()


@pytest.mark.parametrize("md,s2", GRIDS)
def test_xla_grid_twin_matches_jax(md, s2):
    """The twin at origin 0, the correlation's grid, against
    ``corr_bottleneck_xla``: forward within 1e-5, the VJP within 1e-4 of
    the largest gradient; at ``grid_origin`` it is the blur's grid,
    JAX's blur."""
    a, b, w = _inputs(4, md, s2, 3, True)
    cot = _cotangent(md, s2, 3, True)
    got, grads = _torch_grads(
        lambda x, y, z: tcorr.corr_bottleneck_plain(x, y, z, md, s2),
        a, b, w, cot)
    ja, jb, jw = jnp.asarray(a), jnp.asarray(b), jnp.asarray(w)
    xla = np.asarray(_jax_fn(jcorr.corr_bottleneck_xla, md, s2, True)(
        ja, jb, jw))
    np.testing.assert_allclose(got, xla, rtol=1e-5, atol=1e-5)
    _hold_grads(grads, _jax_grads(jcorr.corr_bottleneck_xla, md, s2, True,
                                  a, b, w, cot))
    blur_grid = tcorr.corr_bottleneck_plain(
        *(torch.from_numpy(t) for t in (a, b, w)), md, s2,
        tcorr.grid_origin(md, s2)).numpy()
    blur = np.asarray(_jax_fn(jcorr.corr_bottleneck_blur, md, s2, True)(
        ja, jb, jw))
    np.testing.assert_allclose(blur_grid, blur, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("origin", [-1, 2])
def test_twin_rejects_origins_off_the_stride(origin):
    z = torch.zeros(1, 6, 6, 8)
    with pytest.raises(ValueError):
        tcorr.corr_bottleneck_plain(z, z, torch.zeros(25, 1), 5, 2, origin)
