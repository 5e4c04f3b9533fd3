"""The port's bilinear resize (``ops/resize.resize_bilinear``) against
``jax.image.resize(method="bilinear")`` and its ``jax.vjp``, from the same
seeded numpy inputs on the CPU.

Cases: 2x, 4x and 8x upsampling, the plain VGG tower's ratios (conv4 at
1/8 of a map padded to a multiple of 8, resized to 1/decode_stride),
non-integer ratios and a downsampling (JAX's antialiased weights), and a
tenth-size (35, 40) -> (70, 80) copy of the model's BEV bottleneck
upsample (350, 400) -> (700, 800), each in float32 and in bfloat16 (the
bottleneck's output is float32 in both models, the plain tower's conv4
is in the tower's dtype, bfloat16 on the flagship). Tolerances: float32
1e-6 of the largest |value| (each output is a two-tap sum per axis in
float32 on both sides, in another order); bfloat16 2^-7 of the largest
|value|, one bfloat16 ulp at the top of the range (the port sums both
axes in float32 and rounds once; JAX's einsum rounds to bfloat16 after
each axis's contraction, and the two part by up to 0.86 of that bound
on these inputs).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from dodt_tpu.models import dt_avod as jdt
from dodt_tpu_torch.models import dt_avod as tdt
from dodt_tpu_torch.ops import resize

CASES = [
    ((5, 7), (10, 14)),       # 2x
    ((5, 7), (20, 28)),       # 4x
    ((3, 4), (24, 32)),       # 8x
    ((6, 6), (24, 24)),       # plain VGG: 48 x 48 padded map, decode 2
    ((5, 7), (40, 56)),       # plain VGG: 40 x 56, decode 1
    ((7, 7), (10, 11)),       # non-integer ratios
    ((9, 8), (5, 6)),         # downsampling (antialiased)
    ((35, 40), (70, 80)),     # the BEV bottleneck's upsample, a tenth
]


def _inputs(hw, out_hw, c, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(2, *hw, c).astype(np.float32)
    cot = rng.randn(2, *out_hw, c).astype(np.float32)
    return x, cot


def _jax_resize(x, out_hw, cot):
    """jax.image.resize's output and its VJP under ``cot``, as float32
    numpy arrays."""
    shape = (x.shape[0],) + tuple(out_hw) + x.shape[3:]
    out, vjp = jax.vjp(
        lambda v: jax.image.resize(v, shape, method="bilinear"), x)
    (grad,) = vjp(cot)
    assert out.dtype == x.dtype and grad.dtype == x.dtype
    return (np.asarray(out.astype(jnp.float32)),
            np.asarray(grad.astype(jnp.float32)))


def _hold(got, want, dtype):
    rel = 1e-6 if dtype == "float32" else 2.0 ** -7
    assert np.abs(got - want).max() <= rel * np.abs(want).max()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hw,out_hw", CASES)
def test_resize_and_vjp_match_jax(hw, out_hw, dtype):
    x, cot = _inputs(hw, out_hw, 3)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    jcot = jnp.asarray(cot, getattr(jnp, dtype))
    want, want_grad = _jax_resize(jx, out_hw, jcot)
    tdtype = getattr(torch, dtype)
    tx = torch.tensor(np.asarray(jx.astype(jnp.float32))).to(
        tdtype).requires_grad_()
    got = resize.resize_bilinear(tx, out_hw)
    assert got.dtype == tdtype and tuple(got.shape) == (2, *out_hw, 3)
    got.backward(torch.tensor(np.asarray(jcot.astype(jnp.float32))).to(
        tdtype))
    assert tx.grad.dtype == tdtype
    _hold(got.detach().float().numpy(), want, dtype)
    _hold(tx.grad.float().numpy(), want_grad, dtype)


@pytest.mark.parametrize("n_in,n_out", [(5, 10), (3, 24), (7, 11), (9, 5)])
def test_weight_matrix_is_jaxs(n_in, n_out):
    """The axis weights equal JAX's compute_weight_mat (bilinear, the
    ratio as jax.image.resize gives it, antialias on) bit for bit."""
    from jax._src.image import scale
    want = np.asarray(scale.compute_weight_mat(
        n_in, n_out, n_out / n_in, 0.0, scale._fill_triangle_kernel, True))
    np.testing.assert_array_equal(resize.weight_matrix(n_in, n_out), want.T)


class _Ops(TorchDispatchMode):
    """Records the name of every aten op dispatched under it."""

    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(func.__name__)
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_model_resize_matches_jax_and_gathers_its_backward(dtype):
    """models/dt_avod.py ``_resize_to`` (the BEV bottleneck's upsample)
    against the JAX model's ``_resize_to`` at a tenth of the flagship's
    (2, 350, 400, 1) -> (700, 800), forward and VJP, in the input's
    dtype; its forward and backward dispatch no upsample, index_add,
    scatter or index_put op (the backward gathers), and the same input
    and cotangent give the same gradient bit for bit."""
    x, cot = _inputs((35, 40), (70, 80), 1, seed=1)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    jcot = jnp.asarray(cot, getattr(jnp, dtype))
    out, vjp = jax.vjp(lambda v: jdt._resize_to(v, (70, 80)), jx)
    want = np.asarray(out.astype(jnp.float32))
    want_grad = np.asarray(vjp(jcot)[0].astype(jnp.float32))
    tdtype = getattr(torch, dtype)
    tcot = torch.tensor(np.asarray(jcot.astype(jnp.float32))).to(tdtype)
    grads = []
    for _ in range(2):
        tx = torch.tensor(np.asarray(jx.astype(jnp.float32))).to(
            tdtype).requires_grad_()
        with _Ops() as ops:
            got = tdt._resize_to(tx, (70, 80))
            got.backward(tcot)
        grads.append(tx.grad)
    assert got.dtype == tdtype
    _hold(got.detach().float().numpy(), want, dtype)
    _hold(grads[0].float().numpy(), want_grad, dtype)
    assert torch.equal(grads[0], grads[1])
    assert "index_select.default" in ops.names
    banned = ("upsample", "index_add", "scatter", "index_put")
    assert not [n for n in ops.names if n.startswith(banned)], ops.names


def test_same_size_is_the_identity():
    x = torch.randn(1, 4, 5, 2)
    assert tdt._resize_to(x, (4, 5)) is x
