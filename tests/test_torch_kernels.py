"""The port's kernels (dodt_tpu_torch B1-B4) against the JAX package.

On the CPU each kernel module runs its plain PyTorch twin; these tests
hold every twin against the Pallas kernel it replaces, run the way the
JAX package's own tests run it on the CPU (TPU interpret mode), and
against the XLA forms. The CUDA kernels themselves are held against the
twins on the card by tests/test_torch_cuda.py and chip_smoke.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from dodt_tpu.ops import conv_chain as jcc
from dodt_tpu.ops import correlation as jcorr
from dodt_tpu.ops import roi as jroi
from dodt_tpu.ops import roi_pallas
from dodt_tpu_torch.ops import conv_chain as tcc
from dodt_tpu_torch.ops import correlation as tcorr
from dodt_tpu_torch.ops import roi_window as twin
from test_ops import np_correlation


def _chain(rng, ci, chain_out):
    ks, bs, c = [], [], ci
    for co in chain_out:
        ks.append((rng.randn(3, 3, c, co) * 0.1).astype(np.float32))
        bs.append((rng.randn(co) * 0.1).astype(np.float32))
        c = co
    return ks, bs


def _oihw(ks):
    return [torch.from_numpy(np.ascontiguousarray(k.transpose(3, 2, 0, 1)))
            for k in ks]


# ---------------------------------------------------------------- B1

@pytest.mark.parametrize("b,h,w,ci,chain_out,th", [
    (1, 19, 12, 8, (16, 16), 8),      # odd H, grid remainder strip
    (2, 16, 12, 8, (16, 8, 16), 4),   # batch, 3-conv chain
])
def test_conv_chain_twin_matches_pallas_interpret(b, h, w, ci, chain_out,
                                                  th):
    """f32: the twin equals the interpret-mode Pallas chain and the XLA
    chain to f32 summation-order rounding (1e-5)."""
    rng = np.random.RandomState(0)
    x = rng.randn(b, h, w, ci).astype(np.float32)
    ks, bs = _chain(rng, ci, chain_out)
    got = tcc.conv_chain(torch.from_numpy(x), _oihw(ks),
                         [torch.from_numpy(v) for v in bs]).numpy()
    with pltpu.force_tpu_interpret_mode():
        pallas = np.asarray(jcc.conv_chain_pallas(
            jnp.asarray(x), [jnp.asarray(k) for k in ks],
            [jnp.asarray(v) for v in bs], tile_rows=th))
    xla = np.asarray(jax.vmap(lambda xx: jcc.conv_chain_xla(
        xx, [jnp.asarray(k) for k in ks], [jnp.asarray(v) for v in bs]))(
            jnp.asarray(x)))
    np.testing.assert_allclose(got, pallas, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, xla, rtol=1e-5, atol=1e-5)


def test_conv_chain_twin_bf16_matches_pallas_interpret():
    """bf16 in and out, f32 accumulation and bias, one rounding per
    stage in both: equal up to one bf16 rounding flip (2e-2 relative)."""
    rng = np.random.RandomState(1)
    x = rng.randn(1, 12, 10, 32).astype(np.float32)
    ks, bs = _chain(rng, 32, (64, 64))
    xb = jnp.asarray(x, jnp.bfloat16)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jcc.conv_chain_pallas(
            xb, [jnp.asarray(k) for k in ks], [jnp.asarray(v) for v in bs],
            tile_rows=4), np.float32)
    got = tcc.conv_chain(torch.from_numpy(x).to(torch.bfloat16), _oihw(ks),
                         [torch.from_numpy(v) for v in bs])
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want,
                               atol=2e-2 * np.abs(want).max(), rtol=0)


# ---------------------------------------------------------------- B2

def _window_boxes():
    # spans < window - 10 px, incl. edge-touching and degenerate boxes
    return np.array([[0.1, 0.2, 0.4, 0.5],
                     [0.0, 0.0, 0.3, 0.3],
                     [0.7, 0.6, 1.0, 1.0],
                     [0.42, 0.13, 0.44, 0.17],
                     [0.3, 0.3, 0.3, 0.3],
                     [0.95, 0.95, 1.05, 1.05],
                     [-0.05, -0.05, 0.1, 0.1],
                     [0.5, 0.5, 0.85, 0.82]], np.float32)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("h,c,boxes", [
    (96, 32, _window_boxes()),
    # oversized ROIs clamp to the window edge, identically in both
    (96, 4, np.array([[0.0, 0.0, 1.0, 1.0], [0.2, 0.1, 0.9, 0.95]],
                     np.float32)),
    # 150 - 64 = 86 floors to 80: ROIs reaching rows 144+ clamp at 143
    (150, 32, np.array([[0.9, 0.2, 1.0, 0.3], [0.97, 0.5, 1.0, 0.6]],
                       np.float32)),
])
def test_roi_window_twin_matches_pallas_interpret(h, c, boxes, dtype):
    """Both read the map in its dtype and return bf16: f32 maps (the
    main path's) each casts to bf16 itself. The TPU kernel rounds its hat
    weights and row-reduced partials to bf16 too, so they agree to a few
    bf16 roundings (2e-2 of the map range)."""
    rng = np.random.RandomState(11)
    img = rng.rand(h, 128, c).astype(np.float32)
    want = np.asarray(roi_pallas.crop_and_resize_window(
        jnp.asarray(img, getattr(jnp, dtype)), jnp.asarray(boxes), 7,
        window=64, interpret=True), np.float32)
    got = twin.crop_and_resize_window(
        torch.from_numpy(img).to(getattr(torch, dtype)),
        torch.from_numpy(boxes), 7, window=64)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    np.testing.assert_allclose(got.float().numpy(), want, atol=2e-2, rtol=0)


def test_roi_window_twin_matches_gather_where_rois_fit():
    """For ROIs inside their window the window crop is the gather crop
    (bf16 map, f32 blend in both); the bottom rows of a map whose
    H - WIN is not a multiple of 8 lie outside every window, as on the
    TPU, and window_fits says so."""
    rng = np.random.RandomState(3)
    img = rng.rand(2, 150, 100, 32).astype(np.float32)
    boxes = np.stack([_window_boxes(),
                      np.array([[0.96, 0.2, 1.0, 0.3]] * 8, np.float32)])
    timg = torch.from_numpy(img).to(torch.bfloat16)
    tb = torch.from_numpy(boxes)
    got = twin.crop_and_resize_window(timg, tb, 7).float()
    fits = twin.window_fits(timg.shape, tb, 7)
    # 150 - 64 = 86 floors to 80: rows 144-149 lie in no window
    assert fits[0].sum() == 6 and not fits[1].any()
    for m in range(2):
        want = np.asarray(jroi.crop_and_resize(
            jnp.asarray(img[m], jnp.bfloat16), jnp.asarray(boxes[m]), 7,
            method="gather"), np.float32)
        f = fits[m].numpy()
        np.testing.assert_allclose(got[m].numpy()[f], want[f], atol=1e-2)


# ---------------------------------------------------------------- B3

@pytest.mark.parametrize("h,w,c,cb,md,s2", [
    (20, 24, 8, 1, 5, 1),      # the model's displacement range
    (12, 12, 4, 2, 4, 2),      # stride_2 = 2, two bottleneck channels
    (12, 13, 8, 2, 5, 2),      # the blur's grid one pixel off the centred
    (11, 12, 8, 1, 3, 2),      # one (max_displacement % stride_2 = 1)
])
def test_corr_bottleneck_twin_matches_pallas_interpret(h, w, c, cb, md, s2):
    """The model's op on the CPU (B3's twin on the blur's grid) against
    the Pallas kernel, which reads B on that grid too, and JAX's blur:
    f32 sums of D^2 x C products in another order, 1e-5."""
    rng = np.random.RandomState(5)
    a = rng.randn(h, w, c).astype(np.float32)
    b = rng.randn(h, w, c).astype(np.float32)
    _, d = jcorr._disp_grid(md, s2)
    wts = rng.randn(d * d, cb).astype(np.float32)
    got = tcorr.corr_bottleneck(torch.from_numpy(a), torch.from_numpy(b),
                                torch.from_numpy(wts), md, s2).numpy()
    with pltpu.force_tpu_interpret_mode():
        pallas = np.asarray(jcorr.corr_bottleneck_pallas(
            jnp.asarray(a), jnp.asarray(b), jnp.asarray(wts), md, s2))
    blur = np.asarray(jcorr.corr_bottleneck_blur(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(wts), md, s2))
    assert got.shape == (cb, h, w)
    np.testing.assert_allclose(got, pallas, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, blur, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------- B4

@pytest.mark.parametrize("shape,md,s2", [
    ((20, 24, 8), 5, 1),       # the model's displacement range
    ((12, 12, 4), 4, 2),       # stride_2 = 2
    ((2, 10, 13, 8), 5, 1),    # batched
    ((2, 9, 7, 3), 4, 2),      # batched, stride_2 = 2, odd channels
])
def test_correlation_twin_matches_jax(shape, md, s2):
    """The twin against the interpret-mode Pallas kernel (one call per
    map: vmap of the pallas_call does not run in interpret mode),
    correlation_xla_cf, the JAX reference-layout op and the numpy oracle:
    f32 sums of C products in another order, 1e-6 (the values are
    O(1))."""
    rng = np.random.RandomState(6)
    a = rng.randn(*shape).astype(np.float32)
    b = rng.randn(*shape).astype(np.float32)
    got_cf = tcorr.correlation_cf(torch.from_numpy(a), torch.from_numpy(b),
                                  md, s2).numpy()
    got = tcorr.correlation(torch.from_numpy(a), torch.from_numpy(b), md,
                            s2).numpy()
    _, d = jcorr._disp_grid(md, s2)
    assert got_cf.shape == shape[:-3] + (d * d,) + shape[-3:-1]
    assert got.shape == shape[:-1] + (d * d,)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    with pltpu.force_tpu_interpret_mode():
        pallas = np.stack([np.asarray(jcorr.correlation_pallas_cf(
            x, y, md, s2)) for x, y in zip(ja.reshape((-1,) + shape[-3:]),
                                           jb.reshape((-1,) + shape[-3:]))])
    pallas = pallas.reshape(got_cf.shape)
    xla_cf = np.asarray(jcorr.correlation_cf(ja, jb, md, s2,
                                             use_pallas=False))
    ref = np.asarray(jcorr.correlation(ja, jb, md, s2, use_pallas=False))
    oracle = (np_correlation(a, b, md, s2) if a.ndim == 3 else
              np.stack([np_correlation(x, y, md, s2) for x, y in zip(a, b)]))
    np.testing.assert_allclose(got_cf, pallas, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got_cf, xla_cf, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got, oracle, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("md,s2", [(5, 1), (5, 2), (3, 2)])
def test_correlation_twin_at_the_kernels_origin_matches_pallas(md, s2):
    """B4's twin at ``grid_origin`` (the grid of B4 on the card) against
    the interpret-mode ``correlation_pallas_cf`` (per map), and at origin
    0 against ``correlation_xla_cf`` (the CPU route's grid): f32 sums of
    C products in another order, 1e-6. Where max_displacement %
    stride_2 != 0 the two grids differ (by more than 0.1 here)."""
    rng = np.random.RandomState(13)
    a = rng.randn(2, 21, 26, 8).astype(np.float32)
    b = rng.randn(2, 21, 26, 8).astype(np.float32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    origin = tcorr.grid_origin(md, s2)
    assert origin == md % s2
    got = tcorr.correlation_cf_plain(ta, tb, md, s2, origin).numpy()
    with pltpu.force_tpu_interpret_mode():
        pallas = np.stack([np.asarray(jcorr.correlation_pallas_cf(
            jnp.asarray(x), jnp.asarray(y), md, s2)) for x, y in zip(a, b)])
    np.testing.assert_allclose(got, pallas, rtol=1e-6, atol=1e-6)
    centred = tcorr.correlation_cf_plain(ta, tb, md, s2).numpy()
    xla = np.asarray(jcorr.correlation_cf(jnp.asarray(a), jnp.asarray(b), md,
                                          s2, use_pallas=False))
    np.testing.assert_allclose(centred, xla, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(tcorr.correlation_cf(ta, tb, md, s2).numpy(),
                                  centred)
    assert (np.abs(got - centred).max() > 0.1) == (origin != 0)


@pytest.mark.parametrize("shape,md,s2", [
    ((20, 24, 8), 5, 1),       # the model's displacement range
    ((2, 10, 13, 16), 4, 2),   # batched, stride_2 = 2
])
def test_correlation_twin_bf16_matches_jax(shape, md, s2):
    """bf16 maps: the twin and the JAX op (correlation_cf, XLA) both
    return bf16, each rounding the products, the channel sum and the
    1/C at its own places: within 1e-2 of the range (two or three bf16
    roundings at its top)."""
    rng = np.random.RandomState(12)
    a = rng.randn(*shape).astype(np.float32)
    b = rng.randn(*shape).astype(np.float32)
    want = jcorr.correlation_cf(jnp.asarray(a, jnp.bfloat16),
                                jnp.asarray(b, jnp.bfloat16), md, s2,
                                use_pallas=False)
    got = tcorr.correlation_cf(torch.from_numpy(a).to(torch.bfloat16),
                               torch.from_numpy(b).to(torch.bfloat16), md, s2)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=1e-2 * np.abs(want).max())


@pytest.mark.parametrize("md,s2", [(2, 1), (4, 2)])
def test_correlation_twin_grads_match_jax(md, s2):
    """Gradients of sum(corr * G) w.r.t. both maps: the twin's autograd
    against jax.grad of correlation_xla, f32 sums in another order,
    1e-5."""
    rng = np.random.RandomState(10)
    a = rng.randn(6, 7, 3).astype(np.float32)
    b = rng.randn(6, 7, 3).astype(np.float32)
    _, d = jcorr._disp_grid(md, s2)
    g = rng.randn(6, 7, d * d).astype(np.float32)
    want = jax.grad(lambda x, y: jnp.sum(
        jcorr.correlation_xla(x, y, md, s2) * g), argnums=(0, 1))(
            jnp.asarray(a), jnp.asarray(b))
    ta = torch.from_numpy(a).requires_grad_()
    tb = torch.from_numpy(b).requires_grad_()
    (tcorr.correlation(ta, tb, md, s2) * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(ta.grad.numpy(), np.asarray(want[0]),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(want[1]),
                               rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------- dispatch

def _run_all_cpu():
    x = torch.zeros(1, 4, 4, 32)
    tcc.conv_chain(x, [torch.zeros(64, 32, 3, 3)], [torch.zeros(64)])
    twin.crop_and_resize_window(torch.zeros(64, 64, 32),
                                torch.zeros(3, 4), 7)
    tcorr.corr_bottleneck(torch.zeros(1, 8, 8, 8), torch.zeros(1, 8, 8, 8),
                          torch.zeros(121, 1), 5)
    tcorr.correlation(torch.zeros(2, 8, 8, 8), torch.zeros(2, 8, 8, 8), 5)


def test_cpu_tensors_take_the_twins_and_launch_nothing():
    kernels = (tcc._KERNEL, twin._KERNEL, tcorr._KERNEL, tcorr._CF_KERNEL)
    before = [k.launches for k in kernels]
    _run_all_cpu()
    assert [k.launches for k in kernels] == before == [0, 0, 0, 0]


@pytest.mark.parametrize("fn", [
    lambda: tcc.conv_chain(torch.zeros(1, 4, 4, 32, device="meta"),
                           [torch.zeros(64, 32, 3, 3)], [torch.zeros(64)]),
    lambda: twin.crop_and_resize_window(
        torch.zeros(64, 64, 32, device="meta"), torch.zeros(3, 4), 7),
    lambda: tcorr.corr_bottleneck(
        torch.zeros(8, 8, 8, device="meta"),
        torch.zeros(8, 8, 8, device="meta"), torch.zeros(121, 1), 5),
    lambda: tcorr.correlation_cf(torch.zeros(8, 8, 8, device="meta"),
                                 torch.zeros(8, 8, 8, device="meta"), 5),
])
def test_other_devices_raise(fn):
    with pytest.raises(ValueError):
        fn()


def test_crop_window_rejects_small_maps():
    with pytest.raises(ValueError):
        twin.crop_and_resize_window(torch.zeros(32, 32, 4),
                                    torch.zeros(2, 4), 7)


# ---------------------------------------------------------------- gradients

def _kernel_standin(plain):
    """What a CUDA kernel returns: the right values and no autograd
    graph (the twin under no_grad stands in for the ctypes call)."""
    def call(*args):
        with torch.no_grad():
            return plain(*args)
    return call


@pytest.mark.parametrize("md,s2,cb", [(5, 1, 1), (4, 2, 2), (5, 2, 3),
                                      (2, 1, 1), (3, 2, 1)])
def test_corr_bottleneck_autograd_route_matches_twin(monkeypatch, md, s2,
                                                     cb):
    """B3's CUDA route (``_CorrBottleneck``) with the kernel call replaced
    by a graph-less stand-in (the twin on the blur's grid, the kernel's
    own): the output carries a grad_fn, its backward goes through
    ``corr_bottleneck_vjp`` once (a spy), and the gradients w.r.t. a, b
    and the weights are the autograd of the twin on the same grid to
    1e-6, in f64: the twin's loop and the blur's conv sum in other
    orders, which in f32 alone parts them by a few 1e-6. From the same
    inputs in f32 they are also jax.vjp's of JAX's ``corr_bottleneck``
    (the JAX model's op) within 1e-4 of the largest gradient. Without
    the Function the kernel's output has no graph, so the weights would
    get no gradient on the card."""
    origin = tcorr.grid_origin(md, s2)

    def standin(*args):
        return _kernel_standin(tcorr.corr_bottleneck_plain)(*args, origin)
    monkeypatch.setattr(tcorr, "corr_bottleneck_cuda", standin)
    calls, vjp = [], tcorr.corr_bottleneck_vjp

    def spy(*args):
        calls.append(args[-2:])
        return vjp(*args)
    monkeypatch.setattr(tcorr, "corr_bottleneck_vjp", spy)
    rng = np.random.RandomState(6)
    _, d = tcorr.disp_grid(md, s2)
    a, b = (rng.randn(2, 10, 12, 8).astype(np.float32) for _ in range(2))
    w = (rng.randn(d * d, cb) / d).astype(np.float32)
    cot = rng.randn(2, cb, 10, 12).astype(np.float32)
    assert tcorr.corr_bottleneck_cuda(
        *(torch.from_numpy(t) for t in (a, b, w)), md, s2).grad_fn is None
    leaves = [torch.from_numpy(t).double().requires_grad_()
              for t in (a, b, w)]
    out = tcorr._CorrBottleneck.apply(*leaves, md, s2)
    assert out.grad_fn is not None
    (out * torch.from_numpy(cot).double()).sum().backward()
    assert calls == [(md, s2)]
    twins = [torch.from_numpy(t).double().requires_grad_()
             for t in (a, b, w)]
    (tcorr.corr_bottleneck_plain(*twins, md, s2, origin)
     * torch.from_numpy(cot).double()).sum().backward()
    for got, want in zip(leaves, twins):
        torch.testing.assert_close(got.grad, want.grad, rtol=1e-6,
                                   atol=1e-6)
    assert float(leaves[2].grad.abs().max()) > 0

    def model_op(a, b, w):
        return jcorr.corr_bottleneck(a, b, w, md, s2)
    _, jvjp = jax.vjp(jax.vmap(model_op, in_axes=(0, 0, None)),
                      jnp.asarray(a), jnp.asarray(b), jnp.asarray(w))
    for got, ref in zip(leaves, jvjp(jnp.asarray(cot))):
        ref = np.asarray(ref)
        assert np.abs(got.grad.numpy() - ref).max() <= 1e-4 * np.abs(
            ref).max()


def test_conv_chain_autograd_route_matches_twin(monkeypatch):
    """B1's CUDA route (``_ConvChain``) with the kernel call replaced by a
    graph-less stand-in: gradients w.r.t. the bf16 input and every f32
    weight and bias are the twin's autograd (the JAX custom_vjp replays
    conv_chain_xla), bit for bit."""
    monkeypatch.setattr(tcc, "conv_chain_cuda",
                        _kernel_standin(tcc.conv_chain_plain))
    g = torch.Generator().manual_seed(7)
    x = torch.relu(torch.randn(2, 9, 11, 16, generator=g)).to(torch.bfloat16)
    ws = [torch.randn(co, ci, 3, 3, generator=g) / (9 * ci) ** 0.5
          for ci, co in ((16, 24), (24, 8))]
    bs = [0.1 * torch.randn(co, generator=g) for co in (24, 8)]
    cot = torch.randn(2, 9, 11, 8, generator=g)
    assert tcc.conv_chain_cuda(x, ws, bs).grad_fn is None
    leaves = [t.clone().requires_grad_() for t in (x, *ws, *bs)]
    out = tcc._ConvChain.apply(*leaves)
    assert out.grad_fn is not None and out.dtype == torch.bfloat16
    (out.float() * cot).sum().backward()
    twins = [t.clone().requires_grad_() for t in (x, *ws, *bs)]
    (tcc.conv_chain_plain(twins[0], twins[1:3], twins[3:]).float()
     * cot).sum().backward()
    for got, want in zip(leaves, twins):
        assert torch.equal(got.grad, want.grad)


@pytest.mark.parametrize("ci,co", [(16, 16), (128, 256), (40, 72)])
def test_conv_chain_weight_pack_unpacks_to_hwio(ci, co):
    """B1's K-major pack (Co, 9 * Ci), bf16, unpacks to the HWIO kernel
    (the Flax layout) of the same bf16 weights, element for element."""
    w = torch.randn(co, ci, 3, 3, generator=torch.Generator().manual_seed(8))
    packed = tcc.pack_weights(w)
    assert packed.shape == (co, 9 * ci) and packed.dtype == torch.bfloat16
    assert packed.is_contiguous()
    hwio = packed.reshape(co, 3, 3, ci).permute(1, 2, 3, 0)
    assert torch.equal(hwio, w.permute(2, 3, 1, 0).to(torch.bfloat16))


def test_conv_chain_pack_is_cached_until_a_parameter_changes():
    """The pack and the f32 bias are made once per parameter and made
    again when the weight or the bias is updated in place (an optimiser
    step or load_state_dict bumps ``_version``)."""
    g = torch.Generator().manual_seed(9)
    conv = torch.nn.Conv2d(8, 16, 3)
    w, b = conv.weight, conv.bias
    first = tcc._packed(w, b)
    assert tcc._packed(w, b)[0] is first[0]
    with torch.no_grad():
        w.add_(torch.randn(w.shape, generator=g))
    second = tcc._packed(w, b)
    assert second[0] is not first[0]
    assert torch.equal(second[0], tcc.pack_weights(w))
    assert torch.equal(second[1], b.detach())
    conv.load_state_dict({"weight": w.detach().clone(),
                          "bias": b.detach() + 1.0})
    third = tcc._packed(w, b)
    assert third[1] is not second[1]
    assert torch.equal(third[1], b.detach()) and third[1].dtype == torch.float32


# ---------------------------------------------------------------- helpers

@pytest.mark.parametrize("dtype,c,ptr,vec", [
    (torch.float32, 32, 0, 4),        # the main path: a float4 of channels
    (torch.bfloat16, 32, 256, 8),     # 8 bf16 channels in 16 bytes
    (torch.float32, 12, 16, 4),
    (torch.bfloat16, 12, 16, 1),      # C % 8: the scalar instance
    (torch.bfloat16, 4, 0, 1),
    (torch.float32, 32, 4, 1),        # a map 4 bytes off 16: scalar loads
])
def test_roi_window_vector_width(dtype, c, ptr, vec):
    """B2 reads 16 bytes a load where C is a multiple of the vector and
    the map is 16-byte aligned, else one channel a load."""
    assert twin.vector_width(dtype, c, ptr) == vec


def test_roi_window_takes_f32_and_bf16_maps_only():
    """The kernel's dtype codes: the map is read in its own dtype, f32 or
    bf16 (csrc/roi_window.cu dtype 0 and 1); others have no instance."""
    assert twin._DTYPES == {torch.float32: (0, 4), torch.bfloat16: (1, 2)}
    with pytest.raises(KeyError):
        twin.vector_width(torch.float16, 32, 0)


def test_sample_grid_lattice_is_the_true_quotient():
    """The unit lattice k / (s - 1) is the correctly rounded quotient (as
    numpy, XLA and kernel B2 compute it), kept per device: on a card a
    tensor divided by a Python number is multiplied by the reciprocal,
    one ulp off for s = 7."""
    from dodt_tpu_torch.ops import roi
    for s in range(2, 33):
        want = np.arange(s, dtype=np.float32) / np.float32(s - 1)
        got = roi._unit_grid(s, torch.device("cpu"))
        assert got.dtype == torch.float32 and np.array_equal(got.numpy(), want)
    assert roi._unit_grid(7, torch.device("cpu")) is roi._unit_grid(
        7, torch.device("cpu"))
    boxes = torch.tensor([[0.1, 0.2, 0.4, 0.55]])
    ys = roi.sample_grid(boxes, 350, boxes[:, 0], boxes[:, 2], 7)
    g = np.arange(7, dtype=np.float32) / np.float32(6)
    t = np.float32(0.1) + (np.float32(0.4) - np.float32(0.1)) * g
    np.testing.assert_array_equal(
        ys[0].numpy(), np.clip(t * np.float32(350) - np.float32(0.5), 0, 349))


def test_correlation_cf_geometry_at_the_main_shape():
    """B4 at (1, 350, 400, 32), D = 11: the D = 11 instance, 5 rows of a
    column per thread (55 accumulators), a four-stage ring of 50.6 KB,
    and A and B read from L2 2.6 times the input (each 5 x 32 tile's
    staged slices once), not D times."""
    geo = tcorr.cf_geometry(5, 1)
    assert geo == tcorr.CfGeometry(d=11, dmax=11, rows=5, stages=4,
                                   smem=4 * (15 * 42 + 5 * 32) * 16)
    blocks = -(-400 // tcorr.CF_COLS) * -(-350 // geo.rows)
    l2_bytes = blocks * geo.smem // geo.stages * (32 // 4)
    assert l2_bytes <= 2.6 * 2 * 350 * 400 * 32 * 4


@pytest.mark.parametrize("s2", [1, 2, 3, 5])
def test_correlation_cf_geometry_everywhere(s2):
    """Every D <= 21 at this stride_2: the smallest bucket that holds D,
    at most 55 accumulators a thread, and a ring that fits 227 KB (four
    stages, or two where four do not fit) or a ValueError before
    launch."""
    for md in range(0, 11 * s2):
        _check_cf_geometry(md, s2)


def _check_cf_geometry(md, s2):
    _, d = tcorr.disp_grid(md, s2)
    try:
        geo = tcorr.cf_geometry(md, s2)
    except ValueError:
        span = (d - 1) * s2
        assert 2 * ((2 + span) * (32 + span) + 64) * 16 > tcorr.CF_MAX_SMEM
        return
    assert geo.d == d <= geo.dmax
    assert (geo.dmax, geo.rows) in tcorr.CF_TILINGS
    assert d > max([t[0] for t in tcorr.CF_TILINGS if t[0] < geo.dmax],
                   default=0)
    assert geo.rows * geo.dmax <= 55 and geo.smem <= tcorr.CF_MAX_SMEM
    span = (d - 1) * s2
    stage = ((geo.rows + span) * (32 + span) + geo.rows * 32) * 16
    assert geo.smem == geo.stages * stage
    assert geo.stages == (4 if 4 * stage <= tcorr.CF_MAX_SMEM else 2)


def test_correlation_cf_geometry_rejects_d_past_21():
    with pytest.raises(ValueError, match="D <= 21"):
        tcorr.cf_geometry(11, 1)
