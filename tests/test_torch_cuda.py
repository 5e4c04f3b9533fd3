"""The port's CUDA kernels against their plain twins, on the card.

Every test here is marked ``cuda`` and skips where torch finds no card.
The file imports no JAX, so it also runs on a machine without it; there
``tests/conftest.py`` (which imports JAX) is left out:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

TF32 is off, so the f32 twins run full f32 products.
"""
import pytest
import torch

from dodt_tpu_torch.ops import conv_chain as tcc
from dodt_tpu_torch.ops import correlation as tcorr
from dodt_tpu_torch.ops import roi_window as twin

BOXES = [[0.1, 0.2, 0.4, 0.5], [0.0, 0.0, 0.3, 0.3], [0.7, 0.6, 1.0, 1.0],
         [0.42, 0.13, 0.44, 0.17], [0.3, 0.3, 0.3, 0.3],
         [0.95, 0.95, 1.05, 1.05], [-0.05, -0.05, 0.1, 0.1],
         [0.0, 0.0, 1.0, 1.0]]                       # the last one clamps


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (kernels build with nvcc for sm_90a)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_conv_chain_kernel_matches_twin(dev):
    """bf16 output rounded once per stage in both; summation order may
    flip a rounding by one ulp and propagate: 2e-2 of the range.
    Channel counts leave partial K (40 = 32 + 8) and N (72, 16) tiles."""
    g = torch.Generator().manual_seed(0)
    x = torch.relu(torch.randn(2, 13, 21, 40, generator=g)).to(
        dev, torch.bfloat16)
    ws = [(torch.randn(co, ci, 3, 3, generator=g) / (3 * ci ** 0.5)).to(dev)
          for ci, co in ((40, 72), (72, 16))]
    bs = [(0.1 * torch.randn(co, generator=g)).to(dev) for co in (72, 16)]
    before = tcc._KERNEL.launches
    got = tcc.conv_chain(x, ws, bs).float()
    assert tcc._KERNEL.launches == before + 2
    want = tcc.conv_chain_plain(x, ws, bs).float()
    assert got.shape == (2, 13, 21, 16)
    assert (got - want).abs().max() <= 2e-2 * want.abs().max()


@pytest.mark.cuda
def test_roi_window_kernel_matches_twin(dev):
    """Same f32 arithmetic, one bf16 rounding: within one bf16 ulp."""
    g = torch.Generator().manual_seed(1)
    maps = torch.randn(2, 96, 128, 32, generator=g).to(dev)
    boxes = torch.tensor([BOXES, BOXES[::-1]], device=dev)
    got = twin.crop_and_resize_window(maps, boxes, 7).float()
    want = twin.crop_and_resize_window_plain(maps, boxes, 7).float()
    assert (got - want).abs().max() <= 1e-2 * want.abs().max()


def _car_boxes(g, m, n):
    """(m, n, 4) car-sized normalised BEV boxes (80 m x 70 m map), the
    first tenth of them six times too large (the window clamps them)."""
    cy, cx = (torch.rand((m, n), generator=g) * 0.9 + 0.05 for _ in range(2))
    hy = (torch.rand((m, n), generator=g) * 2.5 + 1.0) / 70.0
    hx = (torch.rand((m, n), generator=g) * 2.5 + 1.0) / 80.0
    hy[:, :n // 10] *= 6.0
    hx[:, :n // 10] *= 6.0
    return torch.stack([cy - hy, cx - hx, cy + hy, cx + hx], -1)


# the bottom rows of a 150-row map lie in no window (C6), oversized ROIs
BOTTOM = [[0.9, 0.2, 1.0, 0.3], [0.97, 0.5, 1.0, 0.6], [0.0, 0.0, 1.0, 1.0],
          [0.2, 0.1, 0.9, 0.95]]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,n,s", [
    ((2, 350, 400, 32), 300, 7),     # the main path
    ((2, 96, 128, 4), 8, 7),         # C = 4: bf16 takes the scalar loads
    ((2, 96, 128, 16), 8, 7),        # C = 16
    ((2, 96, 128, 32), 1, 7),        # N = 1
    ((2, 96, 128, 32), 7, 7),        # N = 7
    ((2, 96, 128, 32), 8, 1),        # S = 1: the box centre
    ((2, 150, 128, 32), 4, 7),       # C6 bottom rows and oversized ROIs
])
def test_roi_window_kernel_matches_twin_on_both_dtypes(dev, shape, n, s,
                                                       dtype):
    """B2 reads the map in its own dtype and rounds each tap to bf16, the
    value the twin reads after casting the map: one launch, equal to the
    twin (the check allows 1e-2 of the range)."""
    g = torch.Generator().manual_seed(14)
    maps = torch.randn(shape, generator=g).to(dev, getattr(torch, dtype))
    boxes = (_car_boxes(g, shape[0], n) if shape[1] == 350 else
             torch.tensor([BOXES[:n] if n <= len(BOXES) else BOXES] * 2)
             if shape[1] == 96 else torch.tensor([BOTTOM, BOTTOM[::-1]]))
    boxes = boxes[:, :n].to(dev)
    before = twin._KERNEL.launches
    got = twin.crop_and_resize_window(maps, boxes, s)
    assert twin._KERNEL.launches == before + 1
    want = twin.crop_and_resize_window_plain(maps, boxes, s)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape == (
        shape[0], n, s, s, shape[3])
    assert (got.float() - want.float()).abs().max() <= \
        1e-2 * want.float().abs().max()


@pytest.mark.cuda
def test_roi_window_kernel_reads_a_misaligned_f32_map(dev):
    """An f32 map 4 bytes off a 16-byte boundary takes the scalar loads,
    with the same result as the aligned map."""
    g = torch.Generator().manual_seed(15)
    flat = torch.randn(2 * 96 * 128 * 32 + 1, generator=g).to(dev)
    maps = flat[1:].view(2, 96, 128, 32)
    assert maps.data_ptr() % 16 and twin.vector_width(
        maps.dtype, 32, maps.data_ptr()) == 1
    boxes = torch.tensor([BOXES, BOXES[::-1]], device=dev)
    got = twin.crop_and_resize_window(maps, boxes, 7)
    assert torch.equal(got, twin.crop_and_resize_window(maps.clone(),
                                                        boxes, 7))
    want = twin.crop_and_resize_window_plain(maps, boxes, 7).float()
    assert (got.float() - want).abs().max() <= 1e-2 * want.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("shape,md,s2,dtype", [
    ((1, 350, 400, 32), 5, 1, "float32"),    # the main path, D = 11
    ((2, 61, 77, 32), 10, 2, "float32"),     # D = 11 at stride 2, odd map
    ((1, 45, 67, 16), 10, 1, "float32"),     # D = 21
    ((3, 40, 72, 8), 5, 1, "float32"),       # N = 3, C = 8
    ((1, 33, 51, 16), 5, 1, "float32"),      # C = 16, odd map
    ((1, 33, 50, 64), 5, 1, "float32"),      # C = 64
    ((2, 64, 96, 32), 5, 2, "float32"),      # D = 5 at stride 2
    ((1, 30, 41, 16), 7, 3, "float32"),      # stride 3: run-time strips
    ((1, 70, 90, 8), 30, 3, "float32"),      # D = 21, a two-stage ring
    ((2, 47, 81, 32), 5, 1, "bfloat16"),     # bf16 inputs
])
def test_correlation_kernel_matches_twin_at_every_shape(dev, shape, md, s2,
                                                        dtype):
    """B4 (one launch) against the twin on the inputs' f32 values: f32
    sums of C products in another order, 1e-5. bf16 inputs give an f32
    volume."""
    g = torch.Generator().manual_seed(16)
    a, b = (torch.randn(shape, generator=g).to(dev, getattr(torch, dtype))
            for _ in range(2))
    before = tcorr._CF_KERNEL.launches
    got = tcorr.correlation_cf(a, b, md, s2)
    assert tcorr._CF_KERNEL.launches == before + 1
    want = tcorr.correlation_cf_plain(a.float(), b.float(), md, s2)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_corr_bottleneck_kernel_matches_twin(dev):
    """f32 sums in another order: 1e-5."""
    g = torch.Generator().manual_seed(2)
    a = torch.randn(2, 30, 41, 16, generator=g).to(dev)
    b = torch.randn(2, 30, 41, 16, generator=g).to(dev)
    w = torch.randn(121, 2, generator=g).to(dev)
    got = tcorr.corr_bottleneck(a, b, w, 5)
    want = tcorr.corr_bottleneck_plain(a, b, w, 5)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,md,s2", [((2, 30, 41, 16), 5, 1),
                                         ((1, 17, 70, 8), 4, 2)])
def test_correlation_kernel_matches_twin(dev, shape, md, s2):
    """f32 sums of C products in another order: 1e-5. The (H, W, D^2)
    op is the same volume with its axis moved; the CUDA route's
    gradients are the twin's."""
    g = torch.Generator().manual_seed(3)
    a = torch.randn(shape, generator=g).to(dev)
    b = torch.randn(shape, generator=g).to(dev)
    before = tcorr._CF_KERNEL.launches
    got = tcorr.correlation_cf(a, b, md, s2)
    assert tcorr._CF_KERNEL.launches == before + 1
    want = tcorr.correlation_cf_plain(a, b, md, s2)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(tcorr.correlation(a, b, md, s2),
                               want.movedim(1, -1), rtol=1e-5, atol=1e-5)
    w = torch.randn(got.shape, generator=g).to(dev)
    ga, gb = (x.clone().requires_grad_() for x in (a, b))
    pa, pb = (x.clone().requires_grad_() for x in (a, b))
    (tcorr.correlation_cf(ga, gb, md, s2) * w).sum().backward()
    (tcorr.correlation_cf_plain(pa, pb, md, s2) * w).sum().backward()
    torch.testing.assert_close(ga.grad, pa.grad, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(gb.grad, pb.grad, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_corr_bottleneck_gradients_are_the_twins(dev):
    """B3 on the card carries a grad_fn; its gradients w.r.t. a, b and
    the weights (the blur form's VJP, corr_bottleneck_vjp) are the
    twin's autograd (1e-5)."""
    g = torch.Generator().manual_seed(4)
    a, b = (torch.randn(1, 30, 41, 16, generator=g).to(dev)
            for _ in range(2))
    w = torch.randn(121, 1, generator=g).to(dev)
    cot = torch.randn(1, 1, 30, 41, generator=g).to(dev)
    kern = [x.clone().requires_grad_() for x in (a, b, w)]
    before = tcorr._KERNEL.launches
    out = tcorr.corr_bottleneck(*kern, 5)
    assert tcorr._KERNEL.launches == before + 1 and out.grad_fn is not None
    (out * cot).sum().backward()
    twins = [x.clone().requires_grad_() for x in (a, b, w)]
    (tcorr.corr_bottleneck_plain(*twins, 5) * cot).sum().backward()
    for got, want in zip(kern, twins):
        torch.testing.assert_close(got.grad, want.grad, rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.cuda
def test_conv_chain_gradients_are_the_twins(dev):
    """B1 on the card carries a grad_fn; its backward is the twin's
    autograd from the saved inputs, so the gradients equal the twin's
    up to cuDNN's summation order (1e-4 of their range)."""
    g = torch.Generator().manual_seed(5)
    x = torch.relu(torch.randn(1, 12, 20, 32, generator=g)).to(
        dev, torch.bfloat16).requires_grad_()
    ws = [(torch.randn(co, ci, 3, 3, generator=g) / (3 * ci ** 0.5)).to(dev)
          .requires_grad_() for ci, co in ((32, 64), (64, 16))]
    bs = [(0.1 * torch.randn(co, generator=g)).to(dev).requires_grad_()
          for co in (64, 16)]
    cot = torch.randn(1, 12, 20, 16, generator=g).to(dev)
    out = tcc.conv_chain(x, ws, bs)
    assert out.grad_fn is not None
    (out.float() * cot).sum().backward()
    px = x.detach().clone().requires_grad_()
    pws = [w.detach().clone().requires_grad_() for w in ws]
    pbs = [b.detach().clone().requires_grad_() for b in bs]
    (tcc.conv_chain_plain(px, pws, pbs).float() * cot).sum().backward()
    for got, want in zip([x, *ws, *bs], [px, *pws, *pbs]):
        scale = want.grad.float().abs().max()
        assert (got.grad.float() - want.grad.float()).abs().max() \
            <= 1e-4 * scale + 1e-6


@pytest.mark.cuda
def test_roi_window_refuses_gradients(dev):
    """B2 has no gradient in either package: its CUDA route raises when
    one is required, and runs under no_grad."""
    maps = torch.randn(1, 96, 128, 32, device=dev, requires_grad=True)
    boxes = torch.tensor([BOXES], device=dev)
    with pytest.raises(RuntimeError, match="no gradient"):
        twin.crop_and_resize_window(maps, boxes, 7)
    with torch.no_grad():
        assert twin.crop_and_resize_window(maps, boxes, 7).shape == (
            1, len(BOXES), 7, 7, 32)


def _chain(g, dev, shape, chans):
    x = torch.relu(torch.randn(shape, generator=g)).to(dev, torch.bfloat16)
    ws = [(torch.randn(co, ci, 3, 3, generator=g) / (9 * ci) ** 0.5).to(dev)
          for ci, co in zip(chans[:-1], chans[1:])]
    bs = [(0.1 * torch.randn(co, generator=g)).to(dev) for co in chans[1:]]
    return x, ws, bs


@pytest.mark.cuda
@pytest.mark.parametrize("shape,chans", [
    ((1, 88, 100, 128), (128, 256, 256, 256)),     # BEV conv4
    ((2, 88, 100, 128), (128, 256, 256, 256)),     # both frames at once
    ((1, 45, 150, 128), (128, 256, 256, 256)),     # image conv4
    ((4, 30, 20, 16), (16, 16)),                   # the small config's
    ((1, 37, 53, 24), (24, 40, 8))])               # odd map, BN 8
def test_conv_chain_kernel_matches_twin_at_model_shapes(dev, shape, chans):
    """The wgmma kernel at the towers' full-width conv4 shapes, the small
    config's Co = 16 and an odd-sized map: one launch per stage, within
    2e-2 of the range of the twin (bf16 rounded once per stage)."""
    x, ws, bs = _chain(torch.Generator().manual_seed(10), dev, shape, chans)
    before = tcc._KERNEL.launches
    got = tcc.conv_chain(x, ws, bs).float()
    assert tcc._KERNEL.launches == before + len(ws)
    want = tcc.conv_chain_plain(x, ws, bs).float()
    assert got.shape == want.shape == shape[:3] + (chans[-1],)
    assert (got - want).abs().max() <= 2e-2 * want.abs().max()


@pytest.mark.cuda
def test_conv_chain_repacks_after_a_weight_update(dev):
    """The cached pack follows an in-place update of the weights and the
    biases (an optimiser step): the kernel then matches the twin on the
    new parameters, not the old."""
    g = torch.Generator().manual_seed(11)
    x, ws, bs = _chain(g, dev, (1, 24, 32, 32), (32, 64, 32))
    old = tcc.conv_chain(x, ws, bs).float()
    with torch.no_grad():
        ws[1].mul_(-1.0)
        bs[0].add_(0.5)
    got = tcc.conv_chain(x, ws, bs).float()
    want = tcc.conv_chain_plain(x, ws, bs).float()
    assert (got - want).abs().max() <= 2e-2 * want.abs().max()
    assert (got - old).abs().max() > 0.1 * want.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("md,s2", [(5, 1), (2, 1), (5, 2), (2, 2), (9, 1)])
@pytest.mark.parametrize("cb", [1, 2, 3, 4])
def test_corr_bottleneck_kernel_matches_twin_at_every_cb(dev, md, s2, cb):
    """D = 11 (the main path), D = 5 (the small config), stride_2 = 2 and
    a displacement past the compiled instances (d = 9, the run-time
    loops), Cb = 1..4, at B = 2 on an odd-sized map: one launch, within
    1e-4 of the twin's range (f32 sums in another order)."""
    g = torch.Generator().manual_seed(12)
    _, d = tcorr.disp_grid(md, s2)
    a, b = (torch.randn(2, 37, 45, 16, generator=g).to(dev)
            for _ in range(2))
    w = (torch.randn(d * d, cb, generator=g) / d).to(dev)
    before = tcorr._KERNEL.launches
    got = tcorr.corr_bottleneck(a, b, w, md, s2)
    assert tcorr._KERNEL.launches == before + 1
    want = tcorr.corr_bottleneck_plain(a, b, w, md, s2,
                                       tcorr.grid_origin(md, s2))
    assert got.shape == want.shape == (2, cb, 37, 45)
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("md,s2", [(5, 2), (3, 2)])
def test_corr_bottleneck_kernel_on_both_grids(dev, md, s2):
    """Where max_displacement % stride_2 != 0: the model's op and the
    kernel's wrapper each launch the kernel on the blur's grid
    (grid_origin 1) and equal the twin there, 1e-4 of the range (f32
    sums in another order); the twin on the centred grid parts from
    it."""
    g = torch.Generator().manual_seed(15)
    _, d = tcorr.disp_grid(md, s2)
    a, b = (torch.randn(2, 37, 45, 8, generator=g).to(dev)
            for _ in range(2))
    w = (torch.randn(d * d, 2, generator=g) / d).to(dev)
    origin = tcorr.grid_origin(md, s2)
    assert origin == 1
    before = tcorr._KERNEL.launches
    blur_grid = tcorr.corr_bottleneck(a, b, w, md, s2)
    direct = tcorr.corr_bottleneck_cuda(a, b, w, md, s2)
    assert tcorr._KERNEL.launches == before + 2
    want = tcorr.corr_bottleneck_plain(a, b, w, md, s2, origin)
    want_c = tcorr.corr_bottleneck_plain(a, b, w, md, s2)
    for got in (blur_grid, direct):
        assert (got - want).abs().max() <= 1e-4 * want.abs().max()
    assert (want - want_c).abs().max() > 0.1 * want.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("md,s2,cb", [(2, 1, 1), (5, 2, 3)])
def test_corr_bottleneck_gradients_are_the_twins_at_other_shapes(dev, md,
                                                                 s2, cb):
    """The kernel forward with the blur form's VJP as its backward:
    gradients w.r.t. a, b and the weights equal the twin's autograd
    (1e-5), off the model's grid too (stride_2 = 2, Cb = 3)."""
    g = torch.Generator().manual_seed(13)
    _, d = tcorr.disp_grid(md, s2)
    a, b = (torch.randn(2, 21, 34, 8, generator=g).to(dev) for _ in range(2))
    w = torch.randn(d * d, cb, generator=g).to(dev)
    cot = torch.randn(2, cb, 21, 34, generator=g).to(dev)
    kern = [x.clone().requires_grad_() for x in (a, b, w)]
    (tcorr.corr_bottleneck(*kern, md, s2) * cot).sum().backward()
    twins = [x.clone().requires_grad_() for x in (a, b, w)]
    (tcorr.corr_bottleneck_plain(*twins, md, s2, tcorr.grid_origin(md, s2))
     * cot).sum().backward()
    for got, want in zip(kern, twins):
        torch.testing.assert_close(got.grad, want.grad, rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("md,s2,cb", [(5, 1, 1), (5, 2, 3)])
def test_corr_bottleneck_blur_matches_twin(dev, md, s2, cb):
    """The blur form (a cuDNN depthwise conv and a reduce) on the card:
    within 1e-4 of the twin's range (f32 sums in another order), and it
    launches no B3 kernel."""
    g = torch.Generator().manual_seed(14)
    _, d = tcorr.disp_grid(md, s2)
    a, b = (torch.randn(2, 37, 45, 16, generator=g).to(dev)
            for _ in range(2))
    w = (torch.randn(d * d, cb, generator=g) / d).to(dev)
    before = tcorr._KERNEL.launches
    got = tcorr.corr_bottleneck_blur(a, b, w, md, s2)
    assert tcorr._KERNEL.launches == before
    want = tcorr.corr_bottleneck_plain(a, b, w, md, s2,
                                       tcorr.grid_origin(md, s2))
    assert got.shape == want.shape == (2, cb, 37, 45)
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()


@pytest.mark.cuda
def test_resize_backward_is_reproducible(dev):
    """The BEV bottleneck's upsample at the flagship's shape, (2, 350,
    400, 1) -> (700, 800) f32: its backward run twice from one input and
    cotangent is bit-equal (it gathers; F.interpolate's CUDA backward
    sums with atomics), and forward and gradient are the CPU's to 1e-6
    of the range (two-tap f32 sums in the same order)."""
    from dodt_tpu_torch.ops.resize import resize_bilinear
    g = torch.Generator().manual_seed(16)
    x = torch.randn(2, 350, 400, 1, generator=g)
    cot = torch.randn(2, 700, 800, 1, generator=g)
    grads = []
    for _ in range(2):
        xd = x.to(dev).requires_grad_()
        out = resize_bilinear(xd, (700, 800))
        out.backward(cot.to(dev))
        grads.append(xd.grad)
    assert torch.equal(grads[0], grads[1])
    xc = x.clone().requires_grad_()
    want = resize_bilinear(xc, (700, 800))
    want.backward(cot)
    assert (out.detach().cpu() - want.detach()).abs().max() <= \
        1e-6 * want.abs().max()
    assert (grads[0].cpu() - xc.grad).abs().max() <= 1e-6 * \
        xc.grad.abs().max()
