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
    ((2, 64, 96, 32), 5, 2, "float32"),      # D = 5 at stride 2, origin 1
    ((1, 30, 41, 16), 7, 3, "float32"),      # stride 3: run-time strips
    ((1, 70, 90, 8), 30, 3, "float32"),      # D = 21, a two-stage ring
    ((2, 47, 81, 32), 5, 1, "bfloat16"),     # bf16 inputs
    ((1, 37, 53, 32), 3, 2, "float32"),      # D = 3 at stride 2, origin 1
])
def test_correlation_kernel_matches_twin_at_every_shape(dev, shape, md, s2,
                                                        dtype):
    """B4 (one launch) against the twin at the Pallas kernel's grid
    origin on the inputs' f32 values: f32 sums of C products in another
    order, 1e-5. The volume comes back in the input dtype: bf16 inputs
    give the f32 kernel's volume cast to bf16."""
    g = torch.Generator().manual_seed(16)
    a, b = (torch.randn(shape, generator=g).to(dev, getattr(torch, dtype))
            for _ in range(2))
    before = tcorr._CF_KERNEL.launches
    got = tcorr.correlation_cf(a, b, md, s2)
    assert tcorr._CF_KERNEL.launches == before + 1
    assert got.dtype == a.dtype
    vol = tcorr.correlation_cf_cuda(a.float().contiguous(),
                                    b.float().contiguous(), md, s2)
    assert torch.equal(got, vol.to(a.dtype))
    want = tcorr.correlation_cf_plain(a.float(), b.float(), md, s2,
                                      tcorr.grid_origin(md, s2))
    torch.testing.assert_close(vol, want, rtol=1e-5, atol=1e-5)


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
    want = tcorr.correlation_cf_plain(a, b, md, s2, tcorr.grid_origin(md, s2))
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


# ------------------------------------------- the exact NMS's fixpoint


def _nms_case(g, lead, n):
    """Car-sized normalised BEV boxes in clusters (so that they overlap),
    scores on a 1/16 lattice (many exact ties) and a fifth of the rows
    invalid, with leading axes ``lead``."""
    centres = torch.rand(lead + (n // 8 + 1, 2), generator=g) * 0.9 + 0.05
    pick = torch.randint(0, centres.shape[-2], lead + (n,), generator=g)
    c = torch.gather(centres, -2, pick[..., None].expand(lead + (n, 2)))
    c = c + 0.01 * torch.randn(lead + (n, 2), generator=g)
    half = (torch.rand(lead + (n, 2), generator=g) * 2.0 + 1.0) / 70.0
    boxes = torch.cat([c - half, c + half], -1)
    scores = torch.round(torch.rand(lead + (n,), generator=g) * 16) / 16
    valid = torch.rand(lead + (n,), generator=g) > 0.2
    return boxes, scores, valid


@pytest.mark.cuda
@pytest.mark.parametrize("n", [300, 301, 1200, 1500, 4096])
@pytest.mark.parametrize("thresh", [0.01, 0.8])
@pytest.mark.parametrize("lead", [(1, 2), (2,)])
def test_nms_fixpoint_kernel_matches_plain(dev, n, thresh, lead):
    """The kernel's supp, and nms_bev_exact's (indices, valid), are the
    plain loop's bit for bit: N = 301 packs a byte a lane, 300 and 1500
    4 bytes, 1200 and 4096 16 bytes (1200 with half a word beyond N);
    1500 and 4096 keep the packed rows in global scratch (beyond 1344
    rows)."""
    from dodt_tpu_torch.ops import nms
    g = torch.Generator().manual_seed(n + int(100 * thresh) + len(lead))
    boxes, scores, valid = (t.to(dev) for t in _nms_case(g, lead, n))
    s, dom = nms._dominance(boxes, scores, valid, thresh)
    before = nms._KERNEL.launches
    got = nms.fixpoint(dom)
    assert nms._KERNEL.launches == before + 1
    want = nms.fixpoint_plain(dom)
    assert torch.equal(got, want)
    assert torch.equal(got.cpu(), nms.fixpoint_plain(dom.cpu()))
    max_out = min(n, 300)
    gi, gv = nms.nms_bev_exact(boxes, scores, valid, max_out, thresh)
    wi, wv = nms._top_kept(s, valid, want, max_out)
    assert torch.equal(gi, wi) and torch.equal(gv, wv)
    assert bool(want.any()) and not bool(want.all())


# ------------------------------------------- the second stage's graphs


def _full_width(dev, num_frames):
    """The flagship pair (cars_dt_tracking) or the single-frame detector
    (cars_single_frame) at 65536 points, seeded weights, on the card."""
    from dodt_tpu_torch.config import cars_dt_tracking, cars_single_frame
    from dodt_tpu_torch.data.clusters import DEFAULT_CAR_CLUSTERS
    from dodt_tpu_torch.models.dt_avod import DtAvodNet, init_params
    cfg = cars_dt_tracking() if num_frames == 2 else cars_single_frame()
    cfg.dataset.max_points = 65536
    model = DtAvodNet(cfg, DEFAULT_CAR_CLUSTERS, num_frames=num_frames)
    init_params(model, torch.Generator().manual_seed(0))
    return cfg, model.to(dev).eval()


def _batches(cfg, dev, num_frames, seeds=(0, 1, 2)):
    import numpy as np
    from dodt_tpu_torch.data.synthetic_scan import make_batch
    out = []
    for s in seeds:
        b = make_batch(cfg, np.random.RandomState(s))
        out.append({k: torch.as_tensor(
            v[:, :num_frames] if k in ("points", "points_valid", "image")
            else v, device=dev) for k, v in b.items()})
    return out


def _kernels():
    from dodt_tpu_torch.ops import correlation, nms, roi_window
    return {"b2": roi_window._KERNEL, "b3": correlation._KERNEL,
            "nms": nms._KERNEL}


def _same(got, want):
    assert set(got) == set(want)
    for k in want:
        if want[k] is None:
            assert got[k] is None, k
        else:
            assert torch.equal(got[k], want[k]), k


def _eager_on_last_inputs(model, expand, keys=None):
    """The stage run eagerly on the inputs of the last replay (the
    graph's own input buffers)."""
    from dodt_tpu_torch.models.dt_avod import _TrainCtx
    (entry,) = model.graphs._entries.values()
    *args, bev_w, img_w = entry.inputs
    with torch.no_grad():
        out = model._second_stage(*args, expand,
                                  _TrainCtx(bev_w=bev_w, img_w=img_w))
    return out if keys is None else {k: out[k] for k in keys}


def _check_replays(model, calls, expand, keys, eager=None):
    """``calls`` (one per call, inputs in turn) replay after the first:
    one capture, the counters, the launches of B2, B3 (the pair) and the
    NMS kernel on every replay, each replay equal to the stage run
    eagerly on its inputs (``eager()``, by default
    ``_eager_on_last_inputs``), and a result held from call i unchanged
    by call i + 1. Returns the last output."""
    if eager is None:
        def eager():
            return _eager_on_last_inputs(model, expand, keys)
    kernels = _kernels()
    held, deltas, out = None, [], None
    for i, call in enumerate(calls):
        before = {k: c.launches for k, c in kernels.items()}
        out = call()
        torch.cuda.synchronize()
        deltas.append({k: c.launches - before[k] for k, c in kernels.items()})
        assert (model.graphs.captures, model.graphs.replays,
                model.graphs.eager) == (1, i, 1)
        _same({k: out[k] for k in keys}, eager())
        if held is not None:
            _same(held[0], held[1])
        held = (out, {k: None if v is None else v.clone()
                      for k, v in out.items()})
    assert all(d == deltas[0] for d in deltas), deltas
    assert deltas[0]["b2"] >= 1 and deltas[0]["nms"] >= 1
    assert deltas[0]["b3"] == int(getattr(model, "correlates", False))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("num_frames", [2, 1])
def test_forward_replays_equal_eager_calls(dev, num_frames):
    """The monolithic val forward of the paired and the single-frame
    presets on three inputs in turn: the second stage replays, equal bit
    for bit to the stage run eagerly on each call's inputs and to the
    forward run again with the cache cleared; a replaced weight tensor
    is captured again."""
    from dodt_tpu_torch.models.dt_avod import FINAL_KEYS
    cfg, model = _full_width(dev, num_frames)
    batches = _batches(cfg, dev, num_frames)
    order = [0, 1, 2, 0, 1]
    stage_keys = [k for k in FINAL_KEYS if num_frames == 2
                  or k != "final_corr_offsets"] + ["proposal_boxes_3d",
                                                   "cls_logits"]
    outs = []
    _check_replays(model, [
        (lambda s=s: outs.append(model(batches[s], mode="val")) or outs[-1])
        for s in order], cfg.model.expand_proposals_xz, stage_keys)
    model.graphs.clear()
    _same(model(batches[order[-1]], mode="val"), outs[-1])
    assert model.graphs.captures == 2

    lin = model.avod_fc.out0
    lin.weight = torch.nn.Parameter(lin.weight.detach() * 2.0)
    out = model(batches[0], mode="val")
    assert model.graphs.captures == 3 and len(model.graphs._entries) == 1
    _same({k: out[k] for k in stage_keys},
          _eager_on_last_inputs(model, cfg.model.expand_proposals_xz,
                                stage_keys))
    assert not torch.equal(out["cls_logits"], outs[0]["cls_logits"])


def _sync_free(events, outer):
    """The CPU ``outer`` spans of a profile, none of which holds a
    runtime *Synchronize call."""
    spans = [e.time_range for e in events if e.name == outer
             and e.device_type == torch.autograd.DeviceType.CPU]
    return spans and not [
        e.name for e in events if "Synchronize" in e.name and any(
            r.start <= e.time_range.start <= r.end for r in spans)]


@pytest.mark.cuda
def test_pair_stage_replays_equal_eager_calls(dev):
    """The stream's pair stage over three pairs in turn: replays equal to
    the stage run eagerly on the same states and to a call with the
    cache cleared, with no host sync inside a replayed call (the sync
    debug mode raises on one, as the control shows; the profiler records
    no runtime *Synchronize and the replay's span)."""
    from torch.profiler import ProfilerActivity, profile
    from dodt_tpu_torch.models.dt_avod import FINAL_KEYS
    cfg, model = _full_width(dev, 2)
    states = [[model.encode_frame({k: v[:, f] if k in (
        "points", "points_valid", "image") else v for k, v in b.items()})
        for f in range(2)] for b in _batches(cfg, dev, 2)]
    order = [0, 1, 2, 0]
    _check_replays(model, [(lambda s=s: model.pair_stage(*states[s]))
                           for s in order], 0.0, FINAL_KEYS)
    with torch.no_grad():
        a, b = states[1]
        want = model._second_stage(
            *(torch.stack([a[k], b[k]], 1) for k in (
                "bev_feats", "img_feats", "top_anchors", "top_valid")),
            a["ground_plane"], a["p2"], a["orig_image_shape"].float(), 0.0)
    _same(model.pair_stage(a, b), {k: want[k] for k in FINAL_KEYS})

    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with pytest.raises(RuntimeError):
            torch.equal(a["top_valid"], b["top_valid"])
        model.pair_stage(a, b)
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        model.pair_stage(a, b)
    events = prof.events()
    assert "dodt/graph_replay" in [e.name for e in events]
    assert _sync_free(events, "dodt/second_stage")
    model.graphs.clear()
    _same(model.pair_stage(a, b), {k: want[k] for k in FINAL_KEYS})


# the outputs of the Stack's second stage (models/stack._second_stage)
STACK_STAGE_KEYS = (
    "proposal_4c", "cls_logits", "box_offsets", "angle_vectors",
    "coexist_logits", "corr_pred", "pred_boxes_3d", "final_indices",
    "final_valid", "final_boxes_3d", "final_orientations",
    "final_cls_softmax", "final_scores", "final_corr_offsets",
    "final_coexist")


def _stack_full_width(dev):
    """The Stack model as the cell cars_stack.stack_detect builds it:
    cars_dt_tracking(data_stride=3) with model_name stack_avod_model (4
    frames), here at 65536 points, seeded weights with the regression
    outputs of the RPN and the second stage scaled by 1e-2, on the
    card."""
    from dodt_tpu_torch.config import cars_dt_tracking
    from dodt_tpu_torch.data.clusters import DEFAULT_CAR_CLUSTERS
    from dodt_tpu_torch.models.dt_avod import init_params
    from dodt_tpu_torch.models.stack import StackAvodNet
    cfg = cars_dt_tracking(data_stride=3)
    cfg.model.model_name = "stack_avod_model"
    cfg.dataset.max_points = 65536
    model = StackAvodNet(cfg, DEFAULT_CAR_CLUSTERS)
    init_params(model, torch.Generator().manual_seed(0))
    with torch.no_grad():
        model.rpn_reg.out.weight.mul_(1e-2)
        model.avod_fc.out1.weight.mul_(1e-2)
    return cfg, model.to(dev).eval()


def _stacks(cfg, dev, seeds):
    """One 4-frame stack per seed: the couples of two draws in turn."""
    import numpy as np
    from dodt_tpu_torch.data.synthetic_scan import make_batch
    per_frame = ("points", "points_valid", "image")
    out = []
    for s in seeds:
        a, b = (make_batch(cfg, np.random.RandomState(s + d))
                for d in (0, 1000))
        out.append({k: torch.as_tensor(
            np.concatenate([a[k], b[k]], 1) if k in per_frame else a[k],
            device=dev) for k in a})
    return out


def _stack_eager_on_last_inputs(model):
    """The Stack's stage run eagerly on the graph's own input buffers."""
    (entry,) = model.graphs._entries.values()
    with torch.no_grad():
        out = model._second_stage(*entry.inputs)
    assert set(out) == set(STACK_STAGE_KEYS)
    return out


@pytest.mark.cuda
def test_stack_forward_replays_equal_eager_calls(dev):
    """The Stack's val forward over four stacks of different draws: one
    capture, then replays, each equal bit for bit to the stage run
    eagerly on its inputs, a held result unchanged by the next call, the
    forward equal to one run with the cache cleared; a replaced weight
    of the trunk or of the correlation head is captured again; a traced
    call holds the replay inside ``dodt/second_stage`` and no host sync
    there."""
    from torch.profiler import ProfilerActivity, profile
    cfg, model = _stack_full_width(dev)
    stacks = _stacks(cfg, dev, (0, 1, 2, 3))
    outs = []
    _check_replays(model, [
        (lambda s=s: outs.append(model(stacks[s], mode="val")) or outs[-1])
        for s in range(4)], 0.0, STACK_STAGE_KEYS,
        eager=lambda: _stack_eager_on_last_inputs(model))
    assert int(outs[-1]["final_valid"].sum()) > 0
    model.graphs.clear()
    _same(model(stacks[3], mode="val"), outs[-1])
    assert model.graphs.captures == 2

    for n, lin in enumerate((model.avod_fc.out0,
                             model.stack_corr.corr_cls.out)):
        lin.weight = torch.nn.Parameter(lin.weight.detach() * 2.0)
        out = model(stacks[3], mode="val")
        assert model.graphs.captures == 3 + n
        assert len(model.graphs._entries) == 1
        _same({k: out[k] for k in STACK_STAGE_KEYS},
              _stack_eager_on_last_inputs(model))
        key = ("cls_logits", "coexist_logits")[n]
        assert not torch.equal(out[key], outs[-1][key]), key

    (entry,) = model.graphs._entries.values()
    sources = tuple(t.clone() for t in entry.inputs)
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.no_grad():
            model._run_second_stage(sources, False, None)
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        model(stacks[0], mode="val")
    events = prof.events()
    names = [e.name for e in events]
    assert "dodt/graph_replay" in names and "dodt/stack_corr" not in names
    # host spans only: a span's device-side interval ends when the card
    # finishes its work, after the host has left the span
    cpu = torch.autograd.DeviceType.CPU
    replays = [e.time_range for e in events if e.name == "dodt/graph_replay"
               and e.device_type == cpu]
    stages = [e.time_range for e in events if e.name == "dodt/second_stage"
              and e.device_type == cpu]
    assert replays and all(any(r.start <= p.start and p.end <= r.end
                               for r in stages) for p in replays)
    assert _sync_free(events, "dodt/second_stage")


def _toy_stage(dev, seed):
    """A toy stage (two linear layers) on the card, and its inputs: a
    pair of (5, 4) frames, and a weight."""
    g = torch.Generator().manual_seed(seed)
    toy = torch.nn.Sequential(torch.nn.Linear(4, 3),
                              torch.nn.Linear(3, 2)).to(dev)
    a, b, w = (torch.randn(s, generator=g).to(dev)
               for s in ((5, 4), (5, 4), (1,)))

    def fn(x, w):
        return {"y": toy(x) * w}
    return toy, fn, (a, b), w


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["draws", "tp"])
def test_graph_cache_call_counts_eager_calls_with_draws_or_tp(dev, case):
    """With draws, or with a tensor-parallel layer (``tp`` set) in the
    stage, ``GraphCache.call`` runs eagerly on the card, counts each call
    in ``eager`` and captures nothing."""
    from dodt_tpu_torch.models.graphs import GraphCache
    toy, fn, (a, b), w = _toy_stage(dev, 6)
    rand = None
    if case == "tp":
        toy[1].tp = object()
    else:
        def rand(name, shape):
            return torch.rand(shape, device=dev)
    cache = GraphCache()
    with torch.no_grad():
        for i in (1, 2):
            got = cache.call(fn, ((a, b), w), "toy", [toy], rand)
            assert (cache.captures, cache.replays, cache.eager,
                    len(cache._entries)) == (0, 0, i, 0)
            _same(got, fn(torch.stack([a, b], 1), w))


@pytest.mark.cuda
def test_graph_cache_call_replays_a_toy_stage(dev):
    """Without grad, draws or ``tp`` a toy stage is captured once, then
    replayed, each call equal to the stage run eagerly on its inputs."""
    from dodt_tpu_torch.models.graphs import GraphCache
    toy, fn, _, _ = _toy_stage(dev, 7)
    cache = GraphCache()
    with torch.no_grad():
        for i, seed in enumerate((8, 9, 10)):
            _, _, (a, b), w = _toy_stage(dev, seed)
            got = cache.call(fn, ((a, b), w), "toy", [toy], None)
            assert (cache.captures, cache.replays, cache.eager) == (1, i, 1)
            _same(got, fn(torch.stack([a, b], 1), w))
