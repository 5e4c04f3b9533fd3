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
    the weights are the twin's autograd (1e-5)."""
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
