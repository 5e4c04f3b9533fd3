"""Times of B3's blur form and of its VJP (B3's backward) in three
layouts, beside the twin's autograd, at the main path's shape (1, 350,
400, 32) f32, d = 5, Cb = 1, on one card with TF32 off:
  nchw           ops.correlation.corr_bottleneck_blur as the port runs
                 it: the depthwise conv on a contiguous NCHW copy;
  channels_last  the same conv on the permuted NHWC map (cuDNN's NHWC
                 depthwise conv);
  folded         the C channels folded into the batch: one conv of
                 (B C, 1, H, W) with the (Cb, 1, D, D) weights;
and ``twin``, the VJP through corr_bottleneck_plain's autograd. Each
form is first held against corr_bottleneck_plain (1e-4 of its range).

    python3 probes/b3_blur_forms.py

Prints one JSON line: per form the forward's and the VJP's ``ms``
(cuda_time_ms: CUDA events around back-to-back calls) and the VJP's
``device_ms`` (chip_smoke.timed: queued behind torch.cuda._sleep)."""
import json
import os
import sys

sys.path.insert(0, os.getcwd())
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import chip_smoke  # noqa: E402
from dodt_tpu_torch.ops import correlation as corr  # noqa: E402


def blur_channels_last(a, b, weights, md, s2=1):
    nb, h, w, c = a.shape
    radius, d = corr.disp_grid(md, s2)
    cb = weights.shape[1]
    span = radius * s2
    kern = weights.t().reshape(cb, 1, d, d).repeat(c, 1, 1, 1)
    b_pad = F.pad(b.permute(0, 3, 1, 2), (span,) * 4)
    bw = F.conv2d(b_pad, kern, dilation=s2, groups=c)
    bw = bw.permute(0, 2, 3, 1).reshape(nb, h, w, c, cb)
    return torch.einsum("nhwc,nhwck->nkhw", a, bw) / c


def blur_folded(a, b, weights, md, s2=1):
    nb, h, w, c = a.shape
    radius, d = corr.disp_grid(md, s2)
    cb = weights.shape[1]
    span = radius * s2
    kern = weights.t().reshape(cb, 1, d, d)
    b_pad = F.pad(b.permute(0, 3, 1, 2).reshape(nb * c, 1, h, w),
                  (span,) * 4)
    bw = F.conv2d(b_pad, kern, dilation=s2).reshape(nb, c, cb, h, w)
    return torch.einsum("nchw,nckhw->nkhw", a.permute(0, 3, 1, 2), bw) / c


def vjp_of(fn):
    def vjp(a, b, w, grad, md, s2=1):
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in (a, b, w)]
            return torch.autograd.grad(fn(*leaves, md, s2), leaves, grad)
    return vjp


def main():
    if not torch.cuda.is_available():
        print("b3_blur_forms: no CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    g = torch.Generator().manual_seed(0)
    a, b = (torch.randn((1, 350, 400, 32), generator=g).to(dev)
            for _ in range(2))
    w = (torch.randn((121, 1), generator=g) / 11.0).to(dev)
    cot = torch.randn((1, 1, 350, 400), generator=g).to(dev)
    want = corr.corr_bottleneck_plain(a, b, w, 5)
    forms = {"nchw": corr.corr_bottleneck_blur,
             "channels_last": blur_channels_last, "folded": blur_folded}
    res = {"card": torch.cuda.get_device_name(0)}
    for name, fn in forms.items():
        e, scale = chip_smoke.rel_err(fn(a, b, w, 5), want)
        if e > 1e-4 * scale:
            print(f"b3_blur_forms: {name} disagrees: {e}", file=sys.stderr)
            return 1
        vjp = corr.corr_bottleneck_vjp if name == "nchw" else vjp_of(fn)
        res[name] = {
            "max_abs_err": e,
            "fwd_ms": chip_smoke.cuda_time_ms(lambda: fn(a, b, w, 5)),
            "vjp_ms": chip_smoke.cuda_time_ms(
                lambda: vjp(a, b, w, cot, 5), n_timed=5),
            "vjp_device_ms": chip_smoke.timed(
                lambda: vjp(a, b, w, cot, 5), n_timed=5)["device_ms"]}
    res["twin"] = {"vjp_ms": chip_smoke.cuda_time_ms(
        lambda: chip_smoke.twin_vjp(a, b, w, cot, 5), n_timed=5)}
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
