"""The reference's copy of ``dodt_tpu_torch/models/backbone.py``: every
convolution contracts at the reference's precision (``lowp.contract``)
and the conv chain takes its plain form. What follows is the original
docstring.

VGG-pyramid feature towers (PyTorch port of
dodt_tpu/models/backbone.py).

Encoder conv1-4 with 2x2 max-pools, decoder of stride-2 transposed convs
with skip concat + 3x3 fusion convs. Inputs are zero-padded top/left to a
multiple of 8 and sliced back after the decoder.

The JAX tower's space-to-depth stem and interior (``s2d_stem``,
``s2d_interior``) are TPU layouts of exactly the plain conv + ReLU +
max-pool function, so the port computes them as plain convolutions
(cuDNN on the card) and keeps only their parameter names: the s2d stem
holds flat ``conv1_{i}_kernel`` / ``conv1_{i}_bias`` parameters, every
other conv a ``{name}_{i}`` module with ``weight``/``bias``. Blocks named
in ``fused_interior`` (conv4 in the flagship) run through the conv-chain
kernel (ops/conv_chain.py) unless ``forward`` is called with
``fused=False``: training runs plain convolutions there, as the JAX model
does (``fused = ()`` in train mode, dt_avod.py:389-394). Public layout
is NHWC; inside, NCHW (channels-last memory on the card, so the
conv-chain hand-off is a view).

Two variants of the JAX tower: ``pyramid=False`` is the plain VGG
(encoder only, conv4 resized bilinearly to the decoder stride, no skip
decoder), and ``norm="gn"`` puts Flax's ``GroupNorm(min(8, ch))`` after
every conv and up-conv, named ``GroupNorm_{k}`` in Flax's call order;
with it the tower takes neither the s2d stem's names nor the
conv-chain kernel (JAX backbone.py:261-271).
"""
from __future__ import annotations

from typing import Iterator, List, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .config import FeatureExtractorConfig
from .lowp import contract, product
from .resize import resize_bilinear

KITTI_IMAGE_MEANS = (92.8403, 97.7996, 93.5843)  # img_feature_extractor.py:8


def tower_channels(cfg: FeatureExtractorConfig) -> int:
    """Channels of a tower's output: conv1's for the pyramid, conv4's
    for the plain tower."""
    return cfg.conv1[1] if cfg.pyramid else cfg.conv4[1]


class GroupNorm(nn.Module):
    """Flax ``nn.GroupNorm`` over channels-last (B, ..., C):
    ``num_groups`` groups, statistics over every axis but the batch in
    float32 with epsilon 1e-6 (torch's default is 1e-5) and var = E[x^2]
    - E[x]^2, the result cast back to the input dtype (Flax's compute
    ``dtype``)."""

    def __init__(self, channels: int, num_groups: int = 1,
                 eps: float = 1e-6):
        super().__init__()
        self.num_groups = num_groups
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(torch.float32)
        b, c, g = x.shape[0], x.shape[-1], self.num_groups
        grouped = xf.reshape(b, -1, g, c // g)
        mean = grouped.mean(dim=(1, 3), keepdim=True)
        mean2 = (grouped * grouped).mean(dim=(1, 3), keepdim=True)
        var = torch.clamp(mean2 - mean * mean, min=0.0)
        shape = (b,) + (1,) * (x.dim() - 2) + (c,)
        mean = mean.expand(b, 1, g, c // g).reshape(shape)
        mul = torch.rsqrt(var + self.eps).expand(b, 1, g, c // g
                                                 ).reshape(shape)
        return ((xf - mean) * (mul * self.weight) + self.bias).to(x.dtype)


class ConvParams(nn.Module):
    """Weight (Co, Ci, k, k) and bias (Co,) of one convolution."""

    def __init__(self, ci: int, co: int, k: int = 3):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(co, ci, k, k))
        self.bias = nn.Parameter(torch.zeros(co))


class SubpixelConvTranspose(ConvParams):
    """Transposed 3x3 conv, stride 2, SAME, in its sub-pixel form: one
    dense 2x2 conv produces the four output phases as channels, which
    ``pixel_shuffle`` interleaves. The phase kernels are those of the
    JAX module (backbone.py:221-236, pinned there against Flax's
    ConvTranspose); ``F.conv_transpose2d`` flips its kernel differently
    and is not this function. Parameters match nn.ConvTranspose's."""

    def forward(self, x: torch.Tensor, dtype: str) -> torch.Tensor:
        k = self.weight.to(torch.float32)                # (co, ci, 3, 3)
        co, ci = k.shape[0], k.shape[1]
        k2 = torch.zeros((co, 4, ci, 2, 2), dtype=torch.float32,
                         device=k.device)
        k2[:, 0] = k[:, :, ::2, ::2]          # phase (0, 0)
        k2[:, 1, :, :, 1] = k[:, :, ::2, 1]   # phase (0, 1)
        k2[:, 2, :, 1, :] = k[:, :, 1, ::2]   # phase (1, 0)
        k2[:, 3, :, 1, 1] = k[:, :, 1, 1]     # phase (1, 1)
        y = product(F.conv2d(contract(F.pad(x, (1, 0, 1, 0)), dtype),
                             contract(k2.reshape(co * 4, ci, 2, 2), dtype)),
                    dtype)
        return F.pixel_shuffle(y, 2) + self.bias.float()[:, None, None]


class VggPyramid(nn.Module):
    """Encoder-decoder pyramid tower, or the plain encoder: (B, H, W,
    Cin) -> (B, H/s, W/s, ``tower_channels(cfg)``) at the decoder stride
    s, in the compute dtype."""

    def __init__(self, cfg: FeatureExtractorConfig, in_channels: int,
                 dtype: str = "float32"):
        super().__init__()
        if cfg.decode_stride not in (1, 2):
            raise ValueError(f"decode_stride {cfg.decode_stride}")
        if cfg.norm not in ("none", "gn"):
            raise ValueError(f"norm {cfg.norm!r}")
        self.cfg = cfg
        self.dtype = dtype
        self.gn = cfg.norm == "gn"
        self.s2d_stem = (cfg.s2d_stem and cfg.decode_stride == 2
                         and cfg.pyramid and not self.gn)
        (n1, ch1), (n2, ch2), (n3, ch3), (n4, ch4) = (
            cfg.conv1, cfg.conv2, cfg.conv3, cfg.conv4)
        # the norm after each conv, in the order the forward calls them
        self._norms: List[str] = []
        ci = in_channels
        for i in range(n1):
            if self.s2d_stem:
                self.register_parameter(
                    f"conv1_{i}_kernel",
                    nn.Parameter(torch.empty(ch1, ci, 3, 3)))
                self.register_parameter(f"conv1_{i}_bias",
                                        nn.Parameter(torch.zeros(ch1)))
            else:
                self.add_module(f"conv1_{i}", ConvParams(ci, ch1))
            ci = ch1
        self._add_norms(n1, ch1)
        for name, num, ch in (("conv2", n2, ch2), ("conv3", n3, ch3),
                              ("conv4", n4, ch4)):
            for i in range(num):
                self.add_module(f"{name}_{i}", ConvParams(ci, ch))
                ci = ch
            self._add_norms(num, ch)
        if not cfg.pyramid:
            return
        self.upconv3 = SubpixelConvTranspose(ch4, ch3)
        self.pyramid_fusion3_0 = ConvParams(2 * ch3, ch2)
        self.upconv2 = SubpixelConvTranspose(ch2, ch2)
        self.pyramid_fusion2_0 = ConvParams(2 * ch2, ch1)
        self._add_norms(1, ch3)
        self._add_norms(2, ch2)
        self._add_norms(1, ch1)
        if cfg.decode_stride == 1:
            self.upconv1 = SubpixelConvTranspose(ch1, ch1)
            self.pyramid_fusion1_0 = ConvParams(2 * ch1, ch1)
            self._add_norms(2, ch1)

    def _add_norms(self, num: int, ch: int) -> None:
        """With ``norm="gn"``, the next ``num`` GroupNorms of ``ch``
        channels, named as Flax names them."""
        for _ in range(num if self.gn else 0):
            name = f"GroupNorm_{len(self._norms)}"
            self.add_module(name, GroupNorm(ch, min(8, ch)))
            self._norms.append(name)

    def _norm_relu(self, h: torch.Tensor, norms: Iterator[str]
                   ) -> torch.Tensor:
        """ReLU, after the next of ``norms`` with ``norm="gn"``."""
        if self.gn:
            norm = getattr(self, next(norms))
            h = norm(h.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
        return F.relu(h)

    def _params(self, name: str, num: int) -> List[Tuple[torch.Tensor,
                                                         torch.Tensor]]:
        if name == "conv1" and self.s2d_stem:
            return [(getattr(self, f"conv1_{i}_kernel"),
                     getattr(self, f"conv1_{i}_bias")) for i in range(num)]
        return [(getattr(self, f"{name}_{i}").weight,
                 getattr(self, f"{name}_{i}").bias) for i in range(num)]

    def _block(self, h: torch.Tensor, name: str, num: int, fused: bool,
               norms: Iterator[str]) -> torch.Tensor:
        for w, b in self._params(name, num):
            h = self._norm_relu(product(F.conv2d(
                contract(h, self.dtype), contract(w, self.dtype),
                b.to(torch.float32), padding=1), self.dtype), norms)
        return h

    def forward(self, x: torch.Tensor, fused: bool = True) -> torch.Tensor:
        cfg = self.cfg
        h = x.to(torch.float32).permute(0, 3, 1, 2)
        if h.is_cuda:
            h = h.contiguous(memory_format=torch.channels_last)
        ph = (-h.shape[2]) % 8
        pw = (-h.shape[3]) % 8
        if ph or pw:
            h = F.pad(h, (pw, 0, ph, 0))
        norms = iter(self._norms)

        c1 = self._block(h, "conv1", cfg.conv1[0], fused, norms)
        c2 = self._block(F.max_pool2d(c1, 2), "conv2", cfg.conv2[0], fused,
                         norms)
        c3 = self._block(F.max_pool2d(c2, 2), "conv3", cfg.conv3[0], fused,
                         norms)
        c4 = self._block(F.max_pool2d(c3, 2), "conv4", cfg.conv4[0], fused,
                         norms)
        s = cfg.decode_stride
        if not cfg.pyramid:
            # jax.image.resize "bilinear", deterministic backward
            f = resize_bilinear(c4.permute(0, 2, 3, 1),
                                (h.shape[2] // s, h.shape[3] // s))
            return f[:, ph // s:, pw // s:]

        u3 = self._norm_relu(self.upconv3(c4, self.dtype), norms)
        f3 = self._block(torch.cat([c3, u3], dim=1), "pyramid_fusion3", 1,
                         fused, norms)
        u2 = self._norm_relu(self.upconv2(f3, self.dtype), norms)
        f2 = self._block(torch.cat([c2, u2], dim=1), "pyramid_fusion2", 1,
                         fused, norms)
        if s == 2:
            return f2[:, :, ph // 2:, pw // 2:].permute(0, 2, 3, 1)
        u1 = self._norm_relu(self.upconv1(f2, self.dtype), norms)
        f1 = self._block(torch.cat([c1, u1], dim=1), "pyramid_fusion1", 1,
                         fused, norms)
        return f1[:, :, ph:, pw:].permute(0, 2, 3, 1)


def preprocess_image(image: torch.Tensor) -> torch.Tensor:
    """Subtract the KITTI channel means, in float32 (uint8 images would
    wrap)."""
    means = torch.tensor(KITTI_IMAGE_MEANS, dtype=torch.float32,
                         device=image.device)
    return image.to(torch.float32) - means
