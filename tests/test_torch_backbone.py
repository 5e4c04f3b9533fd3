"""The port's VGG-pyramid tower against the JAX tower, with converted
weights, on the CPU in float32.

The JAX tower runs its TPU layouts (space-to-depth stem and interior,
packed sub-pixel decoder, the conv-chain block); the port computes the
same function as plain convolutions, so the outputs agree to f32
summation-order rounding (1e-4 on O(1) activations after ~12 convs)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dodt_tpu.config import FeatureExtractorConfig
from dodt_tpu.models import backbone as jbb
from dodt_tpu_torch import config as port_config
from dodt_tpu_torch.convert import flax_to_state_dict
from dodt_tpu_torch.models import backbone as tbb

FLAGSHIP = FeatureExtractorConfig(conv1=(2, 8), conv2=(2, 8), conv3=(2, 16),
                                  conv4=(3, 16))


@pytest.mark.parametrize("cfg,shape", [
    # the flagship flags: s2d stem + interior, decode stride 2, fused conv4;
    # H and W off the multiple of 8 (top/left padding, sliced back)
    (FLAGSHIP, (1, 44, 42, 6)),
    (FLAGSHIP, (2, 36, 50, 3)),
    # plain layouts: nested conv1 parameters, full-resolution decoder
    (dataclasses.replace(FLAGSHIP, s2d_stem=False, s2d_interior=False,
                         decode_stride=1, fused_interior=()),
     (1, 44, 42, 6)),
    # the plain tower: conv4 resized 4x (decode stride 2) and 8x (1) by
    # jax.image.resize against F.interpolate; the s2d flags do not apply
    (dataclasses.replace(FLAGSHIP, pyramid=False), (1, 44, 42, 6)),
    (dataclasses.replace(FLAGSHIP, pyramid=False, decode_stride=1),
     (2, 36, 50, 3)),
    # GroupNorm(min(8, ch)) after every conv and up-conv, GroupNorm_{k}
    # in Flax's call order; no s2d stem and no conv-chain block
    (dataclasses.replace(FLAGSHIP, norm="gn"), (1, 44, 42, 6)),
    (dataclasses.replace(FLAGSHIP, norm="gn", decode_stride=1),
     (2, 36, 50, 3)),
    (dataclasses.replace(FLAGSHIP, norm="gn", pyramid=False, conv4=(2, 4)),
     (1, 44, 42, 6)),
])
def test_vgg_pyramid_matches_jax(cfg, shape):
    rng = np.random.RandomState(0)
    x = rng.randn(*shape).astype(np.float32)
    jt = jbb.VggPyramid(cfg, dtype=jnp.float32)
    # seeded weights of the Flax tree's shapes; every leaf random (a
    # GroupNorm's too), so a misnamed leaf of the same shape shows
    shapes = jax.eval_shape(jt.init, jax.random.PRNGKey(1),
                            jnp.asarray(x))["params"]
    params = jax.tree_util.tree_map(
        lambda s: (rng.randn(*s.shape) / np.sqrt(np.prod(s.shape[:-1]))
                   if len(s.shape) > 1 else 1.0 + 0.1 * rng.randn(*s.shape)
                   ).astype(np.float32), shapes)
    want = np.asarray(jax.jit(jt.apply)({"params": params}, jnp.asarray(x)))

    tcfg = port_config.FeatureExtractorConfig(**dataclasses.asdict(cfg))
    tt = tbb.VggPyramid(tcfg, in_channels=shape[-1], dtype=torch.float32)
    tt.load_state_dict(flax_to_state_dict(jax.tree_util.tree_map(
        np.asarray, params)), strict=True)
    with torch.no_grad():
        got = tt(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_preprocess_image_matches_jax():
    img = np.random.RandomState(2).randint(0, 256, (1, 4, 5, 3)).astype(
        np.uint8)
    np.testing.assert_allclose(
        tbb.preprocess_image(torch.from_numpy(img)).numpy(),
        np.asarray(jbb.preprocess_image(jnp.asarray(img))), atol=1e-5)
