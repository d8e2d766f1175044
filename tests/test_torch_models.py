"""The port's models against daam_tpu's, on the ``tiny`` preset.

``daam_tpu`` random params go through ``from_jax_params`` into the port's
modules (``strict=True``); the same numpy inputs go through both.  fp32,
rtol 1e-4 (atol 1e-5 for values near zero): the two frameworks run the same
fp32 arithmetic in different orders, and the gap stays orders of magnitude
below what a wrong transpose, eps or activation would give.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from daam_tpu.models.clip import CLIPTextEncoder
from daam_tpu.models.unet import UNet2DConditionModel as JaxUNet
from daam_tpu.models.vae import AutoencoderKL as JaxVAE
from daam_tpu.models.weights import _init_random_params_host
from daam_tpu.ops.pallas_attention import cross_acc_shape
from daam_tpu_torch.models import weights as W
from daam_tpu_torch.models.configs import cross_attention_layout, get_pipeline_config
from daam_tpu_torch.tokenization import default_tokenizer

RTOL, ATOL = 1e-4, 1e-5


def jax_params(config, seed: int = 0):
    """daam_tpu random params (its host init: weights ~ N(0, fan_in^-½)),
    with the biases and norm scales it leaves at 0 and 1 drawn at random too,
    so that a misplaced bias or scale shows."""
    import jax

    params = _init_random_params_host(config, seed=seed, dtype=jnp.float32)
    rng = np.random.RandomState(seed + 1)

    def jitter(x):
        if x.ndim != 1:
            return x
        return x + jnp.asarray(0.1 * rng.randn(*x.shape).astype(np.float32))

    return jax.tree_util.tree_map(jitter, params)


@pytest.fixture(scope='module')
def tiny():
    config = get_pipeline_config('tiny')
    params = jax_params(config)
    modules = W.load_modules(config, W.from_jax_params(params), device='cpu')
    return config, params, modules


def test_clip_matches_daam_tpu(tiny):
    config, params, modules = tiny
    tok = default_tokenizer()
    ids = np.asarray(tok(['a dog runs across the field', ''],
                         padding='max_length', return_tensors='np')['input_ids'])
    theirs, theirs_pooled = CLIPTextEncoder(config.text).apply(
        {'params': params['text_encoder']}, jnp.asarray(ids))
    with torch.no_grad():
        ours, pooled = modules['text_encoder'](torch.from_numpy(ids).long())
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(pooled.numpy(), np.asarray(theirs_pooled),
                               rtol=RTOL, atol=ATOL)


def test_unet_acc_capture_matches_daam_tpu(tiny):
    """eps and every layer's 'acc' accumulator after two UNet calls on the
    CFG batch [uncond; cond], each call at its own timestep."""
    config, params, modules = tiny
    cfg = config.unet
    rng = np.random.RandomState(0)
    s = cfg.sample_size
    sample = rng.randn(2, s, s, cfg.in_channels).astype(np.float32)  # NHWC
    ctx = rng.randn(2, 77, cfg.cross_attention_dim).astype(np.float32)

    layout = cross_attention_layout(cfg)
    acc_jax = {i.name: jnp.zeros(cross_acc_shape(1, i.heads, (s // i.downscale) ** 2, 77),
                                 jnp.float32) for i in layout}
    acc = {i.name: torch.zeros(1, i.heads, 77, (s // i.downscale) ** 2)
           for i in layout}
    unet_jax = JaxUNet(cfg)
    for t in (901, 301):
        theirs, acc_jax = unet_jax.apply(
            {'params': params['unet']}, jnp.asarray(sample),
            jnp.full((2,), t), jnp.asarray(ctx), capture='acc', acc=acc_jax)
        with torch.no_grad():
            ours = modules['unet'](torch.from_numpy(sample).permute(0, 3, 1, 2),
                                   torch.full((2,), t), torch.from_numpy(ctx),
                                   capture='acc', acc=acc)
        assert ours.dtype == torch.float32
        np.testing.assert_allclose(ours.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(theirs), rtol=RTOL, atol=ATOL)
    assert set(acc) == set(acc_jax) == set(modules['unet'].layer_names())
    for name, a in acc.items():
        hw = a.shape[-1]
        np.testing.assert_allclose(a.numpy(), np.asarray(acc_jax[name])[:, :, :77, :hw],
                                   rtol=RTOL, atol=ATOL, err_msg=name)


def test_vae_decode_matches_daam_tpu(tiny):
    config, params, modules = tiny
    rng = np.random.RandomState(1)
    z = rng.randn(1, 8, 8, config.vae.latent_channels).astype(np.float32)
    theirs = JaxVAE(config.vae).apply({'params': params['vae']}, jnp.asarray(z),
                                      method=JaxVAE.decode)
    with torch.no_grad():
        ours = modules['vae'].decode(torch.from_numpy(z).permute(0, 3, 1, 2))
    np.testing.assert_allclose(ours.permute(0, 2, 3, 1).numpy(), np.asarray(theirs),
                               rtol=RTOL, atol=ATOL)
