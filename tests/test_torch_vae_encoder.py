"""The VAE encoder of daam_tpu_torch against daam_tpu's, in fp32.

Both packages get the same full VAE params (daam_tpu's init of the encoder
and decoder, with biases and norm scales jittered so that a misplaced one
shows) through ``from_jax_params``, and the same numpy pixels.  The
posterior's mean, logvar and ``mode()`` must agree at rtol 1e-4 on ``tiny``
and on SD 2.1's VAE geometry (128/256/512/512) at 64²; ``sample`` must be
``mean + std·ε`` for the ε its generator draws, and ``forward`` the decode
of that sample.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from daam_tpu.models.vae import AutoencoderKL as JaxVAE
from daam_tpu_torch.models import weights as W
from daam_tpu_torch.models.configs import get_pipeline_config
from daam_tpu_torch.models.vae import AutoencoderKL

RTOL, ATOL = 1e-4, 1e-5


def jax_vae_params(vae_config, seed: int = 0):
    """daam_tpu's params of the whole VAE (encoder and decoder), as numpy
    arrays, with every 1-D leaf (biases, norm scales) jittered."""
    vae = JaxVAE(vae_config)
    x = jnp.zeros((1, 16, 16, vae_config.in_channels))
    params = jax.jit(vae.init)(jax.random.PRNGKey(seed), x,
                               jax.random.PRNGKey(seed + 1))['params']
    rng = np.random.RandomState(seed + 2)

    def jitter(leaf):
        leaf = np.asarray(leaf)
        if leaf.ndim != 1:
            return leaf
        return leaf + 0.1 * rng.randn(*leaf.shape).astype(np.float32)

    return jax.tree_util.tree_map(jitter, params)


def _both(preset, seed):
    cfg = get_pipeline_config(preset).vae
    params = jax_vae_params(cfg, seed)
    vae = AutoencoderKL(cfg)
    vae.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
                         W.from_jax_params({'vae': params})['vae'].items()},
                        strict=True)
    return cfg, params, vae.eval()


@pytest.mark.parametrize('preset,side', [('tiny', 16), ('v2-1-base', 64)])
def test_encode_matches_daam_tpu(preset, side):
    cfg, params, vae = _both(preset, seed=3)
    x = np.random.RandomState(0).uniform(-1, 1, (2, side, side, 3)).astype(np.float32)
    jvae = JaxVAE(cfg)
    theirs = jvae.apply({'params': params}, jnp.asarray(x), method=JaxVAE.encode)
    with torch.no_grad():
        ours = vae.encode(torch.from_numpy(x).permute(0, 3, 1, 2))
    latent = side // cfg.scale_factor
    assert tuple(ours.mean.shape) == (2, cfg.latent_channels, latent, latent)
    for a, b in ((ours.mean, theirs.mean), (ours.logvar, theirs.logvar),
                 (ours.mode(), theirs.mode()), (ours.std, theirs.std)):
        np.testing.assert_allclose(a.permute(0, 2, 3, 1).numpy(), np.asarray(b),
                                   rtol=RTOL, atol=ATOL)
    assert ours.logvar.min() >= -30 and ours.logvar.max() <= 20


def test_sample_and_forward_with_the_same_noise():
    cfg, params, vae = _both('tiny', seed=4)
    x = np.random.RandomState(1).uniform(-1, 1, (1, 16, 16, 3)).astype(np.float32)
    theirs = JaxVAE(cfg).apply({'params': params}, jnp.asarray(x),
                               method=JaxVAE.encode)
    with torch.no_grad():
        post = vae.encode(torch.from_numpy(x).permute(0, 3, 1, 2))
        sample = post.sample(torch.Generator().manual_seed(9))
        image = vae(torch.from_numpy(x).permute(0, 3, 1, 2),
                    torch.Generator().manual_seed(9))
        decoded = vae.decode(sample)
    noise = torch.randn(post.mean.shape, generator=torch.Generator().manual_seed(9))
    expect = np.asarray(theirs.mean) + np.asarray(theirs.std) * \
        noise.permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(sample.permute(0, 2, 3, 1).numpy(), expect,
                               rtol=RTOL, atol=ATOL)
    assert torch.equal(image, decoded)
    assert image.shape == (1, 3, 16, 16) and image.dtype == torch.float32


def test_logvar_clamp():
    from daam_tpu_torch.models.vae import DiagonalGaussian

    params = torch.tensor([0.5, -100.0, 100.0, 1.0]).reshape(1, 4, 1, 1)
    post = DiagonalGaussian(params)
    assert post.mean.flatten().tolist() == [0.5, -100.0]
    assert post.logvar.flatten().tolist() == [20.0, 1.0]
    assert torch.allclose(post.std, torch.exp(0.5 * post.logvar))
