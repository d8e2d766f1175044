"""daam_tpu_torch against daam_tpu at real channel geometry: ``v2-1-base``
(320/640/1280/1280, OpenCLIP-H) and ``xl-base-1.0`` (CLIP-L and
OpenCLIP-bigG, depth-(1, 2, 10) transformers, ``add_embedding``).

The weights are ``daam_tpu``'s host init from seed 0 in bfloat16, made again
by the port's ``init_random_params`` (bit for bit, ``test_torch_params_io``)
and cast up to fp32 on both sides:

* the port's UNet with the ``'acc'`` capture, its text encoders and its VAE
  decoder against ``daam_tpu``'s modules on the same inputs, through
  ``from_jax_params``, at 16² latents as ``tests/test_full_geometry.py``
  runs its UNet (spatial size does not enter the weight mapping): fp32,
  rtol 1e-4, with values near zero held to 1e-4 of the output's largest
  magnitude (23 or 32 fp32 layers summed in other orders leave ~1e-5 on
  O(1) outputs, where a wrong transpose, eps or activation moves them by
  O(1));
* the port's whole traced pipeline on the CPU against the goldens
  ``tests/make_torch_goldens.py`` made with ``daam_tpu`` (512², 10 steps;
  1024², 2 steps): weight sums equal, the golden's initial latents
  injected, images within 2/255, maps per token at Spearman ≥ 0.99 and
  ``tests/test_e2e_fidelity_torch.py::_assert_close``.

Multi-GB (SDXL: ~7 GB of bf16 weights, ~14 GB in fp32 per package), so it
runs only with ``DAAM_FULL_GEOMETRY=1`` (or ``DAAM_FULL_SPATIAL=1``), as
``tests/test_full_geometry.py`` gates itself:

    DAAM_FULL_GEOMETRY=1 python -m pytest tests/test_torch_full_geometry.py
"""

import gc
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from daam_tpu.models.clip import CLIPTextEncoder
from daam_tpu.models.unet import UNet2DConditionModel as JaxUNet
from daam_tpu.models.vae import AutoencoderKL as JaxVAE
from daam_tpu.ops.pallas_attention import cross_acc_shape
from daam_tpu_torch import trace
from daam_tpu_torch.models import weights as W
from daam_tpu_torch.models.configs import cross_attention_layout, get_pipeline_config
from daam_tpu_torch.pipeline.sd import _pipeline_class
from daam_tpu_torch.tokenization import default_tokenizer

import make_torch_goldens as G
from test_e2e_fidelity_torch import _assert_close as _maps_close, _spearman

FULL_SPATIAL = os.environ.get('DAAM_FULL_SPATIAL') == '1'
FULL_GEOMETRY = FULL_SPATIAL or os.environ.get('DAAM_FULL_GEOMETRY') == '1'
pytestmark = pytest.mark.skipif(
    not FULL_GEOMETRY, reason='full-width weights (SDXL ~14 GB in fp32): set '
                              'DAAM_FULL_GEOMETRY=1')

RTOL = 1e-4
SPATIAL = 16


def _assert_close(ours, theirs, err_msg=''):
    """fp32 rtol 1e-4, and atol 1e-4 of the reference's largest value."""
    theirs = np.asarray(theirs)
    np.testing.assert_allclose(ours, theirs, rtol=RTOL,
                               atol=RTOL * float(np.abs(theirs).max()),
                               err_msg=err_msg)


@pytest.fixture(scope='module', params=list(G.CASES))
def weights(request):
    """(config, the goldens' weights: bf16 host tensors)."""
    config = get_pipeline_config(request.param)
    yield config, W.init_random_params(config, seed=G.SEED)
    gc.collect()


def _jax_fp32(tree):
    return {k: _jax_fp32(v) if isinstance(v, dict) else jnp.asarray(v.float().numpy())
            for k, v in tree.items()}


def _port_module(name, config, tree):
    return W._load_module(name, config, W.from_jax_params({name: tree})[name],
                          'cpu', torch.float32)


def _added(config, rng, batch):
    """SDXL's text_time conditioning inputs, or None."""
    if config.unet.addition_embed_type is None:
        return None
    return {'text_embeds': rng.randn(batch, config.text_2.projection_dim).astype(np.float32),
            'time_ids': np.tile(np.array([1024, 1024, 0, 0, 1024, 1024], np.float32),
                                (batch, 1))}


def test_unet_acc_capture_at_full_width(weights):
    """eps and every captured layer's accumulator after two calls on a CFG
    batch of 16² latents, each call at its own timestep."""
    config, params = weights
    cfg = config.unet
    rng = np.random.RandomState(0)
    sample = rng.randn(2, SPATIAL, SPATIAL, cfg.in_channels).astype(np.float32)
    ctx = rng.randn(2, 77, cfg.cross_attention_dim).astype(np.float32)
    added = _added(config, rng, 2)
    layout = cross_attention_layout(cfg)

    acc_jax = {i.name: jnp.zeros(cross_acc_shape(1, i.heads, (SPATIAL // i.downscale) ** 2,
                                                 77), jnp.float32) for i in layout}
    unet_jax, theirs = JaxUNet(cfg), []
    jax_params = _jax_fp32(params['unet'])
    for t in (901, 301):
        eps, acc_jax = unet_jax.apply(
            {'params': jax_params}, jnp.asarray(sample), jnp.full((2,), t),
            jnp.asarray(ctx), capture='acc', acc=acc_jax,
            added_cond=None if added is None else
            {k: jnp.asarray(v) for k, v in added.items()})
        theirs.append(np.asarray(eps))
    acc_jax = {n: np.asarray(a) for n, a in acc_jax.items()}
    del jax_params, unet_jax
    gc.collect()

    unet = _port_module('unet', config, params['unet'])
    acc = {i.name: torch.zeros(1, i.heads, 77, (SPATIAL // i.downscale) ** 2)
           for i in layout}
    for t, eps in zip((901, 301), theirs):
        with torch.no_grad():
            ours = unet(torch.from_numpy(sample).permute(0, 3, 1, 2), torch.full((2,), t),
                        torch.from_numpy(ctx), capture='acc', acc=acc,
                        added_cond=None if added is None else
                        {k: torch.from_numpy(v) for k, v in added.items()})
        _assert_close(ours.permute(0, 2, 3, 1).numpy(), eps)
    assert set(acc) == set(acc_jax) == set(unet.layer_names())
    for name, a in acc.items():
        hw = a.shape[-1]
        _assert_close(a.numpy(), acc_jax[name][:, :, :77, :hw], name)


def test_text_encoders_at_full_width(weights):
    """Each text encoder's last hidden states, penultimate states (SDXL's
    context) and pooled output on the prompt and the empty prompt."""
    config, params = weights
    for name in ('text_encoder', 'text_encoder_2'):
        if name not in params:
            continue
        text = config.text if name == 'text_encoder' else config.text_2
        tok = default_tokenizer(pad_id=0 if name == 'text_encoder_2' else None)
        ids = np.asarray(tok([G.PROMPT, ''], padding='max_length',
                             return_tensors='np')['input_ids'])
        encoder_jax = CLIPTextEncoder(text)
        jax_params = _jax_fp32(params[name])
        module = _port_module(name, config, params[name])
        for penultimate in (False, True):
            theirs = encoder_jax.apply({'params': jax_params}, jnp.asarray(ids),
                                       penultimate=penultimate)
            with torch.no_grad():
                ours = module(torch.from_numpy(ids).long(), penultimate=penultimate)
            for a, b in zip(ours, theirs):
                assert (a is None) == (b is None)
                if a is not None:
                    _assert_close(a.numpy(), b, f'{name} {penultimate}')


def test_vae_decoder_at_full_width(weights):
    config, params = weights
    z = np.random.RandomState(1).randn(1, SPATIAL, SPATIAL,
                                       config.vae.latent_channels).astype(np.float32)
    theirs = JaxVAE(config.vae).apply({'params': _jax_fp32(params['vae'])},
                                      jnp.asarray(z), method=JaxVAE.decode)
    vae = _port_module('vae', config, params['vae'])
    with torch.no_grad():
        ours = vae.decode(torch.from_numpy(z).permute(0, 3, 1, 2))
    _assert_close(ours.permute(0, 2, 3, 1).numpy(), theirs)


def test_pipeline_matches_daam_tpu_golden(weights):
    """The traced fp32 DDIM pipeline from the golden's initial latents:
    weight sums equal, each step's latents printed against the golden's,
    the image within 2/255, the maps at Spearman ≥ 0.99 per token and
    ``_assert_close``."""
    config, params = weights
    with np.load(G.OUT_DIR / f'{config.name}.npz') as g:
        golden = {k: g[k] for k in g.files}
    sums = W.param_sums(params)
    assert [sums[n] for n in golden['module_names']] == golden['module_sums'].tolist()

    # the last test of the preset: each module's bf16 tree is dropped as its
    # fp32 module is built, so SDXL holds ~14 GB here rather than ~28
    pipe = _pipeline_class(config)(config, **{
        name: _port_module(name, config, params.pop(name)) for name in list(params)})
    np.testing.assert_array_equal(pipe._encode_tokens([G.PROMPT])[0].numpy(),
                                  golden['token_ids'])
    stepped = []
    with trace(pipe) as tc:
        out = pipe(G.PROMPT, num_inference_steps=len(golden['latents']),
                   latents=golden['latents_init'], output_type='np', callback_steps=1,
                   callback=lambda i, t, latents: stepped.append(latents.numpy().copy()))
        maps = tc.compute_global_heat_map().heat_maps.numpy()
    errs = [float(np.abs(a - b).max()) for a, b in zip(stepped, golden['latents'])]
    print(f'{config.name} latents max abs err by step: {errs}')
    image = np.clip(out.images[0] * 255 + 0.5, 0, 255).astype(np.uint8)
    assert np.abs(image.astype(int) - golden['image'].astype(int)).max() <= 2
    assert maps.shape == golden['heat_maps'].shape
    print(f'{config.name} maps min Spearman: '
          f'{min(_spearman(a, b) for a, b in zip(maps, golden["heat_maps"])):.6f}')
    _maps_close(maps, golden['heat_maps'])
