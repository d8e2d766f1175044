"""daam_tpu_torch.models.weights: the daam_tpu → diffusers inverse, and init.

``from_jax_params`` must be the exact inverse of daam_tpu's diffusers
converters: a diffusers state dict converted by ``_convert_*`` comes back key
for key and bit for bit.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from daam_tpu.models.vae import AutoencoderKL as JaxVAE
from daam_tpu.models.weights import _convert_clip, _convert_unet, _convert_vae
from daam_tpu_torch.models import weights as W
from daam_tpu_torch.models.configs import get_pipeline_config

from test_weights_conversion import _fabricate_unet_checkpoint


def _random_state_dict(module: torch.nn.Module, seed: int):
    """A module's state dict filled with distinct random values."""
    rng = np.random.RandomState(seed)
    return {k: rng.randn(*v.shape).astype(np.float32)
            for k, v in module.state_dict().items()}


def _assert_same(ours, theirs):
    assert sorted(ours) == sorted(theirs)
    for k in theirs:
        assert ours[k].shape == theirs[k].shape, k
        np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)


@pytest.mark.parametrize('preset', ['tiny', 'tiny-v1', 'tiny-xl'])
def test_unet_round_trip(preset):
    """'tiny' has linear proj_in/out (SD2), 'tiny-v1' 1×1 convs (SD1),
    'tiny-xl' SDXL's add_embedding and depth-2 transformers."""
    cfg = get_pipeline_config(preset).unet
    sd = _fabricate_unet_checkpoint(cfg)
    back = W.from_jax_params({'unet': _convert_unet(sd, cfg)})['unet']
    _assert_same(back, sd)


def test_clip_round_trip():
    modules = W.build_modules(get_pipeline_config('tiny'), device='cpu')
    sd = _random_state_dict(modules['text_encoder'], seed=1)
    back = W.from_jax_params({'text_encoder': _convert_clip(dict(sd))})
    _assert_same(back['text_encoder'], sd)


def test_vae_round_trip_and_encoder_skip_list():
    """Encoder and decoder keys come back exactly: nothing is skipped any
    more.  daam_tpu's full VAE (encoder subtree included) converts to every
    key of the port's full VAE, and its decoder-only tree to the keys of the
    decode-only VAE that build_modules gives."""
    from daam_tpu_torch.models.vae import AutoencoderKL

    config = get_pipeline_config('tiny')
    sd = _random_state_dict(AutoencoderKL(config.vae), seed=2)
    assert 'quant_conv.weight' in sd and any(k.startswith('encoder.') for k in sd)
    back = W.from_jax_params({'vae': _convert_vae(dict(sd), config.vae)})['vae']
    _assert_same(back, sd)

    vae = JaxVAE(config.vae)
    x = jnp.zeros((1, 16, 16, 3))
    shapes = jax.eval_shape(vae.init, jax.random.PRNGKey(0), x,
                            jax.random.PRNGKey(1))['params']
    full = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    assert 'encoder' in full
    keys = W.from_jax_params({'vae': full})['vae']
    assert {k: v.shape for k, v in keys.items()} == {k: v.shape for k, v in sd.items()}
    decoder_only = W.from_jax_params({'vae': {'decoder': full['decoder']}})['vae']
    modules = W.build_modules(config, device='cpu')
    assert sorted(decoder_only) == sorted(modules['vae'].state_dict())
    assert all(k.startswith(('decoder.', 'post_quant_conv.')) for k in decoder_only)


def test_init_random_shapes_and_scale_rule():
    """init_random's modules carry exactly the converted daam_tpu key set
    and shapes, strict-load into fresh modules, and follow the scale rule
    (norm scales 1, biases 0, weights with std fan_in^-½)."""
    from daam_tpu.models.weights import _init_random_params_host

    config = get_pipeline_config('tiny')
    gen = torch.Generator().manual_seed(0)
    modules = W.init_random(config, gen, device='cpu')
    jax_sd = W.from_jax_params(_init_random_params_host(config, 0, jnp.float32))
    fresh = W.build_modules(config, device='cpu')
    for name, module in modules.items():
        sd = module.state_dict()
        assert {k: tuple(v.shape) for k, v in sd.items()} == \
            {k: v.shape for k, v in jax_sd[name].items()}, name
        fresh[name].load_state_dict(sd, strict=True)

    unet = modules['unet']
    block = unet.down_blocks[0].attentions[0].transformer_blocks[0]
    assert torch.all(block.norm1.weight == 1) and torch.all(block.norm1.bias == 0)
    assert torch.all(unet.conv_in.bias == 0)
    w = unet.up_blocks[0].resnets[0].conv1.weight  # (64, 128, 3, 3)
    fan_in = w.shape[1] * 9
    assert abs(w.std().item() * fan_in ** 0.5 - 1.0) < 0.05
    emb = modules['text_encoder'].text_model.embeddings.token_embedding.weight
    assert abs(emb.std().item() * emb.shape[0] ** 0.5 - 1.0) < 0.05


def test_init_random_dtype_and_seed():
    config = get_pipeline_config('tiny')
    a = W.init_random(config, torch.Generator().manual_seed(5), device='cpu',
                      dtype=torch.bfloat16)
    b = W.init_random(config, torch.Generator().manual_seed(5), device='cpu',
                      dtype=torch.bfloat16)
    wa, wb = a['unet'].conv_in.weight, b['unet'].conv_in.weight
    assert wa.dtype == torch.bfloat16
    assert torch.equal(wa, wb)


def _entry_points():
    from daam_tpu_torch import StableDiffusionPipeline
    from daam_tpu_torch.utils import set_seed
    return {'from_pretrained': StableDiffusionPipeline.from_pretrained,
            'build_modules': W.build_modules, 'init_random': W.init_random,
            'load_modules': W.load_modules, 'set_seed': set_seed}


@pytest.mark.parametrize('name', ['from_pretrained', 'build_modules',
                                  'init_random', 'load_modules', 'set_seed'])
def test_entry_points_default_to_the_card(name):
    """The port runs on the card unless the caller asks for the CPU."""
    import inspect
    fn = _entry_points()[name]
    assert inspect.signature(fn).parameters['device'].default == 'cuda'


def test_default_device_raises_without_a_card():
    """Without a card a default call raises; it never falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present: the default call succeeds')
    from daam_tpu_torch.utils import set_seed
    with pytest.raises((RuntimeError, AssertionError)):
        set_seed(0)
    with pytest.raises((RuntimeError, AssertionError)):
        W.build_modules(get_pipeline_config('tiny'))
    assert set_seed(0, device='cpu').device.type == 'cpu'
