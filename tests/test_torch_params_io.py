"""daam_tpu_torch's params layer against daam_tpu's.

``init_random_params`` must rebuild ``daam_tpu``'s host init bit for bit,
over the key tree ``to_jax_params`` derives from the port's own modules (the
same tree ``jax.eval_shape`` gives at full width); ``to_jax_params`` must
invert ``from_jax_params`` and agree with ``daam_tpu``'s diffusers
converters; ``.npz`` files must cross between the packages; and the
committed goldens (``tests/make_torch_goldens.py``) must load, with the port
tokenizer's ids.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from daam_tpu.models import weights as JW
from daam_tpu.models.clip import CLIPTextEncoder
from daam_tpu.models.unet import UNet2DConditionModel
from daam_tpu.models.vae import AutoencoderKL as JaxVAE
from daam_tpu_torch.models import weights as W
from daam_tpu_torch.models.configs import get_pipeline_config
from daam_tpu_torch.tokenization import default_tokenizer

import make_torch_goldens as G

TINY = ['tiny', 'tiny-v1', 'tiny-xl']


def _bits(leaf) -> np.ndarray:
    """A bf16 or fp32 leaf's raw bit patterns, whichever package made it."""
    if isinstance(leaf, torch.Tensor):
        view = torch.int16 if leaf.dtype == torch.bfloat16 else torch.int32
        return leaf.contiguous().view(view).numpy()
    leaf = np.asarray(leaf)
    return leaf.view(np.int16 if leaf.dtype.itemsize == 2 else np.int32)


def _assert_trees_equal(ours, theirs):
    flat_ours, flat_theirs = dict(W._flatten(ours)), dict(W._flatten(theirs))
    assert list(flat_ours) == list(flat_theirs)
    for key, leaf in flat_theirs.items():
        assert tuple(flat_ours[key].shape) == tuple(leaf.shape), key
        np.testing.assert_array_equal(_bits(flat_ours[key]), _bits(leaf), err_msg=key)


@pytest.fixture(scope='module', params=TINY)
def host_init(request):
    """Both packages' host init of one tiny preset, in bf16."""
    config = get_pipeline_config(request.param)
    return (config, W.init_random_params(config, seed=3),
            JW._init_random_params_host(config, seed=3, dtype=jnp.bfloat16))


def test_init_random_params_equals_daam_tpu_host_init(host_init):
    """Same leaves, in the same order, bit for bit, and so the same module
    sums (what the card checks against a golden's)."""
    _, ours, theirs = host_init
    assert list(ours) == list(theirs)
    _assert_trees_equal(ours, theirs)
    assert all(leaf.dtype == torch.bfloat16 for _, leaf in W._flatten(ours))
    assert W.param_sums(ours) == W.param_sums(theirs)


@functools.lru_cache(maxsize=None)
def _eval_shape(module, *inputs):
    """``jax.eval_shape`` of ``module.init`` (flax modules and their configs
    hash by value, so presets that share an encoder or VAE trace it once)."""
    key = jax.random.PRNGKey(0)
    return jax.eval_shape(module.init, key, *(jnp.zeros(s, d) for s, d in inputs))['params']


def _eval_shape_tree(config):
    """``jax.eval_shape``'s parameter tree, as ``_init_random_params_host``
    builds it (``daam_tpu/models/weights.py:87-116``)."""
    ids = ((1, 77), jnp.int32)
    tree = {'text_encoder': _eval_shape(CLIPTextEncoder(config.text), ids)}
    added = None
    if config.is_sdxl:
        tree['text_encoder_2'] = _eval_shape(CLIPTextEncoder(config.text_2), ids)
        added = {'text_embeds': jnp.zeros((1, config.text_2.projection_dim)),
                 'time_ids': jnp.zeros((1, 6))}
    unet = UNet2DConditionModel(config.unet)
    s = config.unet.sample_size
    tree['unet'] = jax.eval_shape(
        lambda k, a, b, c: unet.init(k, a, b, c, added_cond=added), jax.random.PRNGKey(0),
        jnp.zeros((1, s, s, config.unet.in_channels)), jnp.zeros((1,), jnp.int32),
        jnp.zeros((1, 77, config.unet.cross_attention_dim)))['params']
    vae = JaxVAE(config.vae)
    tree['vae'] = jax.eval_shape(
        lambda k, z: vae.init(k, z, method=JaxVAE.decode), jax.random.PRNGKey(0),
        jnp.zeros((1, s, s, config.vae.latent_channels)))['params']
    return tree


@pytest.mark.parametrize('preset,unet_params', [
    ('v2-1-base', 865_910_724), ('v1', 859_520_964),
    ('v2-1-large', 865_910_724), ('xl-base-1.0', 2_567_463_684)])
def test_key_tree_equals_eval_shape_at_full_width(preset, unet_params):
    """The tree init_random_params fills, from the port's modules on the
    meta device, is jax.eval_shape's: keys, order and shapes."""
    config = get_pipeline_config(preset)
    ours = W.to_jax_params({name: m.state_dict() for name, m in
                            W.build_modules(config, device='meta').items()})
    theirs = _eval_shape_tree(config)
    flat_theirs = [(k, tuple(v.shape)) for k, v in W._flatten(theirs)]
    flat_ours = {k: tuple(v.shape) for k, v in W._flatten(ours)}
    assert dict(flat_theirs) == flat_ours
    assert sum(int(np.prod(s)) for k, s in flat_theirs
               if k.startswith('unet/')) == unet_params


def _full_vae_tree(config, seed):
    """daam_tpu's VAE tree with its encoder, filled with distinct values."""
    vae = JaxVAE(config.vae)
    shapes = jax.eval_shape(vae.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 16, 16, 3)), jax.random.PRNGKey(1))['params']
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda s: rng.randn(*s.shape).astype(np.float32), shapes)


@pytest.mark.parametrize('preset', TINY + ['tiny:vae-with-encoder'])
def test_to_jax_params_inverts_from_jax_params(preset):
    """to_jax ∘ from_jax and from_jax ∘ to_jax are the identity, and
    to_jax_params agrees with daam_tpu's diffusers converters."""
    config = get_pipeline_config(preset.split(':')[0])
    if preset.endswith('vae-with-encoder'):
        params = {'vae': _full_vae_tree(config, seed=5)}
    else:
        # norm scales and biases are constants in the init: make them distinct
        rng = np.random.RandomState(6)
        params = jax.tree_util.tree_map(
            lambda x: x.numpy() + rng.randn(*x.shape).astype(np.float32),
            W.init_random_params(config, seed=5, dtype=torch.float32))
    sds = W.from_jax_params(params)
    back = W.to_jax_params(sds)
    assert list(back) == list(params)
    for name in params:
        flat_back, flat_in = dict(W._flatten(back[name])), dict(W._flatten(params[name]))
        assert sorted(flat_back) == sorted(flat_in), name
        for key, leaf in flat_in.items():
            np.testing.assert_array_equal(flat_back[key], leaf, err_msg=key)
    again = W.from_jax_params(back)
    for name, sd in sds.items():
        assert sorted(again[name]) == sorted(sd)
        for key, value in sd.items():
            np.testing.assert_array_equal(again[name][key], value, err_msg=key)

    # the port's keys through daam_tpu's own converters give the same tree
    converted = {'vae': JW._convert_vae(dict(sds['vae']), config.vae)}
    if 'unet' in sds:
        converted['unet'] = JW._convert_unet(dict(sds['unet']), config.unet)
        converted.update({n: JW._convert_clip(dict(sds[n])) for n in sds
                          if n.startswith('text_encoder')})
    for name, tree in converted.items():
        flat_conv = {k: np.asarray(v) for k, v in W._flatten(tree)}
        flat_back = dict(W._flatten(back[name]))
        assert sorted(flat_conv) == sorted(flat_back), name
        for key, leaf in flat_conv.items():
            np.testing.assert_array_equal(flat_back[key], leaf, err_msg=key)


@pytest.fixture(scope='module')
def tiny_trees():
    bf16 = JW._init_random_params_host(get_pipeline_config('tiny'), seed=9,
                                        dtype=jnp.bfloat16)
    return {'bfloat16': bf16,
            'float32': jax.tree_util.tree_map(lambda x: x.astype(jnp.float32), bf16)}


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('writer', ['daam_tpu', 'daam_tpu_torch'])
def test_npz_crosses_between_packages(tiny_trees, tmp_path, dtype, writer):
    """A .npz written by either package loads in the other to equal arrays.
    bf16 leaves are stored as daam_tpu stores them, raw 16-bit patterns
    under numpy's V2: the port reads daam_tpu's bf16 files bit for bit and
    writes the same arrays; daam_tpu's own load_params cannot turn V2 into
    a JAX array (for its own bf16 files too), so that direction is held to
    the stored arrays."""
    jax_tree = tiny_trees[dtype]
    port_tree = jax.tree_util.tree_map(
        lambda x: torch.from_numpy(np.asarray(x, np.float32)).to(getattr(torch, dtype)),
        jax_tree)
    path = tmp_path / f'{writer}.npz'
    if writer == 'daam_tpu':
        JW.save_params(jax_tree, path)
        loaded = W.load_params(path)
        _assert_trees_equal(loaded, {k: port_tree[k] for k in sorted(port_tree)})
        assert all(leaf.dtype == getattr(torch, dtype) for _, leaf in W._flatten(loaded))
        return
    W.save_params(port_tree, path)
    JW.save_params(jax_tree, tmp_path / 'reference.npz')
    with np.load(path) as ours, np.load(tmp_path / 'reference.npz') as theirs:
        assert ours.files == theirs.files
        for key in theirs.files:
            assert ours[key].dtype == theirs[key].dtype, key
            assert ours[key].tobytes() == theirs[key].tobytes(), key
    if dtype == 'float32':
        _assert_trees_equal(JW.load_params(path), jax_tree)
    else:
        with pytest.raises(TypeError, match='V2'):
            JW.load_params(path)


def test_load_params_dtype_casts_floating_leaves_only(tmp_path):
    tree = {'a': {'kernel': torch.randn(3, 2), 'ids': torch.arange(4)},
            'b': torch.ones(2, dtype=torch.bfloat16)}
    W.save_params(tree, tmp_path / 'p.npz')
    loaded = W.load_params(tmp_path / 'p.npz', dtype=torch.bfloat16)
    assert loaded['a']['kernel'].dtype == torch.bfloat16
    assert loaded['a']['ids'].dtype == torch.int64
    assert torch.equal(loaded['a']['kernel'], tree['a']['kernel'].bfloat16())
    assert torch.equal(W.load_params(tmp_path / 'p.npz')['b'], tree['b'])


@pytest.mark.parametrize('preset,steps', list(G.CASES.items()))
def test_committed_goldens_load(preset, steps):
    """Each golden loads, has its case's shapes, and its token ids are the
    port tokenizer's for the prompt (both of SDXL's tokenizers)."""
    npz = G.OUT_DIR / f'{preset}.npz'
    meta = json.loads(npz.with_suffix('.json').read_text())
    config = get_pipeline_config(preset)
    s = config.image_size // 8
    with np.load(npz) as g:
        assert meta['preset'] == preset and meta['steps'] == steps == len(g['latents'])
        assert meta['seed'] == G.SEED and meta['prompt'] == G.PROMPT
        assert g['latents_init'].shape == (1, 4, s, s)
        assert g['latents'].shape == (steps, 1, 4, s, s)
        assert g['image'].shape == (config.image_size, config.image_size, 3)
        assert g['image'].dtype == np.uint8
        assert np.isfinite(g['heat_maps']).all() and np.isfinite(g['latents']).all()
        assert list(g['module_names']) == sorted(
            ['text_encoder', 'unet', 'vae'] + (['text_encoder_2'] if config.is_sdxl else []))
        assert meta['module_sums'] == dict(zip(g['module_names'].tolist(),
                                               g['module_sums'].tolist()))
        tokenizers = [default_tokenizer()] + (
            [default_tokenizer(pad_id=0)] if config.is_sdxl else [])
        ids = np.stack([tok([G.PROMPT], padding='max_length', truncation=True,
                            return_tensors='np')['input_ids'][0]
                        for tok in tokenizers])
        ids = ids if config.is_sdxl else ids[0]
        np.testing.assert_array_equal(ids, g['token_ids'])
        assert np.asarray(meta['token_ids']).tolist() == g['token_ids'].tolist()
        n_tokens = len(tokenizers[0].tokenize(G.PROMPT))
        assert g['heat_maps'].shape[0] == n_tokens + 2
    assert sum(p.stat().st_size for p in G.OUT_DIR.iterdir()) < 8 * 2 ** 20
