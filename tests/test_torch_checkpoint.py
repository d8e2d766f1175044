"""Checkpoint directories: daam_tpu_torch loads what daam_tpu loads.

Diffusers-layout directories of random weights are fabricated on disk with
``tests/test_checkpoint_dir.py``'s ``write_diffusers_dir`` (``tiny`` and
``tiny-xl``, ``.bin`` and ``.safetensors``, a decoder-only VAE), and one
more is written from ``daam_tpu``'s ``init_random_params`` through the
port's ``from_jax_params`` in the variants ``daam_tpu``'s converters accept:
a VAE with its encoder under the legacy ``query/key/value/proj_attn``
names with 1×1 conv weights, ``nin_shortcut`` for ``conv_shortcut``, and
CLIP keys ``_convert_clip`` never reads (``position_ids``).  Each directory
loads in both packages (``from_pretrained(dir)``; the port's on the CPU),
resolves to the same config name, and the traced slice on the same latents
meets the slice gates: images within 2/255, per-token Spearman ≥ 0.99 and
``_assert_close``.  The port's config derivation gives ``daam_tpu``'s names
on every preset geometry, an off-preset one and the malformed-JSON
fallback, and its own safetensors reader gives the ``safetensors``
package's tensors.
"""

import json
import shutil
from dataclasses import replace

import numpy as np
import pytest
import torch

import jax

from daam_tpu import trace as jax_trace
from daam_tpu.models import weights as JW
from daam_tpu.models.configs import get_pipeline_config as jax_config
from daam_tpu.pipeline.sd import StableDiffusionPipeline as JaxPipeline
from daam_tpu_torch import StableDiffusionPipeline, trace
from daam_tpu_torch.models import weights as W
from daam_tpu_torch.models.configs import get_pipeline_config

from test_checkpoint_dir import _clip_json, _unet_json, _vae_json, write_diffusers_dir
from test_e2e_fidelity_torch import _assert_close
from test_torch_models import jax_params
from test_torch_vae_encoder import jax_vae_params

PROMPT = 'A dog runs across the field .'
STEPS = 3


def _write_variant_dir(root, config, params):
    """A ``tiny`` directory from ``daam_tpu`` params in the checkpoint
    variants daam_tpu accepts: unet and vae ``.safetensors``, text encoder
    ``.bin``; the VAE with its encoder, legacy attention names and 1×1 conv
    weights, ``nin_shortcut``; an int64 ``position_ids`` in the CLIP dict."""
    from safetensors.torch import save_file

    sds = W.from_jax_params(params)
    vae = {}
    for k, v in sds['vae'].items():
        for new, old in (('to_q', 'query'), ('to_k', 'key'), ('to_v', 'value'),
                         ('to_out.0', 'proj_attn')):
            if f'mid_block.attentions.0.{new}.' in k:
                k = k.replace(f'.{new}.', f'.{old}.')
                if v.ndim == 2:
                    v = v[:, :, None, None]
        vae[k.replace('.conv_shortcut.', '.nin_shortcut.')] = v
    assert any(k.startswith('encoder.') for k in vae)
    assert any('.nin_shortcut.' in k for k in vae)
    text = {k: torch.from_numpy(np.array(v))
            for k, v in sds['text_encoder'].items()}
    text['text_model.embeddings.position_ids'] = torch.arange(77)[None]
    for name, payload in (('unet', _unet_json(config.unet)),
                          ('vae', _vae_json(config.vae)),
                          ('text_encoder', _clip_json(config.text))):
        (root / name).mkdir(parents=True)
        (root / name / 'config.json').write_text(json.dumps(payload))
    for name, sd in (('unet', sds['unet']), ('vae', vae)):
        save_file({k: torch.from_numpy(np.array(v)) for k, v in sd.items()},
                  str(root / name / 'diffusion_pytorch_model.safetensors'))
    torch.save(text, root / 'text_encoder' / 'pytorch_model.bin')
    (root / 'scheduler').mkdir()
    (root / 'scheduler' / 'scheduler_config.json').write_text(
        json.dumps({'prediction_type': config.prediction_type}))
    return root


@pytest.fixture(scope='module')
def dirs(tmp_path_factory):
    base = tmp_path_factory.mktemp('ckpt')
    out = {(preset, fmt): write_diffusers_dir(base / f'{preset}-{fmt}',
                                              jax_config(preset), fmt=fmt)
           for preset in ('tiny', 'tiny-xl') for fmt in ('bin', 'safetensors')}
    config = get_pipeline_config('tiny')
    params = {**jax_params(config, seed=5), 'vae': jax_vae_params(config.vae, seed=6)}
    out['tiny', 'variants'] = _write_variant_dir(base / 'variants', config, params)
    return out


def _slice(jpipe, pipe, seed):
    """The traced slice through both pipelines from daam_tpu's latents."""
    key = jax.random.PRNGKey(seed)
    with jax_trace(jpipe) as jtc:
        jout = jpipe(PROMPT, num_inference_steps=STEPS, generator=key,
                     output_type='np')
        jmap = np.asarray(jtc.compute_global_heat_map().heat_maps)
    s = pipe.config.unet.sample_size
    latents = np.asarray(jax.random.normal(key, (1, s, s, 4))) * \
        jpipe.scheduler.init_noise_sigma
    with trace(pipe) as tc:
        out = pipe(PROMPT, num_inference_steps=STEPS,
                   latents=latents.transpose(0, 3, 1, 2), output_type='np')
        heat = tc.compute_global_heat_map().heat_maps.numpy()
    return jout.images[0], jmap, out.images[0], heat


@pytest.mark.parametrize('which', [('tiny', 'bin'), ('tiny', 'safetensors'),
                                   ('tiny-xl', 'bin'), ('tiny-xl', 'safetensors'),
                                   ('tiny', 'variants')])
def test_directory_slice_matches_daam_tpu(dirs, which):
    path = str(dirs[which])
    jpipe = JaxPipeline.from_pretrained(path)
    pipe = StableDiffusionPipeline.from_pretrained(path, device='cpu')
    assert pipe.config.name == jpipe.config.name == which[0]
    assert type(pipe).__name__ == type(jpipe).__name__
    assert (pipe.vae.encoder is not None) == (which[1] == 'variants')
    jimage, jmap, image, heat = _slice(jpipe, pipe, seed=7)
    assert image.shape == jimage.shape
    assert np.abs(image - jimage).max() <= 2 / 255
    # _assert_close: per-token Spearman >= 0.99 on every map with structure
    # and allclose on all.  The ranks of a flat map are noise, and the
    # weights write_diffusers_dir fabricates give maps flat to 1e-5 of their
    # level: there the maps are held to 1e-4 of it instead.
    _assert_close(heat, jmap)
    if which[1] == 'variants':  # daam_tpu's init: every token rank-tested
        assert all(np.ptp(m) >= 1e-4 * np.abs(m).max() for m in heat)
    np.testing.assert_allclose(heat, jmap, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize('preset', ['tiny', 'tiny-xl'])
def test_bin_and_safetensors_load_the_same_tensors(dirs, preset):
    """Both formats give the same config and bit-identical modules, and the
    same tokenizer vocabulary as daam_tpu's; bf16 casts on load."""
    config, a, tok = W.load_diffusers_checkpoint(dirs[preset, 'bin'], device='cpu')
    config_s, b, _ = W.load_diffusers_checkpoint(dirs[preset, 'safetensors'],
                                                 device='cpu')
    assert config is config_s is get_pipeline_config(preset)
    assert sorted(a) == sorted(b)
    for name in a:
        sa, sb = a[name].state_dict(), b[name].state_dict()
        assert sorted(sa) == sorted(sb)
        for k in sa:
            assert torch.equal(sa[k], sb[k]), (name, k)
    _, half, _ = W.load_diffusers_checkpoint(dirs[preset, 'safetensors'],
                                             device='cpu', dtype=torch.bfloat16)
    w = a['unet'].conv_in.weight
    assert half['unet'].conv_in.weight.dtype == torch.bfloat16
    assert torch.equal(half['unet'].conv_in.weight, w.to(torch.bfloat16))
    assert tok.tokenize(PROMPT) == JW.load_diffusers_checkpoint(
        dirs[preset, 'bin'])[2].tokenize(PROMPT)


def test_variant_dir_loads_what_daam_tpu_converts(dirs):
    """Every tensor of the variants directory lands where daam_tpu puts it:
    the port's modules, converted by from_jax_params, equal daam_tpu's
    params converted the same way (the VAE encoder included)."""
    _, params, _ = JW.load_diffusers_checkpoint(dirs['tiny', 'variants'])
    theirs = W.from_jax_params(jax.tree_util.tree_map(np.asarray, params))
    _, modules, _ = W.load_diffusers_checkpoint(dirs['tiny', 'variants'], device='cpu')
    for name, module in modules.items():
        sd = module.state_dict()
        assert sorted(sd) == sorted(theirs[name]), name
        for k, v in sd.items():
            np.testing.assert_array_equal(v.numpy(), theirs[name][k], err_msg=k)


def test_decoder_only_vae_encode_raises(dirs):
    _, modules, _ = W.load_diffusers_checkpoint(dirs['tiny', 'bin'], device='cpu')
    vae = modules['vae']
    assert vae.encoder is None and vae.quant_conv is None
    assert not any(k.startswith(('encoder.', 'quant_conv.')) for k in vae.state_dict())
    with pytest.raises(RuntimeError, match='no encoder'):
        vae.encode(torch.zeros(1, 3, 16, 16))


def test_unknown_key_is_not_dropped(dirs, tmp_path):
    """Beyond the variants daam_tpu's converters read past, the load is
    strict: an unexpected UNet key raises."""
    root = tmp_path / 'extra'
    shutil.copytree(dirs['tiny', 'bin'], root)
    f = root / 'unet' / 'diffusion_pytorch_model.bin'
    sd = torch.load(f, weights_only=True)
    sd['conv_in.extra'] = torch.zeros(3)
    torch.save(sd, f)
    with pytest.raises(RuntimeError, match='unexpected keys'):
        W.load_diffusers_checkpoint(root, device='cpu')


def test_missing_weights_raise(dirs, tmp_path):
    root = tmp_path / 'empty'
    shutil.copytree(dirs['tiny', 'bin'], root)
    (root / 'unet' / 'diffusion_pytorch_model.bin').unlink()
    with pytest.raises(FileNotFoundError, match='no safetensors/bin weights'):
        W.load_diffusers_checkpoint(root, device='cpu')
    with pytest.raises(FileNotFoundError):
        JW.load_diffusers_checkpoint(root)


def test_load_defaults_to_the_card(dirs):
    import inspect
    assert inspect.signature(W.load_diffusers_checkpoint).parameters[
        'device'].default == 'cuda'
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present: the default call succeeds')
    with pytest.raises(RuntimeError, match='no CUDA device'):
        StableDiffusionPipeline.from_pretrained(str(dirs['tiny', 'bin']))


def test_cli_from_path(dirs, tmp_path):
    """``daam-torch --from-path`` loads the directory (over ``--model``) and
    writes the artifact set; ``--reference-format`` a torch checkpoint."""
    from daam_tpu_torch.experiment import GenerationExperiment
    from daam_tpu_torch.run.generate import main

    main(['A dog runs.', '--from-path', str(dirs['tiny', 'variants']),
          '--model', 'xl-base-1.0', '-n', '2', '-o', str(tmp_path),
          '--device', 'cpu', '--reference-format'])
    names = {p.name for p in tmp_path.iterdir()}
    assert {'output.png', 'generation.pt', 'dog.heat_map.png'} <= names
    assert (tmp_path / 'generation.pt').read_bytes()[:2] == b'PK'
    exp = GenerationExperiment.load(tmp_path)
    assert exp.prompt == 'A dog runs .' and exp.image.size == (16, 16)


# ---------------------------------------------------------------------------
# config derivation
# ---------------------------------------------------------------------------

def _json_dir(root, pcfg):
    """Only the json configs of a diffusers directory for ``pcfg``."""
    for sub, payload in [('unet', _unet_json(pcfg.unet)),
                         ('text_encoder', _clip_json(pcfg.text)),
                         ('vae', _vae_json(pcfg.vae))]:
        (root / sub).mkdir(parents=True)
        (root / sub / 'config.json').write_text(json.dumps(payload))
    if pcfg.text_2 is not None:
        (root / 'text_encoder_2').mkdir()
        (root / 'text_encoder_2' / 'config.json').write_text(
            json.dumps(_clip_json(pcfg.text_2)))
    (root / 'scheduler').mkdir()
    (root / 'scheduler' / 'scheduler_config.json').write_text(
        json.dumps({'prediction_type': pcfg.prediction_type}))
    return root


@pytest.mark.parametrize('preset', ['v1', 'v2-base', 'v2-large', 'v2-1-base',
                                    'v2-1-large', 'xl-base-1.0', 'tiny',
                                    'tiny-v1', 'tiny-xl'])
def test_config_from_json_names_match(preset, tmp_path):
    """Every preset geometry resolves to daam_tpu's name (SD 2.0 to the 2.1
    preset of its geometry), and to the port's preset object itself."""
    root = _json_dir(tmp_path / preset, jax_config(preset))
    theirs = JW._config_from_json(root)
    ours = W._config_from_json(root)
    assert ours.name == theirs.name
    assert ours is get_pipeline_config(theirs.name)
    assert W._detect_config(root).name == JW._detect_config(root).name


def test_config_from_json_off_preset(tmp_path):
    base = jax_config('tiny')
    pcfg = replace(base, unet=replace(base.unet, block_out_channels=(32, 48),
                                      attention_head_dim=(2, 3)))
    root = _json_dir(tmp_path / 'custom', pcfg)
    ours, theirs = W._config_from_json(root), JW._config_from_json(root)
    assert ours.name == theirs.name == 'custom'
    assert ours.unet.block_out_channels == (32, 48)
    assert ours.unet.attention_head_dim == theirs.unet.attention_head_dim == (2, 3)
    assert not ours.is_sdxl


@pytest.mark.parametrize('preset', ['v1', 'v2-1-base', 'v2-1-large', 'xl-base-1.0'])
def test_detect_config_malformed_json_fallback(preset, tmp_path):
    """A malformed text encoder config.json falls back to the geometry
    heuristic on the UNet's config, in both packages."""
    root = _json_dir(tmp_path / preset, jax_config(preset))
    (root / 'text_encoder' / 'config.json').write_text('{not json')
    assert W._detect_config(root).name == JW._detect_config(root).name == preset


# ---------------------------------------------------------------------------
# the safetensors reader
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('dtype', [torch.float32, torch.float16, torch.bfloat16])
def test_safetensors_reader_matches_the_package(dtype, tmp_path):
    from safetensors import safe_open
    from safetensors.torch import save_file

    g = torch.Generator().manual_seed(0)
    tensors = {'a.weight': torch.randn(7, 5, generator=g).to(dtype),
               'b.bias': torch.randn(3, generator=g).to(dtype),
               'c': torch.randn(2, 3, 1, 1, generator=g).to(dtype),
               'scalar': torch.tensor(1.5).to(dtype),
               'empty': torch.zeros(0, 4, dtype=dtype),
               'ids': torch.arange(77)[None]}
    path = tmp_path / 'model.safetensors'
    save_file(tensors, str(path), metadata={'format': 'pt'})
    ours = W.read_safetensors(path)
    with safe_open(str(path), framework='pt') as f:
        theirs = {k: f.get_tensor(k) for k in f.keys()}
    assert sorted(ours) == sorted(theirs) == sorted(tensors)
    for k, v in theirs.items():
        assert ours[k].dtype == v.dtype and ours[k].shape == v.shape, k
        assert torch.equal(ours[k], v), k
