"""The SDXL slice of daam_tpu_torch against daam_tpu, on ``tiny-xl``.

Both packages get the same params (``daam_tpu``'s random init through
``from_jax_params``) and the same numpy/JAX-drawn inputs; ``daam_tpu``'s
attention takes its jnp path on the CPU.  Held in fp32:

* the UNet with ``added_cond`` (the ``text_time`` add-embedding) under
  ``capture='acc'``: eps and every accumulator at rtol 1e-4 (atol 1e-5);
* each text encoder's penultimate states and pooled output (bigG's
  projected), and the pipeline's encode seams: token ids, the 96-wide
  context, ``text_embeds`` and ``time_ids``;
* the ``from_jax_params`` round trip of ``text_encoder_2`` (the UNet's, with
  its ``add_embedding``, is a case of ``test_torch_weights.py``'s) and
  ``init_random`` on all four modules;
* the tiled VAE decode against ``daam_tpu``'s ``_build_tiled_decode`` within
  1e-4, the single tile, and when ``'auto'`` tiles;
* the whole traced slice, 3 DDIM steps from injected latents: images within
  2/255, ``finalize_acc`` blocks at rtol 1e-4/atol 1e-5, global heat maps at
  per-token Spearman ≥ 0.99 and ``_assert_close``;
* an fp32 ``save_heads`` → ``load_heads`` pair: the buffers at atol 1e-4, the
  replayed run's image and maps as above;
* the ``daam-torch`` CLI's artifact set with ``--model xl-base-1.0 --tiny``.
"""

import importlib
from collections import OrderedDict

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from daam_tpu import trace as jax_trace
from daam_tpu.models.clip import CLIPTextEncoder
from daam_tpu.models.unet import UNet2DConditionModel as JaxUNet
from daam_tpu.models.weights import _convert_clip, _init_random_params_host
from daam_tpu.ops.pallas_attention import cross_acc_shape
from daam_tpu.pipeline.sdxl import StableDiffusionXLPipeline as JaxXLPipeline
from daam_tpu_torch import StableDiffusionPipeline, StableDiffusionXLPipeline, trace
from daam_tpu_torch.models import weights as W
from daam_tpu_torch.models.configs import cross_attention_layout, get_pipeline_config

from test_e2e_fidelity_torch import _assert_close, _spearman
from test_torch_models import jax_params

RTOL, ATOL = 1e-4, 1e-5
PROMPT = 'A dog runs across the field .'
PROMPT2 = 'A cat sits on the mat .'
STEPS = 3
jax_trace_mod = importlib.import_module('daam_tpu.trace')
trace_mod = importlib.import_module('daam_tpu_torch.trace')


@pytest.fixture(scope='module')
def tiny_xl():
    config = get_pipeline_config('tiny-xl')
    params = jax_params(config, seed=4)
    pipe = StableDiffusionXLPipeline(config, **W.load_modules(
        config, W.from_jax_params(params), device='cpu'))
    return config, params, pipe


@pytest.fixture(scope='module')
def jpipe(tiny_xl):
    config, params, _ = tiny_xl
    return JaxXLPipeline(config, params)


def _latents(config, key):
    """daam_tpu's initial noise for ``key`` (NHWC), scaled by DDIM's
    init_noise_sigma (1), as NCHW for the port."""
    s = config.unet.sample_size
    return np.array(jax.random.normal(key, (1, s, s, 4))).transpose(0, 3, 1, 2)


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

def test_unet_added_cond_acc_capture_matches_daam_tpu(tiny_xl):
    """eps and every 'acc' accumulator after two UNet calls on the CFG batch,
    with text_embeds and time_ids feeding the add-embedding."""
    config, params, pipe = tiny_xl
    cfg = config.unet
    rng = np.random.RandomState(0)
    s = cfg.sample_size
    sample = rng.randn(2, s, s, cfg.in_channels).astype(np.float32)  # NHWC
    ctx = rng.randn(2, 77, cfg.cross_attention_dim).astype(np.float32)
    embeds = rng.randn(2, config.text_2.projection_dim).astype(np.float32)
    time_ids = np.array([[1024, 1024, 0, 0, 1024, 1024],
                         [768, 1344, 32, 16, 1024, 1024]], np.float32)

    layout = cross_attention_layout(cfg)
    acc_jax = {i.name: jnp.zeros(cross_acc_shape(1, i.heads, (s // i.downscale) ** 2, 77),
                                 jnp.float32) for i in layout}
    acc = {i.name: torch.zeros(1, i.heads, 77, (s // i.downscale) ** 2)
           for i in layout}
    added_jax = {'text_embeds': jnp.asarray(embeds), 'time_ids': jnp.asarray(time_ids)}
    added = {'text_embeds': torch.from_numpy(embeds),
             'time_ids': torch.from_numpy(time_ids)}
    for t in (901, 301):
        theirs, acc_jax = JaxUNet(cfg).apply(
            {'params': params['unet']}, jnp.asarray(sample), jnp.full((2,), t),
            jnp.asarray(ctx), added_cond=added_jax, capture='acc', acc=acc_jax)
        with torch.no_grad():
            ours = pipe.unet(torch.from_numpy(sample).permute(0, 3, 1, 2),
                             torch.full((2,), t), torch.from_numpy(ctx),
                             added_cond=added, capture='acc', acc=acc)
        np.testing.assert_allclose(ours.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(theirs), rtol=RTOL, atol=ATOL)
    assert set(acc) == set(acc_jax) == set(pipe.unet.layer_names())
    for name, a in acc.items():
        np.testing.assert_allclose(a.numpy(), np.asarray(acc_jax[name])[:, :, :77, :a.shape[-1]],
                                   rtol=RTOL, atol=ATOL, err_msg=name)

    # the add-embedding is live: other time ids give another prediction
    with torch.no_grad():
        other = pipe.unet(torch.from_numpy(sample).permute(0, 3, 1, 2),
                          torch.full((2,), 301), torch.from_numpy(ctx),
                          added_cond={**added, 'time_ids': added['time_ids'] / 2})
    assert not torch.allclose(other, ours)


def test_unet_without_added_cond_raises(tiny_xl):
    _, _, pipe = tiny_xl
    s = pipe.config.unet.sample_size
    with pytest.raises(ValueError, match='added_cond'):
        pipe.unet(torch.zeros(2, 4, s, s), torch.full((2,), 1),
                  torch.zeros(2, 77, pipe.config.unet.cross_attention_dim))


@pytest.mark.parametrize('name', ['text_encoder', 'text_encoder_2'])
def test_text_encoder_penultimate_matches_daam_tpu(tiny_xl, name):
    """Penultimate hidden states, and the pooled output at the first
    <|endoftext|> (bigG's through its text_projection)."""
    config, params, pipe = tiny_xl
    tok = pipe.tokenizer if name == 'text_encoder' else pipe.tokenizer_2
    ids = np.asarray(tok(['a dog runs across the field', ''], padding='max_length',
                         return_tensors='np')['input_ids'])
    cfg = config.text if name == 'text_encoder' else config.text_2
    theirs, theirs_pooled = CLIPTextEncoder(cfg).apply(
        {'params': params[name]}, jnp.asarray(ids), penultimate=True)
    with torch.no_grad():
        ours, pooled = getattr(pipe, name)(torch.from_numpy(ids).long(),
                                           penultimate=True)
    assert pooled.shape == (2, cfg.projection_dim or cfg.hidden_size)
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(pooled.numpy(), np.asarray(theirs_pooled),
                               rtol=RTOL, atol=ATOL)


def test_encode_seams_match_daam_tpu(tiny_xl, jpipe):
    """_encode_tokens (B, 2, 77), _text_forward's 96-wide context and pooled
    embedding, and _merge_added's text_embeds and time_ids."""
    config, params, pipe = tiny_xl
    prompts = [PROMPT, 'a cat']
    ids = pipe._encode_tokens(prompts)
    jids = jpipe._encode_tokens(prompts)
    assert ids.shape == (2, 2, 77)
    np.testing.assert_array_equal(ids.numpy(), jids)
    assert ids[0, 1, -1] == 0 and ids[0, 0, -1] == 49407  # OpenCLIP pads with 0

    with torch.no_grad():
        context, pooled = pipe._text_forward(ids)
        neg_context, neg_pooled = pipe._text_forward(pipe._encode_tokens(['', '']))
    jcontext, jpooled = jpipe._text_forward(params, jnp.asarray(jids))
    _, jneg_pooled = jpipe._text_forward(params, jnp.asarray(jpipe._encode_tokens(['', ''])))
    assert context.shape == (2, 77, config.unet.cross_attention_dim)
    np.testing.assert_allclose(context.numpy(), np.asarray(jcontext), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(pooled.numpy(), np.asarray(jpooled), rtol=RTOL, atol=ATOL)

    added = pipe._merge_added(neg_pooled, pooled, 1024, 768)
    jadded = jpipe._merge_added(jneg_pooled, jpooled, 1024, 768)
    assert sorted(added) == sorted(jadded) == ['text_embeds', 'time_ids']
    assert added['time_ids'].dtype == torch.float32
    np.testing.assert_array_equal(added['time_ids'].numpy(), np.asarray(jadded['time_ids']))
    np.testing.assert_allclose(added['text_embeds'].numpy(),
                               np.asarray(jadded['text_embeds']), rtol=RTOL, atol=ATOL)


def test_text_encoder_2_round_trip():
    """diffusers bigG state dict → daam_tpu → diffusers, key for key and bit
    for bit (text_projection included)."""
    modules = W.build_modules(get_pipeline_config('tiny-xl'), device='cpu')
    rng = np.random.RandomState(3)
    sd = {k: rng.randn(*v.shape).astype(np.float32)
          for k, v in modules['text_encoder_2'].state_dict().items()}
    assert 'text_projection.weight' in sd
    back = W.from_jax_params({'text_encoder_2': _convert_clip(dict(sd))})['text_encoder_2']
    assert sorted(back) == sorted(sd)
    for k in sd:
        np.testing.assert_array_equal(back[k], sd[k], err_msg=k)


def test_init_random_tiny_xl_shapes_and_scale_rule():
    """All four modules carry the converted daam_tpu key set and shapes,
    strict-load into fresh modules, and follow the scale rule."""
    config = get_pipeline_config('tiny-xl')
    modules = W.init_random(config, torch.Generator().manual_seed(0), device='cpu')
    assert sorted(modules) == ['text_encoder', 'text_encoder_2', 'unet', 'vae']
    jax_sd = W.from_jax_params(_init_random_params_host(config, 0, jnp.float32))
    fresh = W.build_modules(config, device='cpu')
    for name, module in modules.items():
        sd = module.state_dict()
        assert {k: tuple(v.shape) for k, v in sd.items()} == \
            {k: v.shape for k, v in jax_sd[name].items()}, name
        fresh[name].load_state_dict(sd, strict=True)

    add = modules['unet'].add_embedding
    assert add.linear_1.weight.shape == (config.unet.time_embed_dim,
                                         config.unet.projection_class_embeddings_input_dim)
    assert torch.all(add.linear_1.bias == 0)
    proj = modules['text_encoder_2'].text_projection.weight  # (64, 64), no bias
    assert modules['text_encoder_2'].text_projection.bias is None
    w = torch.cat([m.weight.flatten() for m in modules['unet'].modules()
                   if isinstance(m, torch.nn.Linear) and m.weight.shape[1] == 64])
    assert abs(w.std().item() * 64 ** 0.5 - 1.0) < 0.05
    assert abs(proj.std().item() * proj.shape[1] ** 0.5 - 1.0) < 0.2


def test_from_pretrained_gives_the_sdxl_class():
    pipe = StableDiffusionPipeline.from_pretrained('tiny-xl', device='cpu')
    assert type(pipe) is StableDiffusionXLPipeline and pipe.is_sdxl
    assert pipe.tokenizer_2.pad_id == 0
    assert type(StableDiffusionPipeline.from_pretrained('tiny', device='cpu')) \
        is StableDiffusionPipeline


# ---------------------------------------------------------------------------
# tiled VAE decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('hw,tile,overlap', [((32, 32), 20, 8), ((36, 44), 20, 8),
                                             ((8, 8), 64, 16)])
def test_tiled_decode_matches_daam_tpu(tiny_xl, jpipe, hw, tile, overlap):
    """Same tiles, order, clip and blend as daam_tpu's, within 1e-4 in fp32.
    (36, 44) puts the last tile off the stride grid; (8, 8) is one tile,
    which equals the whole decode."""
    config, params, pipe = tiny_xl
    h, w = hw
    z = np.random.RandomState(h + w).randn(1, h, w, 4).astype(np.float32)
    theirs = np.asarray(jpipe._build_tiled_decode(1, h, w, tile=tile, overlap=overlap)(
        params, jnp.asarray(z)))
    with torch.no_grad():
        ours = pipe._tiled_decode(torch.from_numpy(z).permute(0, 3, 1, 2),
                                  tile=tile, overlap=overlap)
    sf = pipe.vae_scale_factor
    assert ours.shape == theirs.shape == (1, h * sf, w * sf, 3)
    np.testing.assert_allclose(ours.numpy(), theirs, rtol=0, atol=1e-4)
    if h <= tile:
        pipe.enable_vae_tiling(False)
        try:
            with torch.no_grad():
                whole = pipe._decode(torch.from_numpy(z).permute(0, 3, 1, 2))
        finally:
            pipe.enable_vae_tiling('auto')
        np.testing.assert_allclose(ours.numpy(), whole.numpy(), rtol=0, atol=1e-5)


@pytest.mark.parametrize('tiling,edge,tiled', [('auto', 96, False), ('auto', 97, True),
                                               (True, 8, True), (False, 128, False)])
def test_decode_tiles_when_asked(tiny_xl, monkeypatch, tiling, edge, tiled):
    """'auto' tiles latent edges above vae_tile_threshold (96: SDXL's 128²
    tiles, SD 2.1-base's 64² does not); True and False force it."""
    _, _, pipe = tiny_xl
    calls = []

    def spy(latents):
        calls.append(tuple(latents.shape))
        return latents
    monkeypatch.setattr(pipe, '_tiled_decode', spy)
    monkeypatch.setattr(pipe.vae, 'decode', lambda z: z[:, :3])
    pipe.enable_vae_tiling(tiling)
    try:
        pipe._decode(torch.zeros(1, 4, edge, edge - 1))
    finally:
        pipe.enable_vae_tiling('auto')
    assert calls == ([(1, 4, edge, edge - 1)] if tiled else [])


# ---------------------------------------------------------------------------
# the traced slice
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def runs(tiny_xl, jpipe):
    config, _, pipe = tiny_xl
    key = jax.random.PRNGKey(7)
    with jax_trace(jpipe) as jtc:
        jout = jpipe(PROMPT, num_inference_steps=STEPS, generator=key,
                     output_type='np')
        jmap = np.asarray(jtc.compute_global_heat_map().heat_maps)
        jblocks = {f: np.asarray(b) for f, b in jtc.batch_heat_maps.items()}
    with trace(pipe) as tc:
        out = pipe(PROMPT, num_inference_steps=STEPS,
                   latents=_latents(config, key), output_type='np')
        heat = tc.compute_global_heat_map()
        blocks = {f: b.numpy() for f, b in tc.batch_heat_maps.items()}
    return dict(jimage=jout.images[0], jmap=jmap, jblocks=jblocks,
                image=out.images[0], map=heat.heat_maps.numpy(), blocks=blocks,
                word=heat.compute_word_heat_map('dog').heatmap)


def test_sdxl_images_match(runs):
    assert runs['image'].shape == runs['jimage'].shape == (16, 16, 3)
    assert np.abs(runs['image'] - runs['jimage']).max() <= 2 / 255


def test_sdxl_finalized_blocks_match(runs):
    """Level 1 only (level 0 is 'plain'): 1 down + 2 up attentions × depth 2."""
    assert sorted(runs['blocks']) == sorted(runs['jblocks'])
    for f, block in runs['blocks'].items():
        assert block.shape == runs['jblocks'][f].shape == (1, 6, 4, 77, 4, 4)
        np.testing.assert_allclose(block, runs['jblocks'][f], rtol=1e-4, atol=1e-5)


def test_sdxl_global_heat_maps_match(runs):
    ours, theirs = runs['map'], runs['jmap']
    assert ours.shape == theirs.shape == (9, 96, 96)
    for tok in range(ours.shape[0]):
        assert _spearman(ours[tok], theirs[tok]) >= 0.99, tok
    _assert_close(ours, theirs)
    word = runs['word']
    assert word.shape == (96, 96) and torch.isfinite(word).all()
    assert (word >= 0).all() and word.max() > word.min()


@pytest.fixture(scope='module')
def replay_runs(tiny_xl, jpipe):
    """fp32 save_heads of PROMPT, then load_heads into PROMPT2, in both."""
    config, _, pipe = tiny_xl
    key = jax.random.PRNGKey(7)
    r = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_trace_mod, '_HEAD_CACHE', OrderedDict())
        mp.setattr(trace_mod, '_HEAD_CACHE', OrderedDict())
        jpipe.heads_dtype, pipe.heads_dtype = jnp.float32, torch.float32
        try:
            with jax_trace(jpipe, save_heads=True, persist_heads=False,
                           data_dir='xl') as jtc:
                jpipe(PROMPT, num_inference_steps=STEPS, generator=key)
                r['jbuf'] = {n: np.asarray(a) for n, a in jtc.replay_buffer(STEPS).items()}
            with jax_trace(jpipe, load_heads=True, data_dir='xl') as jtc:
                jout = jpipe(PROMPT2, num_inference_steps=STEPS, generator=key,
                             output_type='np')
                r['jload'] = (jout.images[0],
                              np.asarray(jtc.compute_global_heat_map().heat_maps))
            latents = _latents(config, key)
            with trace(pipe, save_heads=True, persist_heads=False, data_dir='xl') as tc:
                pipe(PROMPT, num_inference_steps=STEPS, latents=latents)
                r['buf'] = tc.replay_buffer(STEPS)
            with trace(pipe, load_heads=True, data_dir='xl') as tc:
                out = pipe(PROMPT2, num_inference_steps=STEPS, latents=latents,
                           output_type='np')
                r['load'] = (out.images[0],
                             tc.compute_global_heat_map().heat_maps.numpy())
        finally:
            jpipe.heads_dtype, pipe.heads_dtype = jnp.bfloat16, torch.bfloat16
    return r


def test_sdxl_save_buffer_matches_daam_tpu(replay_runs):
    """Every cross-attention layer (the mid block's 2 included), every step
    and CFG row."""
    buf, jbuf = replay_runs['buf'], replay_runs['jbuf']
    assert sorted(buf) == sorted(jbuf) and len(buf) == 8
    for name, a in buf.items():
        assert a.dtype == torch.float32 and tuple(a.shape) == jbuf[name].shape
        assert a.shape[:2] == (STEPS, 2) and a.shape[-1] == 77
        np.testing.assert_allclose(a.numpy(), jbuf[name], rtol=0, atol=1e-4,
                                   err_msg=name)


def test_sdxl_load_heads_matches_daam_tpu(replay_runs):
    (image, heat), (jimage, jheat) = replay_runs['load'], replay_runs['jload']
    assert np.abs(image - jimage).max() <= 2 / 255
    for tok in range(heat.shape[0]):
        assert _spearman(heat[tok], jheat[tok]) >= 0.99, tok
    _assert_close(heat, jheat)


def test_quickgen_xl_artifact_set(tmp_path):
    from daam_tpu_torch.run.generate import load_pipeline, build_parser, main

    args = build_parser().parse_args(['x', '--model', 'xl-base-1.0', '--tiny',
                                      '--device', 'cpu'])
    assert load_pipeline(args).config.name == 'tiny-xl'
    main(['A dog runs.', '--model', 'xl-base-1.0', '--tiny', '-n', '2',
          '-o', str(tmp_path), '--device', 'cpu'])
    names = {p.name for p in tmp_path.iterdir()}
    assert {'output.png', 'generation.pt', 'prompt.txt', 'seed.txt',
            'dog.heat_map.png', 'runs.heat_map.png', 'a.heat_map.png'} <= names

    from daam_tpu.experiment import GenerationExperiment
    exp = GenerationExperiment.load(tmp_path)
    assert exp.prompt == 'A dog runs .'
    assert exp.global_heat_map.shape == (6, 96, 96)
    assert np.array(exp.image).shape == (16, 16, 3)
