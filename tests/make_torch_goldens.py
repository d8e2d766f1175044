"""Make the goldens that hold daam_tpu_torch against daam_tpu at full width.

The card has no JAX, so what ``daam_tpu`` computes is made here, on the CPU,
and committed: ``tests/fixtures/torch_goldens/<preset>.npz`` and a ``.json``
of metadata beside it.  For each case the weights are ``daam_tpu``'s host
init (``_init_random_params_host(config, seed=0, dtype=bfloat16)``), cast
up to fp32, which ``daam_tpu_torch.models.weights.init_random_params``
makes again bit for bit with numpy alone; then the fp32 DDIM pipeline runs
traced, with the prompt below, the preset's own guidance (as ``daam`` runs
it) and ``set_seed(0)``.

Each ``.npz`` holds:

* ``latents_init``: the initial latents, drawn as the pipeline draws them
  (``jax.random.normal(key, (1, s, s, 4)) * init_noise_sigma``,
  ``daam_tpu/pipeline/sd.py:247-257``), NCHW as the port takes them;
* ``latents``: the latents after every step, (steps, 1, 4, s, s), NCHW;
* ``image``: the uint8 image, (H, W, 3);
* ``heat_maps``: ``compute_global_heat_map().heat_maps``, one map per token
  of the prompt plus the start and end tokens;
* ``token_ids``: the prompt's 77 padded token ids (SDXL: both tokenizers',
  (2, 77));
* ``module_names``, ``module_sums``: the float64 sum of each module's fp32
  weights, as ``daam_tpu_torch.models.weights.param_sums`` takes it (each
  leaf summed by numpy in float64, the leaves' sums added by ``math.fsum``),
  which the card takes again of the weights it makes.

The ``.json`` adds the preset, seed, steps, prompt, guidance, token ids,
the jax and numpy versions and the seconds the case took (CPU and wall).
The arrays, and the ``.npz`` files byte for byte, come out the same on
every run; the ``.json``'s times do not.

    JAX_PLATFORMS=cpu python tests/make_torch_goldens.py            # both
    JAX_PLATFORMS=cpu python tests/make_torch_goldens.py v2-1-base  # one

The cases: ``v2-1-base`` at 512², 10 steps (the port's main path), and
``xl-base-1.0`` at 1024², 2 steps (its VAE decodes in 3 × 3 tiles, as in
``daam_tpu``).  SDXL holds ~14 GB of fp32 weights; run one case at a time
on a host with room for it.
"""

import argparse
import json
import os
import sys
import time
import zipfile
from pathlib import Path

os.environ.setdefault('JAX_PLATFORMS', 'cpu')
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))  # the repository

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

jax.config.update('jax_platforms', 'cpu')

PROMPT = 'A dog runs across the field.'
SEED = 0
CASES = {'v2-1-base': 10, 'xl-base-1.0': 2}
OUT_DIR = Path(__file__).resolve().parent / 'fixtures' / 'torch_goldens'


def fp32_params(config, seed: int = SEED):
    """``daam_tpu``'s host init in bfloat16, cast up to fp32 leaf by leaf
    (each bf16 leaf dropped as it is replaced)."""
    from daam_tpu.models.weights import _init_random_params_host

    params = _init_random_params_host(config, seed=seed, dtype=jnp.bfloat16)

    def upcast(tree):
        for key in list(tree):
            if isinstance(tree[key], dict):
                upcast(tree[key])
            else:
                tree[key] = tree[key].astype(jnp.float32)
    upcast(params)
    return params


def write_npz(path: Path, arrays: dict):
    """``np.savez_compressed`` with a fixed timestamp on every entry, so the
    same arrays give the same bytes."""
    with zipfile.ZipFile(path, 'w', zipfile.ZIP_DEFLATED) as zf:
        for name, arr in arrays.items():
            info = zipfile.ZipInfo(name + '.npy', date_time=(1980, 1, 1, 0, 0, 0))
            info.compress_type = zipfile.ZIP_DEFLATED
            with zf.open(info, 'w') as f:
                np.lib.format.write_array(f, np.ascontiguousarray(arr),
                                          allow_pickle=False)


def make(preset: str, steps: int, out_dir: Path = OUT_DIR) -> dict:
    """Run one case and write ``<preset>.npz`` and ``<preset>.json``."""
    from daam_tpu import set_seed, trace
    from daam_tpu.models.configs import get_pipeline_config
    from daam_tpu.pipeline.sd import _pipeline_class
    from daam_tpu_torch.models.weights import param_sums

    cpu0, wall0 = time.process_time(), time.perf_counter()
    config = get_pipeline_config(preset)
    params = fp32_params(config)
    sums = param_sums(params)
    pipe = _pipeline_class(config)(config, params)
    del params

    key = set_seed(SEED)
    s = config.image_size // pipe.vae_scale_factor
    init = np.asarray(jax.random.normal(key, (1, s, s, config.unet.in_channels),
                                        dtype=jnp.float32)
                      * pipe.scheduler.init_noise_sigma)
    stepped = []
    with trace(pipe) as tc:
        out = pipe(PROMPT, num_inference_steps=steps, generator=key,
                   output_type='np', callback_steps=1,
                   callback=lambda i, t, latents: stepped.append(np.asarray(latents)))
        heat_maps = np.asarray(tc.compute_global_heat_map().heat_maps, np.float32)
    image = np.clip(np.asarray(out.images[0]) * 255 + 0.5, 0, 255).astype(np.uint8)
    token_ids = np.asarray(pipe._encode_tokens([PROMPT])[0], np.int64)
    names = sorted(sums)
    arrays = {
        'latents_init': init.transpose(0, 3, 1, 2),
        'latents': np.stack(stepped).transpose(0, 1, 4, 2, 3),
        'image': image, 'heat_maps': heat_maps, 'token_ids': token_ids,
        'module_names': np.array(names),
        'module_sums': np.array([sums[n] for n in names], np.float64)}
    out_dir.mkdir(parents=True, exist_ok=True)
    write_npz(out_dir / f'{preset}.npz', arrays)
    meta = {'preset': preset, 'seed': SEED, 'steps': steps, 'prompt': PROMPT,
            'scheduler': 'ddim', 'dtype': 'float32',
            'guidance_scale': config.default_guidance_scale,
            'image_size': config.image_size,
            'token_ids': token_ids.tolist(),
            'module_sums': {n: sums[n] for n in names},
            'shapes': {k: list(v.shape) for k, v in arrays.items()},
            'jax': jax.__version__, 'numpy': np.__version__,
            'cpu_seconds': round(time.process_time() - cpu0, 1),
            'wall_seconds': round(time.perf_counter() - wall0, 1)}
    (out_dir / f'{preset}.json').write_text(json.dumps(meta, indent=1) + '\n')
    return meta


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('presets', nargs='*', default=list(CASES),
                        choices=list(CASES))
    parser.add_argument('-o', '--out-dir', type=Path, default=OUT_DIR)
    args = parser.parse_args(argv)
    for preset in args.presets:
        meta = make(preset, CASES[preset], args.out_dir)
        print(f"{preset}: {meta['steps']} steps, {meta['cpu_seconds']} CPU s, "
              f"{meta['wall_seconds']} s", file=sys.stderr)


if __name__ == '__main__':
    main()
