"""The tensor-core kernels behind K1, K2 and K5, run on the CPU.

``cross_attention_mma_kernel`` (``daam_tpu_torch/csrc/attention.cu``: bf16
``cross_attention_acc`` and ``cross_attention_probs``) and the fp32 3xTF32
kernels ``split_kv_tf32x3_kernel`` and
``flash_attention_tf32x3_wgmma_kernel`` (fp32 ``flash_attention`` at the
head dims they serve: K and V split once a call, then ``wgmma`` on stages
a producer warp bulk-copies),
``flash_attention_tf32x3_kernel`` (the other head dims, on ``mma.sync``)
and ``cross_attention_tf32x3_kernel`` (fp32 ``cross_attention_acc`` and
``cross_attention_probs``) need nvcc and a card.  Here
``tests/torch_emulate/run_case.cpp`` includes ``attention.cu`` after
``tests/torch_emulate/warp.h``, a CPU stand-in for the CUDA runtime and the
operations the kernels use (cp.async, ldmatrix, mma.sync m16n8k16 in bf16
and m16n8k8 in TF32, wgmma m64nNk8 in TF32 with B read through its swizzled
shared-memory descriptor, every TF32 operand truncated as the tensor core
reads it, mbarriers with their phases and transaction bytes, bulk copies,
``__shfl_xor_sync``; one thread per CUDA thread), and g++ builds it.  ``run_case`` calls the kernels' C
entry points and holds the result against a float64 reference that rounds
the inputs and P to bf16 where the bf16 kernel does: bf16 O within 1.6e-2
(one bf16 ulp below 2), fp32 O within 1e-5 (3xTF32 products, ~2^-21
relative; plain TF32's 2^-11 would miss it), the accumulator and fp32 P
within 2e-6, bf16 P within 4e-3.  The cases cover every head dim, both
layouts, Lq that is not a multiple of the 64- or 128-query block, Lk below
8 and 16, at and past one 64-key tile or 80-key chunk, two calls into one
accumulator, ``cond_only``, and P written from a base off a 16-byte
boundary.  The kernels' integer TF32 rounding equals ``cvt.rna.tf32.f32``'s
definition.  The bf16 entry points refuse an Lk whose block does not fit in
shared memory; every K1 and K5 route takes every Lk the former CUDA-core
kernels took.  The overlay kernels of ``csrc/overlay.cu`` run the same way
(``run_case overlay``): their pixels against the host route's, their PNG
rows against Pillow's.  On the card, ``chip_smoke.py`` and
``tests/test_torch_cuda.py`` run the same kernels against their plain
versions.
"""

import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from daam_tpu_torch.ops import kernels

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / 'daam_tpu_torch' / 'csrc'
EMULATE = ROOT / 'tests' / 'torch_emulate'
SMEM_MAX = 227 * 1024  # dynamic shared memory of one H100 block


@pytest.fixture(scope='module')
def run_case(tmp_path_factory):
    gxx = shutil.which('g++')
    if gxx is None:
        pytest.skip('needs g++ to build the emulator')
    exe = tmp_path_factory.mktemp('emulate') / 'run_case'
    build = subprocess.run(
        [gxx, '-std=c++17', '-O1', '-pthread', '-w', f'-I{CSRC}',
         str(EMULATE / 'run_case.cpp'), '-o', str(exe)],
        capture_output=True, text=True)
    assert build.returncode == 0, build.stderr[-4000:]

    def run(*args):
        proc = subprocess.run([str(exe), *map(str, args)], capture_output=True,
                              text=True, timeout=600)
        assert proc.returncode == 0, proc.stdout + proc.stderr
        return proc.stdout
    return run


# (B, H, Lq, Lk, hd, layout): every head dim in both layouts at the ragged
# Lq = 100 (a full and a partial 64-query block) and Lk = 77 (hd 40: q, k
# and v zero-filled to 48 columns in shared memory); Lk below one k16 step;
# three 80-key chunks; Lk at a chunk's edge with B = 2.
SHAPES = ([(1, 2, 100, 77, hd, layout) for hd in kernels.HEAD_DIMS
           for layout in ('head_major', 'packed')]
          + [(1, 2, 64, 13, 64, 'packed'), (1, 1, 128, 200, 64, 'packed'),
             (2, 1, 36, 80, 32, 'head_major'), (1, 1, 64, 200, 40, 'head_major'),
             (1, 1, 64, 13, 160, 'packed')])


@pytest.mark.parametrize('shape', SHAPES, ids=lambda s: '-'.join(map(str, s)))
def test_cross_attention_acc_mma_emulated(run_case, shape):
    out = run_case('acc', *shape)
    assert out.count(' ok') == 2, out


@pytest.mark.parametrize('p_type, cond_only', [('f32', 0), ('bf16', 1)])
@pytest.mark.parametrize('shape', SHAPES + [(2, 2, 37, 77, 64, 'packed')],
                         ids=lambda s: '-'.join(map(str, s)))
def test_cross_attention_probs_mma_emulated(run_case, shape, p_type, cond_only):
    B, H, Lq, Lk, hd, layout = shape
    out = run_case('probs', max(B, 2), H, Lq, Lk, hd, layout, p_type, cond_only)
    assert out.count(' ok') == 3, out


@pytest.mark.parametrize('kind', ['acc', 'f32', 'bf16'])
@pytest.mark.parametrize('hd', kernels.HEAD_DIMS)
def test_entry_points_refuse_a_block_past_shared_memory(run_case, hd, kind):
    """At Lk = 4096 q, k and v alone pass 227 KB: the entry point returns
    cudaErrorInvalidValue before it launches, so the wrapper raises."""
    p_size = {'acc': 0, 'f32': 4, 'bf16': 2}[kind]
    assert int(run_case('smem', hd, 4096, p_size)) > SMEM_MAX
    assert run_case('refuse', kind, hd, 4096).strip() == 'refused'


@pytest.mark.parametrize('hd', kernels.HEAD_DIMS)
def test_cross_route_takes_every_size_the_cuda_core_route_took(run_case, hd):
    """Every Lk whose fp32 operands the CUDA-core kernels stage (K1: 2·Lk·hd
    floats, K5: (2·hd + 64)·Lk floats) fits the tensor-core route's block."""
    k1 = SMEM_MAX // (2 * hd * 4)
    k5 = SMEM_MAX // ((2 * hd + 64) * 4)
    assert int(run_case('smem', hd, k1, 0)) <= SMEM_MAX
    for p_size in (2, 4):
        assert int(run_case('smem', hd, k5, p_size)) <= SMEM_MAX


# fp32 K2: every head dim in both layouts at the ragged Lq = 100 (one
# partial 128-query block) and Lk = 150 (two full 64-key tiles and a ragged
# one up to hd 64, 32-key tiles at hd 80 and 128, 16-key ones at hd 160 on
# mma.sync); Lk below one k8 step; Lk at one tile's edge; Lk = 77 with
# B = 2; hd 160, whose last k and v piece is a thread's partial one.
FLASH_SHAPES = ([(1, 2, 100, 150, hd, layout) for hd in kernels.HEAD_DIMS
                 for layout in ('head_major', 'packed')]
                + [(1, 1, 64, 5, 32, 'packed'), (1, 1, 64, 64, 64, 'head_major'),
                   (2, 2, 40, 77, 16, 'packed'), (1, 1, 200, 128, 128, 'head_major'),
                   (1, 1, 64, 16, 160, 'packed'), (2, 1, 130, 77, 40, 'head_major'),
                   (1, 1, 64, 9, 80, 'packed')])


@pytest.mark.parametrize('shape', FLASH_SHAPES, ids=lambda s: '-'.join(map(str, s)))
def test_flash_attention_tf32x3_emulated(run_case, shape):
    """The head dims of ``TF32X3_WGMMA_HEAD_DIMS`` run
    ``split_kv_tf32x3_kernel`` and ``flash_attention_tf32x3_wgmma_kernel``,
    the others ``flash_attention_tf32x3_kernel``; O within 1e-5 of
    float64."""
    out = run_case('flash', *shape)
    assert out.count(' ok') == 1, out


def _wgmma_tiles():
    """{hd: keys per tile} of the wgmma route, as WtTile sets them."""
    return {16: 64, 32: 64, 40: 64, 64: 64, 80: 32, 128: 32}


# fp32 K2 on wgmma, at every head dim it serves: Lk at one tile's (one
# stage's) edge, four tiles and a ragged fifth (the ring of stages wraps),
# Lk below one k8 step, and two 128-query blocks, the second holding 2 rows
# (Lq not a multiple of 128).
WGMMA_FLASH_SHAPES = [shape for hd, bk in _wgmma_tiles().items() for shape in (
    (1, 1, 64, bk, hd, 'packed'), (1, 1, 64, 4 * bk + 5, hd, 'head_major'),
    (1, 1, 64, 5, hd, 'head_major'), (1, 1, 130, bk + 1, hd, 'packed'))]


@pytest.mark.parametrize('shape', WGMMA_FLASH_SHAPES, ids=lambda s: '-'.join(map(str, s)))
def test_flash_attention_tf32x3_wgmma_edges_emulated(run_case, shape):
    out = run_case('flash', *shape)
    assert out.count(' ok') == 1, out


def test_wgmma_route_head_dims_and_tiles(run_case):
    """``kernels.TF32X3_WGMMA_HEAD_DIMS`` lists exactly the head dims
    ``wgmma_tf32x3_serves`` sends to the wgmma kernel (SD 2.x's and SDXL's
    64, SD 1.x's 40 and 80 among them), each with the keys per tile above,
    a ring of three stages (two at hd 128) and a block within 227 KB of
    shared memory."""
    rows = [tuple(map(int, line.split())) for line in run_case('wgmma32').splitlines()]
    assert tuple(hd for hd, *_ in rows) == kernels.TF32X3_WGMMA_HEAD_DIMS
    assert {40, 64, 80} <= set(kernels.TF32X3_WGMMA_HEAD_DIMS)
    assert {hd: bk for hd, bk, *_ in rows} == _wgmma_tiles()
    assert all(stages == (2 if hd == 128 else 3) and smem <= SMEM_MAX
               for hd, _, stages, smem in rows)


# fp32 K1: the bf16 kernel's cases, and Lk below one k8 step, two full
# 80-key chunks, and one chunk and a key.
ACC32_SHAPES = SHAPES + [(1, 1, 64, 5, 64, 'packed'), (1, 1, 64, 160, 16, 'head_major'),
                         (1, 2, 36, 81, 128, 'packed')]


@pytest.mark.parametrize('shape', ACC32_SHAPES, ids=lambda s: '-'.join(map(str, s)))
def test_cross_attention_acc_tf32x3_emulated(run_case, shape):
    out = run_case('acc32', *shape)
    assert out.count(' ok') == 2, out


def test_tf32_round_is_cvt_rna(run_case):
    """The kernels round to TF32 with two integer operations; they must
    give what cvt.rna.tf32.f32 gives (to nearest, ties away from zero) on
    every input tried, ties and subnormals included."""
    out = run_case('tf32')
    assert ' on 0 of ' in out, out


@pytest.mark.parametrize('hd', kernels.HEAD_DIMS)
def test_fp32_cross_route_takes_every_lk_the_cuda_core_route_took(run_case, hd):
    """The former CUDA-core fp32 K1 staged 2·Lk·hd floats, so it took Lk up
    to 227 KB / (8·hd).  The 3xTF32 kernel streams 80-key chunks, so its
    block stays under 227 KB at every Lk, and a call at that largest Lk
    holds its gates."""
    lk = SMEM_MAX // (2 * hd * 4)
    for L in (1, 77, 80, lk, 10 ** 6):
        assert int(run_case('smem32', hd, L)) <= SMEM_MAX
    out = run_case('acc32', 1, 1, 8, lk, hd, 'packed')
    assert out.count(' ok') == 2, out


# fp32 K5, one 64-query block a head where it can (the emulator spends
# about a CPU second a block): every head dim, in alternate layouts, at the
# ragged Lq = 36 and Lk = 77; a full and a partial block (Lq = 100); Lk
# below one k16 and one k8 step, one chunk and a key, two full 80-key
# chunks, and three chunks.
PROBS32_SHAPES = [(1, 1, 36, 77, 16, 'head_major'), (1, 1, 36, 77, 32, 'packed'),
                  (1, 1, 36, 77, 40, 'head_major'), (1, 1, 36, 77, 64, 'packed'),
                  (1, 1, 36, 77, 80, 'head_major'), (1, 1, 36, 77, 128, 'packed'),
                  (1, 1, 36, 77, 160, 'head_major'), (1, 1, 36, 77, 64, 'head_major'),
                  (1, 1, 100, 77, 64, 'packed'), (1, 1, 64, 13, 64, 'packed'),
                  (1, 1, 64, 5, 32, 'packed'), (1, 1, 36, 81, 128, 'head_major'),
                  (1, 1, 64, 160, 16, 'head_major'), (1, 1, 64, 200, 32, 'packed'),
                  (1, 1, 64, 200, 160, 'packed'), (1, 1, 64, 81, 80, 'head_major')]


@pytest.mark.parametrize('p_type, cond_only', [('f32', 0), ('bf16', 1)])
@pytest.mark.parametrize('shape', PROBS32_SHAPES, ids=lambda s: '-'.join(map(str, s)))
def test_cross_attention_probs_tf32x3_emulated(run_case, shape, p_type, cond_only):
    """O within 1e-5, fp32 P within 2e-6, bf16 P within 4e-3 of float64; P
    from a base off 16 bytes; under cond_only the first B/2 samples' rows
    unwritten."""
    B, H, Lq, Lk, hd, layout = shape
    out = run_case('probs32', 2 if cond_only else B, H, Lq, Lk, hd, layout, p_type,
                   cond_only)
    assert out.count(' ok') == 3, out


@pytest.mark.parametrize('p_type, cond_only', [('f32', 1), ('bf16', 0)])
@pytest.mark.parametrize('Lk', [77, 200])
def test_cross_attention_probs_tf32x3_p_types_emulated(run_case, Lk, p_type, cond_only):
    """The other pairings of P's type and cond_only, in one chunk and in
    three."""
    out = run_case('probs32', 2, 1, 64, Lk, 64, 'packed', p_type, cond_only)
    assert out.count(' ok') == 3, out


@pytest.mark.parametrize('hd', kernels.HEAD_DIMS)
def test_fp32_probs_route_takes_every_lk_the_cuda_core_route_took(run_case, hd):
    """The former CUDA-core fp32 K5 staged (2·hd + 64)·Lk floats, so it took
    Lk up to 227 KB / ((2·hd + 64)·4).  The 3xTF32 kernel streams 80-key
    chunks and writes P a chunk at a time, so its block stays under 227 KB
    at every Lk, and a call at that largest Lk holds its gates."""
    lk = SMEM_MAX // ((2 * hd + 64) * 4)
    for L in (1, 77, 80, lk, 10 ** 6):
        assert int(run_case('smem32', hd, L)) <= SMEM_MAX
    out = run_case('probs32', 1, 1, 8, lk, hd, 'packed', 'f32', 0)
    assert out.count(' ok') == 3, out


def test_head_dims_are_the_kernel_switch():
    """HEAD_DIMS (the wrappers' check) lists exactly the cases of
    ``by_head_dim``, the one switch that instantiates every kernel, and SD
    1.x's 40, 80 and 160 are among them."""
    import re

    src = (CSRC / 'attention.cu').read_text()
    switch = src[src.index('int by_head_dim(int hd, F f)'):]
    switch = switch[:switch.index('default:')]
    cases = tuple(int(x) for x in re.findall(r'case (\d+): return f\(', switch))
    assert cases == kernels.HEAD_DIMS == (16, 32, 40, 64, 80, 128, 160)


# ---------------------------------------------------------------- overlays
#
# overlay_resample_kernel and png_rows_kernel (csrc/overlay.cu) draw a
# word's overlay on the card up to PNG scanlines.  Their pixels are held
# against the host route (expand_as, _jet_composite, the rounding to uint8)
# and their filtered rows against Pillow's own, read back from its IDAT.

def _overlay_image(kind: str, H: int, W: int, rng) -> np.ndarray:
    if kind == 'noise':
        return rng.randint(0, 256, (H, W, 3)).astype(np.uint8)
    y, x = np.mgrid[0:H, 0:W].astype(np.float64)
    if kind == 'smooth':
        rgb = [np.sin(x / 7.0 + c) * np.cos(y / 5.0 - c) for c in range(3)]
        return np.round(127.5 + 127.5 * np.stack(rgb, -1)).astype(np.uint8)
    ramp = (x / max(W - 1, 1) * 0.7 + y / max(H - 1, 1) * 0.3)[..., None]
    return np.round(ramp * [255.0, 180.0, 60.0]).astype(np.uint8)  # gradient


def _host_overlay(image, heat, color_normalize: bool) -> np.ndarray:
    from daam_tpu_torch import heatmap

    expanded = heatmap.WordHeatMap(torch.from_numpy(heat)).expand_as(image)
    composite = heatmap._jet_composite(image, expanded, color_normalize)
    return np.clip(composite * 255 + 0.5, 0, 255).astype(np.uint8)


def _pillow_rows(pixels: np.ndarray) -> np.ndarray:
    """The (H, 1 + 3W) scanlines Pillow writes for ``pixels``, from its
    IDAT."""
    import io
    import struct
    import zlib

    import PIL.Image

    buf = io.BytesIO()
    PIL.Image.fromarray(pixels).save(buf, format='PNG')
    png, pos, idat = buf.getvalue(), 8, b''
    while pos < len(png):
        n, = struct.unpack('>I', png[pos:pos + 4])
        if png[pos + 4:pos + 8] == b'IDAT':
            idat += png[pos + 8:pos + 8 + n]
        pos += 12 + n
    H, W = pixels.shape[:2]
    return np.frombuffer(zlib.decompress(idat), np.uint8).reshape(H, 1 + 3 * W)


@pytest.fixture
def run_overlay(run_case, tmp_path):
    from daam_tpu_torch.heatmap import _JET_LUT

    def run(image, heat, color_normalize=True, filtered=True):
        H, W = image.shape[:2]
        h, w = heat.shape if heat is not None else (0, 0)
        src, dst = tmp_path / 'in.bin', tmp_path / 'out.bin'
        src.write_bytes(_JET_LUT.astype('<f8').tobytes()
                        + (b'' if heat is None else heat.astype('<f4').tobytes())
                        + np.ascontiguousarray(image).tobytes())
        run_case('overlay', src, dst, h, w, H, W, int(color_normalize), int(filtered))
        return np.fromfile(dst, np.uint8).reshape(H, 1 + 3 * W)
    return run


# (image, H, W, map h, w, map kind, color_normalize): noise, smooth and
# gradient images; save_heat_map's absolute False (levels color-normalized)
# and True (levels clipped); a constant map (hi = lo); non-square images;
# 64 -> 128, the main path's factor 8
OVERLAY_CASES = [('noise', 64, 64, 16, 16, 'rand', True),
                 ('smooth', 40, 40, 8, 8, 'rand', False),
                 ('gradient', 48, 80, 12, 20, 'rand', True),
                 ('noise', 36, 52, 9, 13, 'rand', False),
                 ('smooth', 40, 24, 8, 8, 'constant', True),
                 ('gradient', 32, 32, 8, 8, 'constant', False),
                 ('smooth', 128, 128, 64, 64, 'peaks', True)]


@pytest.mark.parametrize('case', OVERLAY_CASES, ids=lambda c: '-'.join(map(str, c)))
def test_overlay_kernels_emulated(run_overlay, case):
    kind, H, W, h, w, heat_kind, color_normalize = case
    rng = np.random.RandomState(H * 100 + W + h)
    image = _overlay_image(kind, H, W, rng)
    if heat_kind == 'constant':
        # zeros: the one constant whose resample is exactly constant on both
        # routes (any other sums its weights to within an ulp of it, and the
        # min-max stretches those ulps over the whole range)
        heat = np.zeros((h, w), np.float32)
    elif heat_kind == 'peaks':  # an attention-like map: a few blobs over noise
        y, x = np.mgrid[0:h, 0:w] / h
        heat = (0.02 * rng.rand(h, w) + np.exp(-((x - 0.3) ** 2 + (y - 0.6) ** 2) * 40)
                + 0.5 * np.exp(-((x - 0.7) ** 2 + (y - 0.2) ** 2) * 80)).astype(np.float32)
    else:
        heat = (rng.rand(h, w) * 3e-3).astype(np.float32)
    raw = run_overlay(image, heat, color_normalize, filtered=False)
    assert not raw[:, 0].any(), 'unfiltered rows take filter type 0'
    pixels = raw[:, 1:].reshape(H, W, 3)
    want = _host_overlay(image, heat, color_normalize)
    diff = np.abs(pixels.astype(np.int16) - want).max(-1)
    # the fp32 resample may sit an ulp off PyTorch's: a pixel moves one
    # level where a table index boundary or a rounding half lies between
    assert diff.max() <= 1, diff.max()
    assert (diff > 0).mean() <= 0.005, (diff > 0).mean()
    np.testing.assert_array_equal(run_overlay(image, heat, color_normalize),
                                  _pillow_rows(pixels))


@pytest.mark.parametrize('kind,H,W', [('noise', 24, 40), ('smooth', 40, 24), ('gradient', 33, 17)])
def test_png_rows_of_an_image_are_pillows_emulated(run_overlay, kind, H, W):
    """Without a map the rows are the image's own, filtered as Pillow
    filters them (rows equal to the one above, a flat image included)."""
    image = _overlay_image(kind, H, W, np.random.RandomState(H + W))
    image[5:9] = image[4]
    for img in (image, np.zeros_like(image)):
        np.testing.assert_array_equal(run_overlay(img, None), _pillow_rows(img))
        raw = run_overlay(img, None, filtered=False)
        assert not raw[:, 0].any()
        np.testing.assert_array_equal(raw[:, 1:].reshape(img.shape), img)


# ---------------------------------------------------------------- GEGLU
#
# geglu_kernel (csrc/geglu.cu): h * gelu(gate) of the feed-forward's
# (rows, 2w) projection output in one pass.  run_case holds each output
# element to the chain's own expression with std::erf in float, bit for
# bit, and the elements around the output to their sentinel; here the
# output is held against PyTorch's CPU chain (``ops.geglu.geglu_plain``).

def _ulp(x: torch.Tensor, dtype) -> torch.Tensor:
    """One ulp of ``dtype`` at the magnitudes ``x`` (float64, > 0)."""
    mantissa = 7 if dtype == torch.bfloat16 else 23
    return torch.pow(2.0, torch.floor(torch.log2(x.clamp_min(1e-30))) - mantissa)


# (dtype, rows, w, offset): the 16-byte route with 37 rows (more chunks
# than a block's threads: a second step of the walk) and 300 (several
# blocks); widths that are not a multiple of a 16-byte chunk and a base off
# 16 bytes, which take the kernel one element at a time; a width of 3
GEGLU_CASES = [('bf16', 37, 64, 0), ('bf16', 300, 128, 0), ('bf16', 37, 52, 0),
               ('bf16', 37, 64, 3), ('bf16', 5, 3, 0), ('f32', 37, 64, 0),
               ('f32', 300, 64, 0), ('f32', 37, 50, 0), ('f32', 37, 64, 1)]


@pytest.mark.parametrize('case', GEGLU_CASES, ids=lambda c: '-'.join(map(str, c)))
def test_geglu_kernel_emulated(run_case, tmp_path, case):
    """The kernel equals the std::erf expression bit for bit (run_case) and
    the CPU chain within one ulp of the output dtype at s = |h|·max(|g|, 1),
    plus 5e-7·s: PyTorch's CPU GELU is a vectorized polynomial within
    3.6e-7·max(|g|, 1) of the exact GELU (measured over [-12, 12]), glibc's
    erff within an ulp of erf, so in fp32 the two chains part by a few ulps
    where the card's chain and the kernel share their bits."""
    from daam_tpu_torch.ops.geglu import geglu_plain

    dtype_name, rows, w, offset = case
    dtype = torch.bfloat16 if dtype_name == 'bf16' else torch.float32
    rng = np.random.RandomState(rows * 1000 + w + offset)
    x = rng.randn(rows, 2 * w).astype(np.float32)
    x[:, w:] *= 2.5  # gates out to the GELU's flat negative tail
    x[0, w:w + 3] = (-12.0, 0.0, 12.0)[:w]
    x = torch.from_numpy(x).to(dtype)
    src, dst = tmp_path / 'in.bin', tmp_path / 'out.bin'
    (x.view(torch.int16) if dtype == torch.bfloat16 else x).numpy().tofile(src)
    out = run_case('geglu', dtype_name, rows, w, offset, src, dst)
    assert ' 0 ok' in out and out.count(' ok') == 2, out
    raw = np.fromfile(dst, np.int16 if dtype == torch.bfloat16 else np.float32)
    got = torch.from_numpy(raw).view(dtype).reshape(rows, w)
    want = geglu_plain(x)
    h, g = x[:, :w].double().abs(), x[:, w:].double().abs().clamp_min(1)
    scale = h * g
    err = (got.double() - want.double()).abs()
    assert (err <= _ulp(scale, dtype) + 5e-7 * scale).all(), err.max()
