"""The tensor-core kernels behind K1, K2 and K5, run on the CPU.

``cross_attention_mma_kernel`` (``daam_tpu_torch/csrc/attention.cu``: bf16
``cross_attention_acc`` and ``cross_attention_probs``) and the fp32 3xTF32
kernels ``flash_attention_tf32x3_kernel`` and
``cross_attention_tf32x3_kernel`` need nvcc and a card.  Here
``tests/torch_emulate/run_case.cpp`` includes ``attention.cu`` after
``tests/torch_emulate/warp.h``, a CPU stand-in for the CUDA runtime and the
warp-level operations the kernels use (cp.async, ldmatrix, mma.sync
m16n8k16 in bf16 and m16n8k8 in TF32, whose operands it truncates to TF32
as the tensor core reads them, ``__shfl_xor_sync``, barriers; one thread
per CUDA thread), and g++ builds it.  ``run_case`` calls the kernels' C
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
shared memory; both K1 routes take every Lk the former CUDA-core kernel
took.  On the card, ``chip_smoke.py`` and ``tests/test_torch_cuda.py`` run
the same kernels against their plain versions.
"""

import shutil
import subprocess
from pathlib import Path

import pytest

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
# Lq = 100 (a full and a partial 64-query block) and Lk = 77; Lk below one
# k16 step; three 80-key chunks; Lk at a chunk's edge with B = 2.
SHAPES = ([(1, 2, 100, 77, hd, layout) for hd in (16, 32, 64, 128)
           for layout in ('head_major', 'packed')]
          + [(1, 2, 64, 13, 64, 'packed'), (1, 1, 128, 200, 64, 'packed'),
             (2, 1, 36, 80, 32, 'head_major')])


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
# one); Lk below one k8 step; Lk at one tile's edge; Lk = 77 with B = 2.
FLASH_SHAPES = ([(1, 2, 100, 150, hd, layout) for hd in (16, 32, 64, 128)
                 for layout in ('head_major', 'packed')]
                + [(1, 1, 64, 5, 32, 'packed'), (1, 1, 64, 64, 64, 'head_major'),
                   (2, 2, 40, 77, 16, 'packed'), (1, 1, 200, 128, 128, 'head_major')])


@pytest.mark.parametrize('shape', FLASH_SHAPES, ids=lambda s: '-'.join(map(str, s)))
def test_flash_attention_tf32x3_emulated(run_case, shape):
    out = run_case('flash', *shape)
    assert out.count(' ok') == 1, out


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
