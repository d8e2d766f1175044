"""The tensor-core kernels behind K1 and K5, run on the CPU.

``cross_attention_mma_kernel`` (``daam_tpu_torch/csrc/attention.cu``: bf16
``cross_attention_acc`` and ``cross_attention_probs``) needs nvcc and a
card.  Here ``tests/torch_emulate/run_case.cpp`` includes ``attention.cu``
after ``tests/torch_emulate/warp.h``, a CPU stand-in for the CUDA runtime
and the warp-level operations the kernel uses (cp.async, ldmatrix, mma.sync
m16n8k16, ``__shfl_xor_sync``, barriers; one thread per CUDA thread), and
g++ builds it.  ``run_case`` calls the kernel's C entry points and holds
the result against a float64 reference that rounds the inputs and P to
bf16 where the kernel does: O within 1.6e-2 (one bf16 ulp below 2), the
accumulator and fp32 P within 2e-6, bf16 P within 4e-3.  The cases cover
every head dim, both layouts, Lq that is not a multiple of the 64-query
block, Lk below 16, past one 80-key chunk and at a chunk's edge, two calls
into one accumulator, ``cond_only``, and P written from a base off a
16-byte boundary.  The entry points refuse an Lk whose block does not fit
in shared memory, and take every Lk the CUDA-core kernels took.  On the
card, ``chip_smoke.py`` runs the same kernels against their plain versions.
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
