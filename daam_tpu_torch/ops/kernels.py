"""Build and launch the hand-written CUDA kernels of ``csrc/attention.cu``.

The sources are compiled with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface, at first use, under
``build/daam_tpu_torch/<hash of the sources, headers and flags>/libattention.so``
in the checkout, and bound with :mod:`ctypes`.  Nothing here touches CUDA at
import time, so CPU-only hosts import the module freely; the launchers raise
on a tensor that is not on a CUDA device.

Each launcher checks device, dtype, shape and strides, allocates its output
with ``torch.empty``, launches on PyTorch's current stream without
synchronizing, raises if the launch reported a CUDA error, and then adds one
to its count in :data:`launches` (the proof that a run went through the
kernel).  The plain PyTorch versions of the same functions live in
:mod:`daam_tpu_torch.ops.attention`.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

import torch

__all__ = ['flash_attention', 'cross_attention_acc', 'cross_attention_probs',
           'launches', 'reset_launches', 'load_library', 'tma_view_error',
           'cross_route_error', 'HEAD_DIMS']

_CSRC = Path(__file__).resolve().parents[1] / 'csrc'
_BUILD_ROOT = Path(__file__).resolve().parents[2] / 'build' / 'daam_tpu_torch'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')
HEAD_DIMS = (16, 32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_INT_MAX = 2 ** 31 - 1
_SMEM_MAX = 227 * 1024

#: Kernel launches since the last :func:`reset_launches`, by launcher name.
#: ``flash_attention_wgmma``, ``cross_attention_acc_mma`` and
#: ``cross_attention_probs_mma`` count the launches of the bf16 routes,
#: ``flash_attention_tf32x3`` and ``cross_attention_acc_tf32x3`` those of
#: the fp32 routes (all on the tensor cores); the launcher's own total counts
#: them too.  fp32 ``cross_attention_probs`` (CUDA cores) has no count of
#: its own.
launches = {'flash_attention': 0, 'flash_attention_wgmma': 0,
            'flash_attention_tf32x3': 0,
            'cross_attention_acc': 0, 'cross_attention_acc_mma': 0,
            'cross_attention_acc_tf32x3': 0,
            'cross_attention_probs': 0, 'cross_attention_probs_mma': 0}

_lib: Optional[ctypes.CDLL] = None
#: Seconds the first :func:`load_library` spent building and loading.
build_seconds: Optional[float] = None
#: ``nvcc`` output of the build of the loaded library (``-Xptxas -v``:
#: registers and spills per kernel), kept beside it as ``build.log``.
build_log: str = ''


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _library_path() -> Path:
    """Build path keyed by the flags and every source and header."""
    digest = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for src in sorted([*_CSRC.glob('*.cu'), *_CSRC.glob('*.cuh')]):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return _BUILD_ROOT / digest.hexdigest()[:16] / 'libattention.so'


def _build(out: Path) -> str:
    nvcc = shutil.which('nvcc') or os.path.join(
        os.environ.get('CUDA_HOME', '/usr/local/cuda'), 'bin', 'nvcc')
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f'{out.name}.{os.getpid()}.tmp')
    cmd = [nvcc, *NVCC_FLAGS, '-o', str(tmp),
           *(str(s) for s in sorted(_CSRC.glob('*.cu')))]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f'nvcc failed ({proc.returncode}):\n{proc.stderr}')
    log = proc.stdout + proc.stderr
    tmp_log = out.with_name(f'build.log.{os.getpid()}.tmp')
    tmp_log.write_text(log)
    # atomic: a concurrent build never sees half a file
    os.replace(tmp_log, out.parent / 'build.log')
    os.replace(tmp, out)
    return log


def load_library() -> ctypes.CDLL:
    """Build (if the sources changed) and load the kernel library."""
    global _lib, build_seconds, build_log
    if _lib is not None:
        return _lib
    t0 = time.perf_counter()
    path = _library_path()
    if not path.exists():
        build_log = _build(path)
    else:
        log = path.parent / 'build.log'
        build_log = log.read_text() if log.exists() else ''
    lib = ctypes.CDLL(str(path))
    ptr, i = ctypes.c_void_p, ctypes.c_int
    common = [i, i, ptr, ptr, ptr, ptr]  # device, hd, q, k, v, o
    dims = [i] * 4 + [i] * 9 + [ctypes.c_float, ptr]
    for fn, extra in ((lib.daam_flash_attention_tf32x3, []),
                      (lib.daam_flash_attention_wgmma, []),
                      (lib.daam_cross_attention_acc_tf32x3, [ptr]),
                      (lib.daam_cross_attention_acc_mma, [ptr]),
                      (lib.daam_cross_attention_probs, [ptr, i, i]),
                      (lib.daam_cross_attention_probs_mma, [ptr, i, i])):
        fn.argtypes = common + extra + dims
        fn.restype = i
    lib.daam_error_string.argtypes = [i]
    lib.daam_error_string.restype = ctypes.c_char_p
    _lib = lib
    build_seconds = time.perf_counter() - t0
    return lib


def _check_qkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """Validate (B, L, H, hd) views; returns (B, Lq, Lk, H, hd)."""
    for name, t in (('q', q), ('k', k), ('v', v)):
        if not t.is_cuda:
            raise ValueError(f'{name} must be a CUDA tensor, got {t.device}')
        if t.dim() != 4:
            raise ValueError(f'{name} must be a (B, L, H, hd) view, '
                             f'got shape {tuple(t.shape)}')
        if t.stride(3) != 1:
            raise ValueError(f'{name}: the head dim must be contiguous, '
                             f'strides {t.stride()}')
        if t.dtype not in _DTYPE_CODES:
            raise ValueError(f'{name}: dtype {t.dtype} not supported')
        if max(t.stride()) > _INT_MAX:
            raise ValueError(f'{name}: strides {t.stride()} exceed int32')
    if not (q.device == k.device == v.device):
        raise ValueError('q, k and v must be on one device')
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f'dtype mismatch: {q.dtype}, {k.dtype}, {v.dtype}')
    B, Lq, H, hd = q.shape
    Lk = k.shape[1]
    if k.shape != (B, Lk, H, hd) or v.shape != k.shape:
        raise ValueError(f'k/v shapes {tuple(k.shape)}, {tuple(v.shape)} do '
                         f'not match q {tuple(q.shape)}')
    if hd not in HEAD_DIMS:
        raise ValueError(f'head dim {hd} not in {HEAD_DIMS}')
    if min(B, Lq, Lk, H) < 1 or B * Lq * H * hd > _INT_MAX:
        raise ValueError(f'unsupported sizes B={B} Lq={Lq} Lk={Lk} H={H}')
    return B, Lq, Lk, H, hd


def tma_view_error(shape, strides, data_ptr: int,
                   itemsize: int) -> Optional[str]:
    """Why a (B, L, H, hd) view cannot be a TMA or 16-byte cp.async source,
    or None if it can.

    Both need a 16-byte-aligned base and b, l, h strides that are positive
    multiples of 16 bytes (the hd stride is 1).  Pure: shapes, strides in
    elements and the address as integers.
    """
    if data_ptr % 16:
        return f'base address {data_ptr:#x} is not 16-byte aligned'
    if any(s <= 0 or (s * itemsize) % 16 for s in strides[:3]):
        return (f'strides {tuple(strides)} of shape {tuple(shape)}: b, l and '
                f'h strides must be positive multiples of 16 bytes')
    return None


def cross_route_error(views, Lq: int, acc_ptr=None,
                      itemsize: int = 2) -> Optional[str]:
    """Why a tensor-core ``cross_attention_acc`` kernel (``acc_ptr`` given:
    bf16, or fp32 with ``itemsize`` 4) or the bf16 ``cross_attention_probs``
    kernel cannot take these operands, or None.

    ``views``: ``{name: (shape, strides, data_ptr)}`` of the q, k and v
    views, which the kernels copy in 16-byte pieces (the conditions of
    :func:`tma_view_error`).  The accumulator tile moves in 16-byte pieces
    too: acc's base must be 16-byte aligned and Lq a multiple of 4.  Pure:
    shapes, strides and addresses as integers.  (An Lk whose block does not
    fit in shared memory is refused by the bf16 kernels' entry point, and
    the launch raises; the fp32 kernel streams long Lk through.)
    """
    for name, (shape, strides, ptr) in views.items():
        why = tma_view_error(shape, strides, ptr, itemsize)
        if why:
            return f'{name}: {why}'
    if acc_ptr is not None:
        if acc_ptr % 16:
            return f'acc base address {acc_ptr:#x} is not 16-byte aligned'
        if Lq % 4:
            return f'Lq={Lq}: the accumulator tile needs Lq % 4 == 0'
    return None


def _route_check(name, q, k, v, Lq, **kw):
    why = cross_route_error({n: (t.shape, t.stride(), t.data_ptr())
                             for n, t in (('q', q), ('k', k), ('v', v))},
                            Lq, itemsize=q.element_size(), **kw)
    if why:
        raise ValueError(f'{q.dtype} {name} runs on the tensor cores, which '
                         f'cannot take this call: {why}')


def _args(q, k, v):
    strides = [s for t in (q, k, v) for s in t.stride()[:3]]
    return strides, ctypes.c_float(q.shape[3] ** -0.5), \
        torch.cuda.current_stream(q.device).cuda_stream


def _raise_on(err: int, name: str):
    if err:
        msg = load_library().daam_error_string(err).decode()
        raise RuntimeError(f'{name} launch failed: CUDA error {err} ({msg})')


def flash_attention(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """softmax(q kᵀ / √hd) v on the card.

    ``q``: (B, Lq, H, hd), ``k``/``v``: (B, Lk, H, hd) views with a
    contiguous hd axis.  Returns (B, Lq, H·hd).

    The kernel is chosen by dtype; both run on the tensor cores.  bf16 takes
    ``flash_attention_wgmma_kernel`` (wgmma for both products, TMA loads),
    fp32 ``flash_attention_tf32x3_kernel`` (mma.sync for both products in
    3xTF32: each operand split into two TF32 parts and three products
    taken, which keeps fp32 accuracy; cp.async loads).  TMA and cp.async
    both read in 16-byte pieces, so every view needs a 16-byte-aligned base
    and b, l, h strides that are multiples of 16 bytes
    (:func:`tma_view_error`; any other view raises).
    """
    B, Lq, Lk, H, hd = _check_qkv(q, k, v)
    bf16 = q.dtype == torch.bfloat16
    for name, t in (('q', q), ('k', k), ('v', v)):
        why = tma_view_error(t.shape, t.stride(), t.data_ptr(), t.element_size())
        if why:
            raise ValueError(f'{name}: {q.dtype} flash_attention reads its inputs '
                             f'by {"TMA" if bf16 else "16-byte cp.async"}: {why}')
    o = torch.empty(B, Lq, H * hd, dtype=q.dtype, device=q.device)
    strides, scale, stream = _args(q, k, v)
    lib = load_library()
    launch = (lib.daam_flash_attention_wgmma if bf16
              else lib.daam_flash_attention_tf32x3)
    err = launch(q.device.index, hd, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 o.data_ptr(), B, H, Lq, Lk, *strides, scale, stream)
    _raise_on(err, 'flash_attention')
    launches['flash_attention'] += 1
    launches['flash_attention_wgmma' if bf16 else 'flash_attention_tf32x3'] += 1
    return o


def cross_attention_acc(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        acc: torch.Tensor) -> torch.Tensor:
    """Cross-attention that also adds Pᵀ into ``acc`` in place.

    ``q``: (B, Lq, H, hd), ``k``/``v``: (B, Lk, H, hd) views as for
    :func:`flash_attention`; ``acc``: contiguous fp32 (B, H, Lk, Lq).
    Returns the attention output (B, Lq, H·hd).

    The kernel is chosen by dtype; both run on the tensor cores with
    16-byte copies of the operands and of the acc tile, and raise on a call
    they cannot take (:func:`cross_route_error`).  bf16 takes
    ``cross_attention_mma_kernel`` (mma.sync for both products; an Lk whose
    block passes 227 KB of shared memory fails at launch), fp32
    ``cross_attention_tf32x3_kernel`` (the same block in 3xTF32, as
    :func:`flash_attention`; it streams a long Lk through in 80-key chunks,
    so every Lk fits).
    """
    B, Lq, Lk, H, hd = _check_qkv(q, k, v)
    if acc.dtype != torch.float32 or tuple(acc.shape) != (B, H, Lk, Lq) \
            or not acc.is_contiguous() or acc.device != q.device:
        raise ValueError(f'acc must be contiguous fp32 {(B, H, Lk, Lq)} on '
                         f'{q.device}, got {acc.dtype} {tuple(acc.shape)} '
                         f'on {acc.device}')
    bf16 = q.dtype == torch.bfloat16
    _route_check('cross_attention_acc', q, k, v, Lq, acc_ptr=acc.data_ptr())
    o = torch.empty(B, Lq, H * hd, dtype=q.dtype, device=q.device)
    strides, scale, stream = _args(q, k, v)
    lib = load_library()
    launch = (lib.daam_cross_attention_acc_mma if bf16
              else lib.daam_cross_attention_acc_tf32x3)
    err = launch(q.device.index, hd, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 o.data_ptr(), acc.data_ptr(), B, H, Lq, Lk, *strides, scale,
                 stream)
    _raise_on(err, 'cross_attention_acc')
    launches['cross_attention_acc'] += 1
    launches['cross_attention_acc_mma' if bf16 else 'cross_attention_acc_tf32x3'] += 1
    return o


def cross_attention_probs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          cond_only: bool = False,
                          probs_dtype: torch.dtype = torch.float32):
    """Cross-attention that also writes its probabilities out.

    ``q``: (B, Lq, H, hd), ``k``/``v``: (B, Lk, H, hd) views as for
    :func:`flash_attention`.  Returns ``(o, p)``: the output (B, Lq, H·hd)
    and P (B, H, Lq, Lk) in ``probs_dtype`` (float32 or bfloat16).  With
    ``cond_only`` (CFG layout ``[uncond; cond]``) the rows of the first B/2
    samples of P are left unwritten.

    Routed by the dtype of q, k and v: bf16 on the tensor cores
    (``cross_attention_mma_kernel``, raising on a call
    :func:`cross_route_error` refuses), fp32 on the CUDA cores
    (``cross_attention_probs_kernel``, any strides; (2·hd + 64)·Lk floats
    must fit in 227 KB of shared memory).
    """
    B, Lq, Lk, H, hd = _check_qkv(q, k, v)
    if probs_dtype not in _DTYPE_CODES:
        raise ValueError(f'probs_dtype {probs_dtype} not supported')
    tensor_cores = q.dtype == torch.bfloat16
    if tensor_cores:
        _route_check('cross_attention_probs', q, k, v, Lq)
    elif (2 * Lk * hd + 64 * Lk) * 4 > _SMEM_MAX:
        raise ValueError(f'Lk={Lk} x hd={hd} does not fit in shared memory')
    o = torch.empty(B, Lq, H * hd, dtype=q.dtype, device=q.device)
    p = torch.empty(B, H, Lq, Lk, dtype=probs_dtype, device=q.device)
    strides, scale, stream = _args(q, k, v)
    lib = load_library()
    launch = (lib.daam_cross_attention_probs_mma if tensor_cores
              else lib.daam_cross_attention_probs)
    err = launch(q.device.index, hd, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 o.data_ptr(), p.data_ptr(), _DTYPE_CODES[probs_dtype],
                 B // 2 if cond_only else 0, B, H, Lq, Lk, *strides, scale,
                 stream)
    _raise_on(err, 'cross_attention_probs')
    launches['cross_attention_probs'] += 1
    if tensor_cores:
        launches['cross_attention_probs_mma'] += 1
    return o, p
