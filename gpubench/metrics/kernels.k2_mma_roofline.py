"""K2 ``flash_attention``'s float32 one-kernel route, its share of its
roofline over one profiled request: the least time of the float32 K2 calls
whose head dim is outside the program's ``TF32X3_WGMMA_HEAD_DIMS`` (SD
1.x's hd 160: the self-attention and the captured cross-attention's
unconditional half at 16² and 8²; ``core/counters.py``'s calls and bounds)
over the profiler's device time of ``flash_attention_tf32x3_kernel``, one
launch a call.  None where the request makes no such call."""

import sys

from daam_tpu_torch.ops.kernels import TF32X3_WGMMA_HEAD_DIMS
from gpubench.core import counters
from gpubench.reference.schedulers import evaluations

LAYER = 'Kernels'
UNIT = '%'
BETTER = 'higher'
SOURCE = 'device_trace'
MOVES = 'images_per_s'
NAMES = ('flash_attention_tf32x3_kernel',)


def mma_calls(cfg: dict, batch: int, mode: str):
    """One UNet evaluation's K2 calls that take the mma.sync route."""
    if cfg['dtype'] != 'float32':
        return []
    return [c for c in counters.attention_calls(cfg, batch, mode)
            if c['kernel'] == 'k2' and c['hd'] not in TF32X3_WGMMA_HEAD_DIMS]


def read(data):
    p = data['profile']
    if p is None:
        return None
    cfg = data['cfg']
    n = evaluations(cfg, data['steps'])
    calls = [c for kind, batch in data['profile_runs']
             for c in mma_calls(cfg, batch, counters.MODE[kind])]
    bound = n * sum(counters.attention_bound_s(c, cfg['dtype']) for c in calls)
    seconds, seen = p.device_s(NAMES)
    if seen != n * len(calls):
        print(f'k2 mma: {seen} launches profiled, {n * len(calls)} expected', file=sys.stderr)
    return 100.0 * bound / seconds if seconds > 0 and bound > 0 else None
