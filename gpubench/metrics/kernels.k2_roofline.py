"""K2 ``flash_attention``'s share of its roofline over one profiled request:
the least time of the attention calls that the configuration's shapes
imply for the request (every UNet ``attn1``, the unconditional half of each
captured cross-attention, the uncaptured cross-attentions; see
``core/counters.py``) over the profiler's device time of the kernels named
below (float32 at hd 16-128 launches two a call: the split of K and V, and
the attention)."""

from gpubench.core import counters

LAYER = 'Kernels'
UNIT = '%'
BETTER = 'higher'
SOURCE = 'device_trace'
MOVES = 'images_per_s'
NAMES = ('flash_attention_wgmma_kernel', 'split_kv_tf32x3_kernel',
         'flash_attention_tf32x3_wgmma_kernel', 'flash_attention_tf32x3_kernel')


def launches_per_call(dtype, hd):
    return 2 if dtype == 'float32' and hd <= 128 else 1


def read(data):
    return counters.roofline_share(data, 'k2', NAMES, launches_per_call)
