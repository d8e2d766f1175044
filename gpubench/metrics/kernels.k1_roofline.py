"""K1 ``cross_attention_acc``'s share of its roofline over one profiled
request: the least time of the captured cross-attentions' conditional
halves that the configuration's shapes imply (the float32 accumulator read
and written counted; ``core/counters.py``) over the profiler's device time
of the kernels named below, one a call.  No K5 runs in the cells that list
it, whose kernels K1 shares."""

from gpubench.core import counters

LAYER = 'Kernels'
UNIT = '%'
BETTER = 'higher'
SOURCE = 'device_trace'
MOVES = 'images_per_s'
NAMES = ('cross_attention_mma_kernel', 'cross_attention_tf32x3_kernel')


def read(data):
    return counters.roofline_share(data, 'k1', NAMES, lambda dtype, hd: 1)
