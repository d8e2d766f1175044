"""Gigabytes per second of the program's ``heads.d2h``, ``heads.h2d`` and
``heads.cat`` spans in the profiled request: the bytes each span states
over the seconds it took (pageable or pinned host memory shows here)."""

from gpubench.core import spans

LAYER = 'Trace'
UNIT = 'GB/s'
BETTER = 'higher'
SOURCE = 'program_counter'
MOVES = 'images_per_s'
NAMES = ('heads.d2h', 'heads.h2d', 'heads.cat')

def read(data):
    sp = [x for x in spans.program_spans(data) or [] if x[2] in NAMES]
    seconds = sum(e - s for s, e, _, _ in sp) / 1e6
    nbytes = sum(attrs.get('bytes', 0) for _, _, _, attrs in sp)
    return nbytes / seconds / 1e9 if seconds > 0 and nbytes else None
