"""Milliseconds per image of the program's ``heads.d2h``, ``heads.h2d`` and
``heads.cat`` spans in the profiled request: the saved probabilities
stacked and copied to host memory, copied back each step of the load run,
and joined into one buffer on the host."""

from gpubench.core import spans

LAYER = 'Trace'
UNIT = 'ms'
BETTER = 'lower'
SOURCE = 'host_clock'
MOVES = 'images_per_s'
NAMES = ('heads.d2h', 'heads.h2d', 'heads.cat')

def read(data):
    sp = spans.program_spans(data)
    us = [e - s for s, e, name, _ in sp or [] if name in NAMES]
    n = spans.images(data)
    return sum(us) / 1e3 / n if us and n else None
