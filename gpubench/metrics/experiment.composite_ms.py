"""Milliseconds per image of the program's ``overlay.composite`` spans in the
profiled request: the image as an array, the jet colour map and its blend
with the image."""

from gpubench.core import spans

LAYER = 'Experiment'
UNIT = 'ms'
BETTER = 'lower'
SOURCE = 'host_clock'
MOVES = 'images_per_s'

def read(data):
    sp = spans.program_spans(data)
    us = [e - s for s, e, name, _ in sp or [] if name == 'overlay.composite']
    n = spans.images(data)
    return sum(us) / 1e3 / n if us and n else None
