"""Milliseconds per image of the program's ``overlay.resize`` spans in the
profiled request: the word map's bicubic resample to the image's size, its
min-max and its copy to host memory (twice a word: ``expand_as`` resamples
for what it returns and again for the overlay it draws)."""

from gpubench.core import spans

LAYER = 'Experiment'
UNIT = 'ms'
BETTER = 'lower'
SOURCE = 'host_clock'
MOVES = 'images_per_s'

def read(data):
    sp = spans.program_spans(data)
    us = [e - s for s, e, name, _ in sp or [] if name == 'overlay.resize']
    n = spans.images(data)
    return sum(us) / 1e3 / n if us and n else None
