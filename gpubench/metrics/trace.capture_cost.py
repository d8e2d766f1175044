"""Seconds per denoising step with the DAAM capture over seconds per step
without it: the same prompts and generator seeds, two traced and two
untraced calls in turns after the window, outside any profiler session
(CUDA events, steps after the first)."""

LAYER = 'Trace'
UNIT = 'ratio'
BETTER = 'lower'
SOURCE = 'device_trace'
MOVES = 'images_per_s'

def read(data):
    return data['capture_cost']
