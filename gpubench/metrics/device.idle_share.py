"""Share of one whole profiled request (the host's time from its start to
its images, maps and files) with no kernel, copy or set running on the
card (``torch.profiler``)."""

LAYER = 'Device'
UNIT = '%'
BETTER = 'lower'
SOURCE = 'device_trace'
MOVES = 'images_per_s'

def read(data):
    p = data['profile']
    return None if p is None or p.window_s <= 0 else 100.0 * (1.0 - p.busy_s / p.window_s)
