"""Peak device memory the program allocated in the window
(``torch.cuda.max_memory_allocated`` after a reset at the window's start;
the benchmark's own weights are freed before it)."""

LAYER = 'Device'
UNIT = 'GiB'
BETTER = 'lower'
SOURCE = 'program_counter'
MOVES = 'images_per_s'

def read(data):
    return data['peak_bytes'] / 2 ** 30 if data['peak_bytes'] else None
