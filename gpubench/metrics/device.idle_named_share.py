"""Share of the profiled request's idle time (no kernel, copy or set on
the card) that the program names: time whose innermost program span
exists and is not the pipeline call's own ``call`` (``torch.profiler``'s
gaps laid exactly over the program's spans, one clock)."""

from gpubench.core import spans

LAYER = 'Device'
UNIT = '%'
BETTER = 'higher'
SOURCE = 'device_trace'
MOVES = 'images_per_s'

def read(data):
    sp = spans.program_spans(data)
    if sp is None:
        return None
    idle = spans.idle_by_name(data['profile'], sp)
    total = sum(idle.values())
    named = sum(v for k, v in idle.items() if k not in ('', 'call'))
    return 100.0 * named / total if total > 0 else None
