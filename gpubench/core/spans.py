"""The program's own spans inside the profiled request.

``daam_tpu_torch.profiling`` records a span around each stage of the work
(the pipeline call, the text encode, each step, the UNet and its blocks,
the scheduler, the heads copies, the decode, the maps, the overlays) while
a ``torch.profiler`` session records, on the profiler's clock
(``time.time_ns``).  The readers here keep the spans that lie inside the
profiled request, ``[profile.t0, profile.t1]`` (microseconds on the same
clock), and lay them over the request's idle gaps.  A program without
spans, or a run without a profile, gives None.
"""

from typing import Dict, List, Optional, Tuple

Span = Tuple[float, float, str, Dict[str, float]]  # start µs, end µs, name, attrs


def program_spans(data: dict) -> Optional[List[Span]]:
    """The program's spans inside the profiled request, by start; None
    without a profile or where the program records no spans."""
    p = data.get('profile')
    if p is None:
        return None
    try:
        from daam_tpu_torch import profiling
    except ImportError:
        return None
    read = getattr(profiling, 'spans', None)
    if read is None:
        return None
    out = []
    for r in read():
        s, e = r.start_ns / 1000, r.end_ns / 1000  # int / int: rounded once
        if p.t0 <= s and e <= p.t1:
            out.append((s, e, r.name, dict(r.attrs)))
    return sorted(out, key=lambda x: (x[0], -x[1])) or None


def images(data: dict) -> int:
    """Images the profiled request made."""
    return sum(n for _, n in data.get('profile_runs') or [])


def union(intervals) -> List[Tuple[float, float]]:
    merged: List[List[float]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def overlap(gaps, intervals) -> float:
    """Length of the gaps' time that the intervals cover (µs)."""
    a, b = union(gaps), union(intervals)
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def innermost(spans: List[Span]) -> List[Tuple[float, float, str]]:
    """The time the spans cover, cut into pieces, each named after the
    innermost span over it: of those over it, the one that started last
    (of two that started together, the one that ends first)."""
    bounds = sorted({x for s, e, _, _ in spans for x in (s, e)})
    by_start = sorted(range(len(spans)), key=lambda k: spans[k][0])
    active: Dict[int, Span] = {}
    out = []
    nxt = 0
    for a, b in zip(bounds, bounds[1:]):
        while nxt < len(by_start) and spans[by_start[nxt]][0] <= a:
            active[by_start[nxt]] = spans[by_start[nxt]]
            nxt += 1
        for k in [k for k, sp in active.items() if sp[1] <= a]:
            del active[k]
        if active:
            s, e, name, _ = max(active.values(), key=lambda sp: (sp[0], -sp[1]))
            if out and out[-1][2] == name and out[-1][1] == a:
                out[-1] = (out[-1][0], b, name)
            else:
                out.append((a, b, name))
    return out


def idle_by_name(profile, spans: List[Span]) -> Dict[str, float]:
    """Idle microseconds of the request by the innermost span over them
    (``''`` where no span is)."""
    pieces = innermost(spans)
    out: Dict[str, float] = {}
    for name in {n for _, _, n in pieces}:
        out[name] = overlap(profile.gaps, [(s, e) for s, e, n in pieces if n == name])
    covered = sum(out.values())
    out[''] = sum(e - s for s, e in profile.gaps) - covered
    return out
