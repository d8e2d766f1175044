"""Find a cell's files by the names in ``BENCHMARK.json``.

A workload names a configuration (``configs/<config>.json``) and a traffic
mix (``traffic/<traffic>.json``); the traffic file names its flow
(``flows/<flow>.py``) and its caption grammar
(``traffic/grammar/<grammar>.json``); each per-layer metric is
``metrics/<name>.py``; the limits of the comparison that decides
``correct`` are ``limits/<workload>.json``.  Nothing here needs an edit when a later change
adds a cell, a mix, a flow or a metric: only files and entries.
"""

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List

ROOT = Path(__file__).resolve().parents[1]          # gpubench/
REPO = ROOT.parent


def load_module(path: Path) -> ModuleType:
    """Import a file by path (metric files have dots in their names)."""
    name = 'gpubench_' + path.stem.replace('.', '_').replace('-', '_')
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def benchmark() -> dict:
    with (REPO / 'BENCHMARK.json').open() as f:
        return json.load(f)


def cell(name: str, bench: dict) -> Dict:
    """Everything one run of workload ``name`` needs."""
    by_name = {w['name']: w for w in bench['workloads']}
    if name not in by_name:
        raise SystemExit(f'unknown workload {name!r}; known: {sorted(by_name)}')
    w = by_name[name]
    config = json.loads((ROOT / 'configs' / f"{w['config']}.json").read_text())
    traffic = json.loads((ROOT / 'traffic' / f"{w['traffic']}.json").read_text())
    traffic['grammar'] = json.loads(
        (ROOT / 'traffic' / 'grammar' / f"{traffic['grammar']}.json").read_text())
    limits = json.loads((ROOT / 'limits' / f'{name}.json').read_text())
    return {'workload': w, 'config': config, 'traffic': traffic, 'limits': limits,
            'flow': load_module(ROOT / 'flows' / f"{traffic['flow']}.py"),
            'end_to_end': metrics_for(name, bench['end_to_end'], None),
            'per_layer': metrics_for(name, bench['per_layer'], bench['end_to_end'])}


def metrics_for(workload: str, metrics: List[dict], end_to_end) -> List[dict]:
    """The metrics that the cell reports: those that list it, and those
    without a list whose end-to-end metric the cell reports."""
    e2e = ({m['name'] for m in metrics_for(workload, end_to_end, None)}
           if end_to_end is not None else None)
    out = []
    for m in metrics:
        if 'workloads' in m:
            if workload in m['workloads']:
                out.append(m)
        elif e2e is None or m['moves'] in e2e:
            out.append(m)
    return out


def reader(metric: dict) -> ModuleType:
    return load_module(ROOT / 'metrics' / f"{metric['name']}.py")
