"""``BENCHMARK.json`` and the files it names: each cell's configuration,
traffic, flow, limits and metrics exist and name each other, and every
name, unit and line keeps to the benchmark's character rules."""

import json
import re

import pytest

from gpubench.core import spec

BENCH = spec.benchmark()
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.\-]{1,16}$')
CELLS = [w['name'] for w in BENCH['workloads']]


def _line(text):
    return 1 <= len(text) <= 200 and '\n' not in text and '\t' not in text


def test_keys_and_sizes():
    assert set(BENCH) == {'command', 'paths', 'run_seconds', 'configs', 'workloads',
                          'end_to_end', 'per_layer'}
    assert 1 <= BENCH['run_seconds'] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024
    assert all(re.fullmatch(r'[A-Za-z0-9_.\-/]{1,200}', p) for p in BENCH['paths'])
    assert all(_line(w) for w in BENCH['command'])
    assert 1 <= len(BENCH['workloads']) <= 24 and 1 <= len(BENCH['configs']) <= 24
    assert any(m['name'] == 'setup_s' and m['bound'] <= 0.25 for m in BENCH['end_to_end'])


def test_names_units_lines():
    for group in ('configs', 'workloads', 'end_to_end', 'per_layer'):
        names = [e['name'] for e in BENCH[group]]
        assert len(names) == len(set(names)), group
        for e in BENCH[group]:
            assert NAME.match(e['name']), e['name']
            if 'unit' in e:
                assert UNIT.match(e['unit']) and e['better'] in ('lower', 'higher')
            for key in ('why', 'layer', 'source'):
                if key in e:
                    assert _line(e[key]), (e['name'], key)
    for w in BENCH['workloads']:
        assert NAME.match(w['config']) and NAME.match(w['traffic']) and w['chips'] in (1, 4)
    pairs = [(w['config'], w['traffic']) for w in BENCH['workloads']]
    assert len(pairs) == len(set(pairs))


def test_metric_entries():
    e2e = {m['name'] for m in BENCH['end_to_end']}
    for m in BENCH['end_to_end']:
        assert set(m) <= {'name', 'unit', 'better', 'bound', 'source', 'workloads'}
        assert m['source'] in ('host_clock', 'device_trace') and 0.01 <= m['bound'] <= 0.25
    for m in BENCH['per_layer']:
        assert set(m) <= {'name', 'unit', 'better', 'source', 'layer', 'moves', 'workloads'}
        assert m['moves'] in e2e and set(m['workloads']) <= set(CELLS)


@pytest.mark.parametrize('workload', CELLS)
def test_cell_files_name_each_other(workload):
    cell = spec.cell(workload, BENCH)
    w = cell['workload']
    assert cell['config']['name'] == w['config']
    assert cell['traffic']['name'] == w['traffic']
    assert cell['traffic']['grammar']['labels'], 'the traffic names a grammar file'
    assert hasattr(cell['flow'], 'Flow')
    cfg_entry = {c['name']: c for c in BENCH['configs']}[w['config']]
    assert cfg_entry['file'] == f"gpubench/configs/{w['config']}.json"
    assert cfg_entry['source'] == cell['config']['source']
    assert cell['limits']['limits'] and cell['limits']['sampled_requests'] >= 1
    reported = {m['name'] for m in cell['per_layer']}
    assert reported, 'every cell reports a per-layer metric'
    for m in cell['per_layer']:
        r = spec.reader(m)
        assert (r.LAYER, r.UNIT, r.BETTER, r.SOURCE, r.MOVES) == (
            m['layer'], m['unit'], m['better'], m['source'], m['moves'])
        assert callable(r.read)


def test_every_config_is_used():
    used = {w['config'] for w in BENCH['workloads']}
    assert used == {c['name'] for c in BENCH['configs']}


def test_configs_hold_the_program_presets():
    from daam_tpu_torch.models.configs import get_pipeline_config
    from gpubench.core.runner import program_config_mismatch

    for c in BENCH['configs']:
        cfg = json.loads((spec.REPO / c['file']).read_text())
        assert program_config_mismatch(cfg, get_pipeline_config(cfg['program_preset'])) == []
