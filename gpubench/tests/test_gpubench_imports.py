"""No module of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the program.  Top-level module names are
compared whole: ``daam_tpu_torch`` is not ``daam_tpu``."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {'jax', 'jaxlib', 'flax', 'daam_tpu'}
FILES = sorted(ROOT.rglob('*.py'))


def top_level_imports(path: Path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split('.')[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split('.')[0])
        elif isinstance(node, ast.Call) and getattr(node.func, 'attr', '') == 'import_module':
            if node.args and isinstance(node.args[0], ast.Constant):
                names.add(str(node.args[0].value).split('.')[0])
    return names


@pytest.mark.parametrize('path', FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize('path', sorted((ROOT / 'reference').rglob('*.py')),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert not top_level_imports(path) & (FORBIDDEN | {'daam_tpu_torch', 'gpubench'})


def test_whole_names():
    from gpubench.core.runner import forbidden_modules
    import types
    sys.modules['daam_tpu_torch_probe'] = types.ModuleType('daam_tpu_torch_probe')
    try:
        assert 'daam_tpu' not in forbidden_modules()
    finally:
        del sys.modules['daam_tpu_torch_probe']


def test_harness_loads_no_jax():
    """Import the harness, the flows, the metrics and the program in a fresh
    interpreter and look at ``sys.modules``, as a run does."""
    code = ('import sys; sys.path.insert(0, %r)\n'
            'from gpubench.core import runner, spec, readings\n'
            'b = spec.benchmark()\n'
            'for w in b["workloads"]:\n'
            '    c = spec.cell(w["name"], b)\n'
            '    [spec.reader(m) for m in c["per_layer"]]\n'
            'import daam_tpu_torch\n'
            'print(runner.forbidden_modules())' % str(ROOT.parent))
    out = subprocess.run([sys.executable, '-c', code], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == '[]'
