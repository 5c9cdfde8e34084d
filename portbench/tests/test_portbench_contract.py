"""BENCHMARK.json against the benchmark's contract: names and units,
the files each entry names, which cells report which metric, and the
import rule for everything run.py loads."""

import json
import os
import re
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')
PATH = re.compile(r'^[A-Za-z0-9_./-]{1,200}$')


@pytest.fixture(scope='module')
def bench():
    with open(os.path.join(ROOT, 'BENCHMARK.json')) as f:
        return json.load(f)


def test_keys_and_sizes(bench):
    assert set(bench) == {'command', 'paths', 'run_seconds', 'configs',
                          'workloads', 'end_to_end', 'per_layer'}
    assert os.path.getsize(os.path.join(ROOT, 'BENCHMARK.json')) <= 64 * 1024
    assert 1 <= len(bench['paths']) <= 16
    assert all(PATH.match(p) and '..' not in p and not p.startswith('/')
               for p in bench['paths'])
    assert len(bench['command']) <= 32
    assert isinstance(bench['run_seconds'], int)
    assert 1 <= bench['run_seconds'] <= 51
    cells = len(bench['workloads'])
    assert 1 <= cells <= 24 and 1 <= len(bench['configs']) <= 24
    assert 1 <= len(bench['end_to_end']) <= 16
    assert 1 <= len(bench['per_layer']) <= 128
    # A full check of 24 cells must fit its time.
    runs = 2 + 14 * 24
    assert (runs * (bench['run_seconds'] + 60) + 24 * 2 * 90 + 1200
            <= 43200)


def test_names_units_and_texts(bench):
    entries = (bench['configs'] + bench['workloads'] + bench['end_to_end'] +
               bench['per_layer'])
    names = [e['name'] for e in entries]
    for group in ('configs', 'workloads', 'end_to_end', 'per_layer'):
        group_names = [e['name'] for e in bench[group]]
        assert len(group_names) == len(set(group_names)), group
    metric_names = [m['name'] for m in bench['end_to_end'] +
                    bench['per_layer']]
    assert len(metric_names) == len(set(metric_names))
    for name in names:
        assert NAME.match(name), name
    for cell in bench['workloads']:
        assert NAME.match(cell['config']) and NAME.match(cell['traffic'])
    for config in bench['configs']:
        assert len(config['reduced']) <= 16
        assert all(NAME.match(k) for k in config['reduced'])
    for metric in bench['end_to_end'] + bench['per_layer']:
        assert UNIT.match(metric['unit']), metric
        assert metric['better'] in ('lower', 'higher')
    texts = ([e['why'] for e in bench['workloads'] + bench['configs']] +
             [c['source'] for c in bench['configs']] +
             [m['layer'] for m in bench['per_layer']] + bench['command'])
    for text in texts:
        assert 1 <= len(text) <= 200 and '\n' not in text and '\t' not in text


def test_entries_have_exactly_their_keys(bench):
    for config in bench['configs']:
        assert set(config) == {'name', 'source', 'file', 'reduced', 'why'}
    for cell in bench['workloads']:
        assert set(cell) == {'name', 'config', 'traffic', 'chips', 'why'}
        assert cell['chips'] in (1, 4)
    for metric in bench['end_to_end']:
        assert set(metric) - {'workloads'} == {
            'name', 'unit', 'better', 'bound', 'source'}
        assert metric['source'] in ('host_clock', 'device_trace')
        assert 0.01 <= metric['bound'] <= 0.25
    for metric in bench['per_layer']:
        assert set(metric) - {'workloads'} == {
            'name', 'unit', 'better', 'source', 'layer', 'moves'}
        assert metric['source'] in ('device_trace', 'program_span',
                                    'program_counter', 'host_clock')


def _reports(metric, cell):
    return 'workloads' not in metric or cell in metric['workloads']


def test_every_cell_reports_what_it_should(bench):
    cells = [c['name'] for c in bench['workloads']]
    e2e = {m['name']: m for m in bench['end_to_end']}
    assert 'setup_s' in e2e and e2e['setup_s'].get('workloads') is None
    pairs = {(c['config'], c['traffic']) for c in bench['workloads']}
    assert len(pairs) == len(cells)
    for cell in cells:
        assert sum(_reports(m, cell) for m in e2e.values()) >= 2
        assert any(_reports(m, cell) for m in bench['per_layer'])
    for metric in bench['per_layer']:
        moved = e2e[metric['moves']]
        for cell in metric.get('workloads', cells):
            assert cell in cells and _reports(moved, cell), metric['name']
    for metric in e2e.values():
        assert set(metric.get('workloads', cells)) <= set(cells)
    used = {c['config'] for c in bench['workloads']}
    assert used == {c['name'] for c in bench['configs']}
    rooflines = [m for m in bench['per_layer']
                 if m['name'].endswith('_roofline')]
    for roofline in rooflines:
        assert roofline['unit'] == '%'
        assert any('mfu' in m['name'].split('.') and
                   m['moves'] == roofline['moves'] and m['unit'] == '%'
                   for m in bench['per_layer'])


def test_named_files_exist(bench):
    for path in bench['paths']:
        assert os.path.isdir(os.path.join(ROOT, path))
    assert os.path.isfile(os.path.join(ROOT, bench['command'][-1]))
    for config in bench['configs']:
        assert config['file'].startswith(bench['paths'][0] + '/')
        with open(os.path.join(ROOT, config['file'])) as f:
            cfg = json.load(f)
        assert cfg['source'] == config['source']
        assert cfg['reduced'] == config['reduced']
    for cell in bench['workloads']:
        for part in (('traffic', cell['traffic'] + '.json'),
                     ('limits', cell['name'] + '.json')):
            assert os.path.isfile(os.path.join(ROOT, 'portbench', *part))
    for metric in bench['per_layer']:
        assert os.path.isfile(os.path.join(
            ROOT, 'portbench', 'metrics', metric['name'] + '.py'))


def test_forbidden_names_compare_whole():
    sys.path.insert(0, ROOT)
    from portbench import run
    before = dict(sys.modules)
    try:
        sys.modules['telluride_decoding_tpux'] = sys.modules['os']
        sys.modules['jaxtools.sub'] = sys.modules['os']
        assert run.forbidden_modules() == []
        sys.modules['jax.numpy'] = sys.modules['os']
        sys.modules['telluride_decoding_tpu.ops'] = sys.modules['os']
        assert run.forbidden_modules() == ['jax', 'telluride_decoding_tpu']
    finally:
        for key in set(sys.modules) - set(before):
            del sys.modules[key]


def test_nothing_run_loads_is_jax():
    """Every module of the benchmark and each program module a cell
    drives, imported in a fresh interpreter: no top-level name (compared
    whole) is JAX's or the JAX package's."""
    code = '''
import glob, importlib, os, sys
sys.path.insert(0, %r)
from portbench import run, control
from portbench.harness import common, flops, gen, serve, sweep, trace
from portbench.reference import decode, precision, ssd
from portbench.reference import sweep as ref_sweep
from telluride_decoding_torch.cli import serve as cli_serve
from telluride_decoding_torch.sweep import engine
from telluride_decoding_torch.utils import profiling
for path in glob.glob(os.path.join(%r, 'portbench', 'metrics', '*.py')):
    run.read_metric(os.path.basename(path)[:-3], {'kind': None})
print(run.forbidden_modules())
''' % (ROOT, ROOT)
    out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT,
                         env=dict(os.environ, USE_FLAX='0'))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == '[]'
