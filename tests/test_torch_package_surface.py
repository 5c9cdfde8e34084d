"""The port's package surface against the JAX package's: the subpackage
exports, the lazy top level, ``timed_block``, the ``tdt-torch-*`` scripts
and ``load_model``'s error for a class that is not registered.

Every JAX subpackage's ``__init__`` names (read with ``ast``) import from
the port's subpackage of the same name, and the port's ``__init__``
imports no other names. Each subpackage, and the top level, is imported
first in a fresh interpreter (all started together, about 10 s): no
compiler is started by the import (the kernels build with nvcc, the
TFRecord codec with g++), no library is loaded, no process group is joined, no JAX is imported, and
the bare top level leaves torch out.
"""

import ast
import json
import os
import subprocess
import sys
import time
import tomllib

import pytest

import telluride_decoding_tpu
from telluride_decoding_tpu.utils import profiling as jax_profiling
from telluride_decoding_torch.models import brain_model
from telluride_decoding_torch.utils import profiling

from test_torch_parallel import subprocess_env

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUBPACKAGES = ('ops', 'solvers', 'models', 'data', 'decode', 'decide',
               'signal', 'io', 'sweep', 'parallel', 'cli', 'utils')
IMPORT_TIMEOUT_S = 120


def exported_names(package: str, sub: str):
    """{name: module} that the subpackage's __init__ imports."""
    path = os.path.join(REPO, package, sub, '__init__.py')
    with open(path) as f:
        tree = ast.parse(f.read())
    return {alias.asname or alias.name: node.module
            for node in tree.body if isinstance(node, ast.ImportFrom)
            for alias in node.names}


_FIRST_IMPORT = '''
import os, subprocess, sys

started = subprocess.Popen


def refuse_builds(args, *rest, **kwargs):
    program = os.path.basename(str(args[0] if isinstance(args, (list, tuple))
                                   else args).split()[0])
    if program in ('nvcc', 'g++', 'gcc', 'c++', 'cc'):
        raise AssertionError('a build was started at import: %r' % (args,))
    return started(args, *rest, **kwargs)


subprocess.Popen = refuse_builds   # Kernel and codec builds run these.
import telluride_decoding_torch
if {sub!r}:
    import importlib
    importlib.import_module('telluride_decoding_torch.' + {sub!r})
else:
    assert 'torch' not in sys.modules, 'the top level imported torch'
    models = telluride_decoding_torch.models
    assert 'telluride_decoding_torch.models' in sys.modules
    assert models.BrainModelCCA.__module__ == \\
        'telluride_decoding_torch.models.cca'
    print(telluride_decoding_torch.__version__)
from telluride_decoding_torch import _native, kernels
import torch.distributed as dist
assert _native._LIB is None, 'the TFRecord codec was loaded'
assert kernels._lib is None, 'the kernel library was loaded'
assert not (dist.is_available() and dist.is_initialized())
leaked = [m for m in sys.modules if m == 'jax' or m.startswith(
    ('jax.', 'telluride_decoding_tpu'))]
assert not leaked, leaked
'''


@pytest.fixture(scope='module')
def first_imports():
    """{subpackage or '': (returncode, stdout, stderr)} of one fresh
    interpreter each, all run at once."""
    env = subprocess_env()
    procs = {sub: subprocess.Popen(
        [sys.executable, '-c', _FIRST_IMPORT.format(sub=sub)], env=env,
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for sub in ('',) + SUBPACKAGES}
    results = {}
    try:
        for sub, proc in procs.items():
            out, err = proc.communicate(timeout=IMPORT_TIMEOUT_S)
            results[sub] = (proc.returncode, out, err)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return results


@pytest.mark.parametrize('sub', [s for s in SUBPACKAGES if s != 'cli'])
def test_subpackage_exports_the_jax_names(sub):
    import importlib
    jax_names = exported_names('telluride_decoding_tpu', sub)
    torch_names = exported_names('telluride_decoding_torch', sub)
    assert jax_names, sub
    assert set(torch_names) == set(jax_names)
    module = importlib.import_module('telluride_decoding_torch.' + sub)
    for name, jax_module in jax_names.items():
        value = getattr(module, name)
        want = jax_module.replace('telluride_decoding_tpu',
                                  'telluride_decoding_torch')
        assert torch_names[name] == want, name
        owner = getattr(value, '__module__', None)
        if owner is not None:
            assert owner.startswith('telluride_decoding_torch.'), (name,
                                                                   owner)


@pytest.mark.parametrize('sub', SUBPACKAGES)
def test_subpackage_imports_first_in_a_fresh_interpreter(first_imports,
                                                         sub):
    code, _, err = first_imports[sub]
    assert code == 0, err[-3000:]


def test_top_level_is_lazy_and_versioned(first_imports):
    code, out, err = first_imports['']
    assert code == 0, err[-3000:]
    assert out.strip() == telluride_decoding_tpu.__version__ == '0.1.0'
    import telluride_decoding_torch
    assert telluride_decoding_torch._SUBPACKAGES == \
        telluride_decoding_tpu._SUBPACKAGES
    with pytest.raises(AttributeError, match='no attribute'):
        telluride_decoding_torch.kernels_of_another_name


@pytest.mark.parametrize('verbose', [False, True])
def test_timed_block_is_the_jax_one(capsys, verbose):
    """The same block timed by both: the label stored, sync called once
    before the clock stops (a 20 ms sync is inside the time), and the
    same printed line."""
    printed = []
    for module in (jax_profiling, profiling):
        results, calls = {}, []

        def sync():
            calls.append(1)
            time.sleep(0.02)

        with module.timed_block('step', results, sync=sync,
                                verbose=verbose):
            sum(range(1000))
        assert calls == [1]
        assert list(results) == ['step']
        assert 0.02 <= results['step'] < 5.0
        lines = capsys.readouterr().out.splitlines()
        assert len(lines) == int(verbose)
        printed.append([line.split(':')[0] for line in lines])
        if verbose:
            assert lines[0].endswith(' ms')
        with module.timed_block('bare'):
            pass
    assert printed[0] == printed[1]


def _scripts():
    with open(os.path.join(REPO, 'pyproject.toml'), 'rb') as f:
        return tomllib.load(f)['project']['scripts']


JAX_SCRIPTS = sorted(name for name, target in _scripts().items()
                     if target.startswith('telluride_decoding_tpu.'))


def test_every_jax_script_is_in_the_list():
    assert len(JAX_SCRIPTS) == 10
    assert not [name for name in _scripts() if name not in JAX_SCRIPTS
                and not name.startswith('tdt-torch-')]


@pytest.mark.parametrize('name', JAX_SCRIPTS)
def test_every_jax_script_has_a_torch_twin(name):
    import importlib
    scripts = _scripts()
    twin = 'tdt-torch-' + name[len('tdt-'):]
    assert twin in scripts, twin
    want = scripts[name].replace('telluride_decoding_tpu.',
                                 'telluride_decoding_torch.')
    assert scripts[twin] == want
    module_name, func = scripts[twin].split(':')
    assert func == 'app_main'
    assert callable(getattr(importlib.import_module(module_name), func))


@pytest.mark.parametrize('module,flag', [
    ('decoding', 'device'), ('regression', 'device'), ('cohort', 'device'),
    ('infer', 'device')])
def test_entry_points_default_to_the_card(module, flag):
    import importlib
    cli = importlib.import_module('telluride_decoding_torch.cli.' + module)
    assert cli.build_parser().get_default(flag) == 'cuda'


def test_a_twin_runs_help():
    """tdt-torch-regression --help through its app_main, as the console
    script calls it: exit 0, the JAX flags and the port's --device."""
    code = ('import sys; sys.argv = ["tdt-torch-regression", "--help"]; '
            'from telluride_decoding_torch.cli.regression import app_main; '
            'app_main()')
    proc = subprocess.run([sys.executable, '-c', code], cwd=REPO,
                          env=subprocess_env(), capture_output=True,
                          text=True, timeout=IMPORT_TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert '--device' in proc.stdout
    assert '--regularization_list' in proc.stdout


def test_load_model_names_an_unknown_class(tmp_path):
    with open(tmp_path / 'model.json', 'w') as f:
        json.dump({'model_class': 'BrainModelUnheardOf', 'config': {}}, f)
    with pytest.raises(ValueError) as info:
        brain_model.load_model(str(tmp_path), 'cpu')
    text = str(info.value)
    assert text.startswith('Unknown model class BrainModelUnheardOf in ')
    for name in ('BrainModelCCA', 'BrainModelClassifier', 'BrainModelDCCA',
                 'BrainModelDNN', 'BrainModelLinearRegression'):
        assert name in text
    assert 'port' not in text
