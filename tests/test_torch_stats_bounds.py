"""The port's utils/stats_bounds.py against the JAX package's: each case
of tests/test_stats_bounds.py runs on both modules (``[jax]`` and
``[torch]``) with the same inputs, and the two give the same summaries,
z-scores, messages and golden files (float64 numpy and json on both
sides, so equal, not close)."""

import json

import numpy as np
import pytest

from telluride_decoding_tpu.utils import stats_bounds as jax_bounds
from telluride_decoding_torch.utils import stats_bounds

MODULES = {'jax': jax_bounds, 'torch': stats_bounds}


@pytest.fixture(params=sorted(MODULES))
def module(request):
    return MODULES[request.param]


def test_summarize(rng, module):
    values = 0.5 + 0.1 * rng.randn(1000)
    s = module.summarize_results(values)
    assert s['mean'] == pytest.approx(0.5, abs=0.02)
    assert s['std'] == pytest.approx(0.1, abs=0.02)
    assert s['count'] == 1000


def test_bounds_pass_and_fail(module):
    golden = {'mean': 0.5, 'std': 0.05, 'count': 100}
    z = module.check_within_bounds(0.55, golden)
    assert z == pytest.approx(1.0)
    with pytest.raises(module.BoundViolation):
        module.check_within_bounds(0.25, golden)  # 5 sigma low.
    with pytest.raises(module.BoundViolation):
        module.check_within_bounds(0.55, golden, num_sigmas=0.5)


def test_golden_results_roundtrip(tmp_path, rng, module):
    path = str(tmp_path / 'golden.json')
    g = module.GoldenResults(path)
    assert g.check('corr', 0.5) is None        # No golden yet.
    g.record('corr', 0.5 + 0.02 * rng.randn(50))
    g2 = module.GoldenResults(path)            # Reload from disk.
    assert g2.check('corr', 0.5) == pytest.approx(0.0, abs=1.0)
    with pytest.raises(module.BoundViolation):
        g2.check('corr', 0.9)
    assert g2.names() == ['corr']


def test_same_summaries_and_messages(rng):
    values = rng.randn(257) * 3.0 + 1.0
    assert stats_bounds.summarize_results(values) == \
        jax_bounds.summarize_results(values)
    golden = {'mean': 0.5, 'std': 0.0, 'count': 1}   # The 1e-12 floor.
    for value in (0.5, 0.5 + 1e-13, 0.7):
        outcomes = []
        for mod in (jax_bounds, stats_bounds):
            try:
                outcomes.append(mod.check_within_bounds(value, golden, 2.0,
                                                        label='r'))
            except mod.BoundViolation as error:
                outcomes.append(str(error))
        assert outcomes[0] == outcomes[1]


def test_golden_files_are_the_same_and_cross_load(tmp_path, rng):
    values = {'a': rng.randn(40), 'b': 0.3 + rng.randn(9)}
    paths = {}
    for name, mod in MODULES.items():
        paths[name] = str(tmp_path / name / 'golden.json')
        g = mod.GoldenResults(paths[name])
        for key, v in values.items():
            g.record(key, v)
    texts = [open(paths[name]).read() for name in sorted(MODULES)]
    assert texts[0] == texts[1]
    for reader, writer in (('torch', 'jax'), ('jax', 'torch')):
        g = MODULES[reader].GoldenResults(paths[writer])
        assert g.names() == ['a', 'b']
        golden = json.loads(texts[0])['b']
        assert g.check('b', golden['mean'] + golden['std']) == \
            pytest.approx(1.0)
