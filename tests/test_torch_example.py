"""examples/full_pipeline_torch.py on the CPU against the same five steps
through the JAX package (examples/full_pipeline.py's code, on the same
simulated arrays), at a reduced size: 4 trials of 2000 frames, one
window size (100 frames). About 30 s, half of it the JAX side's.

Tolerances (PERF.md §2's port-against-JAX bounds), each with its reason:
  * the TFRecords, byte for byte: one encoder, in both packages;
  * step 3's r within 1e-4 abs and d' within 1e-3 rel: float32 fits and
    scores in another order of summation;
  * step 4's best lambda equal and its [lambda, file] grid within 1e-4
    abs: float32 solves of the same moments;
  * step 5's accuracy within one window's share (1 / windows): a
    decision that flips on a near tie moves it by one window.
"""

import os

import numpy as np
import pytest

from examples import full_pipeline as jax_example
from examples import full_pipeline_torch as example

FRAMES = 2000
WINDOWS = [100]
R_TOL = 1e-4
DPRIME_RTOL = 1e-3
GRID_TOL = 1e-4


def run_jax_steps(workdir, monkeypatch, frames, window_list):
    """examples/full_pipeline.py's steps through the JAX package, sized;
    also returns the sweep's [lambda, file] grid."""
    from telluride_decoding_tpu.cli import decoding, infer, regression
    from telluride_decoding_tpu.io import (BrainExperiment,
                                           MemoryBrainDataFile)
    records_dir = os.path.join(workdir, 'records')
    model_dir = os.path.join(workdir, 'model')
    trials = jax_example.simulate_subject(np.random.RandomState(0),
                                          frames=frames)
    trial_dict = {}
    for k, (s1, s2, labels, eeg) in enumerate(trials):
        name = ('test_%02d' if k == len(trials) - 1 else 'train_%02d') % k
        trial_dict[name] = [
            {'loudness': s1[:, None], 'loudness2': s2[:, None],
             'attend': labels},
            MemoryBrainDataFile({'eeg_data': eeg},
                                sr=jax_example.FRAME_RATE)]
    exp = BrainExperiment(trial_dict, frame_rate=jax_example.FRAME_RATE)
    exp.load_all_data()
    for trial in exp.iterate_trials():
        trial.assemble_brain_data('eeg_data')
    exp.write_all_data(records_dir)
    flags = decoding.DecodingOptions().set_from_dict(dict(
        tfexample_dir=records_dir, input_field='eeg',
        output_field='loudness', attended_field='attend',
        frame_rate=jax_example.FRAME_RATE, pre_context=0,
        post_context=jax_example.IR_FRAMES - 1,
        dnn_regressor='linear', regularization_lambda=1e-3,
        batch_size=200, shuffle_buffer_size=0,
        train_file_pattern='train', validate_file_pattern='test',
        test_file_pattern='test',
        summary_dir=os.path.join(workdir, 'summary'),
        saved_model_dir=model_dir))
    _, test_results, dprime = decoding.run_decoding_experiment(flags)

    grids = []
    real_sweep = regression.engine.ridge_jackknife_sweep

    def keep_grid(*args, **kwargs):
        result = real_sweep(*args, **kwargs)
        grids.append(np.asarray(result.correlations))
        return result

    monkeypatch.setattr(regression.engine, 'ridge_jackknife_sweep',
                        keep_grid)
    obj = regression.RegressionLinear(flags)
    obj.my_flags.post_context = jax_example.IR_FRAMES - 1
    obj.my_flags.output_field = 'loudness'
    results = obj.jackknife_over_regularizations(
        flags, np.logspace(-6, 1, 8),
        summary_base_dir=os.path.join(workdir, 'sweep'))
    best = max(results.items(), key=lambda kv: kv[1][0])
    accuracy = infer.run_reduction_test(
        model_dir, records_dir, ['train'], ['test'],
        reduction='lda', decoder_type='ssd',
        audio_label_1='loudness', audio_label_2='loudness2',
        window_list=window_list)
    return dict(records_dir=records_dir,
                r=float(test_results['pearson_correlation_first']),
                dprime=float(dprime), grid=grids[0],
                best_lambda=float(best[0]), accuracy=accuracy)


@pytest.mark.parametrize('num_trials,frames', [(4, 3000), (2, 500)])
def test_simulate_subject_is_the_jax_examples(num_trials, frames):
    want = jax_example.simulate_subject(np.random.RandomState(0),
                                        num_trials, frames)
    got = example.simulate_subject(np.random.RandomState(0), num_trials,
                                   frames)
    assert len(got) == len(want) == num_trials
    for got_trial, want_trial in zip(got, want):
        for a, b in zip(got_trial, want_trial):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_example_on_the_cpu_is_the_jax_steps(tmp_path, monkeypatch):
    port = example.main(str(tmp_path / 'torch'), frames=FRAMES,
                        window_list=WINDOWS, device='cpu')
    assert set(port['seconds']) == {'simulate', 'ingest', 'decoding',
                                    'sweep', 'ssd'}
    want = run_jax_steps(str(tmp_path / 'jax'), monkeypatch, FRAMES,
                         WINDOWS)

    names = sorted(os.listdir(want['records_dir']))
    assert [os.path.basename(f) for f in port['records']] == names
    for name in names:
        with open(os.path.join(want['records_dir'], name), 'rb') as f:
            want_bytes = f.read()
        with open(os.path.join(port['workdir'], 'records', name),
                  'rb') as f:
            assert f.read() == want_bytes, name

    assert abs(port['r'] - want['r']) <= R_TOL
    np.testing.assert_allclose(port['dprime'], want['dprime'],
                               rtol=DPRIME_RTOL)
    assert port['best_lambda'] == want['best_lambda']
    grid = np.genfromtxt(port['sweep_csv'], delimiter=',')
    np.testing.assert_allclose(grid[:, 0], np.logspace(-6, 1, 8),
                               rtol=1e-12)
    np.testing.assert_allclose(grid[:, 1:], want['grid'], rtol=0,
                               atol=GRID_TOL)
    for lamb, (mean, std) in port['sweep'].items():
        row = want['grid'][list(port['sweep']).index(lamb)]
        assert abs(mean - row.mean()) <= GRID_TOL
        assert abs(std - row.std()) <= GRID_TOL

    assert list(port['accuracy']) == list(want['accuracy']) == WINDOWS
    for window in WINDOWS:
        share = 1.0 / (2 * FRAMES // window - 1)   # Windows at step w / 2.
        assert abs(port['accuracy'][window] -
                   want['accuracy'][window]) <= share, window
    assert port['accuracy'][WINDOWS[0]] > 0.7


def test_example_refuses_a_missing_card(tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip('a card is present; the refusal needs none')
    with pytest.raises(RuntimeError, match='No CUDA device'):
        example.main(str(tmp_path), device='cuda')
    assert not os.listdir(tmp_path)
