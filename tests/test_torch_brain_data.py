"""Dataset assembly of the PyTorch port vs the JAX package.

The same TFRecord files feed TFExampleData in both packages. File order
and allbut subsets come from the same seeded numpy shuffle, so they are
identical; so are the minibatches of create_dataset (shuffles, mixup,
mismatch and the reference protocol all draw from that generator in the
same order), which must be equal bit for bit. load_arrays is a host copy
and agrees exactly, except where
a field spec runs a filter (atol 1e-3, the JAX suite's bound for a pole
near DC, tests/test_signal.py:34-37). streaming_moments agrees within
1e-4 of each statistic's largest magnitude: float32 sums in another
order; through that highpass spec, within the same filter bound,
1e-3 of the largest magnitude.
"""

import os

import numpy as np
import pytest
import torch

from telluride_decoding_tpu.data import brain_data as jax_bd
from telluride_decoding_torch.data import brain_data, records

STATS_REL = 1e-4
FILES = ['S%d_T%d' % (s, t) for s in (1, 2) for t in range(4)]


@pytest.fixture
def data_dir(tmp_path):
    rng = np.random.RandomState(11)
    for i, name in enumerate(FILES):
        n = 300 + 17 * i
        eeg = rng.randn(n, 5).astype(np.float32) + 0.5
        intensity = np.abs(rng.randn(n, 1)).astype(np.float32)
        records.convert_data_to_tfrecords(
            {'eeg': eeg, 'intensity': intensity,
             'intensity2': np.abs(rng.randn(n, 1)).astype(np.float32),
             'attended_speaker': np.zeros((n, 1), np.float32)},
            str(tmp_path / name[:2] / (name + '.tfrecords')))
    return str(tmp_path)


def _pair(data_dir, **kwargs):
    args = dict(in_fields='eeg', out_field='intensity', frame_rate=64,
                pre_context=1, post_context=4, in2_fields='intensity2',
                in2_pre_context=2, in2_post_context=2, data_dir=data_dir,
                train_file_pattern='allbut', validate_file_pattern='S1_T2',
                test_file_pattern='S2_T1', shuffle_seed=3)
    args.update(kwargs)
    return (brain_data.TFExampleData(device='cpu', **args),
            jax_bd.TFExampleData(**args))


def _assert_stats_close(got, want, rel=STATS_REL):
    for name, g, w in zip(got._fields, got, want):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape, name
        scale = max(np.max(np.abs(w)), 1e-30)
        assert np.max(np.abs(g - w)) <= rel * scale, name


def test_file_order_and_patterns_match_jax(data_dir):
    port, ref = _pair(data_dir)
    assert port.all_files() == ref.all_files()
    assert port.all_files() != sorted(port.all_files())     # Shuffled.
    for mode in ('train', 'validate', 'test'):
        assert port.filter_file_names(mode) == ref.filter_file_names(mode)
    for pattern in ('allbut', 'allbut_3'):
        port.set_file_patterns(pattern, 'S1_T2', 'S2_T1')
        ref.set_file_patterns(pattern, 'S1_T2', 'S2_T1')
        assert port.filter_file_names('train') == \
            ref.filter_file_names('train')
    assert len(port.filter_file_names('train')) == 3
    assert port.input_fields_width(1) == ref.input_fields_width(1) == 30
    assert port.input_fields_width(2) == ref.input_fields_width(2) == 5


@pytest.mark.parametrize('in_fields,tol', [
    ('eeg', 0.0), ('eeg(highpass_cutoff=0.5)', 1e-3)],
    ids=['plain', 'highpass_spec'])
def test_load_arrays_match_jax(data_dir, in_fields, tol):
    port, ref = _pair(data_dir, in_fields=in_fields)
    for mode in ('train', 'test'):
        for g, w in zip(port.load_arrays(mode), ref.load_arrays(mode)):
            assert g.shape == w.shape
            np.testing.assert_allclose(g, w, atol=tol, rtol=0)
    (name, got), = list(port.iter_file_arrays('test'))
    assert name == port.filter_file_names('test')[0]
    assert got[0].shape[1] == 30


@pytest.mark.parametrize('y_source,in_fields,offset,rel', [
    ('output', 'eeg', 0, STATS_REL), ('input_2', 'eeg', 0, STATS_REL),
    ('input_2', 'eeg(highpass_cutoff=0.5)', 0, 1e-3),
    ('input_2', 'eeg', 2, STATS_REL)],
    ids=['output', 'input_2', 'highpass_spec', 'offset'])
def test_streaming_moments_match_jax(data_dir, y_source, in_fields, offset,
                                     rel):
    port, ref = _pair(data_dir, in_fields=in_fields, input_offset=offset)
    got = port.streaming_moments('train', y_source=y_source, want_syy=True)
    want = ref.streaming_moments('train', y_source=y_source, want_syy=True)
    assert float(got.count) == float(want.count)
    _assert_stats_close(got, want, rel)


def test_streaming_moments_equal_dense_arrays(data_dir):
    """The masked, filled per-file pass equals the moments of the
    concatenated context-stacked arrays (the JAX package's contract)."""
    port, _ = _pair(data_dir)
    got = port.streaming_moments('train', y_source='input_2', want_syy=True)
    in1, in2, _, _ = port.load_arrays('train')
    x, y = torch.from_numpy(in1).double(), torch.from_numpy(in2).double()
    assert float(got.count) == in1.shape[0]
    np.testing.assert_allclose(got.sxy.numpy(), (x.T @ y).numpy(),
                               rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(got.sxx.numpy(), (x.T @ x).numpy(),
                               rtol=1e-4, atol=1e-3)


def test_test_brain_data_matches_jax(rng):
    x = rng.randn(100, 3).astype(np.float32)
    y = rng.randn(100, 1).astype(np.float32)
    args = dict(in_fields='input_1', out_field='output', frame_rate=100,
                pre_context=1, post_context=2)
    port = brain_data.create_brain_dataset('test', device='cpu', **args)
    ref = jax_bd.create_brain_dataset('test', **args)
    port.preserve_test_data(x, y)
    ref.preserve_test_data(x, y)
    for g, w in zip(port.load_arrays('train'), ref.load_arrays('train')):
        np.testing.assert_array_equal(g, w)
    assert port.input_fields_width(1) == ref.input_fields_width(1) == 12
    with pytest.raises(ValueError):
        port.preserve_test_data(x, y[:50])


def test_create_brain_dataset_rejects_bad_args(data_dir):
    with pytest.raises(TypeError):
        brain_data.create_brain_dataset('nope', 'eeg', 'intensity', 64,
                                        device='cpu')
    with pytest.raises(ValueError):
        brain_data.create_brain_dataset('tfrecord', 'eeg', 'intensity', 0,
                                        device='cpu')
    port = brain_data.create_brain_dataset(
        'tfrecord', 'eeg', 'intensity', 64, data_dir=data_dir,
        attended_field=None, device='cpu')
    assert len(port.all_files()) == len(FILES)
    assert os.path.basename(sorted(port.all_files())[0]) == \
        'S1_T0.tfrecords'


def _assert_same_batches(got, want):
    """Equal minibatch streams, batch by batch, bit for bit."""
    count = 0
    for (g_in, g_out), (w_in, w_out) in zip(got, want, strict=True):
        assert g_in.keys() == w_in.keys()
        for key in w_in:
            np.testing.assert_array_equal(g_in[key], w_in[key])
        np.testing.assert_array_equal(g_out, w_out)
        count += 1
    return count


DATASET_CASES = {
    'train_shuffled': dict(mode='train'),
    'test_shuffled': dict(mode='test'),
    'train_in_order': dict(mode='train', shuffle_buffer_size=0),
    'train_repeated': dict(mode='train', repeat_count=3),
    'test_mixup': dict(mode='test', mixup_batch=True),
    'train_mismatch': dict(mode='train', mismatch_batch=True),
    'reference_protocol': dict(mode='train', reference_protocol=True),
    'reference_in_order': dict(mode='test', reference_protocol=True,
                               shuffle_buffer_size=0),
    'reference_offset_quirk': dict(mode='train', reference_protocol=True,
                                   input_offset=2, pre_context=0,
                                   post_context=0, in2_pre_context=0,
                                   in2_post_context=0),
}


@pytest.mark.parametrize('case', sorted(DATASET_CASES))
def test_create_dataset_batches_equal_jax(data_dir, case):
    kwargs = dict(DATASET_CASES[case])
    mode = kwargs.pop('mode')
    transforms = {k: kwargs.pop(k) for k in ('mixup_batch', 'mismatch_batch')
                  if k in kwargs}
    kwargs = dict(dict(final_batch_size=64, shuffle_buffer_size=100),
                  **kwargs)
    port, ref = _pair(data_dir, **kwargs)
    # Two datasets from one source, as the driver builds them, so the
    # second sees the generator where the first left it.
    for _ in range(2):
        got = port.create_dataset(mode, **transforms)
        want = ref.create_dataset(mode, **transforms)
        assert got.reference_batch_size == want.reference_batch_size
        for g, w in zip(got.all_arrays(), want.all_arrays()):
            np.testing.assert_array_equal(g, w)
        assert got.element_spec == want.element_spec
        assert _assert_same_batches(got, want) > 0
    assert _assert_same_batches(got.iter_one_epoch(),
                                want.iter_one_epoch()) > 0
    if case == 'reference_protocol':
        assert got.num_frames % 64 == 0
    if case == 'reference_offset_quirk':
        # TFRecord sources ignore a lone offset under this protocol.
        assert not port._needs_context()


def test_spec_dataset_and_estimated_bytes_match_jax(data_dir):
    port, ref = _pair(data_dir, final_batch_size=32)
    got, want = port.spec_dataset(), ref.spec_dataset()
    assert got.element_spec == want.element_spec == (
        {'input_1': (30,), 'input_2': (5,), 'attended_speaker': (1,)},
        (1,))
    assert got.num_frames == 0 and got.batch_size == 32
    assert port.output_field_width() == ref.output_field_width() == 1
    for mode in ('train', 'test'):
        assert port.estimated_stacked_bytes(mode) == \
            ref.estimated_stacked_bytes(mode) > 0
