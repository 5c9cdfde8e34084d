"""Kernel T1's wrapper and the deep CCA towers' dispatch by shape, on the
CPU (ops/dcca_towers.py, models/cca.py::DccaTowers).

T1 itself runs on the card only (tests/test_torch_cuda.py, ``-k
dcca_towers``). Here: the wrapper's plain version against the model's own
stack (``_apply_mlp``) bit for bit at the served shapes, T1's limits and
launch plan, the packed layout, the checks that refuse a call, the
dispatch (a call of at most 64 rows a stream with weights packed on a
card goes to T1, every other to the model's stack) seen through a stand-in
for the launch, the counter ``decoder.fused_tower_passes``, and the AOT
program, which keeps the model's stack.
"""

import ctypes

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from telluride_decoding_torch.decode import aot
from telluride_decoding_torch.decode.infer_decoder import (
    CCADecoder, CorrelationParamsTuple, ModelParamsTuple)
from telluride_decoding_torch.models.brain_model import _apply_mlp
from telluride_decoding_torch.models.cca import BrainModelDCCA, DccaTowers
from telluride_decoding_torch.ops import dcca_towers
from telluride_decoding_torch.solvers.lda import LdaParams
from telluride_decoding_torch.utils import profiling

CODELAB = (2553, 31, [128, 64])   # F1, F2, hidden: the served widths.
SMALL = (40, 5, [16, 8], 4)       # F1, F2, hidden, dims.


@pytest.fixture(autouse=True)
def fresh():
    profiling.reset()
    yield
    profiling.reset()


def tower_weights(rng, f1, f2, hidden, dims):
    """Both towers' parameters, He-scaled weights and small biases, under
    the model's names."""
    flat = {}
    for index, width in ((1, f1), (2, f2)):
        widths = [width] + list(hidden) + [dims]
        for i in range(len(widths) - 1):
            flat['tower%d/%d/w' % (index, i)] = torch.as_tensor(
                rng.randn(widths[i], widths[i + 1]) *
                np.sqrt(2.0 / widths[i]), dtype=torch.float32)
            flat['tower%d/%d/b' % (index, i)] = torch.as_tensor(
                0.1 * rng.randn(widths[i + 1]), dtype=torch.float32)
    return flat


def dcca_model(f1, f2, hidden, dims, seed=0):
    rng = np.random.RandomState(seed)
    flat = tower_weights(rng, f1, f2, hidden, dims)
    flat.update({'mean1': torch.zeros(1, dims), 'mean2': torch.zeros(1, dims),
                 'rot1': torch.as_tensor(rng.randn(dims, dims) * 0.3,
                                         dtype=torch.float32),
                 'rot2': torch.as_tensor(rng.randn(dims, dims) * 0.3,
                                         dtype=torch.float32)})
    return BrainModelDCCA.from_numpy(
        {k: v.numpy() for k, v in flat.items()}, 'cpu',
        config={'cca_dims': dims, 'hidden_units': list(hidden),
                'input1_width': f1, 'input2_width': f2})


def dcca_decoder(seed=0):
    f1, f2, hidden, dims = SMALL
    rng = np.random.RandomState(seed + 100)
    decoder = CCADecoder(dcca_model(f1, f2, hidden, dims, seed),
                         reduction='lda', device='cpu')
    zeros = np.zeros(dims)
    lda_w = rng.randn(dims, 1) / np.sqrt(dims)
    decoder.model_params = ModelParamsTuple(
        CorrelationParamsTuple(1, zeros, zeros, zeros, zeros,
                               0.1 * rng.randn(dims), 0.1 * rng.randn(dims),
                               1.0 + rng.rand(dims)),
        LdaParams(lda_w, np.zeros_like(lda_w), np.array([0, 1]),
                  np.zeros((2, dims)), 0.1, 0.5))
    return decoder


def pair(rows, f1, f2, seed=1):
    rng = np.random.RandomState(seed)
    return (rng.randn(rows, f1).astype(np.float32),
            rng.randn(rows, f2).astype(np.float32),
            rng.randn(rows, f2).astype(np.float32))


@pytest.mark.parametrize('dims', [10, 5])
@pytest.mark.parametrize('rows', [1, 16, 29, 32, 64])
def test_wrapper_on_cpu_equals_the_models_stack(rows, dims):
    """On CPU tensors the wrapper gives _apply_mlp's bits, each stream's
    tower as the model computes it, at the served widths."""
    f1, f2, hidden = CODELAB
    params = tower_weights(np.random.RandomState(rows), f1, f2, hidden, dims)
    depth = len(hidden) + 1
    weights = dcca_towers.TowerWeights(*(
        [(params['tower%d/%d/w' % (t, i)], params['tower%d/%d/b' % (t, i)])
         for i in range(depth)] for t in (1, 2)))
    x1, x2a, x2b = (torch.from_numpy(a) for a in pair(rows, f1, f2, rows))
    h1, (h2a, h2b) = dcca_towers.dcca_towers(weights, x1, [x2a, x2b])
    assert torch.equal(h1, _apply_mlp(params, x1, depth, 'tower1/'))
    for got, x in ((h2a, x2a), (h2b, x2b)):
        assert torch.equal(got, _apply_mlp(params, x, depth, 'tower2/'))
    assert h1.shape == (rows, dims) and weights.fits()
    assert weights.packed is None and not weights.launches(rows)


def test_limits():
    """T1 takes 1 to 64 rows a stream (the towers packed on a card), one
    or two hidden layers of at most 256, at most 16 dimensions, and what
    a block's shared memory holds."""
    f1, f2, hidden = CODELAB

    def weights(hidden, dims=10, f1=f1, f2=f2):
        params = tower_weights(np.random.RandomState(0), f1, f2, hidden,
                               dims)
        depth = len(hidden) + 1
        return dcca_towers.TowerWeights(*(
            [(params['tower%d/%d/w' % (t, i)],
              params['tower%d/%d/b' % (t, i)]) for i in range(depth)]
            for t in (1, 2)))
    served = weights(hidden)
    assert served.fits() and not served.launches(32)
    served.packed = torch.zeros(4)   # As if packed on a card.
    assert served.launches(1) and served.launches(64)
    assert not served.launches(65) and not served.launches(0)
    assert weights([128]).fits() and weights([20, 20], f1=60, f2=7).fits()
    for other in ([128, 64, 32], [512, 64], [256, 256]):
        assert not weights(other).fits(), other
    assert not weights(hidden, dims=17).fits()
    # At the served widths and 64 rows a stream a block fits, as each
    # tower's plan stages its slice.
    towers = served._towers(64, 2)
    assert [t[:2] for t in towers] == [(4, 16), (1, 1)]
    assert all(dcca_towers.smem_bytes(served.widths, slice_, chunk, rows, ks)
               <= dcca_towers._MAX_SMEM_BYTES
               for _, ks, slice_, chunk, rows in towers)


def test_plan_at_the_served_widths():
    """The EEG tower splits its 2553 inputs over 4 clusters of 16 slices
    of 40, one row group; the audio tower's 31 inputs take one cluster,
    one slice, and its 2 x 32 rows 16 groups of 4. At 1408 inputs the EEG
    tower takes 2 clusters, at 1000 one of 8 slices. The plan is the
    kernel's struct, field for field."""
    f1, f2, hidden = CODELAB
    params = tower_weights(np.random.RandomState(0), f1, f2, hidden, 10)
    weights = dcca_towers.TowerWeights(*(
        [(params['tower%d/%d/w' % (t, i)], params['tower%d/%d/b' % (t, i)])
         for i in range(3)] for t in (1, 2)))
    weights._offsets = ((0, 8), (16, 24))
    plan = weights.plan(32, 2)
    assert ctypes.sizeof(plan) == 4 * (4 + 3 + 2 * 9)
    assert (plan.rows, plan.depth, plan.dims, plan.cluster) == (32, 3, 10, 16)
    assert list(plan.widths) == [128, 64, 12]
    eeg, audio = plan.tower
    assert (eeg.width, eeg.streams, eeg.clusters, eeg.kslices, eeg.slice,
            eeg.chunk, eeg.group_rows, eeg.w0, eeg.later) == (
                2553, 1, 4, 16, 40, 40, 32, 0, 8)
    assert (audio.width, audio.streams, audio.clusters, audio.kslices,
            audio.slice, audio.chunk, audio.group_rows) == (
                31, 2, 1, 1, 31, 31, 4)
    assert weights.plan(32, 2) is plan     # Kept per signature.
    assert dcca_towers._split(1408, 32, True) == (2, 16, 44, 32)
    assert dcca_towers._split(1000, 32, True) == (1, 8, 125, 16)
    assert dcca_towers._split(2553, 32, False) == (1, 16, 160, 32)


def test_packed_layout():
    """Each tower's W0 [F, H0p] and then one run b0, W1, b1, W2, b2, every
    width zero-padded (H0p to 32, the others to 4)."""
    f1, f2, hidden, dims = 7, 3, [20, 6], 5
    params = tower_weights(np.random.RandomState(3), f1, f2, hidden, dims)
    weights = dcca_towers.TowerWeights(*(
        [(params['tower%d/%d/w' % (t, i)], params['tower%d/%d/b' % (t, i)])
         for i in range(3)] for t in (1, 2)))
    assert weights.widths == (32, 8, 8)
    packed, offsets = weights._pack()
    for index, width, (w0, later) in zip((1, 2), (f1, f2), offsets):
        at = w0
        ins = width
        for i, out in enumerate(weights.widths):
            w = packed[at:at + ins * out].reshape(ins, out)
            real = params['tower%d/%d/w' % (index, i)]
            assert torch.equal(w[:real.shape[0], :real.shape[1]], real)
            assert not w[real.shape[0]:].any()
            assert not w[:, real.shape[1]:].any()
            at += ins * out
            if i == 0:
                assert at == later
            b = packed[at:at + out]
            bias = params['tower%d/%d/b' % (index, i)]
            assert torch.equal(b[:bias.shape[0]], bias)
            assert not b[bias.shape[0]:].any()
            at += out
            ins = out
        assert at % 4 == 0


@pytest.mark.parametrize('case', ['rows', 'width', 'streams', 'dtype',
                                  'contiguous', 'device', 'unpacked'])
def test_calls_t1_does_not_take_are_refused(case):
    """The checks a CUDA call passes before T1 launches; on the CPU they
    run on CPU tensors against a stand-in packed buffer."""
    f1, f2, hidden, dims = SMALL
    params = tower_weights(np.random.RandomState(0), f1, f2, hidden, dims)
    weights = dcca_towers.TowerWeights(*(
        [(params['tower%d/%d/w' % (t, i)], params['tower%d/%d/b' % (t, i)])
         for i in range(3)] for t in (1, 2)))
    weights.packed = torch.zeros(4)
    x1, x2a, x2b = (torch.from_numpy(a) for a in pair(32, f1, f2))
    x2s = [x2a, x2b]
    assert dcca_towers._check(weights, x1, x2s) == (32, 2)
    assert dcca_towers._check(weights, x1, x2s[:1]) == (32, 1)
    if case == 'rows':
        x1, x2a, x2b = (torch.from_numpy(a) for a in pair(65, f1, f2))
        x2s = [x2a, x2b]
    elif case == 'width':
        x1 = x1[:, 1:]
    elif case == 'streams':
        x2s = [x2a, x2b, x2a]
    elif case == 'dtype':
        x1 = x1.double()
    elif case == 'contiguous':
        x1 = torch.from_numpy(pair(32, 2 * f1, f2)[0])[:, ::2]
    elif case == 'device':
        x1 = x1.to('meta')
    elif case == 'unpacked':
        weights.packed = None
    with pytest.raises(ValueError):
        dcca_towers._check(weights, x1, x2s)


@pytest.fixture
def stand_in_t1(monkeypatch):
    """T1 replaced by a recorder of its calls' rows that computes the
    plain version, and towers packed as if on a card."""
    calls = []

    def launch(weights, x1, x2s):
        calls.append(x1.shape[0])
        return dcca_towers.dcca_towers_reference(weights, x1, x2s)
    monkeypatch.setattr(dcca_towers, 'dcca_towers', launch)
    return calls


def packed_as_on_a_card(towers: DccaTowers) -> DccaTowers:
    towers.weights.packed = torch.zeros(4)
    return towers


def test_dispatch_sends_64_rows_to_t1_and_65_to_the_plain_stack(
        stand_in_t1):
    f1, f2, hidden, dims = SMALL
    model = dcca_model(f1, f2, hidden, dims)
    towers = packed_as_on_a_card(model.towers())
    for rows, launched in ((64, [64]), (65, [64]), (1, [64, 1])):
        x1, x2a, x2b = (torch.from_numpy(a) for a in pair(rows, f1, f2))
        h1, h2s = towers(x1, [x2a, x2b])
        assert stand_in_t1 == launched, rows
        params = model.params
        assert torch.equal(h1, _apply_mlp(params, x1, 3, 'tower1/'))
        assert torch.equal(h2s[1], _apply_mlp(params, x2b, 3, 'tower2/'))
    # Off the card (nothing packed) every call takes the model's stack.
    stand_in_t1.clear()
    plain = model.towers()
    plain(*pair(32, f1, f2)[:1], list(pair(32, f1, f2)[1:]))
    assert stand_in_t1 == [] and not plain.fused(32)


def served_counts(decoder, rows, call='infer_pair'):
    f1, f2, _, _ = SMALL
    x1, x2a, x2b = pair(rows, f1, f2)
    blank = np.zeros((rows, 1), np.float32)
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        if call == 'infer_pair':
            decoder.infer_pair(x1, x2a, x2b, blank, blank)
        else:
            decoder.infer_one({'input_1': x1, 'input_2': x2a}, blank)
    counters = profiling.recorded().counters
    return (counters.get(profiling.TOWER_PASSES, 0),
            counters.get(profiling.FUSED_TOWER_PASSES, 0))


def test_fused_tower_passes_count_the_streams_t1_ran(stand_in_t1):
    """``decoder.fused_tower_passes`` counts a stream a call that ran T1
    (3 a pair, 2 an infer_one), beside ``decoder.tower_passes``; a
    65-row call counts tower passes and no fused ones, and so does a
    decoder whose towers are not packed on a card."""
    decoder = dcca_decoder()
    assert served_counts(decoder, 32) == (3, 0)
    packed_as_on_a_card(decoder._current_pipeline().towers)
    assert served_counts(decoder, 32) == (3, 3)
    assert served_counts(decoder, 29, 'infer_one') == (2, 2)
    assert served_counts(decoder, 65) == (3, 0)
    assert stand_in_t1 == [32, 29]


def test_fused_scores_are_the_plain_scores(stand_in_t1):
    """A served pair through the (stand-in) T1 route scores as the
    model's stack does: the route changes where the towers run, not what
    they compute."""
    f1, f2, _, _ = SMALL
    args = pair(32, f1, f2) + (np.zeros((32, 1), np.float32),) * 2
    want = dcca_decoder().infer_pair(*args)
    decoder = dcca_decoder()
    packed_as_on_a_card(decoder._current_pipeline().towers)
    got = decoder.infer_pair(*args)
    assert stand_in_t1 == [32]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_pair_program_keeps_the_models_stack(stand_in_t1, tmp_path,
                                             monkeypatch):
    """The AOT program runs the towers as the model's stack, never T1:
    a row count chosen by shape would not hold over the exported dynamic
    frame axis. It exports with towers packed as on a card, and its
    scores are the live decoder's on the CPU."""
    f1, f2, _, _ = SMALL
    decoder = dcca_decoder()
    original = DccaTowers.__init__

    def packed_init(self, model, params):
        original(self, model, params)
        packed_as_on_a_card(self)
    monkeypatch.setattr(DccaTowers, '__init__', packed_init)
    aot.export_decoder(decoder, str(tmp_path / 'artifact'),
                       input_widths=(f1, f2), output_width=1)
    monkeypatch.undo()
    assert stand_in_t1 == []
    exported = aot.load_exported_decoder(str(tmp_path / 'artifact'), 'cpu')
    args = pair(23, f1, f2) + (np.zeros((23, 1), np.float32),) * 2
    want = dcca_decoder().infer_pair(*args)
    for g, w in zip(exported.infer_pair(*args), want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)
    assert stand_in_t1 == []
