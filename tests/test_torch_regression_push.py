"""Kernel R1's wrapper and a regression decoder's dispatch by shape, on
the CPU (ops/regression_push.py, decode/infer_decoder.py).

R1 itself runs on the card only (tests/test_torch_cuda.py, ``-k
regression_push``). Here: the wrapper's plain version against the
model's own stack and the decoder's ``correlate_reduce`` bit for bit,
R1's limits and launch plan, the packed layout, the checks that refuse a
call, the decoders whose calls R1 never takes, the dispatch (a call of at
most 64 rows with layers packed on a card goes to R1, every other to the
model's stack) seen through a stand-in for the launch, the counter
``decoder.fused_predict_passes``, and the AOT program, which keeps the
model's stack.
"""

import ctypes

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from telluride_decoding_torch.decode import aot, infer_decoder
from telluride_decoding_torch.decode.infer_decoder import (
    CCADecoder, CorrelationParamsTuple, LinearRegressionDecoder,
    ModelParamsTuple)
from telluride_decoding_torch.models.brain_model import (
    BrainModelClassifier, BrainModelDNN, BrainModelLinearRegression)
from telluride_decoding_torch.models.cca import BrainModelCCA, BrainModelDCCA
from telluride_decoding_torch.ops import regression_push
from telluride_decoding_torch.solvers.lda import LdaParams
from telluride_decoding_torch.utils import profiling

CODELAB = (2553, [20, 20], 1)     # F, hidden, out: the served DNN.
F1 = 40                           # The small decoders' input width.


@pytest.fixture(autouse=True)
def fresh():
    profiling.reset()
    yield
    profiling.reset()


def stats_params(rng, out):
    """The correlation statistics and LDA of ``out`` dimensions, drawn
    so that power stays positive."""
    zeros = np.zeros(out)
    return ModelParamsTuple(
        CorrelationParamsTuple(1, zeros, zeros, zeros, zeros,
                               0.1 * rng.randn(out), 0.1 * rng.randn(out),
                               1.0 + rng.rand(out)),
        LdaParams(rng.randn(out, 1), np.zeros((out, 1)), np.array([0, 1]),
                  np.zeros((2, out)), 0.1, 0.5))


def regression_model(f1, hidden, out, seed=0, batch_norm=False):
    """A DNN regressor of ``hidden`` widths (He-scaled weights, biases
    N(0, 0.01)), or with no hidden layer the linear regressor."""
    rng = np.random.RandomState(seed)
    widths = [f1] + list(hidden) + [out]
    flat = {}
    for i in range(len(widths) - 1):
        flat['layers/%d/w' % i] = rng.randn(
            widths[i], widths[i + 1]) * np.sqrt(2.0 / widths[i])
        flat['layers/%d/b' % i] = 0.1 * rng.randn(widths[i + 1])
        if batch_norm and i < len(widths) - 2:
            h = widths[i + 1]
            flat.update({'bn/%d/gamma' % i: np.ones(h),
                         'bn/%d/beta' % i: np.zeros(h),
                         'bn/%d/mean' % i: np.zeros(h),
                         'bn/%d/var' % i: np.ones(h)})
    if not hidden:
        return BrainModelLinearRegression.from_numpy(
            {'w': flat['layers/0/w'], 'b': flat['layers/0/b']}, 'cpu')
    return BrainModelDNN.from_numpy(flat, 'cpu', config={
        'num_hidden_list': list(hidden), 'input_width': f1,
        'output_width': out, 'dropout': 0.0, 'batch_norm': batch_norm})


def regression_decoder(f1=F1, hidden=(16, 8), out=1, seed=0,
                       reduction='lda', model=None):
    if model is None:
        model = regression_model(f1, hidden, out, seed)
    decoder = LinearRegressionDecoder(model, reduction=reduction,
                                      device='cpu')
    decoder.model_params = stats_params(np.random.RandomState(seed + 100),
                                        out)
    return decoder


def classifier_decoder():
    rng = np.random.RandomState(0)
    widths = [F1 + 1, 4, 1]
    flat = {}
    for i in range(len(widths) - 1):
        flat['%d/w' % i] = rng.randn(widths[i], widths[i + 1])
        flat['%d/b' % i] = rng.randn(widths[i + 1])
    model = BrainModelClassifier.from_numpy(flat, 'cpu', config={
        'num_hidden_list': [4], 'input_width': F1, 'input2_width': 1,
        'output_width': 1})
    return regression_decoder(model=model)


def pair(rows, f1=F1, out=1, seed=1):
    """infer_pair's arguments: EEG rows, two audio streams, two
    envelopes of ``out`` columns."""
    rng = np.random.RandomState(seed)
    return (rng.randn(rows, f1).astype(np.float32),
            *(np.abs(rng.randn(rows, 1)).astype(np.float32)
              for _ in range(2)),
            *(np.abs(rng.randn(rows, out)).astype(np.float32)
              for _ in range(2)))


def weights_of(decoder) -> regression_push.RegressionWeights:
    return decoder._current_pipeline().regression


@pytest.mark.parametrize('out', [1, 4])
@pytest.mark.parametrize('hidden', [[], [20], [20, 20]])
@pytest.mark.parametrize('rows', [1, 32, 64])
def test_wrapper_on_cpu_equals_the_models_stack(rows, hidden, out):
    """On CPU tensors the wrapper gives the bits of the model's stack and
    the decoder's ``correlate_reduce``, each talker's scores as the
    decoder computes them without R1, at the served input width."""
    f1 = CODELAB[0]
    decoder = regression_decoder(f1, hidden, out, seed=rows)
    pipeline = decoder._current_pipeline()
    weights = pipeline.regression
    assert weights.fits() and weights.packed is None
    assert not weights.launches(rows)
    x1, _, _, ya, yb = (torch.from_numpy(a) for a in pair(rows, f1, out))
    got = regression_push.regression_push(weights, x1, [ya, yb])
    prediction = decoder.decoding_model({'input_1': x1})
    want = torch.stack([pipeline.correlate_reduce(y, prediction)
                        for y in (ya, yb)])
    assert got.shape == (2, rows)
    assert torch.equal(got, want)
    (one,) = regression_push.regression_push(weights, x1, [ya])
    assert torch.equal(one, want[0])


def test_limits():
    """R1 takes 1 to 64 rows (the layers packed on a card), one to four
    layers, hidden widths of at most 64, an output of at most 16, and
    what a block's shared memory holds."""
    def fits(hidden, out=1, f1=CODELAB[0]):
        return weights_of(regression_decoder(f1, hidden, out)).fits()
    assert fits([20, 20]) and fits([]) and fits([64, 64, 64], 16)
    assert fits([20], 4, f1=7)
    for hidden, out in (([65], 1), ([20, 65], 1), ([20], 17),
                        ([8, 8, 8, 8], 1)):
        assert not fits(hidden, out), (hidden, out)
    assert not fits([20, 20], f1=100000)   # A slice of W0 and x too large.
    weights = weights_of(regression_decoder(*CODELAB))
    weights.packed = torch.zeros(4)    # As if packed on a card.
    assert weights.launches(1) and weights.launches(64)
    assert not weights.launches(65) and not weights.launches(0)
    assert [regression_push.cluster_size(f) for f in
            (2553, 1408, 512, 511, 100, 40, 7)] == [16, 16, 16, 8, 2, 1, 1]
    assert regression_push.smem_bytes(
        (64, 64, 64, 16), 64, 160, 16) <= regression_push._MAX_SMEM_BYTES


def test_plan_at_the_served_widths():
    """The served DNN (2553 -> 20 -> 20 -> 1): one cluster of 16 blocks,
    slices of 160 inputs, widths padded to 20, 20, 4; the run after W0
    [2553, 20] holds 544 floats; a block of a 32-row call takes 51,280
    bytes of shared memory. The plan is the kernel's struct, field for
    field, kept per signature."""
    weights = weights_of(regression_decoder(*CODELAB))
    plan = weights.plan(32, 2, 1)
    assert ctypes.sizeof(plan) == 4 * (10 + regression_push.MAX_LAYERS)
    assert (plan.rows, plan.streams, plan.width, plan.depth, plan.out,
            plan.ycols, plan.cluster, plan.slice) == (
                32, 2, 2553, 3, 1, 1, 16, 160)
    assert list(plan.widths) == [20, 20, 4, 0]
    assert (plan.run, plan.run_floats) == (2553 * 20, 544)
    assert weights.plan(32, 2, 1) is plan
    assert weights.plan(32, 1, 1) is not plan
    assert regression_push.smem_bytes(weights.widths, 32, 160, 16) == 51280
    linear = weights_of(regression_decoder(1408, [], 1))
    assert (linear.cluster, linear.slice, linear.widths) == (16, 88, (4,))


def test_packed_layout():
    """W0 [F, H0p], then one run b0, W1, b1, ..., mean_x, mean_y, power
    and lda_w[:, 0] at the last padded width, slope, intercept and two
    zeros; every width zero-padded (to 4), power with ones; statistics of
    one value broadcast to the output's width."""
    f1, hidden, out = 7, [6, 5], 3
    decoder = regression_decoder(f1, hidden, out, seed=3)
    weights = weights_of(decoder)
    mean_x, mean_y, power, lda_w, slope, intercept = weights.stats
    weights.stats = (mean_x[:1], mean_y, power, lda_w, slope, intercept)
    assert weights.widths == (8, 8, 4)
    packed = weights._pack()
    assert packed.numel() == f1 * 8 + regression_push.run_floats((8, 8, 4))
    at, ins = 0, f1
    for i, (w, b) in enumerate(weights.layers):
        cols = weights.widths[i]
        block = packed[at:at + ins * cols].reshape(ins, cols)
        assert torch.equal(block[:w.shape[0], :w.shape[1]], w)
        assert not block[w.shape[0]:].any() and not block[:, w.shape[1]:].any()
        at += ins * cols
        if i == 0:
            assert at == weights.plan(1, 1, 1).run
        assert torch.equal(packed[at:at + b.numel()], b.reshape(-1))
        assert not packed[at + b.numel():at + cols].any()
        at += cols
        ins = cols
    for value, fill in ((mean_x[:1].expand(out), 0.0), (mean_y, 0.0),
                        (power, 1.0), (lda_w[:, 0], 0.0)):
        assert torch.equal(packed[at:at + out], value.reshape(-1))
        assert torch.equal(packed[at + out:at + ins],
                           torch.full((ins - out,), fill))
        at += ins
    assert packed[at:].tolist() == [slope.item(), intercept.item(), 0, 0]


@pytest.mark.parametrize('case', ['rows', 'width', 'talkers', 'ycols',
                                  'dtype', 'contiguous', 'device',
                                  'unpacked'])
def test_calls_r1_does_not_take_are_refused(case):
    """The checks a CUDA call passes before R1 launches; on the CPU they
    run on CPU tensors against a stand-in packed buffer."""
    weights = weights_of(regression_decoder(F1, [16, 8], 4))
    weights.packed = torch.zeros(4)
    x1, _, _, ya, yb = (torch.from_numpy(a) for a in pair(32, out=4))
    ys = [ya, yb]
    assert regression_push._check(weights, x1, ys) == (32, 4)
    assert regression_push._check(weights, x1,
                                  [ya[:, :1].contiguous()]) == (32, 1)
    if case == 'rows':
        x1, _, _, ya, yb = (torch.from_numpy(a) for a in pair(65, out=4))
        ys = [ya, yb]
    elif case == 'width':
        x1 = x1[:, 1:].contiguous()
    elif case == 'talkers':
        ys = [ya, yb, ya]
    elif case == 'ycols':
        ys = [ya[:, :2].contiguous()] * 2
    elif case == 'dtype':
        x1 = x1.double()
    elif case == 'contiguous':
        x1 = torch.from_numpy(pair(32, 2 * F1)[0])[:, ::2]
    elif case == 'device':
        x1 = x1.to('meta')
    elif case == 'unpacked':
        weights.packed = None
    with pytest.raises(ValueError):
        regression_push._check(weights, x1, ys)


@pytest.mark.parametrize('case', ['batch_norm', 'classifier', 'mean', 'all',
                                  'rows_65', 'hidden_65'])
def test_decoders_and_calls_r1_does_not_take(case):
    """Batch norm, the classifier (its prediction reads input_2) and
    reductions other than 'lda' build no R1 layers; a 65-row call on
    layers packed on a card and a hidden width of 65 (not packed) take the
    model's stack."""
    rows = 32
    if case == 'batch_norm':
        decoder = regression_decoder(model=regression_model(
            F1, [16, 8], 1, batch_norm=True))
        assert decoder.decoding_model.dense_layers() is None
    elif case == 'classifier':
        decoder = classifier_decoder()
    elif case in ('mean', 'all'):
        decoder = regression_decoder(reduction=case)
    elif case == 'rows_65':
        decoder = regression_decoder()
        weights_of(decoder).packed = torch.zeros(4)
        rows = 65
    else:
        decoder = regression_decoder(hidden=[65])
        assert not weights_of(decoder).fits()
    pipeline = decoder._current_pipeline()
    assert (pipeline.regression is None) == (case not in ('rows_65',
                                                          'hidden_65'))
    assert not decoder._fused_prediction(pipeline, rows)


@pytest.fixture
def stand_in_r1(monkeypatch):
    """R1 replaced by a recorder of its calls' rows that computes the
    plain version."""
    calls = []

    def launch(weights, x1, ys):
        calls.append(x1.shape[0])
        return regression_push.regression_push_reference(weights, x1, ys)
    monkeypatch.setattr(infer_decoder, 'regression_push', launch)
    return calls


def packed_as_on_a_card(decoder):
    weights_of(decoder).packed = torch.zeros(4)
    return decoder


@pytest.mark.parametrize('hidden', [[], [16, 8]])
def test_dispatch_sends_64_rows_to_r1_and_65_to_the_stack(stand_in_r1,
                                                          hidden):
    """A pair of 64 rows is one call of R1 for both talkers, one of 65
    the model's stack; the scores are the plain decoder's either way."""
    decoder = packed_as_on_a_card(regression_decoder(hidden=hidden))
    plain = regression_decoder(hidden=hidden)
    for rows, launched in ((64, [64]), (65, [64]), (1, [64, 1])):
        args = pair(rows)
        got = decoder.infer_pair(*args)
        assert stand_in_r1 == launched, rows
        for g, w in zip(got, plain.infer_pair(*args)):
            np.testing.assert_array_equal(g, w)
    assert stand_in_r1 == [64, 1]


def served_counts(decoder, rows, call='infer_pair'):
    x1, a1, a2, ya, yb = pair(rows)
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        if call == 'infer_pair':
            decoder.infer_pair(x1, a1, a2, ya, yb)
        else:
            decoder.infer_one({'input_1': x1, 'input_2': a1}, ya)
    counters = profiling.recorded().counters
    return (counters.get(profiling.PREDICT_PASSES, 0),
            counters.get(profiling.FUSED_PREDICT_PASSES, 0))


def test_fused_predict_passes_count_what_r1_ran(stand_in_r1):
    """``decoder.fused_predict_passes`` counts the predictions that ran
    R1 (one a call, for both talkers), beside
    ``decoder.predict_passes``; a 65-row call counts a prediction and no
    fused one, and so does a decoder whose layers are not packed on a
    card."""
    decoder = regression_decoder()
    assert served_counts(decoder, 32) == (1, 0)
    packed_as_on_a_card(decoder)
    assert served_counts(decoder, 32) == (1, 1)
    assert served_counts(decoder, 29, 'infer_one') == (1, 1)
    assert served_counts(decoder, 65) == (1, 0)
    assert stand_in_r1 == [32, 29]
    assert served_counts(classifier_decoder(), 32) == (2, 0)


@pytest.mark.parametrize('out', [1, 4])
@pytest.mark.parametrize('hidden', [[], [16, 8]])
def test_fused_scores_are_the_plain_scores(stand_in_r1, hidden, out):
    """A served pair through the (stand-in) R1 route scores as the
    model's stack does, bit for bit, with the span ``decoder.predict``
    in ``decoder.launch``: the route changes where the prediction runs,
    not what it computes."""
    args = pair(32, out=out)
    want = regression_decoder(hidden=hidden, out=out).infer_pair(*args)
    decoder = packed_as_on_a_card(regression_decoder(hidden=hidden,
                                                     out=out))
    with profile(activities=[ProfilerActivity.CPU]):
        got = decoder.infer_pair(*args)
    assert stand_in_r1 == [32]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    found = profiling.recorded()
    (predict,) = [e for e in found.events if e.name == 'decoder.predict']
    assert found.events[predict.parent].name == 'decoder.launch'


def test_pair_program_keeps_the_models_stack(stand_in_r1, tmp_path,
                                             monkeypatch):
    """The AOT program runs the model's stack, never R1: a row count
    chosen by shape would not hold over the exported dynamic frame axis.
    It exports with layers packed as on a card, and its scores are the
    live decoder's on the CPU."""
    decoder = regression_decoder()
    original = regression_push.RegressionWeights.__init__

    def packed_init(self, *args):
        original(self, *args)
        self.packed = torch.zeros(4)
    monkeypatch.setattr(regression_push.RegressionWeights, '__init__',
                        packed_init)
    aot.export_decoder(decoder, str(tmp_path / 'artifact'),
                       input_widths=(F1, 1), output_width=1)
    monkeypatch.undo()
    assert stand_in_r1 == []
    exported = aot.load_exported_decoder(str(tmp_path / 'artifact'), 'cpu')
    args = pair(23)
    want = regression_decoder().infer_pair(*args)
    for g, w in zip(exported.infer_pair(*args), want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)
    assert stand_in_r1 == []


@pytest.mark.parametrize('kind', ['cca', 'dcca'])
def test_cca_pipelines_never_reach_r1(stand_in_r1, kind):
    """A CCA or deep CCA decoder's pipeline holds no R1 layers, and its
    served pairs never call R1 (K1 serves them)."""
    rng = np.random.RandomState(0)
    f2, dims = 3, 3
    if kind == 'cca':
        model = BrainModelCCA.from_numpy(
            {'mean1': 0.1 * rng.randn(1, F1), 'mean2': 0.1 * rng.randn(1, f2),
             'rot1': rng.randn(F1, dims) / F1, 'rot2': rng.randn(f2, dims)},
            'cpu')
    else:
        model = BrainModelDCCA(cca_dims=dims, hidden_units=[4],
                               input1_width=F1, input2_width=f2,
                               device='cpu')
        x1 = rng.randn(200, F1).astype(np.float32)
        x2 = (x1[:, :f2] + rng.randn(200, f2)).astype(np.float32)
        model.fit([({'input_1': x1, 'input_2': x2}, x2)], epochs=1,
                  batch_size=100)
    decoder = CCADecoder(model, reduction='lda', device='cpu')
    decoder.model_params = stats_params(rng, dims)
    pipeline = decoder._current_pipeline()
    assert pipeline.folded is not None and pipeline.regression is None
    x1 = rng.randn(32, F1).astype(np.float32)
    x2 = [rng.randn(32, f2).astype(np.float32) for _ in range(2)]
    decoder.infer_pair(x1, *x2, *(np.zeros((32, 1), np.float32),) * 2)
    assert stand_in_r1 == []
