"""Regression decoders on the serving path, on the CPU: the toolbox's
default fullyconnected DNN regressor (with and without batch norm) and
the linear regressor served through ``StreamingAttentionServer.push``
against the plain reference (tests/plain_dnn.py) on seeded random
weights; one prediction a call for a model that reads input_1 alone and
one a stream for the classifier, read from the counter
``decoder.predict_passes``; and the resident push plan's key and staged
inputs for a regression decoder.

The plan itself (a CUDA graph) runs on the card only
(tests/test_torch_cuda.py, ``-k push_plan_regression``). Here a decoder
built on the CPU and then named a CUDA one (its pipeline already built)
shows which key it gets, and a stand-in plan shows what the decoder
hands a plan: the shapes it stages (frames, then the two envelopes) and
the function it captures.

Tolerance of the window means: 2e-6 of the reference's RMS. The port and
the reference both compute in float32, in other orders (the port's
products over 32-row pushes, the reference's over the whole session,
batch norm folded there); a float32 rounding is 6e-8 of a value, and a
few tens of them along a score's chain stay under 2e-6. A product in
TF32 (10-bit mantissas, 5e-4 a rounding) or a missing ReLU moves the
means by far more.
"""

import gc
import weakref

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import plain_dnn
from telluride_decoding_torch.cli import serve
from telluride_decoding_torch.decode import push_plan
from telluride_decoding_torch.decode.infer_decoder import (
    CorrelationParamsTuple, LinearRegressionDecoder, ModelParamsTuple)
from telluride_decoding_torch.models.brain_model import (
    BrainModelClassifier, BrainModelDNN, BrainModelLinearRegression)
from telluride_decoding_torch.ops.lagstack import LagRows
from telluride_decoding_torch.solvers.lda import LdaParams
from telluride_decoding_torch.utils import profiling

CHANNELS, HIDDEN = 8, [16, 8]
LAGS = {'eeg_pre': 0, 'eeg_post': 4, 'audio_pre': 0, 'audio_post': 0}
F1 = CHANNELS * (LAGS['eeg_pre'] + 1 + LAGS['eeg_post'])
WIDTH, STEP = 40, 20
TOL = 2e-6
MODELS = ('dnn', 'dnn_batch_norm', 'linear')


@pytest.fixture(autouse=True)
def fresh():
    profiling.reset()
    yield
    profiling.reset()


def seeded_weights(kind, seed):
    """The regressor's layers (weights N(0, 2 / fan_in), biases N(0,
    0.01); the linear regressor one layer), batch norm's statistics
    where ``kind`` has it, and the decoder's statistics and LDA drawn so
    that scores stay positive; float32 values, as the model files hold
    them. Under the reference's names (tests/plain_dnn.py)."""
    rng = np.random.RandomState(seed)
    widths = [F1] + ([] if kind == 'linear' else HIDDEN) + [1]
    weights = {}
    for i in range(len(widths) - 1):
        weights['layers/%d/w' % i] = rng.randn(
            widths[i], widths[i + 1]) * np.sqrt(2.0 / widths[i])
        weights['layers/%d/b' % i] = 0.1 * rng.randn(widths[i + 1])
        if kind == 'dnn_batch_norm' and i < len(widths) - 2:
            h = widths[i + 1]
            weights.update({'bn/%d/gamma' % i: 1.0 + 0.2 * rng.randn(h),
                            'bn/%d/beta' % i: 0.1 * rng.randn(h),
                            'bn/%d/mean' % i: rng.randn(h),
                            'bn/%d/var' % i: 1.0 + rng.rand(h)})
    weights.update(corr_mean_x=0.1 * rng.randn(1),
                   corr_mean_y=0.1 * rng.randn(1),
                   corr_power=1.0 + rng.rand(1), lda_w=rng.randn(1, 1))
    weights = {k: v.astype(np.float32).astype(np.float64)
               for k, v in weights.items()}
    weights.update(lda_slope=0.1, lda_intercept=0.5)
    return weights


def model_params(weights):
    zeros = np.zeros(1)
    return ModelParamsTuple(
        CorrelationParamsTuple(1, zeros, zeros, zeros, zeros,
                               weights['corr_mean_x'],
                               weights['corr_mean_y'],
                               weights['corr_power']),
        LdaParams(weights['lda_w'], np.zeros_like(weights['lda_w']),
                  np.array([0, 1]), np.zeros((2, 1)),
                  weights['lda_slope'], weights['lda_intercept']))


def regression_model(kind, weights):
    if kind == 'linear':
        return BrainModelLinearRegression.from_numpy(
            {'w': weights['layers/0/w'], 'b': weights['layers/0/b']}, 'cpu')
    return BrainModelDNN.from_numpy(
        {k: v for k, v in weights.items() if k.startswith(('layers/', 'bn/'))},
        'cpu', config={'num_hidden_list': HIDDEN, 'input_width': F1,
                       'output_width': 1, 'dropout': 0.0,
                       'batch_norm': kind == 'dnn_batch_norm'})


def regression_decoder(kind, weights, reduction='lda'):
    decoder = LinearRegressionDecoder(regression_model(kind, weights),
                                      reduction=reduction, device='cpu')
    decoder.model_params = model_params(weights)
    decoder.decoding_model_params = {
        'pre_context': LAGS['eeg_pre'], 'post_context': LAGS['eeg_post'],
        'input2_pre_context': LAGS['audio_pre'],
        'input2_post_context': LAGS['audio_post']}
    return decoder


def classifier_decoder(seed=0):
    """A match-mismatch classifier on concat(input_1, input_2): its
    prediction reads input_2, so one a stream."""
    rng = np.random.RandomState(seed)
    widths = [F1 + 1, 4, 1]
    flat = {}
    for i in range(len(widths) - 1):
        flat['%d/w' % i] = rng.randn(widths[i], widths[i + 1])
        flat['%d/b' % i] = rng.randn(widths[i + 1])
    model = BrainModelClassifier.from_numpy(flat, 'cpu', config={
        'num_hidden_list': [4], 'input_width': F1, 'input2_width': 1,
        'output_width': 1})
    decoder = LinearRegressionDecoder(model, reduction='lda', device='cpu')
    decoder.model_params = model_params(seeded_weights('linear', seed))
    return decoder


def session(frames, seed):
    """Two positive talker envelopes and EEG following talker 1 for the
    first half and talker 2 after it, plus noise."""
    rng = np.random.RandomState(seed)
    talkers = np.abs(rng.randn(2, frames)).astype(np.float32)
    attended = np.where(np.arange(frames) < frames // 2, talkers[0],
                        talkers[1])
    mix = rng.randn(CHANNELS)
    eeg = (attended[:, None] * mix + rng.randn(frames, CHANNELS))
    return (eeg.astype(np.float32), talkers[0][:, None], talkers[1][:, None])


def served(decoder, chunk, frames=1000, seed=1):
    """(window means [windows, 2], decisions) of one session pushed in
    chunks of ``chunk`` frames."""
    eeg, audio1, audio2 = session(frames, seed)
    server = serve.StreamingAttentionServer(
        decoder, eeg_channels=CHANNELS, audio_channels=1,
        window_width=WIDTH, window_step=STEP, decision='wta')
    means, decisions = [], []
    attention = server._decide.attention

    def taped(c1, c2):
        out = attention(c1, c2)
        means.append((c1, c2))
        decisions.append(bool(out[0] >= 0.5))
        return out
    server._decide.attention = taped
    for start in range(0, len(eeg), chunk):
        sl = slice(start, start + chunk)
        server.push(eeg[sl], audio1[sl], audio2[sl])
    return np.asarray(means), np.asarray(decisions)


def reference(weights, frames=1000, seed=1):
    eeg, audio1, audio2 = session(frames, seed)
    s1, s2 = plain_dnn.frame_scores(eeg, audio1, audio2, weights, LAGS)
    return (plain_dnn.window_means(s1, WIDTH, STEP),
            plain_dnn.window_means(s2, WIDTH, STEP))


@pytest.mark.parametrize('chunk', [7, 32])
@pytest.mark.parametrize('kind', MODELS)
def test_served_regression_matches_the_plain_reference(kind, chunk):
    """Every window mean of one session served in chunks against the
    plain reference's."""
    weights = seeded_weights(kind, 0)
    means, _ = served(regression_decoder(kind, weights), chunk)
    want1, want2 = reference(weights)
    got1, got2 = means.T
    assert len(got1) == len(want1) > 40
    scale = np.sqrt(np.mean(np.concatenate([want1, want2]) ** 2))
    assert np.abs(np.concatenate([got1 - want1, got2 - want2])).max() \
        <= TOL * scale


@pytest.mark.parametrize('kind', MODELS)
def test_server_decisions_are_the_reference_wta(kind):
    """The server's WTA decisions on a short session are the reference's
    wherever its margin is clear of the tolerance, and both talkers win
    windows: the weights do not decide alone."""
    weights = seeded_weights(kind, 3)
    means, decisions = served(regression_decoder(kind, weights), 32,
                              frames=600, seed=4)
    want1, want2 = reference(weights, frames=600, seed=4)
    scale = np.sqrt(np.mean(np.concatenate([want1, want2]) ** 2))
    clear = np.abs(want1 - want2) > 2 * TOL * scale
    assert clear.mean() > 0.9
    assert np.array_equal(decisions[clear], plain_dnn.wta(want1,
                                                          want2)[clear])
    assert 0 < np.mean(decisions) < 1


def test_plain_reference_fails_without_a_relu(monkeypatch):
    """The tolerance above tells a regressor without its ReLUs apart."""
    weights = seeded_weights('dnn', 0)
    s1, _ = plain_dnn.frame_scores(*session(400, 1), weights, LAGS)
    monkeypatch.setattr(torch, 'relu', lambda x: x)
    t1, _ = plain_dnn.frame_scores(*session(400, 1), weights, LAGS)
    m1, n1 = (plain_dnn.window_means(s, WIDTH, STEP) for s in (s1, t1))
    assert np.abs(m1 - n1).max() > 100 * TOL * np.sqrt(np.mean(m1 ** 2))


def pair(rows=32, seed=2, raw=False):
    """infer_pair's arguments: EEG rows (raw windows of the EEG lags
    with ``raw``), two audio streams of no context, two envelopes."""
    rng = np.random.RandomState(seed)
    post = LAGS['eeg_post']
    eeg = (LagRows(rng.randn(rows + post, CHANNELS).astype(np.float32), 0,
                   post) if raw else
           rng.randn(rows, F1).astype(np.float32))
    audio = [np.abs(rng.randn(rows, 1)).astype(np.float32)
             for _ in range(2)]
    if raw:
        audio = [LagRows(a, 0, 0) for a in audio]
    return (eeg, *audio, *(np.abs(rng.randn(rows, 1)).astype(np.float32)
                           for _ in range(2)))


def decoder_of(kind):
    if kind == 'classifier':
        return classifier_decoder()
    return regression_decoder(kind, seeded_weights(kind, 0))


@pytest.mark.parametrize('kind,passes', [
    ('dnn', 1), ('dnn_batch_norm', 1), ('linear', 1), ('classifier', 2)])
@pytest.mark.parametrize('call', ['infer_pair', 'infer_pair_async'])
def test_predictions_a_call(kind, passes, call):
    """``decoder.predict_passes`` a pair: one for a model whose
    prediction reads input_1 alone, one a stream for the classifier;
    ``decoder.predict`` inside ``decoder.launch``. One pass for
    ``infer_one``; nothing without a profiler."""
    decoder = decoder_of(kind)
    args = pair()
    getattr(decoder, call)(*args)
    assert profiling.recorded() == profiling.Recorded([], {})
    with profile(activities=[ProfilerActivity.CPU]):
        getattr(decoder, call)(*args)
    found = profiling.recorded()
    assert found.counters[profiling.PREDICT_PASSES] == passes
    assert profiling.TOWER_PASSES not in found.counters
    predict = [e for e in found.events if e.name == 'decoder.predict']
    assert len(predict) == 1
    assert found.events[predict[0].parent].name == 'decoder.launch'
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        decoder.infer_one({'input_1': args[0], 'input_2': args[1]}, args[3])
    assert profiling.recorded().counters[profiling.PREDICT_PASSES] == 1


@pytest.mark.parametrize('kind', ['dnn', 'linear', 'classifier'])
def test_one_prediction_gives_the_scores_of_one_a_stream(kind):
    """The pair's scores are those of two single-stream calls, bit for
    bit, the prediction shared or not."""
    decoder = decoder_of(kind)
    args = pair()
    got = decoder.infer_pair(*args)
    for stream in (0, 1):
        want = decoder.infer_one({'input_1': args[0],
                                  'input_2': args[1 + stream]},
                                 args[3 + stream])
        np.testing.assert_array_equal(got[stream], want)


def on_card(decoder):
    """The decoder with its CPU pipeline built, then named a CUDA one."""
    decoder._pipeline = None
    decoder._current_pipeline()
    decoder._device = torch.device('cuda', 0)
    return decoder


@pytest.mark.parametrize('raw', [False, True])
@pytest.mark.parametrize('kind', ['dnn', 'linear', 'classifier'])
def test_regression_plan_key(kind, raw):
    """A regression decoder on the card gets a key of its pipeline, rows,
    lags and widths (input_1, input_2, the envelopes) for host arrays or
    raw windows and host envelopes."""
    decoder = on_card(decoder_of(kind))
    args = pair(raw=raw)
    lags = ((0, LAGS['eeg_post']) if raw else (0, 0), (0, 0), (0, 0))
    assert decoder._plan_key(*args) == (decoder._pipeline, 32, lags,
                                        (F1, 1, 1))


@pytest.mark.parametrize('case', [
    'reduction_all', 'no_outputs', 'outputs_differ', 'outputs_short',
    'tensor_outputs', 'cpu_decoder'])
def test_regression_calls_off_the_plan(case):
    """No key for the 'all' reduction (one score a frame per dimension),
    envelopes missing, unlike or short, envelopes already tensors, or a
    decoder off the card."""
    decoder = regression_decoder('dnn', seeded_weights('dnn', 0),
                                 'all' if case == 'reduction_all' else 'lda')
    x1, x2a, x2b, ya, yb = pair()
    if case == 'no_outputs':
        args = (x1, x2a, x2b)
    elif case == 'outputs_differ':
        args = (x1, x2a, x2b, ya, np.concatenate([yb, yb], axis=1))
    elif case == 'outputs_short':
        args = (x1, x2a, x2b, ya[:-1], yb[:-1])
    elif case == 'tensor_outputs':
        args = (x1, x2a, x2b, torch.from_numpy(ya), torch.from_numpy(yb))
    else:
        args = (x1, x2a, x2b, ya, yb)
    if case != 'cpu_decoder':
        on_card(decoder)
    assert decoder._plan_key(*args) is None


class StandInPlan:
    """What the decoder hands a plan: the function it captures, run here
    on CPU tensors of the staged inputs, at capture and at each push."""

    made = []

    def __init__(self, run, frame_shapes, rows, device):
        self.shape = (list(frame_shapes), rows)
        self.captured = run
        run([torch.zeros(shape) for shape in frame_shapes])
        StandInPlan.made.append(self)

    def run(self, staged):
        self.staged = staged
        scores = self.captured([torch.from_numpy(s) for s in staged])
        return scores[0].numpy(), scores[1].numpy()


@pytest.mark.parametrize('raw', [False, True])
@pytest.mark.parametrize('kind', ['dnn', 'linear', 'classifier'])
def test_regression_plan_stages_the_envelopes(monkeypatch, kind, raw):
    """The plan captured on a key's second sight stages the three
    streams' frames and then the two envelopes, and its function gives
    the eager scores bit for bit; the decoder counts the push's
    predictions once, replays included."""
    args = pair(raw=raw)
    want = decoder_of(kind).infer_pair(*args)
    decoder = on_card(decoder_of(kind))
    monkeypatch.setattr(push_plan, 'PushPlan', StandInPlan)
    StandInPlan.made = []
    decoder._push_plans.saw(decoder._plan_key(*args))
    with profile(activities=[ProfilerActivity.CPU]):
        got = decoder.infer_pair(*args)
    (plan,) = StandInPlan.made
    frames = [getattr(a, 'frames', a) for a in args[:3]]
    assert plan.shape == ([f.shape for f in frames] + [(32, 1)] * 2, 32)
    assert all(s is a for s, a in zip(plan.staged, frames + list(args[3:])))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert profiling.recorded().counters[profiling.PREDICT_PASSES] == (
        2 if kind == 'classifier' else 1)


def test_regression_plan_keeps_the_weights_of_its_key(monkeypatch):
    """A refit (``set_params``) gives a new key. The plan of the old key
    holds the parameters its graph reads, which the refit replaced (the
    old key's pipeline holds them too, for kernel R1), and frees them
    with it."""
    args = pair()
    decoder = on_card(decoder_of('dnn'))
    key = decoder._plan_key(*args)
    monkeypatch.setattr(push_plan, 'PushPlan', StandInPlan)
    StandInPlan.made = []
    decoder._push_plans.saw(key)
    decoder.infer_pair(*args)
    model = decoder.decoding_model
    read = [weakref.ref(v) for v in model.params.values()]
    decoder._device = torch.device('cpu')
    model.set_params({k: v * 2 for k, v in model.params.items()})
    on_card(decoder)
    again = decoder._plan_key(*args)
    assert again[1:] == key[1:] and again[0] is not key[0]
    del key
    gc.collect()
    assert all(r() is not None for r in read)
    StandInPlan.made = []
    decoder._push_plans = push_plan.PushPlans()
    gc.collect()
    assert all(r() is None for r in read)
