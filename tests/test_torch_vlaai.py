"""VLAAI (models/vlaai.py) on the CPU at a small size, on seeded weights:
the model against the plain reference (tests/plain_vlaai.py), a served
raw window's rows against the forward pass over the whole zero-prefixed
stream, the weights shared across blocks and those of one block, a save
and ``load_model`` round trip, ``StreamingAttentionServer.push`` against
the plain reference's window means and decisions, and the decoder's
route for a model with a window context: no kernel R1's weights, no lag
stack of the EEG, the raw window staged in a push plan, the offline
routes refused.

The small network: 8 EEG channels, extractor filters 16-16-16-8-8 of
kernel 8, an output context of kernel 32, 2 blocks; its window context
is 62 frames before a frame and 70 after.

Tolerances. The port computes in float32, the plain reference in
float64. A float32 rounding is 6e-8 of a value; a prediction passes 12
convolutions of up to 512 products each and 12 layer norms, whose
roundings add to a few 1e-6 of the prediction's scale (measured: under
2e-6), so predictions are held to 2e-5 of their RMS, and window means,
whose prediction enters through a 0.1 LDA slope around a 0.5 intercept,
to 2e-6 of the means' RMS. A leaky ReLU of slope 0.01, a dropped skip
path, the extractor padded at its start or one dense layer for every
block moves the means by far more (``test_faults_move_the_means``). Two
float32 forward passes over windows of different lengths are held to
1e-5 of the RMS (bit for bit on the CPU here): the unfolded products'
shapes differ, and a library may round products of other shapes in
other orders.
"""

import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import plain_vlaai
from telluride_decoding_torch.cli import serve
from telluride_decoding_torch.decode import infer_decoder, push_plan
from telluride_decoding_torch.decode.infer_decoder import (
    CorrelationParamsTuple, LinearRegressionDecoder, ModelParamsTuple)
from telluride_decoding_torch.models import vlaai
from telluride_decoding_torch.models.brain_model import load_model
from telluride_decoding_torch.ops import lagstack
from telluride_decoding_torch.ops.lagstack import LagRows
from telluride_decoding_torch.solvers.lda import LdaParams
from telluride_decoding_torch.utils import profiling

CHANNELS = 8
CONFIG = {'input_channels': CHANNELS, 'filters': [16, 16, 16, 8, 8],
          'kernels': [8] * 5, 'context_kernel': 32, 'blocks': 2,
          'output_width': 1}
PRE, POST = 62, 70
WIDTH, STEP = 40, 20
PRED_TOL = 2e-5
TOL = 2e-6
WINDOW_TOL = 1e-5


@pytest.fixture(autouse=True)
def fresh():
    profiling.reset()
    yield
    profiling.reset()


def seeded_weights(seed=0):
    """The network's weights (N(0, 2 / fan_in); biases N(0, 0.01); scales
    1 + N(0, 0.1), shifts N(0, 0.1)) and the decoder's statistics and
    LDA, float32 values, under the reference's names."""
    rng = np.random.RandomState(seed)
    model = vlaai.BrainModelVLAAI(**CONFIG, device='cpu')
    weights = {}
    for name, shape in model.param_shapes():
        if name.endswith('/w'):
            fan_in = int(np.prod(shape[:-1]))
            weights[name] = rng.randn(*shape) * np.sqrt(2.0 / fan_in)
        elif name.endswith('/gamma'):
            weights[name] = 1.0 + np.sqrt(0.1) * rng.randn(*shape)
        elif name.endswith('/beta'):
            weights[name] = np.sqrt(0.1) * rng.randn(*shape)
        else:
            weights[name] = 0.1 * rng.randn(*shape)
    weights.update(corr_mean_x=0.1 * rng.randn(1),
                   corr_mean_y=0.1 * rng.randn(1),
                   corr_power=1.0 + rng.rand(1), lda_w=rng.randn(1, 1))
    weights = {k: v.astype(np.float32).astype(np.float64)
               for k, v in weights.items()}
    weights.update(lda_slope=0.1, lda_intercept=0.5)
    return weights


def vlaai_model(weights):
    return vlaai.BrainModelVLAAI.from_numpy(
        {k: v for k, v in weights.items() if '/' in k}, 'cpu', CONFIG)


def vlaai_decoder(weights, reduction='lda'):
    decoder = LinearRegressionDecoder(vlaai_model(weights),
                                      reduction=reduction, device='cpu')
    zeros = np.zeros(1)
    decoder.model_params = ModelParamsTuple(
        CorrelationParamsTuple(1, zeros, zeros, zeros, zeros,
                               weights['corr_mean_x'],
                               weights['corr_mean_y'],
                               weights['corr_power']),
        LdaParams(weights['lda_w'], np.zeros_like(weights['lda_w']),
                  np.array([0, 1]), np.zeros((2, 1)),
                  weights['lda_slope'], weights['lda_intercept']))
    decoder.decoding_model_params = {
        'pre_context': PRE, 'post_context': POST,
        'input2_pre_context': 0, 'input2_post_context': 0}
    return decoder


def session(frames, seed):
    """Two positive talker envelopes and EEG following talker 1 for the
    first half and talker 2 after it, plus noise."""
    rng = np.random.RandomState(seed)
    talkers = np.abs(rng.randn(2, frames)).astype(np.float32)
    attended = np.where(np.arange(frames) < frames // 2, talkers[0],
                        talkers[1])
    eeg = attended[:, None] * rng.randn(CHANNELS) + rng.randn(frames,
                                                              CHANNELS)
    return (eeg.astype(np.float32), talkers[0][:, None], talkers[1][:, None])


def rms(a):
    return float(np.sqrt(np.mean(np.square(a))))


def forward(model, frames):
    with torch.no_grad():
        return model({'input_1': frames})[:, 0].double().numpy()


def test_published_widths():
    """The default model is the paper's: 1,740,289 parameters, a window
    of 124 frames before a frame and 140 after."""
    model = vlaai.BrainModelVLAAI(device='cpu')
    assert model.window_context == (124, 140)
    assert sum(int(np.prod(s)) for _, s in model.param_shapes()) == 1740289
    assert model.reads_input_1_only


@pytest.mark.parametrize('rows', [1, 32, 100])
def test_model_matches_the_plain_reference(rows):
    """A raw window of rows + 132 frames gives the plain network's
    outputs at its frames 62 .. 62 + rows - 1."""
    weights = seeded_weights(0)
    frames = np.random.RandomState(rows).randn(
        rows + PRE + POST, CHANNELS).astype(np.float32)
    got = forward(vlaai_model(weights), frames)
    w = {k: torch.as_tensor(v) for k, v in weights.items() if '/' in k}
    want = plain_vlaai.network(torch.as_tensor(frames, dtype=torch.float64),
                               w)[PRE:PRE + rows, 0].numpy()
    assert got.shape == (rows,)
    assert np.abs(got - want).max() <= PRED_TOL * rms(want)


@pytest.mark.parametrize('start', [0, 10, 61, 62, 200])
def test_served_rows_equal_the_zero_prefixed_stream(start):
    """The rows of a raw window cut from a stream with 62 zero frames in
    front, frames within 62 of its start included, are the forward pass
    over the whole zero-prefixed stream at those frames."""
    weights = seeded_weights(1)
    model = vlaai_model(weights)
    eeg, _, _ = session(600, 2)
    padded = np.concatenate([np.zeros((PRE, CHANNELS), np.float32), eeg])
    rows = 32
    window = padded[start:start + rows + PRE + POST]
    got = forward(model, window)
    whole = forward(model, padded)        # Frames 0 .. 600 - 70 - 1.
    want = whole[start:start + rows]
    assert np.abs(got - want).max() <= WINDOW_TOL * rms(want)
    plain = plain_vlaai.predict(eeg, weights).numpy()[start:start + rows]
    assert np.abs(got - plain).max() <= PRED_TOL * rms(plain)


def test_blocks_share_the_extractor_and_context():
    """One extractor and one output context for every block, a dense
    layer of its own a block: a change to block 1's dense layer leaves
    block 0's output as it was and changes block 1's; a change to the
    shared extractor changes both."""
    weights = seeded_weights(3)
    model = vlaai_model(weights)
    names = [n for n, _ in model.param_shapes()]
    assert sum(n.startswith('extractor/') for n in names) == 4 * 5
    assert sum(n.startswith('context/') for n in names) == 4
    assert [n for n in names if n.startswith('dense/')] == [
        'dense/0/w', 'dense/0/b', 'dense/1/w', 'dense/1/b']
    e = torch.as_tensor(session(300, 4)[0])
    params = model.params

    def outputs(p):
        return [vlaai.run_blocks(p, e, count, 5) for count in (1, 2)]
    base = outputs(params)
    dense = outputs(dict(params, **{'dense/1/w': params['dense/1/w'] * 1.5}))
    assert torch.equal(dense[0], base[0])
    assert not torch.allclose(dense[1], base[1])
    shared = outputs(dict(params, **{
        'extractor/2/w': params['extractor/2/w'] * 1.5}))
    assert not torch.allclose(shared[0], base[0])
    assert not torch.allclose(shared[1], base[1])


def test_save_and_load_round_trip(tmp_path):
    """model.json and weights.npz load back through ``load_model`` (the
    class registered by name) with the same config and weights, and as a
    decoder through cli/infer.py's ``load_model``."""
    weights = seeded_weights(5)
    decoder = vlaai_decoder(weights)
    model = decoder.decoding_model
    model.add_metadata(decoder.decoding_model_params)
    model.save(str(tmp_path))
    decoder.save_parameters(os.path.join(tmp_path, 'decoder_model.json'))
    loaded = load_model(str(tmp_path), 'cpu')
    assert type(loaded) is vlaai.BrainModelVLAAI
    assert loaded.config() == CONFIG
    assert set(loaded.params) == set(model.params)
    for name, value in model.params.items():
        assert torch.equal(loaded.params[name], value), name
    frames = session(200, 6)[0][:PRE + POST + 20]
    np.testing.assert_array_equal(forward(loaded, frames),
                                  forward(model, frames))
    served = serve._load_serving_decoder(str(tmp_path), None, 'cpu')
    assert isinstance(served, LinearRegressionDecoder)
    assert served._current_pipeline().window == (PRE, POST)


def served(decoder, chunk, frames=900, seed=1):
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


def reference(weights, frames=900, seed=1):
    s1, s2 = plain_vlaai.frame_scores(*session(frames, seed), weights)
    return (plain_vlaai.window_means(s1, WIDTH, STEP),
            plain_vlaai.window_means(s2, WIDTH, STEP))


@pytest.mark.parametrize('chunk', [7, 32])
def test_served_session_matches_the_plain_reference(chunk):
    """Every window mean of one session served in chunks, and every
    decision clear of the tolerance, against the plain reference's; both
    talkers win windows."""
    weights = seeded_weights(0)
    means, decisions = served(vlaai_decoder(weights), chunk)
    want1, want2 = reference(weights)
    got1, got2 = means.T
    assert len(got1) == len(want1) > 30
    scale = rms(np.concatenate([want1, want2]))
    assert np.abs(np.concatenate([got1 - want1, got2 - want2])).max() \
        <= TOL * scale
    clear = np.abs(want1 - want2) > 2 * TOL * scale
    assert clear.mean() > 0.9
    assert np.array_equal(decisions[clear],
                          plain_vlaai.wta(want1, want2)[clear])
    assert 0 < np.mean(decisions) < 1


FAULTS = {
    'slope_0.01': lambda mp: mp.setattr(
        vlaai, 'activation', lambda h: torch.nn.functional.leaky_relu(
            h, 0.01)),
    'dropped_skip': lambda mp: mp.setattr(vlaai, 'run_blocks',
                                          _blocks(skip=False)),
    'pad_at_start': lambda mp: mp.setattr(vlaai, 'extractor',
                                          _extractor_padded_in_front),
    'one_dense_layer': lambda mp: mp.setattr(vlaai, 'run_blocks',
                                             _blocks(one_dense=True)),
}


def _blocks(skip=True, one_dense=False):
    def run_blocks(params, e, count, layers):
        x = torch.zeros_like(e)
        for i in range(count):
            h = vlaai.extractor(params, e + x if skip or i == 0 else x,
                                layers)
            d = 0 if one_dense else i
            h = h @ params['dense/%d/w' % d] + params['dense/%d/b' % d]
            x = vlaai.output_context(params, h)
        return x
    return run_blocks


def _extractor_padded_in_front(params, h, layers):
    for j in range(layers):
        k = params['extractor/%d/w' % j].shape[0]
        h = torch.nn.functional.pad(
            vlaai.conv_ln_act(h, params, 'extractor/%d/' % j),
            (0, 0, k - 1, 0))
    return h


@pytest.mark.parametrize('fault', sorted(FAULTS))
def test_faults_move_the_means(fault, monkeypatch):
    """Each departure from the equations moves the served means by far
    more than the tolerance."""
    weights = seeded_weights(0)
    FAULTS[fault](monkeypatch)
    means, _ = served(vlaai_decoder(weights), 32, frames=500)
    want1, want2 = reference(weights, frames=500)
    got1, got2 = means.T
    scale = rms(np.concatenate([want1, want2]))
    assert np.abs(np.concatenate([got1 - want1, got2 - want2])).max() \
        > 100 * TOL * scale


def raw_pair(rows=32, seed=2):
    """infer_pair's arguments as the serving loop hands them over: the
    EEG's raw window, two audio windows of no context, two envelopes."""
    rng = np.random.RandomState(seed)
    eeg = LagRows(rng.randn(rows + PRE + POST, CHANNELS).astype(np.float32),
                  PRE, POST)
    audio = [LagRows(np.abs(rng.randn(rows, 1)).astype(np.float32), 0, 0)
             for _ in range(2)]
    envelopes = [np.abs(rng.randn(rows, 1)).astype(np.float32)
                 for _ in range(2)]
    return (eeg, *audio, *envelopes)


def test_pipeline_reads_the_raw_window(monkeypatch):
    """The pipeline builds no R1 weights, holds the window context and
    hands the model the raw window: no lag stack runs. The pair's scores
    are the plain reference's on the window; one prediction a call, the
    raw frames it read, no device stack."""
    weights = seeded_weights(7)
    decoder = vlaai_decoder(weights)
    pipeline = decoder._current_pipeline()
    assert pipeline.regression is None and pipeline.folded is None
    assert pipeline.window == (PRE, POST)

    def no_stack(*args):
        raise AssertionError('lag_stack ran')
    monkeypatch.setattr(infer_decoder, 'lag_stack', no_stack)
    monkeypatch.setattr(lagstack, 'lag_stack', no_stack)
    args = raw_pair()
    with profile(activities=[ProfilerActivity.CPU]):
        got = decoder.infer_pair(*args)
    counters = profiling.recorded().counters
    assert counters[profiling.PREDICT_PASSES] == 1
    assert counters[profiling.WINDOW_FRAMES] == 32 + PRE + POST
    assert profiling.DEVICE_STACKS not in counters
    w = {k: torch.as_tensor(v) for k, v in weights.items() if '/' in k}
    prediction = plain_vlaai.network(
        torch.as_tensor(args[0].frames, dtype=torch.float64),
        w)[PRE:PRE + 32, 0].numpy()
    for stream in (0, 1):
        y = args[3 + stream][:, 0]
        want = (0.1 * weights['lda_w'][0, 0] *
                (y - weights['corr_mean_x'][0]) *
                (prediction - weights['corr_mean_y'][0]) /
                weights['corr_power'][0] + 0.5)
        assert np.abs(got[stream] - want).max() <= TOL * rms(want)


def test_other_pipelines_stack_as_before():
    """A model of stacked rows gets no window and the stacking input."""
    from test_torch_dnn_serving import regression_decoder, seeded_weights \
        as dnn_weights
    pipeline = regression_decoder('dnn', dnn_weights('dnn', 0)) \
        ._current_pipeline()
    assert pipeline.window is None
    assert pipeline.input_1 is infer_decoder._stacked


def on_card(decoder):
    """The decoder with its CPU pipeline built, then named a CUDA one."""
    decoder._pipeline = None
    decoder._current_pipeline()
    decoder._device = torch.device('cuda', 0)
    return decoder


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


def test_plan_stages_the_raw_window(monkeypatch):
    """On the card the push's key holds the window's lags; the plan
    stages the raw window (rows + 132 frames of 8 channels), the audio
    and the envelopes, and its function gives the eager scores bit for
    bit; replays count the frames read."""
    weights = seeded_weights(8)
    args = raw_pair()
    want = vlaai_decoder(weights).infer_pair(*args)
    decoder = on_card(vlaai_decoder(weights))
    key = decoder._plan_key(*args)
    assert key == (decoder._pipeline, 32, ((PRE, POST), (0, 0), (0, 0)),
                   (CHANNELS * (PRE + 1 + POST), 1, 1))
    monkeypatch.setattr(push_plan, 'PushPlan', StandInPlan)
    StandInPlan.made = []
    decoder._push_plans.saw(key)
    with profile(activities=[ProfilerActivity.CPU]):
        got = decoder.infer_pair(*args)
        decoder.infer_pair(*args)
    (plan,) = StandInPlan.made
    assert plan.shape == ([(32 + PRE + POST, CHANNELS), (32, 1), (32, 1),
                           (32, 1), (32, 1)], 32)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    counters = profiling.recorded().counters
    assert counters[profiling.WINDOW_FRAMES] == 2 * (32 + PRE + POST)
    assert profiling.DEVICE_STACKS not in counters


@pytest.mark.parametrize('route', ['frame_scores', 'test_by_window_means',
                                   'pair_program', 'stacked_rows',
                                   'train'])
def test_offline_routes_are_refused(route):
    """The offline routes read lag-stacked rows, 133 lags of every frame
    here: each is refused with an error that names the served path."""
    decoder = vlaai_decoder(seeded_weights(9))
    rows = np.zeros((10, CHANNELS), np.float32)
    batch = [({'input_1': rows, 'input_2': rows[:, :1],
               'attended_speaker': rows[:, :1]}, rows[:, :1])]
    calls = {
        'frame_scores': lambda: decoder.frame_scores(batch),
        'test_by_window_means': lambda: decoder.test_by_window_means(
            batch, 4),
        'pair_program': lambda: infer_decoder.PairProgram(decoder),
        'stacked_rows': lambda: decoder.infer_one(
            {'input_1': rows, 'input_2': rows[:, :1]}, rows[:, :1]),
        'train': lambda: decoder.train(batch, batch),
    }
    with pytest.raises(ValueError, match='StreamingAttentionServer.push'):
        calls[route]()


def test_window_shorter_than_the_context_is_refused():
    model = vlaai_model(seeded_weights(10))
    with pytest.raises(ValueError, match='raw window'):
        model({'input_1': np.zeros((PRE + POST, CHANNELS), np.float32)})
