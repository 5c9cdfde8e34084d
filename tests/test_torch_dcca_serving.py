"""The deep CCA decoder on the serving path, on the CPU: one session
pushed through ``StreamingAttentionServer.push`` against the plain
reference (tests/plain_dcca.py) on seeded random weights, the resident
push plan's key and towers for a deep CCA decoder, and the towers' span
and counter.

The plan itself (a CUDA graph) runs on the card only
(tests/test_torch_cuda.py, ``-k push_plan_dcca``). Here a decoder built
on the CPU and then named a CUDA one (its pipeline already built) shows
which key it gets, and a stand-in plan shows what the decoder hands a
plan: the frames' shapes and the function it captures, which holds the
towers and K1's parameters.

Tolerance of the window means: 2e-6 of the reference's RMS. The port
computes in float32 (towers of at most 40 inputs, then K1's sums of 4
dimensions) against float64; a float32 rounding is 6e-8 of a value, and
a few tens of them along a score's chain stay under 2e-6. A tower
product in TF32 (10-bit mantissas, 5e-4 a rounding) or a missing ReLU
moves the means by far more.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import plain_dcca
from telluride_decoding_torch.cli import serve
from telluride_decoding_torch.decode import push_plan
from telluride_decoding_torch.decode.infer_decoder import (
    CCADecoder, CorrelationParamsTuple, ModelParamsTuple)
from telluride_decoding_torch.models.cca import BrainModelCCA, BrainModelDCCA
from telluride_decoding_torch.solvers.lda import LdaParams
from telluride_decoding_torch.utils import profiling

CHANNELS, HIDDEN, DIMS = 8, [16, 8], 4
LAGS = {'eeg_pre': 0, 'eeg_post': 4, 'audio_pre': 2, 'audio_post': 2}
F1 = CHANNELS * (LAGS['eeg_pre'] + 1 + LAGS['eeg_post'])
F2 = LAGS['audio_pre'] + 1 + LAGS['audio_post']
WIDTH, STEP = 40, 20
TOL = 2e-6


@pytest.fixture(autouse=True)
def fresh():
    profiling.reset()
    yield
    profiling.reset()


def seeded_weights(seed):
    """Towers He-scaled (N(0, 2 / fan_in), biases N(0, 0.01)), the final
    CCA, statistics and LDA drawn so that scores stay positive; float32
    values, as the model files hold them."""
    rng = np.random.RandomState(seed)
    weights = {}
    for index, width in ((1, F1), (2, F2)):
        widths = [width] + HIDDEN + [DIMS]
        for i in range(len(widths) - 1):
            weights['tower%d/%d/w' % (index, i)] = rng.randn(
                widths[i], widths[i + 1]) * np.sqrt(2.0 / widths[i])
            weights['tower%d/%d/b' % (index, i)] = 0.1 * rng.randn(
                widths[i + 1])
    weights.update(
        mean1=0.1 * rng.randn(1, DIMS), mean2=0.1 * rng.randn(1, DIMS),
        rot1=rng.randn(DIMS, DIMS) * 0.5 / np.sqrt(DIMS),
        rot2=rng.randn(DIMS, DIMS) * 0.5 / np.sqrt(DIMS),
        corr_mean_x=0.1 * rng.randn(DIMS), corr_mean_y=0.1 * rng.randn(DIMS),
        corr_power=1.0 + rng.rand(DIMS),
        lda_w=rng.randn(DIMS, 1) / np.sqrt(DIMS))
    weights = {k: v.astype(np.float32).astype(np.float64)
               for k, v in weights.items()}
    weights.update(lda_slope=0.1, lda_intercept=0.5)
    return weights


def model_params(weights):
    zeros = np.zeros(DIMS)
    return ModelParamsTuple(
        CorrelationParamsTuple(1, zeros, zeros, zeros, zeros,
                               weights['corr_mean_x'],
                               weights['corr_mean_y'],
                               weights['corr_power']),
        LdaParams(weights['lda_w'], np.zeros_like(weights['lda_w']),
                  np.array([0, 1]), np.zeros((2, DIMS)),
                  weights['lda_slope'], weights['lda_intercept']))


def dcca_decoder(weights):
    model = BrainModelDCCA.from_numpy(
        {k: v for k, v in weights.items()
         if k.startswith('tower') or k in ('mean1', 'mean2', 'rot1',
                                           'rot2')},
        'cpu', config={'cca_dims': DIMS, 'hidden_units': HIDDEN,
                       'input1_width': F1, 'input2_width': F2})
    decoder = CCADecoder(model, reduction='lda', device='cpu')
    decoder.model_params = model_params(weights)
    decoder.decoding_model_params = {
        'pre_context': LAGS['eeg_pre'], 'post_context': LAGS['eeg_post'],
        'input2_pre_context': LAGS['audio_pre'],
        'input2_post_context': LAGS['audio_post']}
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


@pytest.mark.parametrize('chunk', [7, 32])
def test_served_dcca_matches_the_plain_reference(chunk):
    """Every window mean of one session served in chunks against the
    plain reference's, and WTA where its margin is clear."""
    weights = seeded_weights(0)
    eeg, audio1, audio2 = session(1000, seed=1)
    server = serve.StreamingAttentionServer(
        dcca_decoder(weights), eeg_channels=CHANNELS, audio_channels=1,
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
    s1, s2 = plain_dcca.frame_scores(eeg, audio1, audio2, weights, LAGS)
    want1, want2 = (plain_dcca.window_means(s, WIDTH, STEP)
                    for s in (s1, s2))
    got1, got2 = np.asarray(means).T
    assert len(got1) == len(want1) > 40
    scale = np.sqrt(np.mean(np.concatenate([want1, want2]) ** 2))
    assert np.abs(np.concatenate([got1 - want1, got2 - want2])).max() \
        <= TOL * scale
    clear = np.abs(want1 - want2) > 2 * TOL * scale
    assert np.array_equal(np.asarray(decisions)[clear],
                          plain_dcca.wta(want1, want2)[clear])
    # Both talkers win windows: the weights do not decide alone.
    assert 0 < np.mean(decisions) < 1


def test_plain_reference_fails_without_a_relu(monkeypatch):
    """The tolerance above tells a tower without its ReLUs apart."""
    weights = seeded_weights(0)
    eeg, audio1, audio2 = session(400, seed=1)
    s1, _ = plain_dcca.frame_scores(eeg, audio1, audio2, weights, LAGS)
    monkeypatch.setattr(torch, 'relu', lambda x: x)
    t1, _ = plain_dcca.frame_scores(eeg, audio1, audio2, weights, LAGS)
    m1, n1 = (plain_dcca.window_means(s, WIDTH, STEP) for s in (s1, t1))
    assert np.abs(m1 - n1).max() > 100 * TOL * np.sqrt(np.mean(m1 ** 2))


def on_card(decoder):
    """The decoder with its CPU pipeline built, then named a CUDA one."""
    decoder._pipeline = None
    decoder._current_pipeline()
    decoder._device = torch.device('cuda', 0)
    return decoder


def pair(rows=32, seed=2):
    rng = np.random.RandomState(seed)
    return (rng.randn(rows, F1).astype(np.float32),
            np.abs(rng.randn(rows, F2)).astype(np.float32),
            np.abs(rng.randn(rows, F2)).astype(np.float32))


@pytest.mark.parametrize('refit', ['model', 'lda'])
def test_dcca_plan_key_and_a_new_one_after_a_refit(refit):
    """A deep CCA decoder on the card gets a plan key of its towers'
    input widths; a refit of the model or new statistics and LDA give
    another key."""
    decoder = on_card(dcca_decoder(seeded_weights(0)))
    key = decoder._plan_key(*pair())
    pipeline = decoder._pipeline
    assert pipeline.folded.rot1.shape == (DIMS, DIMS)
    assert pipeline.towers is not None
    assert key == (pipeline, 32, ((0, 0),) * 3)
    fresh = seeded_weights(5)
    decoder._device = torch.device('cpu')
    if refit == 'model':
        model = decoder.decoding_model
        model.set_params({k: torch.as_tensor(v) for k, v in fresh.items()
                          if k in dict(model.param_shapes())})
    else:
        decoder.model_params = model_params(fresh)
    on_card(decoder)
    again = decoder._plan_key(*pair())
    assert again[1:] == key[1:] and again[0] is not key[0]


class StandInPlan:
    """What the decoder hands a plan: the function it captures, run here
    on CPU tensors of the staged frames, at capture and at each push."""

    made = []

    def __init__(self, run, frame_shapes, rows, device):
        self.shape = (list(frame_shapes), rows)
        self.captured = run
        run([torch.zeros(shape) for shape in frame_shapes])
        StandInPlan.made.append(self)

    def run(self, frames):
        scores = self.captured([torch.from_numpy(f) for f in frames])
        return scores[0].numpy(), scores[1].numpy()


def test_dcca_plan_gets_the_towers_of_its_key(monkeypatch):
    """The plan captured on a key's second sight gets the decoder's
    composition with the towers and K1's parameters: its scores are the
    CPU path's, bit for bit. Its towers keep the weights of its key
    after a refit."""
    weights = seeded_weights(0)
    x1, x2a, x2b = pair()
    blank = np.zeros((32, 1), np.float32)
    want = dcca_decoder(weights).infer_pair(x1, x2a, x2b, blank, blank)
    decoder = on_card(dcca_decoder(weights))
    monkeypatch.setattr(push_plan, 'PushPlan', StandInPlan)
    StandInPlan.made = []
    decoder._push_plans.saw(decoder._plan_key(x1, x2a, x2b))
    with profile(activities=[ProfilerActivity.CPU]):
        got = decoder.infer_pair(x1, x2a, x2b, blank, blank)
    (plan,) = StandInPlan.made
    assert plan.shape == ([(32, F1), (32, F2), (32, F2)], 32)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    # The plan ran the towers at capture and at the push; the decoder
    # counts the three passes the push served, once.
    assert profiling.recorded().counters[profiling.TOWER_PASSES] == 3
    frames = [torch.from_numpy(x) for x in (x1, x2a, x2b)]
    before = plan.captured(frames)
    decoder.decoding_model.set_params({
        k: torch.as_tensor(v) * 2 for k, v in
        decoder.decoding_model.params.items()})
    torch.testing.assert_close(plan.captured(frames), before, rtol=0,
                               atol=0)


@pytest.mark.parametrize('kind,call,passes', [
    ('dcca', 'infer_pair', 3), ('dcca', 'infer_one', 2),
    ('cca', 'infer_pair', 0)])
def test_towers_span_and_counter_record_under_a_profiler(kind, call,
                                                         passes):
    """``decoder.towers`` inside ``decoder.launch`` and
    ``decoder.tower_passes`` a stream, while a profiler runs; nothing
    without one, and nothing for a model without towers."""
    if kind == 'dcca':
        decoder = dcca_decoder(seeded_weights(0))
    else:
        rng = np.random.RandomState(0)
        decoder = CCADecoder(BrainModelCCA.from_numpy(
            {'mean1': 0.1 * rng.randn(1, F1), 'mean2': 0.1 * rng.randn(1, F2),
             'rot1': rng.randn(F1, DIMS) / F1, 'rot2': rng.randn(F2, DIMS)},
            'cpu'), reduction='lda', device='cpu')
        decoder.model_params = model_params(seeded_weights(0))
    x1, x2a, x2b = pair()
    blank = np.zeros((32, 1), np.float32)

    def serve_once():
        if call == 'infer_pair':
            decoder.infer_pair(x1, x2a, x2b, blank, blank)
        else:
            decoder.infer_one({'input_1': x1, 'input_2': x2a}, blank)
    serve_once()
    assert profiling.recorded() == profiling.Recorded([], {})
    with profile(activities=[ProfilerActivity.CPU]):
        serve_once()
    found = profiling.recorded()
    assert found.counters.get(profiling.TOWER_PASSES, 0) == passes
    towers = [e for e in found.events if e.name == 'decoder.towers']
    assert len(towers) == (1 if passes else 0)
    if call == 'infer_pair' and towers:
        assert found.events[towers[0].parent].name == 'decoder.launch'
