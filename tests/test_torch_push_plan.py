"""The decoder's resident push plans (decode/push_plan.py) on the CPU:
which calls take a plan, the plans' LRU, and the function a plan
captures. The graphs themselves run on the card only
(tests/test_torch_cuda.py, ``-k push_plan``).

A decoder built on the CPU and then pointed at a CUDA device (its
pipeline already built, so nothing is moved) shows the selection rule
without a card: only a CCA or deep CCA model with the LDA reduction and
numpy inputs or raw windows of the model's widths get a plan key (a
deep CCA's plan runs its towers too: tests/test_torch_dcca_serving.py),
and a regression decoder given its two envelopes
(tests/test_torch_dnn_serving.py).
A stand-in plan takes what the decoder hands a plan: the function it
captures runs here on CPU tensors of the frames a plan stages.
"""

import gc
import weakref

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from telluride_decoding_torch.decode import push_plan
from telluride_decoding_torch.decode.infer_decoder import (
    CCADecoder, CorrelationParamsTuple, LinearRegressionDecoder,
    ModelParamsTuple)
from telluride_decoding_torch.models.brain_model import (
    BrainModelLinearRegression)
from telluride_decoding_torch.models.cca import BrainModelCCA, BrainModelDCCA
from telluride_decoding_torch.ops import decode_kernel
from telluride_decoding_torch.ops.lagstack import LagRows
from telluride_decoding_torch.solvers.lda import LdaParams
from telluride_decoding_torch.utils import profiling

F1, F2, DIMS, ROWS = 12, 3, 3, 8
# Raw windows of those widths: (C, pre, post) of the EEG and the audio.
LAGS = ((3, 0, 3), (1, 1, 1))
# Their plan key's lags: each stream's (pre, post).
KEY_LAGS = ((0, 3), (1, 1), (1, 1))
GRAPH_COUNTERS = (profiling.GRAPH_REPLAYS, profiling.GRAPH_CAPTURES)


@pytest.fixture(autouse=True)
def fresh():
    profiling.reset()
    yield
    profiling.reset()


def _lda_params(decoder, rng, dims):
    zeros = np.zeros(dims)
    decoder.model_params = ModelParamsTuple(
        CorrelationParamsTuple(1, zeros, zeros, zeros, zeros,
                               0.1 * rng.randn(dims), 0.1 * rng.randn(dims),
                               1.0 + rng.rand(dims)),
        LdaParams(rng.randn(dims, 1), np.zeros((dims, 1)), np.array([0, 1]),
                  np.zeros((2, dims)), 0.1, 0.5))
    return decoder


def make_decoder(kind, reduction='lda'):
    """A decoder of ``kind`` ('cca', 'linear' or 'dcca') on the CPU."""
    rng = np.random.RandomState(0)
    if kind == 'cca':
        model = BrainModelCCA.from_numpy(
            {'mean1': 0.1 * rng.randn(1, F1), 'mean2': 0.1 * rng.randn(1, F2),
             'rot1': rng.randn(F1, DIMS) / F1, 'rot2': rng.randn(F2, DIMS)},
            'cpu')
        decoder = CCADecoder(model, reduction=reduction, device='cpu')
        dims = DIMS
    elif kind == 'linear':
        model = BrainModelLinearRegression.from_numpy(
            {'w': rng.randn(F1, 1), 'b': np.zeros(1)}, 'cpu')
        decoder = LinearRegressionDecoder(model, reduction=reduction,
                                          device='cpu')
        dims = 1
    else:
        model = BrainModelDCCA(cca_dims=DIMS, hidden_units=[4],
                               input1_width=F1, input2_width=F2,
                               device='cpu')
        x1 = rng.randn(200, F1).astype(np.float32)
        x2 = (x1[:, :F2] + rng.randn(200, F2)).astype(np.float32)
        model.fit([({'input_1': x1, 'input_2': x2}, x2)], epochs=1,
                  batch_size=100)
        decoder = CCADecoder(model, reduction=reduction, device='cpu')
        dims = DIMS
    return _lda_params(decoder, rng, dims)


def inputs(rows=ROWS, seed=1):
    rng = np.random.RandomState(seed)
    return (rng.randn(rows, F1).astype(np.float32),
            rng.randn(rows, F2).astype(np.float32),
            rng.randn(rows, F2).astype(np.float32),
            np.zeros((rows, 1), np.float32), np.zeros((rows, 1), np.float32))


def windows(rows=ROWS, seed=1, lags=LAGS):
    """inputs() as raw windows (LagRows) of ``lags``."""
    rng = np.random.RandomState(seed)
    (c1, pre1, post1), (c2, pre2, post2) = lags
    return (LagRows(rng.randn(pre1 + rows + post1, c1).astype(np.float32),
                    pre1, post1),
            LagRows(rng.randn(pre2 + rows + post2, c2).astype(np.float32),
                    pre2, post2),
            LagRows(rng.randn(pre2 + rows + post2, c2).astype(np.float32),
                    pre2, post2)) + inputs(rows)[3:]


def on_card(decoder):
    """The decoder with its CPU pipeline built, then named a CUDA one."""
    decoder._pipeline = None
    decoder._current_pipeline()
    decoder._device = torch.device('cuda', 0)
    return decoder


def test_plan_key_of_a_cca_decoder_with_lda_and_host_arrays():
    decoder = on_card(make_decoder('cca'))
    key = decoder._plan_key(*inputs()[:3])
    # The pipeline, no operand addresses; host arrays are windows with
    # no context.
    assert key == (decoder._pipeline, ROWS, ((0, 0),) * 3)


def test_plan_key_of_raw_windows():
    """LagRows get a key of their own: the stacked rows' key with the
    windows' (pre, post)."""
    decoder = on_card(make_decoder('cca'))
    key = decoder._plan_key(*windows()[:3])
    assert key == (decoder._pipeline, ROWS, KEY_LAGS)
    stacked = [np.asarray(w) for w in windows()[:3]]
    assert decoder._plan_key(*stacked)[:2] == key[:2]
    assert decoder._plan_key(*stacked) != key


@pytest.mark.parametrize('case', [
    'cpu_decoder', 'linear', 'reduction_first', 'tensor_inputs',
    'no_rows', 'wrong_width', 'streams_differ', 'one_dim',
    'windows_and_arrays', 'audio_windows_differ', 'window_wrong_width'])
def test_every_other_call_takes_todays_path(case):
    kind = 'linear' if case == 'linear' else 'cca'
    decoder = make_decoder(
        kind, 'first' if case == 'reduction_first' else 'lda')
    x1, x2a, x2b = inputs()[:3]
    if case == 'windows_and_arrays':
        x1 = windows()[0]
    elif case == 'audio_windows_differ':
        # The same stacked width from other lags.
        x1, x2a, _ = windows()[:3]
        x2b = windows(lags=(LAGS[0], (1, 0, 2)))[2]
    elif case == 'window_wrong_width':
        x1, x2a, x2b = windows(lags=((3, 0, 2), LAGS[1]))[:3]
    elif case == 'tensor_inputs':
        x1 = torch.from_numpy(x1)
    elif case == 'no_rows':
        x1, x2a, x2b = x1[:0], x2a[:0], x2b[:0]
    elif case == 'wrong_width':
        x1 = x1[:, :-1]
    elif case == 'streams_differ':
        x2b = x2b[:-1]
    elif case == 'one_dim':
        x2a, x2b = x2a[:, 0], x2b[:, 0]
    if case != 'cpu_decoder':
        on_card(decoder)
        if kind != 'linear' and case != 'reduction_first':
            # The pipeline has K1's parameters: something else decides.
            assert decoder._pipeline.folded is not None
    assert decoder._plan_key(x1, x2a, x2b) is None


@pytest.mark.parametrize('kind', ['cca', 'linear', 'dcca'])
def test_cpu_decoders_serve_as_before_and_count_nothing(kind):
    decoder = make_decoder(kind)
    args = inputs()
    with profile(activities=[ProfilerActivity.CPU]):
        got = [decoder.infer_pair(*args) for _ in range(4)]
    assert len(decoder._push_plans) == 0
    counters = profiling.recorded().counters
    assert not set(GRAPH_COUNTERS) & set(counters), counters
    want = [s.numpy() for s in decoder._pair_scores(*args)]
    for pair in got:
        for g, w in zip(pair, want):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize('kind', ['cca', 'linear', 'dcca'])
def test_raw_windows_off_the_plan_stack_on_the_host(kind):
    """Off the plan (here the CPU), raw windows are stacked where the
    decoder uses them: the scores of their host-stacked rows, bit for
    bit, synchronous or not."""
    decoder = make_decoder(kind)
    raw = windows()
    stacked = [np.asarray(a) for a in raw]
    want = decoder.infer_pair(*stacked)
    for got in (decoder.infer_pair(*raw), decoder.infer_pair_async(*raw)):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


class StandIn:
    """A stand-in plan: what the decoder hands a plan, and what it runs."""

    def __init__(self, run, frame_shapes, rows, device):
        self.captured = run
        self.made = (list(frame_shapes), rows)
        self.ran = []

    def run(self, frames):
        self.ran.append(frames)
        return np.zeros(ROWS, np.float32), np.ones(ROWS, np.float32)


def stand_in_plans(monkeypatch):
    """The plans the decoder makes from here on, stand-ins."""
    made = []
    monkeypatch.setattr(push_plan, 'PushPlan',
                        lambda *a: made.append(StandIn(*a)) or made[-1])
    return made


def test_raw_window_plan_gets_the_windows_and_their_frames(monkeypatch):
    decoder = on_card(make_decoder('cca'))
    made = stand_in_plans(monkeypatch)
    raw = windows()
    decoder._push_plans.saw(decoder._plan_key(*raw[:3]))
    got = decoder.infer_pair(*raw)
    (plan,) = made
    assert plan.made == ([w.frames.shape for w in raw[:3]], ROWS)
    assert [a is b.frames for a, b in zip(plan.ran[0], raw)] == [True] * 3
    assert got[1][0] == 1.0


@pytest.mark.parametrize('kind', ['cca', 'dcca'])
@pytest.mark.parametrize('form', ['raw_windows', 'host_arrays'])
def test_the_plans_function_gives_the_eager_scores(monkeypatch, kind, form):
    """The function the decoder hands a plan, run on CPU tensors of the
    frames the plan stages, gives eager infer_pair's scores bit for bit:
    a plan captures the composition the path without a plan runs."""
    decoder = make_decoder(kind)
    args = windows() if form == 'raw_windows' else inputs()
    want = decoder.infer_pair(*args)
    on_card(decoder)
    made = stand_in_plans(monkeypatch)
    decoder._push_plans.saw(decoder._plan_key(*args[:3]))
    decoder.infer_pair(*args)
    (plan,) = made
    frames = [torch.from_numpy(getattr(a, 'frames', a)) for a in args[:3]]
    assert plan.made == ([tuple(f.shape) for f in frames], ROWS)
    scores = plan.captured(frames)
    assert scores.shape == (2, ROWS)
    for g, w in zip(scores, want):
        np.testing.assert_array_equal(g.numpy(), w)


def test_a_dropped_decoder_frees_its_plans_at_once(monkeypatch):
    """A plan holds its decoder weakly: dropping the decoder frees its
    plans without the cyclic collector, which could run inside another
    decoder's capture and break it by freeing a graph or pinned memory."""
    decoder = on_card(make_decoder('dcca'))
    made = stand_in_plans(monkeypatch)
    args = windows()
    decoder._push_plans.saw(decoder._plan_key(*args[:3]))
    decoder.infer_pair(*args)
    plan = weakref.ref(made.pop())
    gc.disable()
    try:
        del decoder
        assert plan() is None
    finally:
        gc.enable()


class FakePlan:
    captured = 0

    def __init__(self, key):
        FakePlan.captured += 1
        self.key = key


def test_plans_are_captured_on_a_keys_second_sight():
    plans = push_plan.PushPlans()
    FakePlan.captured = 0
    key = ('pipeline', ROWS, KEY_LAGS)
    assert plans.plan(key, lambda: FakePlan(key)) is None
    assert FakePlan.captured == 0
    plans.saw(key)
    plan = plans.plan(key, lambda: FakePlan(key))
    assert plan.key == key and FakePlan.captured == 1
    for _ in range(3):
        assert plans.plan(key, lambda: FakePlan(key)) is plan
    assert FakePlan.captured == 1
    # A key seen long ago is forgotten: its next sight is a first one.
    other = key[:1] + (ROWS - 1,) + key[2:]
    plans.saw(other)
    for rows in range(plans.SEEN_SIZE):
        plans.saw(key[:1] + (100 + rows,) + key[2:])
    assert plans.plan(other, lambda: FakePlan(other)) is None


def test_plan_lru_keeps_four_and_holds_their_operands(monkeypatch):
    """A plan holds what its graph reads: its pipeline and K1's operands
    as its capture took them, after prepared_operands' LRU has dropped
    them. The decoder keeps four plans; an evicted one frees both."""
    decoder = make_decoder('cca')
    monkeypatch.setattr(push_plan, 'PushPlan', StandIn)
    rng = np.random.RandomState(2)
    refs = []
    for refit in range(push_plan.PushPlans.SIZE + 2):
        # New statistics and LDA: a new pipeline, so a new key.
        decoder._device = torch.device('cpu')
        on_card(_lda_params(decoder, rng, DIMS))
        args = inputs(seed=refit)
        decoder._push_plans.saw(decoder._plan_key(*args[:3]))
        decoder.infer_pair(*args)
        folded = decoder._pipeline.folded
        refs.append((weakref.ref(decode_kernel.prepared_operands(
            folded, torch.float32).rot1), weakref.ref(folded.scale)))
        del folded
        decoder._pipeline = None
        decode_kernel._prepared.clear()
        gc.collect()
        assert all(r() is not None for r in refs[-1])
        assert len(decoder._push_plans) == min(refit + 1,
                                               push_plan.PushPlans.SIZE)
    gc.collect()
    alive = [[r() is not None for r in pair] for pair in refs]
    assert alive == [[False] * 2] * 2 + [[True] * 2] * 4


