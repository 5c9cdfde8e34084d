"""The decoder's resident push plans (decode/push_plan.py) on the CPU:
which calls take a plan, and the plans' LRU. The plans themselves run
on the card only (tests/test_torch_cuda.py, ``-k push_plan``).

A decoder built on the CPU and then pointed at a CUDA device (its
pipeline already built, so nothing is moved) shows the selection rule
without a card: only a CCA or deep CCA model with the LDA reduction and
numpy inputs of the model's widths get a plan key (a deep CCA's plan
runs its towers too: tests/test_torch_dcca_serving.py).
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
    decoder._invalidate_stale_pipelines()
    decoder._pipeline = decoder._build_pipeline()
    decoder._device = torch.device('cuda', 0)
    return decoder


def test_plan_key_of_a_cca_decoder_with_lda_and_host_arrays():
    decoder = on_card(make_decoder('cca'))
    key, operands, folded = decoder._plan_key(*inputs()[:3])
    assert folded is decoder._pipeline.folded
    assert operands is decode_kernel.prepared_operands(folded, torch.float32)
    # Host arrays are windows with no context.
    assert key == (ROWS, F1, F2, operands.pointers, ((F1, 0, 0), (F2, 0, 0)))


def test_plan_key_of_raw_windows():
    """LagRows get a key of their own: the stacked widths' key with the
    windows' (C, pre, post)."""
    decoder = on_card(make_decoder('cca'))
    key, operands, folded = decoder._plan_key(*windows()[:3])
    assert folded is decoder._pipeline.folded
    assert key == (ROWS, F1, F2, operands.pointers, LAGS)
    stacked = [np.asarray(w) for w in windows()[:3]]
    assert decoder._plan_key(*stacked)[0][:4] == key[:4]
    assert decoder._plan_key(*stacked)[0] != key


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
    """Off the plan (here the CPU), raw windows are stacked on the host:
    the scores of their stacked rows, bit for bit, synchronous or not."""
    decoder = make_decoder(kind)
    raw = windows()
    stacked = [np.asarray(a) for a in raw]
    want = decoder.infer_pair(*stacked)
    for got in (decoder.infer_pair(*raw), decoder.infer_pair_async(*raw)):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


class StandIn:
    """A stand-in plan: what the decoder hands a raw-window plan."""

    def __init__(self, folded, operands, rows, f1, f2, device, towers,
                 lags=None):
        self.made = (rows, f1, f2, lags)
        self.ran = []

    def run(self, *args):
        self.ran.append(args)
        return np.zeros(ROWS, np.float32), np.ones(ROWS, np.float32)


def test_raw_window_plan_gets_the_windows_and_their_frames(monkeypatch):
    decoder = on_card(make_decoder('cca'))
    made = []
    monkeypatch.setattr(push_plan, 'PushPlan',
                        lambda *a: made.append(StandIn(*a)) or made[-1])
    raw = windows()
    decoder._push_plans.saw(decoder._plan_key(*raw[:3])[0])
    got = decoder.infer_pair(*raw)
    (plan,) = made
    assert plan.made == (ROWS, F1, F2, LAGS)
    assert [a is b for a, b in zip(plan.ran[0], raw)] == [True] * 3
    assert got[1][0] == 1.0


class FakePlan:
    captured = 0

    def __init__(self, key):
        FakePlan.captured += 1
        self.key = key


def _operands(seed):
    rng = np.random.RandomState(seed)

    def randn(*shape):
        return torch.as_tensor(rng.randn(*shape), dtype=torch.float32)
    return decode_kernel.prepared_operands(decode_kernel.fold_decode_params({
        'mean1': randn(1, F1), 'mean2': randn(1, F2),
        'rot1': randn(F1, DIMS), 'rot2': randn(F2, DIMS),
        'corr_mean_x': torch.zeros(DIMS), 'corr_mean_y': torch.zeros(DIMS),
        'corr_power': torch.ones(DIMS), 'lda_w': randn(DIMS, 1),
        'lda_slope': 1.0, 'lda_intercept': 0.0}), torch.float32)


def test_plans_are_captured_on_a_keys_second_sight():
    plans = push_plan.PushPlans()
    FakePlan.captured = 0
    ops = _operands(0)
    key = (ROWS, F1, F2, ops.pointers)
    assert plans.plan(key, ops, lambda: FakePlan(key)) is None
    assert FakePlan.captured == 0
    plans.saw(key)
    plan = plans.plan(key, ops, lambda: FakePlan(key))
    assert plan.key == key and FakePlan.captured == 1
    for _ in range(3):
        assert plans.plan(key, ops, lambda: FakePlan(key)) is plan
    assert FakePlan.captured == 1
    # A key seen long ago is forgotten: its next sight is a first one.
    other = (ROWS - 1,) + key[1:]
    plans.saw(other)
    for rows in range(plans.SEEN_SIZE):
        plans.saw((100 + rows,) + key[1:])
    assert plans.plan(other, ops, lambda: FakePlan(other)) is None


def test_plan_lru_keeps_four_and_holds_their_operands():
    plans = push_plan.PushPlans()
    decode_kernel._prepared.clear()
    refs = []
    for seed in range(plans.SIZE + 2):
        ops = _operands(seed)
        key = (ROWS, F1, F2, ops.pointers)
        plans.saw(key)
        assert plans.plan(key, ops, lambda: FakePlan(key)) is not None
        refs.append(weakref.ref(ops.rot1))
        del ops
        # Evicted from prepared_operands' LRU: only the plan holds them.
        decode_kernel._prepared.clear()
        gc.collect()
        assert refs[-1]() is not None
        assert len(plans) == min(seed + 1, plans.SIZE)
    gc.collect()
    alive = [r() is not None for r in refs]
    assert alive == [False, False] + [True] * plans.SIZE
