"""S1's sequence form on the CPU: ssd_sequence and its plain version,
the decision rules' attention_sequence and attention_sequences, against
successive window updates or calls of the port and the JAX decoder.

The plain SSD costs about 0.2 s a window at the factory's trip counts on
a CPU, so these tests run k_w 5 at 3 / 2 / 4 iterations. Tolerance
against JAX: TOL 1e-5 abs, as tests/test_torch_attention_decoder.py
(float32 on both sides, exp, log and the four window sums rounded
differently). Against the port's own successive updates: exact, since
the sequence's plain version runs the same window update on the same
values.
"""

import numpy as np
import pytest
import torch

from telluride_decoding_tpu.decide import attention_decoder as jax_ad
from telluride_decoding_torch import kernels
from telluride_decoding_torch.decide import attention_decoder as ad
from telluride_decoding_torch.ops import ssd_update as ops

TOL = 1e-5
K_W, TRIPS = 5, (3, 2, 4)
SSD = ad.StateSpaceAttentionDecoder


def lognormal_pairs(rng, n):
    attended = (np.arange(n) // 15) % 2 == 0
    r_att = np.exp(-0.4 + 0.6 * rng.randn(n))
    r_un = np.exp(-1.5 + 0.9 * rng.randn(n))
    return np.where(attended, r_att, r_un), np.where(attended, r_un, r_att)


def port_decoder(r1, r2, offset=0.0):
    dec = ad.StateSpaceAttentionDecoder(*TRIPS, 100.0, backward_lag=K_W - 1,
                                        offset=offset, device='cpu')
    dec.tune(r1[:10], r2[:10])
    return dec


def jax_decoder(r1, r2, offset=0.0):
    dec = jax_ad.StateSpaceAttentionDecoder(*TRIPS, 100.0,
                                            backward_lag=K_W - 1,
                                            offset=offset)
    dec.tune(r1[:10], r2[:10])
    return dec


def stream(seed, length):
    """A packed state, packed constants and a series of ``length``
    values (its ring at the first window, then one value a window)."""
    rng = np.random.RandomState(seed)
    a_0 = 2 + 0.2 ** 2 / 5
    consts = torch.tensor([-0.4 + 0.1 * rng.randn(), -1.5, 641.13, 4043.4,
                           375.81, 6279.1, a_0, 0.2 * (a_0 - 1), 1.0])
    state = torch.cat([
        torch.tensor([-0.3994, -1.5103, 1.7060, 0.64395]),
        torch.tensor(0.5 * rng.randn(K_W + 1), dtype=torch.float32),
        torch.tensor(0.1 + rng.rand(K_W + 1), dtype=torch.float32),
        torch.full((K_W,), 0.3), torch.zeros(K_W)])
    r1, r2 = lognormal_pairs(rng, length)
    return (state, consts, torch.tensor(r1, dtype=torch.float32),
            torch.tensor(r2, dtype=torch.float32))


def window_loop(state, consts, r1, r2, at=-1):
    """ssd_update_reference window after window on one stream."""
    views = ops.state_views(state, K_W)
    rows = []
    for j in range(r1.numel() - K_W + 1):
        views, z, eta = ops.ssd_update_reference(
            views, r1[j:j + K_W], r2[j:j + K_W], ops.constants_views(consts),
            *TRIPS, K_W)
        rows.append(torch.stack([z[at], eta[at]]))
    return ops.pack(list(views)), torch.stack(rows)


@pytest.mark.parametrize('at', [-1, -3])
def test_sequence_reference_equals_the_window_loop(at):
    """Two streams of different lengths and constants: each equals its
    own per-window loop exactly, in stream order."""
    streams = [stream(0, K_W - 1 + 4), stream(1, K_W - 1 + 2)]
    offsets = np.cumsum([0] + [s[2].numel() for s in streams])
    states, out = ops.ssd_sequence_reference(
        torch.stack([s[0] for s in streams]),
        torch.stack([s[1] for s in streams]),
        torch.cat([s[2] for s in streams]),
        torch.cat([s[3] for s in streams]), offsets, *TRIPS, K_W, at=at)
    assert ops.sequence_windows(offsets, K_W) == [4, 2]
    first = 0
    for b, s in enumerate(streams):
        want_state, want = window_loop(*s, at=at)
        assert torch.equal(states[b], want_state)
        assert torch.equal(out[first:first + want.shape[0]], want)
        first += want.shape[0]
    assert first == out.shape[0]


def test_sequence_takes_the_plain_version_on_the_cpu():
    state, consts, r1, r2 = stream(2, K_W + 1)
    before = kernels.launches['ssd_sequence']
    got = ops.ssd_sequence(state[None], consts[None], r1, r2, [0, K_W + 1],
                           *TRIPS, K_W)
    want = ops.ssd_sequence_reference(state[None], consts[None], r1, r2,
                                      [0, K_W + 1], *TRIPS, K_W)
    assert kernels.launches['ssd_sequence'] == before
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert not torch.equal(got[0], state[None])    # a new state


@pytest.mark.parametrize('offsets,match', [([0, K_W - 2], 'shorter'),
                                           ([1, K_W + 1], 'start at 0'),
                                           ([0], 'start at 0')])
def test_sequence_refuses_bad_offsets(offsets, match):
    state, consts, r1, r2 = stream(3, K_W + 1)
    with pytest.raises(ValueError, match=match):
        ops.ssd_sequence(state[None], consts[None], r1, r2, offsets, *TRIPS,
                         K_W)


def test_attention_sequence_matches_jax():
    """attention_sequence over a stream: JAX's attention outputs, z_dyn
    and eta_dyn within TOL; calls and ring buffers as JAX leaves them;
    a following attention call matches JAX's."""
    r1, r2 = lognormal_pairs(np.random.RandomState(4), 30)
    got_dec, want_dec = port_decoder(r1, r2, 0.05), jax_decoder(r1, r2, 0.05)
    got = np.array(got_dec.attention_sequence(r1, r2))
    want = np.array([want_dec.attention(a, b) for a, b in zip(r1, r2)])
    np.testing.assert_allclose(got, want, atol=TOL)
    np.testing.assert_allclose(got_dec.z_dyn, want_dec.z_dyn, atol=TOL)
    np.testing.assert_allclose(got_dec.eta_dyn, want_dec.eta_dyn, atol=TOL)
    assert got_dec.calls == want_dec.calls == 30
    np.testing.assert_array_equal(got_dec._r1_buf,
                                  np.asarray(want_dec._r1_buf))
    np.testing.assert_array_equal(got_dec._r2_buf,
                                  np.asarray(want_dec._r2_buf))
    np.testing.assert_allclose(got_dec.attention(0.4, 0.3),
                               want_dec.attention(0.4, 0.3), atol=TOL)


def test_attention_sequence_leaves_the_decoder_as_successive_calls():
    """Split anywhere, warm-up included, the sequence gives the port's
    successive attention calls exactly and leaves the decoder alike."""
    r1, r2 = lognormal_pairs(np.random.RandomState(5), 24)
    by_call, by_sequence = port_decoder(r1, r2), port_decoder(r1, r2)
    want = [by_call.attention(a, b) for a, b in zip(r1, r2)]
    got = []
    for lo, hi in ((0, 2), (2, 7), (7, 7), (7, 24)):
        got += by_sequence.attention_sequence(r1[lo:hi], r2[lo:hi])
    assert got == want
    assert got[:K_W - 1] == [(0.5, 0.5, 0.5)] * (K_W - 1)
    assert (by_sequence.calls, by_sequence.z_dyn, by_sequence.eta_dyn) == (
        by_call.calls, by_call.z_dyn, by_call.eta_dyn)
    assert np.array_equal(by_sequence._r1_buf, by_call._r1_buf)
    assert np.array_equal(by_sequence._r2_buf, by_call._r2_buf)
    assert torch.equal(ops.pack(list(by_sequence._state)),
                       ops.pack(list(by_call._state)))
    assert by_sequence.attention(0.4, 0.3) == by_call.attention(0.4, 0.3)


def test_attention_sequences_decides_several_decoders_at_once():
    """Decoders tuned apart (their own constants), one of them with no
    full window: each gets what its own successive calls give."""
    rng = np.random.RandomState(6)
    pairs = [lognormal_pairs(rng, n) for n in (20, 3, 12)]
    by_call = [port_decoder(*p) for p in pairs]
    by_sequence = [port_decoder(*p) for p in pairs]
    want = [[dec.attention(a, b) for a, b in zip(*p)]
            for dec, p in zip(by_call, pairs)]
    got = SSD.attention_sequences(by_sequence, [p[0] for p in pairs],
                                  [p[1] for p in pairs])
    assert got == want
    for a, b in zip(by_call, by_sequence):
        assert (a.calls, a.z_dyn) == (b.calls, b.z_dyn)
        assert torch.equal(ops.pack(list(a._state)), ops.pack(list(b._state)))
    assert SSD.attention_sequences([], [], []) == []


def test_stack_streams_packs_copies():
    """stack_streams gives ssd_sequence's [S, 6 + 4 k_w] and [S, 9]
    inputs from state and constants views, as new tensors."""
    r1, r2 = lognormal_pairs(np.random.RandomState(7), 12)
    decs = [port_decoder(r1, r2), port_decoder(r2, r1)]
    states, consts = ops.stack_streams([d._state for d in decs],
                                       [d._constants() for d in decs])
    assert states.shape == (2, 6 + 4 * K_W) and consts.shape == (2, 9)
    for b, dec in enumerate(decs):
        assert torch.equal(states[b], ops.pack(list(dec._state)))
        assert torch.equal(consts[b], ops.pack(list(dec._constants())))
    states += 1.0
    assert not torch.equal(states[0], ops.pack(list(decs[0]._state)))


def test_attention_sequences_refuses_mixed_decoders():
    r1, r2 = lognormal_pairs(np.random.RandomState(8), 8)
    other = ad.StateSpaceAttentionDecoder(*TRIPS, 100.0, backward_lag=2,
                                          device='cpu')
    with pytest.raises(ValueError, match='differ'):
        SSD.attention_sequences([port_decoder(r1, r2), other], [r1, r1],
                                [r2, r2])
    with pytest.raises(ValueError, match='r1 against'):
        SSD.attention_sequences([port_decoder(r1, r2)], [r1], [r2[:3]])


@pytest.mark.parametrize('rule', ['wta', 'stepped'])
def test_host_rules_decide_sequences_call_by_call(rule):
    """The host rules' attention_sequences (the base class's) and
    attention_sequence give their successive attention calls, and leave
    the stepper's state as those calls do."""
    rng = np.random.RandomState(10)
    pairs = [(rng.randn(n), rng.randn(n)) for n in (9, 4)]
    by_call = [ad.create_attention_decoder(rule) for _ in pairs]
    by_sequence = [ad.create_attention_decoder(rule) for _ in pairs]
    want = [[dec.attention(a, b) for a, b in zip(*p)]
            for dec, p in zip(by_call, pairs)]
    got = type(by_sequence[0]).attention_sequences(
        by_sequence, [p[0] for p in pairs], [p[1] for p in pairs])
    assert got == want
    assert by_sequence[0].attention_sequence(*pairs[1]) == [
        by_call[0].attention(a, b) for a, b in zip(*pairs[1])]
    assert [vars(d) for d in by_sequence] == [vars(d) for d in by_call]


def test_window_update_fills_decision_and_rows_on_the_cpu():
    """ssd_update's ``out`` and ``decision`` take the plain version's
    rows and its values at ``at`` on the CPU too."""
    state, consts, r1, r2 = stream(9, K_W)
    rows = torch.empty(2, K_W)
    decision = torch.empty(2)
    _, z, eta = ops.ssd_update(ops.state_views(state, K_W), r1, r2,
                               ops.constants_views(consts), *TRIPS, K_W,
                               out=rows, decision=decision, at=-2)
    assert torch.equal(rows, torch.stack([z, eta]))
    assert torch.equal(decision, torch.stack([z[-2], eta[-2]]))
