"""Attention decision rules of the PyTorch port vs the JAX package.

The same seeded numpy log-normal correlation streams go through JAX's
``_ssd_update`` / ``StateSpaceAttentionDecoder`` and the port's
``ssd_update_reference`` / decoder on the CPU. Tolerances: 1e-5 abs on z
and eta of one update and on p, lower and upper over a stream. Both sides
compute in float32 with the same operation order; only exp, log and the
four window sums round differently (about 5e-7 measured on one update,
8e-8 on a 60-call stream), and 1e-5 leaves room for twenty EM rounds of
Newton steps to amplify that. Decisions must agree wherever p is more
than that away from 0.5.

The plain SSD costs about 0.2 s a window update on the CPU, so each test
uses as few calls as it needs.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from telluride_decoding_tpu.decide import attention_decoder as jax_ad
from telluride_decoding_torch import kernels
from telluride_decoding_torch.decide import attention_decoder as ad
from telluride_decoding_torch.ops import ssd_update as ops

TOL = 1e-5


def lognormal_stream(rng, attended):
    """Window correlations, higher log-normal when attended (the JAX
    suite's _lognormal_correlations)."""
    n = attended.shape[0]
    r_att = np.exp(-0.4 + 0.6 * rng.randn(n))
    r_un = np.exp(-1.5 + 0.9 * rng.randn(n))
    return np.where(attended, r_att, r_un), np.where(attended, r_un, r_att)


def random_state(rng, k_w):
    return dict(mu_d=np.array([-0.3994, -1.5103], np.float32),
                rho_d=np.array([1.7060, 0.64395], np.float32),
                z_kk=(0.5 * rng.randn(k_w + 1)).astype(np.float32),
                sig_kk=(0.1 + rng.rand(k_w + 1)).astype(np.float32),
                eta=(0.1 + 0.4 * rng.rand(k_w)).astype(np.float32),
                z_smooth=(0.5 * rng.randn(k_w)).astype(np.float32))


def priors():
    dec = jax_ad.StateSpaceAttentionDecoder(20, 1, 10, 100.0)
    return dict(mu_0=np.array(dec.mu_0, np.float32),
                alpha_0=np.array(dec.alpha_0, np.float32),
                beta_0=np.array(dec.beta_0, np.float32),
                a_0=np.float32(dec.a_0), b_0=np.float32(dec.b_0),
                lambda_state=np.float32(dec.lambda_state))


def port_state(state, k_w):
    return ops.state_views(ops.pack(
        [torch.as_tensor(state[f]) for f in ops.SsdState._fields]), k_w)


def port_constants(consts):
    return ops.constants_views(ops.pack(
        [torch.as_tensor(np.asarray(consts[f]))
         for f in ops.SsdConstants._fields]))


@pytest.mark.parametrize('k_w,iters', [(14, (20, 1, 10)), (5, (3, 2, 4)),
                                       (1, (2, 1, 3))])
def test_one_update_matches_jax(k_w, iters):
    rng = np.random.RandomState(k_w)
    state = random_state(rng, k_w)
    consts = priors()
    r1, r2 = lognormal_stream(rng, rng.rand(k_w) < 0.5)
    r1, r2 = r1.astype(np.float32), r2.astype(np.float32)
    want_state, want_z, want_eta = jax_ad._ssd_update(
        jax_ad.SsdState(**{k: jnp.asarray(v) for k, v in state.items()}),
        jnp.asarray(r1), jnp.asarray(r2),
        jax_ad.SsdConstants(**{k: jnp.asarray(v)
                               for k, v in consts.items()}),
        *iters, k_w)
    got_state, got_z, got_eta = ops.ssd_update_reference(
        port_state(state, k_w), torch.as_tensor(r1), torch.as_tensor(r2),
        port_constants(consts), *iters, k_w)
    np.testing.assert_allclose(got_z.numpy(), np.asarray(want_z), atol=TOL)
    np.testing.assert_allclose(got_eta.numpy(), np.asarray(want_eta),
                               atol=TOL)
    for field in ops.SsdState._fields:
        np.testing.assert_allclose(getattr(got_state, field).numpy(),
                                   np.asarray(getattr(want_state, field)),
                                   atol=TOL, err_msg=field)


def test_reference_batches_independent_updates():
    """Leading batch axes are independent updates: each row equals the
    update on its own."""
    k_w = 3
    rng = np.random.RandomState(3)
    consts = port_constants(priors())
    states = [random_state(rng, k_w) for _ in range(2)]
    rs = [lognormal_stream(rng, np.ones(k_w, bool)) for _ in range(2)]
    batch = ops.state_views(torch.stack(
        [ops.pack(list(port_state(s, k_w))) for s in states]), k_w)
    r1 = torch.as_tensor(np.stack([r[0] for r in rs]), dtype=torch.float32)
    r2 = torch.as_tensor(np.stack([r[1] for r in rs]), dtype=torch.float32)
    _, z, eta = ops.ssd_update_reference(batch, r1, r2, consts, 2, 1, 3,
                                         k_w)
    for i, state in enumerate(states):
        _, zi, etai = ops.ssd_update_reference(
            port_state(state, k_w), r1[i], r2[i], consts, 2, 1, 3, k_w)
        assert torch.equal(z[i], zi) and torch.equal(eta[i], etai)


@pytest.fixture(scope='module')
def switch_run():
    """60 calls through both decoders, tuned on the first 20, with the
    attended speaker switching at call 30."""
    rng = np.random.RandomState(1)
    attended = np.arange(60) < 30
    r1, r2 = lognormal_stream(rng, attended)
    want_dec = jax_ad.create_attention_decoder('ssd')
    got_dec = ad.create_attention_decoder('ssd', device='cpu')
    want_dec.tune(r1[:20], r2[:20])
    got_dec.tune(r1[:20], r2[:20])
    want = np.array([want_dec.attention(a, b) for a, b in zip(r1, r2)])
    got = np.array([got_dec.attention(a, b) for a, b in zip(r1, r2)])
    return attended, got, want, got_dec, want_dec


def test_stream_matches_jax(switch_run):
    attended, got, want, got_dec, want_dec = switch_run
    np.testing.assert_allclose(got, want, atol=TOL)
    clear = np.abs(want[:, 0] - 0.5) > TOL
    assert np.array_equal(got[clear, 0] >= 0.5, want[clear, 0] >= 0.5)
    np.testing.assert_allclose(got_dec.z_dyn, want_dec.z_dyn, atol=TOL)
    np.testing.assert_allclose(got_dec.eta_dyn, want_dec.eta_dyn, atol=TOL)


def test_stream_warms_up_and_orders_bounds(switch_run):
    _, got, _, got_dec, _ = switch_run
    k_w = got_dec.k_w
    assert np.array_equal(got[:k_w - 1], np.full((k_w - 1, 3), 0.5))
    p, lower, upper = got[k_w - 1:].T
    assert np.all(lower <= p) and np.all(p <= upper)
    assert np.all((0 <= lower) & (upper <= 1))
    assert len(got_dec.z_dyn) == k_w + len(got) - (k_w - 1)


def test_stream_tracks_the_switch(switch_run):
    """Decisions counted with their fixed lag of k_b calls track the
    planted switch with under 15% error (the JAX suite's bar,
    tests/test_attention_decoder.py:99-120)."""
    attended, got, _, got_dec, _ = switch_run
    calls = np.arange(got_dec.k_w, len(got))
    errors = (got[calls, 0] > 0.5) != attended[calls - got_dec.k_b]
    assert errors.mean() < 0.15


def test_tune_matches_jax():
    rng = np.random.RandomState(7)
    r1 = np.exp(-0.4 + 0.6 * rng.randn(5000))
    r2 = np.exp(-1.5 + 0.9 * rng.randn(5000))
    got = ad.StateSpaceAttentionDecoder(20, 1, 10, 100.0, offset=0.05,
                                        device='cpu')
    want = jax_ad.StateSpaceAttentionDecoder(20, 1, 10, 100.0, offset=0.05)
    got.tune(r1, r2)
    want.tune(r1, r2)
    for name in ('mu_d', 'rho_d', 'mu_0'):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name))
    np.testing.assert_array_equal(got._state.mu_d.numpy(),
                                  np.asarray(want._state.mu_d))
    np.testing.assert_array_equal(got._state.rho_d.numpy(),
                                  np.asarray(want._state.rho_d))
    np.testing.assert_array_equal(got._constants().mu_0.numpy(),
                                  np.asarray(want._constants().mu_0))


def test_factory_types_and_fs_corr():
    assert type(ad.create_attention_decoder('wta')) is ad.AttentionDecoder
    for name in ('stepped', 'step'):
        assert isinstance(ad.create_attention_decoder(name),
                          ad.StepAttentionDecoder)
    got = ad.create_attention_decoder('ssd', window_step=50, frame_rate=64.0,
                                      ssd_offset=0.1, device='cpu')
    want = jax_ad.create_attention_decoder('ssd', window_step=50,
                                           frame_rate=64.0, ssd_offset=0.1)
    assert isinstance(got, ad.StateSpaceAttentionDecoder)
    for name in ('fs_corr', 'outer_iter', 'inner_iter', 'newton_iter',
                 'k_w', 'k_b', 'k_f', '_offset', 'a_0', 'b_0'):
        assert getattr(got, name) == getattr(want, name), name
    assert got.fs_corr == 1600.0
    with pytest.raises(ValueError):
        ad.create_attention_decoder('bogus')


def test_ssd_without_a_card_refuses_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='No CUDA device'):
        ad.create_attention_decoder('ssd', device='cuda')


def test_wrapper_takes_the_plain_version_on_the_cpu():
    k_w = 2
    rng = np.random.RandomState(0)
    state = port_state(random_state(rng, k_w), k_w)
    consts = port_constants(priors())
    r = torch.tensor([0.4, 0.6])
    before = kernels.launches['ssd_update']
    got = ops.ssd_update(state, r, r * 0.5, consts, 2, 1, 2, k_w)
    want = ops.ssd_update_reference(state, r, r * 0.5, consts, 2, 1, 2, k_w)
    assert kernels.launches['ssd_update'] == before
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])


def test_packed_buffer_checks_the_layout():
    k_w = 3
    buf = torch.zeros(6 + 4 * k_w)
    state = ops.state_views(buf, k_w)
    assert ops.packed_buffer(state, ops._state_sizes(k_w)) is buf
    loose = ops.SsdState(*(f.clone() for f in state))
    with pytest.raises(ValueError, match='packed'):
        ops.packed_buffer(loose, ops._state_sizes(k_w))


def test_plot_aad_results(tmp_path):
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    n = 200
    t = np.arange(n) / 100.0
    decision = 0.5 + 0.4 * np.sin(t)
    plt.figure()
    ad.plot_aad_results(decision, attention_flag=(np.arange(n) > 100) * 1.0,
                        decision_upper=decision + 0.05,
                        decision_lower=decision - 0.05, t=t)
    out = tmp_path / 'aad.png'
    plt.savefig(str(out))
    plt.close('all')
    assert out.stat().st_size > 1000


def test_plot_aad_results_errors():
    with pytest.raises(TypeError, match='decision'):
        ad.plot_aad_results([0.5, 0.6])
    with pytest.raises(TypeError, match='attention_flag'):
        ad.plot_aad_results(np.zeros(5), attention_flag=[1, 2])
    with pytest.raises(TypeError, match='match length'):
        ad.plot_aad_results(np.zeros(5), t=np.zeros(4))
