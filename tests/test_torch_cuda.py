"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA card and skips without one. The file
imports neither JAX nor the JAX package and uses no conftest fixture,
so it also runs on a machine without JAX:

  python -m pytest --noconftest tests/test_torch_cuda.py

Tolerances: the lag stack is a copy, so bit-exact. The decode: float32
rtol 1e-4 / atol 1e-4 (sums in another order, the JAX suite's bound);
bf16 rtol 1e-3 / atol 1e-3, since both sides read the same bf16 data and
rotations and accumulate in float32 (the tensor cores' products of two
bf16 values are exact in float32; only the order of the sums differs). The audio envelope: atol 1e-4, the
JAX suite's bound for its kernel (float32 window sums in another order).
The deep CCA's decoder: rtol 1e-4 / atol 1e-4, K1's float32 bound,
against the plain decode on the CPU; the DNN's streamed fit, card
against CPU, 1e-3 on parameters and losses after some 20 Adam steps at
lr 0.05. The SSD update (S1): atol 1e-4 on z, eta and the new state, against the
plain version on the card from the same state (every operation rounded
alike; only the four window sums run in another order, and twenty EM
rounds of Newton steps amplify that). S1's sequence form against its
window form: bit for bit (the same device function on the same inputs).
The decoder's resident push plan against the decoder's path without it:
bit for bit (K1's launch on the same inputs and operands).
"""

import numpy as np
import pytest
import torch

from telluride_decoding_torch.ops import (decode_kernel, fused_frontend,
                                          lagstack, ssd_update)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    from telluride_decoding_torch.device import cuda_device
    return cuda_device()


@pytest.mark.cuda
@pytest.mark.parametrize('n,c,pre,post', [(12000, 69, 0, 36),
                                          (1237, 5, 3, 2), (7, 3, 5, 9)])
def test_lag_stack_bit_exact(cuda, n, c, pre, post):
    x = torch.randn((n, c), device=cuda)
    before = lagstack.lag_stack.launches
    got = lagstack.lag_stack(x, pre, post)
    torch.cuda.synchronize()
    assert lagstack.lag_stack.launches == before + 1
    assert torch.equal(got, lagstack.lag_stack_reference(x, pre, post))


def _folded(cuda, rng, f1, f2, d):
    def tensor(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=cuda)
    return decode_kernel.fold_decode_params({
        'mean1': tensor(rng.randn(1, f1)), 'mean2': tensor(rng.randn(1, f2)),
        'rot1': tensor(rng.randn(f1, d) * 0.02),
        'rot2': tensor(rng.randn(f2, d) * 0.2),
        'corr_mean_x': tensor(rng.randn(d) * 0.1),
        'corr_mean_y': tensor(rng.randn(d) * 0.1),
        'corr_power': tensor(1.0 + rng.rand(d)),
        'lda_w': tensor(rng.randn(d, 2)), 'lda_slope': tensor(1.3),
        'lda_intercept': tensor(-0.25)})


BF16_TOL = dict(rtol=1e-3, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize('w,t,dtype', [(32, 1, torch.float32),
                                       (7, 13, torch.float32),
                                       (512, 100, torch.bfloat16)])
def test_fused_cca_decode_matches_plain(cuda, w, t, dtype):
    rng = np.random.RandomState(0)
    d, f1, f2 = 10, 2553, 31
    folded = _folded(cuda, rng, f1, f2, d)
    x1 = torch.randn((w, t, f1), device=cuda).to(dtype)
    x2a = torch.randn((w, t, f2), device=cuda).to(dtype)
    x2b = torch.randn((w, t, f2), device=cuda).to(dtype)
    before = decode_kernel.fused_cca_decode.launches
    got = decode_kernel.fused_cca_decode(folded, x1, x2a, x2b)
    assert decode_kernel.fused_cca_decode.launches == before + 1
    want = torch.stack([
        decode_kernel.fused_cca_decode_reference(folded, x1, x2a),
        decode_kernel.fused_cca_decode_reference(folded, x1, x2b)])
    tol = (dict(rtol=1e-4, atol=1e-4) if dtype == torch.float32 else
           BF16_TOL)
    torch.testing.assert_close(got, want, **tol)
    with pytest.raises(ValueError):     # Mixed dtypes raise, never fall back.
        decode_kernel.fused_cca_decode(folded, x1, x2a.double())


F32_TOL = dict(rtol=1e-4, atol=1e-4)


def _f32_windows(cuda, seed, w, t, f1, f2=31):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    return tuple(torch.randn((w, t, f), generator=gen, device=cuda)
                 for f in (f1, f2, f2))


@pytest.mark.cuda
@pytest.mark.parametrize('f1', [31, 1408, 2553, 5000])
@pytest.mark.parametrize('d', [1, 5, 10, 16])
@pytest.mark.parametrize('w,t', [(1, 1), (11, 1), (28, 1), (32, 1), (33, 1),
                                 (4096, 1), (7, 13), (64, 100)])
def test_fused_cca_decode_f32_matches_plain(cuda, w, t, d, f1):
    """The float32 cluster kernel, single and pair form, against the
    plain version: served chunks (T = 1, up to 33 frames), many windows
    (4096, fewer blocks a cluster) and windows of many frames (rows
    walked 32 at a time); each call launches once."""
    rng = np.random.RandomState(100 * d + f1 % 97)
    folded = _folded(cuda, rng, f1, 31, d)
    x1, x2a, x2b = _f32_windows(cuda, w * t + f1, w, t, f1)
    before = decode_kernel.fused_cca_decode.launches
    single = decode_kernel.fused_cca_decode(folded, x1, x2a)
    assert decode_kernel.fused_cca_decode.launches == before + 1
    pair = decode_kernel.fused_cca_decode(folded, x1, x2a, x2b)
    assert decode_kernel.fused_cca_decode.launches == before + 2
    want_a = decode_kernel.fused_cca_decode_reference(folded, x1, x2a)
    want_b = decode_kernel.fused_cca_decode_reference(folded, x1, x2b)
    torch.testing.assert_close(single, want_a, **F32_TOL)
    torch.testing.assert_close(pair, torch.stack([want_a, want_b]),
                               **F32_TOL)


def _narrow_cases():
    """(f1, d) for F1 in {1, 5, 10, 16} and every D <= F1 of 1, 5, 10,
    16 (F2 = F1)."""
    return [(f1, d) for f1 in (1, 5, 10, 16) for d in (1, 5, 10, 16)
            if d <= f1]


@pytest.mark.cuda
@pytest.mark.parametrize('f1,d', _narrow_cases())
@pytest.mark.parametrize('w', [32, 11776])
def test_fused_cca_decode_f32_narrow_features(cuda, w, f1, d):
    """Narrow features, as a deep CCA's tower outputs give (F1 = F2 =
    D = 10 on the codelab path): at the served pair of 32 frames the plan
    takes a cluster of 16, whose blocks past F1 own no features (F1 = 10:
    slice 1, ranks 10-15 empty); at 11776 windows of one frame (a test
    split's frame scores) one block a tile. Single and pair form against
    the plain version, one launch each."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    cluster, _, slice_, _, _ = decode_kernel.f32_plan(w, 1, f1, f1, sms)
    if w == 32:
        assert cluster == 16 and slice_ * cluster >= f1
    rng = np.random.RandomState(10 * f1 + d)
    folded = _folded(cuda, rng, f1, f1, d)
    x1, x2a, x2b = _f32_windows(cuda, w + f1, w, 1, f1, f2=f1)
    before = decode_kernel.fused_cca_decode.launches
    single = decode_kernel.fused_cca_decode(folded, x1, x2a)
    pair = decode_kernel.fused_cca_decode(folded, x1, x2a, x2b)
    assert decode_kernel.fused_cca_decode.launches == before + 2
    want_a = decode_kernel.fused_cca_decode_reference(folded, x1, x2a)
    want_b = decode_kernel.fused_cca_decode_reference(folded, x1, x2b)
    torch.testing.assert_close(single, want_a, **F32_TOL)
    torch.testing.assert_close(pair, torch.stack([want_a, want_b]),
                               **F32_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize('w,t,f1,d', [(32, 1, 2553, 10), (32, 1, 1408, 5),
                                      (4096, 1, 2553, 10),
                                      (64, 100, 1408, 5)])
def test_fused_cca_decode_f32_is_bitwise_repeatable(cuda, w, t, f1, d):
    """No float atomics: the sums are taken in one fixed order, so two
    calls on the same inputs give the same bits."""
    folded = _folded(cuda, np.random.RandomState(5), f1, 31, d)
    x1, x2a, x2b = _f32_windows(cuda, 5, w, t, f1)
    first = decode_kernel.fused_cca_decode(folded, x1, x2a, x2b)
    second = decode_kernel.fused_cca_decode(folded, x1, x2a, x2b)
    assert torch.equal(first, second)


@pytest.mark.cuda
@pytest.mark.parametrize('w,t', [(32, 1), (40, 13)])
def test_fused_cca_decode_f32_contains_non_finite_frames(cuda, w, t):
    """A NaN in one frame of x1, at the first feature of a block's slice
    (which the previous row's aligned-down copy also reads), and an inf
    in x2 of another frame: only their windows change."""
    f1, d = 2553, 10
    folded = _folded(cuda, np.random.RandomState(6), f1, 31, d)
    x1, x2a, x2b = _f32_windows(cuda, 6, w, t, f1)
    _, _, slice_, _, _ = decode_kernel.f32_plan(
        w, t, f1, 31, decode_kernel._sm_count(cuda))
    x1[5, t - 1, slice_] = float('nan')
    x2b[20, 0, 30] = float('inf')
    got = decode_kernel.fused_cca_decode(folded, x1, x2a, x2b)
    want = torch.stack([
        decode_kernel.fused_cca_decode_reference(folded, x1, x2a),
        decode_kernel.fused_cca_decode_reference(folded, x1, x2b)])
    keep = torch.ones(w, dtype=torch.bool, device=cuda)
    keep[5] = False
    assert torch.isfinite(got[:, keep][0]).all()
    assert not torch.isfinite(got[:, 5]).any()
    assert not torch.isfinite(got[1, 20])
    keep[20] = False
    assert torch.isfinite(got[:, keep]).all()
    torch.testing.assert_close(got[:, keep], want[:, keep], **F32_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize('f1,f2', [(2553, 31), (2553, 5), (1408, 31),
                                   (1408, 5), (17, 31), (17, 5)])
@pytest.mark.parametrize('d', [1, 8, 10, 16])
@pytest.mark.parametrize('w,t', [(512, 100), (7, 13), (3, 100), (1, 1)])
def test_fused_cca_decode_bf16_matches_plain(cuda, w, t, d, f1, f2):
    """The tensor-core kernel, single and pair form, against the plain
    version on the same bf16 inputs."""
    rng = np.random.RandomState(1000 * d + f2)
    folded = _folded(cuda, rng, f1, f2, d)
    gen = torch.Generator(device=cuda).manual_seed(w * t + f1)

    def window(f):
        return torch.randn((w, t, f), generator=gen, device=cuda).to(
            torch.bfloat16)
    x1, x2a, x2b = window(f1), window(f2), window(f2)
    before = decode_kernel.fused_cca_decode.launches
    single = decode_kernel.fused_cca_decode(folded, x1, x2a)
    pair = decode_kernel.fused_cca_decode(folded, x1, x2a, x2b)
    assert decode_kernel.fused_cca_decode.launches == before + 2
    want_a = decode_kernel.fused_cca_decode_reference(folded, x1, x2a)
    want_b = decode_kernel.fused_cca_decode_reference(folded, x1, x2b)
    torch.testing.assert_close(single, want_a, **BF16_TOL)
    torch.testing.assert_close(pair, torch.stack([want_a, want_b]),
                               **BF16_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize('f1,f2', [(5000, 31), (2553, 500)])
def test_fused_cca_decode_bf16_chunked_rows(cuda, f1, f2):
    """Rows wider than a chunk of the feature axis (5000 features; 2553
    when 500 x2 features narrow the chunk) are multiplied chunk by
    chunk, the B fragments reloaded for each."""
    rng = np.random.RandomState(3)
    folded = _folded(cuda, rng, f1, f2, 10)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    chunk, _, _ = decode_kernel.mma_plan(f1, f2, 300, sms)
    assert chunk < f1
    gen = torch.Generator(device=cuda).manual_seed(3)
    x1, x2a, x2b = (torch.randn((300, 13, f), generator=gen,
                                device=cuda).to(torch.bfloat16)
                    for f in (f1, f2, f2))
    got = decode_kernel.fused_cca_decode(folded, x1, x2a, x2b)
    want = torch.stack([
        decode_kernel.fused_cca_decode_reference(folded, x1, x2a),
        decode_kernel.fused_cca_decode_reference(folded, x1, x2b)])
    torch.testing.assert_close(got, want, **BF16_TOL)


@pytest.mark.cuda
def test_fused_cca_decode_bf16_contains_non_finite_frames(cuda):
    """An inf in the first feature of a window's first frame, which the
    previous window's last frame reads past its end in its last k-step,
    and a nan in the last feature of another frame: only their windows
    change. 300 windows of 13 frames put 3 windows in a block, so rows
    of different windows share a 16-row group."""
    rng = np.random.RandomState(2)
    f1, f2 = 2553, 31
    folded = _folded(cuda, rng, f1, f2, 10)
    gen = torch.Generator(device=cuda).manual_seed(2)
    x1 = torch.randn((300, 13, f1), generator=gen, device=cuda).to(
        torch.bfloat16)
    x2a, x2b = (torch.randn((300, 13, f2), generator=gen, device=cuda).to(
        torch.bfloat16) for _ in range(2))
    x1[100, 0, 0] = float('inf')
    x1[200, 5, f1 - 1] = float('nan')
    got = decode_kernel.fused_cca_decode(folded, x1, x2a, x2b)
    want = torch.stack([
        decode_kernel.fused_cca_decode_reference(folded, x1, x2a),
        decode_kernel.fused_cca_decode_reference(folded, x1, x2b)])
    keep = torch.ones(300, dtype=torch.bool, device=cuda)
    keep[[100, 200]] = False
    assert torch.isfinite(got[:, keep]).all()
    assert not torch.isfinite(got[:, ~keep]).any()
    torch.testing.assert_close(got[:, keep], want[:, keep], **BF16_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize('n,fs_in,fs_out,args', [
    (30 * 44100, 44100.0, 32.0, dict(window=1.0, exponent=1.0)),
    (10 * 16000, 16000.0, 100.0, dict(window=2.0, exponent=0.30103,
                                      pre=3, post=3)),
    (1 << 16, 16000.0, 100.0, dict(window=2.0, pre=2, post=1,
                                   valid_len=30000, valid_out=188)),
], ids=['ingest_30s', 'gate', 'valid_len'])
def test_fused_envelope_lagstack_matches_plain(cuda, n, fs_in, fs_out, args):
    audio = torch.randn((n,), device=cuda)
    before = fused_frontend.fused_envelope_lagstack.launches
    got = fused_frontend.fused_envelope_lagstack(audio, fs_in, fs_out, **args)
    torch.cuda.synchronize()
    assert fused_frontend.fused_envelope_lagstack.launches == before + 1
    want = fused_frontend.fused_envelope_lagstack_reference(
        audio, fs_in, fs_out, **args)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
    with pytest.raises(ValueError):     # Wrong dtype raises, never falls back.
        fused_frontend.fused_envelope_lagstack(audio.double(), fs_in, fs_out)


@pytest.mark.cuda
def test_compute_intensity_routes_to_kernel_and_keeps_stream_state(cuda):
    """AudioFeatures on the card: a first whole-track call runs K3 and
    leaves the same streaming tail as the CPU's cumsum path, so a
    second (streaming) call, which takes the cumsum path on both
    devices, agrees too."""
    from telluride_decoding_torch.signal.preprocess import AudioFeatures
    rng = np.random.RandomState(6)
    first = rng.randn(3 * 44100, 1).astype(np.float32)
    second = rng.randn(44100, 1).astype(np.float32)
    card = AudioFeatures('a', 44100, 32, device=cuda)
    cpu = AudioFeatures('a', 44100, 32, device='cpu')
    before = fused_frontend.fused_envelope_lagstack.launches
    np.testing.assert_allclose(card.compute_intensity(first),
                               cpu.compute_intensity(first), atol=1e-4)
    assert fused_frontend.fused_envelope_lagstack.launches == before + 1
    np.testing.assert_array_equal(card._buff, cpu._buff)
    np.testing.assert_allclose(card.compute_intensity(second),
                               cpu.compute_intensity(second), atol=1e-6)
    assert fused_frontend.fused_envelope_lagstack.launches == before + 1


@pytest.mark.cuda
def test_fused_cca_decode_f32_frame_scores_shape(cuda):
    """The decoding driver's evaluation call: a whole test split of
    11776 frames (12000 cut to whole 512-frame batches) scored as
    windows of one frame, single form, 2553 + 31 columns, D 10."""
    rng = np.random.RandomState(11776)
    folded = _folded(cuda, rng, 2553, 31, 10)
    x1, x2, _ = _f32_windows(cuda, 11776, 11776, 1, 2553)
    before = decode_kernel.fused_cca_decode.launches
    got = decode_kernel.fused_cca_decode(folded, x1, x2)
    assert decode_kernel.fused_cca_decode.launches == before + 1
    torch.testing.assert_close(
        got, decode_kernel.fused_cca_decode_reference(folded, x1, x2),
        **F32_TOL)


@pytest.mark.cuda
def test_frame_scores_on_card_match_cpu(cuda):
    """Decoder.frame_scores of one CCA + LDA decoder on the card (one
    K1 launch over the split) and on the CPU (the plain decode), at a
    small width, on a BrainDataset and on its batches."""
    from telluride_decoding_torch.data.brain_data import BrainDataset
    from telluride_decoding_torch.decode.infer_decoder import CCADecoder
    from telluride_decoding_torch.models import convert
    rng = np.random.RandomState(5)
    f1, f2, d, n = 40, 5, 3, 1000
    flat = {'mean1': rng.randn(1, f1), 'mean2': rng.randn(1, f2),
            'rot1': rng.randn(f1, d) * 0.1, 'rot2': rng.randn(f2, d) * 0.3}
    x1 = rng.randn(n, f1).astype(np.float32)
    x2 = (x1[:, :f2] + rng.randn(n, f2)).astype(np.float32)
    out = np.zeros((n, 1), np.float32)

    def batches(x2_part):
        return [({'input_1': x1[i:i + 100], 'input_2': x2_part[i:i + 100]},
                 out[i:i + 100]) for i in range(0, n, 100)]
    cpu = CCADecoder(convert.cca_params_from_numpy(flat, 'cpu'),
                     reduction='lda', device='cpu')
    cpu.train(batches(x2[::-1].copy()), batches(x2), window_size=10)
    card = CCADecoder(convert.cca_params_from_numpy(flat, cuda),
                      reduction='lda', device=cuda)
    card.model_params = cpu.model_params
    dataset = BrainDataset(x1, x2, out, out, batch_size=64, mode='test',
                           shuffle=False)
    want = cpu.frame_scores(dataset)
    before = decode_kernel.fused_cca_decode.launches
    got = card.frame_scores(dataset)
    assert decode_kernel.fused_cca_decode.launches == before + 1
    assert got[0].shape == (960,)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(got[1], want[1])
    got_batches = card.frame_scores(list(dataset))
    np.testing.assert_allclose(got_batches[0], want[0], rtol=1e-4,
                               atol=1e-4)


@pytest.mark.cuda
def test_dcca_decoder_on_card_matches_cpu(cuda):
    """A deep CCA's decoder on the card: one K1 launch a pair, on the
    towers' outputs (F1 = F2 = D = 10), against the CPU's plain decode of
    the same model, statistics and LDA."""
    from telluride_decoding_torch.decode.infer_decoder import CCADecoder
    from telluride_decoding_torch.models.cca import BrainModelDCCA
    rng = np.random.RandomState(6)
    n, f1, f2 = 800, 60, 7
    x1 = rng.randn(n, f1).astype(np.float32)
    x2 = (x1[:, :f2] + rng.randn(n, f2)).astype(np.float32)
    x2b = rng.randn(n, f2).astype(np.float32)
    cpu_model, card_model = (
        BrainModelDCCA(cca_dims=10, hidden_units=[20, 20], input1_width=f1,
                       input2_width=f2, device=where)
        for where in ('cpu', cuda))
    cpu_model.fit([({'input_1': x1, 'input_2': x2}, x2)], epochs=2,
                  batch_size=200)
    card_model.set_params(cpu_model.params)
    cpu = CCADecoder(cpu_model, reduction='lda', device='cpu')
    cpu.train([({'input_1': x1, 'input_2': x2b}, x2b)],
              [({'input_1': x1, 'input_2': x2}, x2)], window_size=10)
    card = CCADecoder(card_model, reduction='lda', device=cuda)
    card.model_params = cpu.model_params
    want = cpu.infer_pair(x1[:32], x2[:32], x2b[:32], x2[:32], x2b[:32])
    before = decode_kernel.fused_cca_decode.launches
    got = card.infer_pair(x1[:32], x2[:32], x2b[:32], x2[:32], x2b[:32])
    assert decode_kernel.fused_cca_decode.launches == before + 1
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_streamed_dnn_fit_on_card_matches_cpu(cuda, tmp_path):
    """The DNN's streamed fit from one initialisation on the card and on
    the CPU: the same batch stream, parameters within 1e-3 after some 20
    Adam steps at lr 0.05 (float32 sums in another order, TF32 off)."""
    from telluride_decoding_torch.data import records
    from telluride_decoding_torch.data.brain_data import TFExampleData
    from telluride_decoding_torch.models.brain_model import BrainModelDNN
    rng = np.random.RandomState(7)
    for i in range(3):
        eeg = rng.randn(900, 6).astype(np.float32)
        records.convert_data_to_tfrecords(
            {'eeg': eeg, 'intensity': eeg[:, :1] + 0.1 * rng.randn(
                900, 1).astype(np.float32)},
            str(tmp_path / ('trial%d.tfrecords' % i)))
    fits = []
    init = None
    for where in ('cpu', cuda):
        data = TFExampleData('eeg', 'intensity', 100, post_context=4,
                             data_dir=str(tmp_path),
                             train_file_pattern='trial', device=where)
        model = BrainModelDNN(data.spec_dataset(), [20, 20], device=where)
        model.compile(learning_rate=0.05)
        if init is None:
            init = model._init_params(torch.Generator().manual_seed(0))
        model.set_params(init)
        fits.append((model.fit_streaming(data, 'train',
                                         batch_size=128)['loss'],
                     {k: v.cpu() for k, v in model.params.items()}))
    np.testing.assert_allclose(fits[1][0], fits[0][0], rtol=0, atol=1e-3)
    for key, value in fits[0][1].items():
        torch.testing.assert_close(fits[1][1][key], value, rtol=0,
                                   atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize('grid', ['ridge_cholesky', 'ridge_eig', 'cca'])
def test_sweep_grid_on_card_matches_cpu(cuda, grid):
    """The jackknife grid from raw streams with the lag context on the
    card (one K2 launch per file per lagged input) against the same
    sweep on the CPU (plain lag stack): correlations within 1e-4."""
    from telluride_decoding_torch.sweep import engine
    rng = np.random.RandomState(7)
    ctx = engine.ContextSpec(0, 8, 2, 2) if grid == 'cca' else \
        engine.ContextSpec(0, 8, 0, 0)
    xs, ys = [], []
    for n in (900, 1100, 1000, 950, 1200, 1050, 980, 1010):
        x = rng.randn(n + ctx.x_post, 69).astype(np.float32)
        y = np.zeros((n + ctx.y_post, 1), np.float32)
        y[:n] = x[:n, :1] + 0.5 * rng.randn(n, 1)
        xs.append(x)
        ys.append(y)
    lambdas = (list(np.logspace(-6, 2, 25)) if grid == 'ridge_eig'
               else list(np.logspace(-6, 2, 9)))
    sweep = (engine.cca_jackknife_sweep if grid == 'cca'
             else engine.ridge_jackknife_sweep)
    before = lagstack.lag_stack.launches
    got = sweep(xs, ys, lambdas, context=ctx, device=cuda)
    launches = lagstack.lag_stack.launches - before
    assert launches == len(xs) * (2 if grid == 'cca' else 1)
    want = sweep(xs, ys, lambdas, context=ctx, device='cpu')
    assert np.isfinite(got.correlations).all()
    np.testing.assert_allclose(got.correlations, want.correlations,
                               rtol=0, atol=1e-4)


@pytest.mark.cuda
def test_streaming_moments_stack_each_file_on_card(cuda):
    """The sweep's bounded-memory regime (batch_bytes 0) uploads each
    file's raw channels and lag-stacks them on the card (one K2 launch
    per file per lagged input); its moments match the same regime on the
    CPU within 1e-4 relative."""
    from telluride_decoding_torch.sweep import engine
    rng = np.random.RandomState(8)
    ctx = engine.ContextSpec(0, 8, 2, 2)
    xs, ys = [], []
    for n in (700, 1300, 900):
        xs.append(rng.randn(n + ctx.x_post, 16).astype(np.float32))
        ys.append(rng.randn(n + ctx.y_post, 1).astype(np.float32))
    before = lagstack.lag_stack.launches
    got = engine.per_file_stats(xs, ys, True, batch_bytes=0, context=ctx,
                                frame_bucket=256, device=cuda)
    assert lagstack.lag_stack.launches - before == 2 * len(xs)
    want = engine.per_file_stats(xs, ys, True, batch_bytes=0, context=ctx,
                                 frame_bucket=256, device='cpu')
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.cpu().numpy(), w.numpy(), rtol=1e-4,
                                   atol=1e-3)


@pytest.mark.cuda
def test_cohort_on_card_matches_cpu(cuda, tmp_path):
    """cli.cohort's sweep over a tiny ragged cohort on the card (K2 once
    a trial) against the same sweep on the CPU: grids and summary within
    1e-4; streaming and eager loading bit-identical on the card."""
    from telluride_decoding_torch.cli import cohort, decoding
    from telluride_decoding_torch.data import records
    rng = np.random.RandomState(11)
    w = rng.randn(69 * 9, 1).astype(np.float32) / np.sqrt(69 * 9)
    for s in range(3):
        d = tmp_path / ('subject%02d' % s)
        d.mkdir()
        for t in range(4):
            n = 900 + 37 * t + 11 * s
            eeg = rng.randn(n, 69).astype(np.float32)
            intensity = (lagstack.lag_stack_np(eeg, 0, 8) @ w +
                         0.3 * rng.randn(n, 1)).astype(np.float32)
            records.convert_data_to_tfrecords(
                {'eeg': eeg, 'intensity': intensity},
                str(d / ('trial%02d.tfrecords' % t)))
    my_flags = decoding.DecodingOptions(
        input_field='eeg', output_field='intensity', post_context=8,
        dnn_regressor='linear', attended_field='')
    subjects = cohort.discover_subjects(str(tmp_path), [])
    lambdas = list(np.logspace(-6, 2, 9))
    before = lagstack.lag_stack.launches
    got, (mean, std) = cohort.run_cohort_sweep(my_flags, subjects, lambdas,
                                               device=cuda)
    assert lagstack.lag_stack.launches - before == 12
    eager, _ = cohort.run_cohort_sweep(my_flags, subjects, lambdas,
                                       streaming=False, device=cuda)
    want, (want_mean, want_std) = cohort.run_cohort_sweep(
        my_flags, subjects, lambdas, device='cpu')
    for name in want:
        assert np.isfinite(got[name].correlations).all()
        np.testing.assert_array_equal(got[name].correlations,
                                      eager[name].correlations)
        np.testing.assert_allclose(got[name].correlations,
                                   want[name].correlations, rtol=0,
                                   atol=1e-4)
    np.testing.assert_allclose(mean, want_mean, rtol=0, atol=1e-4)
    np.testing.assert_allclose(std, want_std, rtol=0, atol=1e-4)


SSD_TOL = dict(rtol=0, atol=1e-4, equal_nan=True)


def _ssd_stream(cuda, k_w, windows, seed=0, zero_at=None):
    """S1 over ``windows`` updates of a seeded log-normal stream, in
    place; returns (S1's input state buffers, r1, r2, S1's z and eta, the
    final buffer), each stacked over the windows."""
    rng = np.random.RandomState(seed)
    mean_p, var_p = 0.2, 5
    a_0 = 2 + mean_p ** 2 / var_p
    consts = ssd_update.constants_views(torch.tensor(
        [-0.3994, -1.5103, 641.13, 4043.4, 375.81, 6279.1, a_0,
         mean_p * (a_0 - 1), 1.0], device=cuda))
    buf = torch.cat([torch.tensor([-0.3994, -1.5103, 1.7060, 0.64395]),
                     torch.zeros(2 * (k_w + 1)), torch.full((k_w,), 0.3),
                     torch.zeros(k_w)]).to(cuda)
    state = ssd_update.state_views(buf, k_w)
    att = (np.arange(windows + k_w) // 20) % 2 == 0
    r_att = np.exp(-0.4 + 0.6 * rng.randn(att.size))
    r_un = np.exp(-1.5 + 0.9 * rng.randn(att.size))
    r1_all = np.where(att, r_att, r_un).astype(np.float32)
    r2_all = np.where(att, r_un, r_att).astype(np.float32)
    if zero_at is not None:
        r1_all[zero_at] = 0.0
    inputs, r1s, r2s, outs = [], [], [], []
    for i in range(windows):
        r1 = torch.as_tensor(r1_all[i:i + k_w], device=cuda)
        r2 = torch.as_tensor(r2_all[i:i + k_w], device=cuda)
        inputs.append(buf.clone())
        _, z, eta = ssd_update.ssd_update(state, r1, r2, consts, 20, 1, 10,
                                          k_w)
        r1s.append(r1)
        r2s.append(r2)
        outs.append(torch.stack([z, eta]))
    return (torch.stack(inputs), torch.stack(r1s), torch.stack(r2s),
            torch.stack(outs), buf, consts)


@pytest.mark.cuda
@pytest.mark.parametrize('k_w,windows', [(1, 12), (14, 40), (32, 20)])
def test_ssd_update_matches_plain(cuda, k_w, windows):
    before = ssd_update.ssd_update.launches
    inputs, r1, r2, got, final, consts = _ssd_stream(cuda, k_w, windows)
    torch.cuda.synchronize()
    assert ssd_update.ssd_update.launches == before + windows
    new_state, z, eta = ssd_update.ssd_update_reference(
        ssd_update.state_views(inputs, k_w), r1, r2, consts, 20, 1, 10, k_w)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, torch.stack([z, eta], 1), **SSD_TOL)
    torch.testing.assert_close(final, ssd_update.pack(
        [f[-1] for f in new_state]), **SSD_TOL)


@pytest.mark.cuda
def test_ssd_update_is_bitwise_repeatable(cuda):
    first = _ssd_stream(cuda, 14, 25)
    second = _ssd_stream(cuda, 14, 25)
    assert torch.equal(first[3], second[3])
    assert torch.equal(first[4], second[4])


@pytest.mark.cuda
def test_ssd_update_log_of_zero_as_plain(cuda):
    """An r of 0 (log 0) gives what the plain version gives (NaN where
    it gives NaN)."""
    k_w = 14
    inputs, r1, r2, got, _, consts = _ssd_stream(cuda, k_w, 3,
                                                 zero_at=k_w + 1)
    _, z, eta = ssd_update.ssd_update_reference(
        ssd_update.state_views(inputs, k_w), r1, r2, consts, 20, 1, 10, k_w)
    want = torch.stack([z, eta], 1)
    assert torch.isnan(want).any()
    torch.testing.assert_close(got, want, **SSD_TOL)


@pytest.mark.cuda
def test_ssd_update_refuses_a_long_window(cuda):
    k_w = 33
    state = ssd_update.state_views(torch.zeros(6 + 4 * k_w, device=cuda),
                                   k_w)
    consts = ssd_update.constants_views(torch.ones(9, device=cuda))
    r = torch.ones(k_w, device=cuda)
    with pytest.raises(ValueError, match='k_w <= 32'):
        ssd_update.ssd_update(state, r, r, consts, 20, 1, 10, k_w)


@pytest.mark.cuda
def test_ssd_decoder_on_card_matches_cpu(cuda):
    """The decider end to end: one S1 launch a window after the warm-up,
    p, lower and upper within the tolerance of the CPU's plain run."""
    from telluride_decoding_torch.decide import attention_decoder
    rng = np.random.RandomState(5)
    att = np.arange(50) < 25
    r_att = np.exp(-0.4 + 0.6 * rng.randn(50))
    r_un = np.exp(-1.5 + 0.9 * rng.randn(50))
    r1, r2 = np.where(att, r_att, r_un), np.where(att, r_un, r_att)
    card = attention_decoder.create_attention_decoder('ssd', device=cuda)
    cpu = attention_decoder.create_attention_decoder('ssd', device='cpu')
    for dec in (card, cpu):
        dec.tune(r1[:20], r2[:20])
    before = ssd_update.ssd_update.launches
    got = np.array([card.attention(a, b) for a, b in zip(r1, r2)])
    assert ssd_update.ssd_update.launches - before == 50 - card.k_w + 1
    want = np.array([cpu.attention(a, b) for a, b in zip(r1, r2)])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def _ssd_series(cuda, k_w, length, seed):
    """A seeded stream for S1's sequence form: (the packed initial state,
    the packed constants, r1, r2), the series on the card."""
    rng = np.random.RandomState(seed)
    a_0 = 2 + 0.2 ** 2 / 5
    consts = torch.tensor([-0.3994 + 0.1 * rng.randn(), -1.5103, 641.13,
                           4043.4, 375.81, 6279.1, a_0, 0.2 * (a_0 - 1),
                           1.0], device=cuda)
    state = torch.cat([
        torch.tensor([-0.3994, -1.5103, 1.7060, 0.64395]),
        torch.tensor(0.5 * rng.randn(2 * (k_w + 1)), dtype=torch.float32),
        torch.full((k_w,), 0.3), torch.zeros(k_w)]).to(cuda)
    state[4 + k_w + 1:4 + 2 * (k_w + 1)].abs_().add_(0.1)   # sig_kk > 0
    att = (np.arange(length) // 20) % 2 == 0
    r_att = np.exp(-0.4 + 0.6 * rng.randn(length))
    r_un = np.exp(-1.5 + 0.9 * rng.randn(length))
    r1 = torch.as_tensor(np.where(att, r_att, r_un), dtype=torch.float32,
                         device=cuda)
    r2 = torch.as_tensor(np.where(att, r_un, r_att), dtype=torch.float32,
                         device=cuda)
    return state, consts, r1, r2


def _window_launches(state, consts, r1, r2, k_w, trips, at=-1):
    """The series through successive window-form launches; returns the
    (z, eta) at ``at`` of each window and leaves ``state`` updated."""
    views = ssd_update.state_views(state, k_w)
    const_views = ssd_update.constants_views(consts)
    got = []
    for j in range(r1.numel() - k_w + 1):
        _, z, eta = ssd_update.ssd_update(
            views, r1[j:j + k_w].contiguous(), r2[j:j + k_w].contiguous(),
            const_views, *trips, k_w)
        got.append(torch.stack([z[at], eta[at]]))
    return torch.stack(got)


@pytest.mark.cuda
@pytest.mark.parametrize('k_w,trips,windows', [
    (14, (20, 1, 10), 30), (1, (20, 1, 10), 12), (32, (20, 1, 10), 10),
    (5, (3, 2, 4), 9)])
def test_ssd_sequence_equals_window_launches(cuda, k_w, trips, windows):
    """The sequence form gives bit for bit the window form's z, eta and
    final state (k_w 14 at 20 / 1 / 10: the factory's shape; k_w 1 and 32
    the extremes a warp takes)."""
    state, consts, r1, r2 = _ssd_series(cuda, k_w, windows + k_w - 1, 1)
    by_window = state.clone()
    want = _window_launches(by_window, consts, r1, r2, k_w, trips)
    before = ssd_update.ssd_sequence.launches
    states, got = ssd_update.ssd_sequence(
        state[None].clone(), consts[None].clone(), r1, r2,
        [0, r1.numel()], *trips, k_w)
    torch.cuda.synchronize()
    assert ssd_update.ssd_sequence.launches == before + 1
    assert torch.isfinite(got).all()
    assert torch.equal(got, want)
    assert torch.equal(states[0], by_window)


@pytest.mark.cuda
def test_ssd_sequence_streams_of_unequal_length(cuda):
    """Streams of unequal length and constants in one launch each equal
    their own launch, bit for bit."""
    k_w, trips = 14, (20, 1, 10)
    streams = [_ssd_series(cuda, k_w, k_w - 1 + n, seed)
               for seed, n in enumerate((17, 1, 40, 5))]
    offsets = np.cumsum([0] + [s[2].numel() for s in streams])
    states, got = ssd_update.ssd_sequence(
        torch.stack([s[0] for s in streams]),
        torch.stack([s[1] for s in streams]),
        torch.cat([s[2] for s in streams]),
        torch.cat([s[3] for s in streams]), offsets, *trips, k_w)
    at = 0
    for b, (state, consts, r1, r2) in enumerate(streams):
        alone_states, alone = ssd_update.ssd_sequence(
            state[None].clone(), consts[None], r1, r2, [0, r1.numel()],
            *trips, k_w)
        n = alone.shape[0]
        assert torch.equal(got[at:at + n], alone)
        assert torch.equal(states[b], alone_states[0])
        at += n
    assert at == got.shape[0]


@pytest.mark.cuda
def test_ssd_sequence_matches_plain(cuda):
    """The sequence form against ssd_sequence_reference on the card from
    the same states: two streams of unequal length."""
    k_w, trips = 14, (20, 1, 10)
    streams = [_ssd_series(cuda, k_w, k_w - 1 + n, 7 + n) for n in (3, 2)]
    args = (torch.cat([s[2] for s in streams]),
            torch.cat([s[3] for s in streams]),
            [0, k_w + 2, 2 * k_w + 3])
    states = torch.stack([s[0] for s in streams])
    consts = torch.stack([s[1] for s in streams])
    want_states, want = ssd_update.ssd_sequence_reference(
        states, consts, *args, *trips, k_w)
    got_states, got = ssd_update.ssd_sequence(states.clone(), consts, *args,
                                              *trips, k_w)
    torch.testing.assert_close(got, want, **SSD_TOL)
    torch.testing.assert_close(got_states, want_states, **SSD_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize('k_w', [14, 3])
def test_ssd_update_zero_copy_matches_device_buffers(cuda, k_w):
    """The window form reading r1 and r2 from pinned host memory and
    writing the decision and the rows there gives the bits that buffers
    on the card give, within SSD_TOL of the plain version."""
    state, consts, r1, r2 = _ssd_series(cuda, k_w, k_w, 3)
    const_views = ssd_update.constants_views(consts)
    before = state.clone()
    _, z, eta = ssd_update.ssd_update(ssd_update.state_views(state, k_w), r1,
                                      r2, const_views, 20, 1, 10, k_w)
    pinned = torch.empty((2, k_w), pin_memory=True)
    pinned.copy_(torch.stack([r1, r2]))
    rows = torch.empty((2, k_w), pin_memory=True)
    decision = torch.empty((2,), pin_memory=True)
    zero_copy = before.clone()
    ssd_update.ssd_update(ssd_update.state_views(zero_copy, k_w), pinned[0],
                          pinned[1], const_views, 20, 1, 10, k_w, out=rows,
                          decision=decision, at=-2)
    torch.cuda.synchronize()
    assert torch.equal(rows, torch.stack([z, eta]).cpu())
    assert torch.equal(decision, torch.stack([z[-2], eta[-2]]).cpu())
    assert torch.equal(zero_copy, state)
    _, want_z, want_eta = ssd_update.ssd_update_reference(
        ssd_update.state_views(before, k_w), r1, r2, const_views, 20, 1, 10,
        k_w)
    torch.testing.assert_close(rows, torch.stack([want_z, want_eta]).cpu(),
                               **SSD_TOL)


@pytest.mark.cuda
def test_ssd_update_refuses_pageable_host_memory(cuda):
    k_w = 4
    state, consts, r1, r2 = _ssd_series(cuda, k_w, k_w, 0)
    with pytest.raises(ValueError, match='pinned'):
        ssd_update.ssd_update(ssd_update.state_views(state, k_w), r1.cpu(),
                              r2, ssd_update.constants_views(consts), 20, 1,
                              10, k_w)


@pytest.mark.cuda
def test_attention_sequences_on_card_match_successive_calls(cuda):
    """Three decoders' streams in one sequence launch give what their
    successive attention calls give on the card, bit for bit, and leave
    the decoders alike; a following attention call carries on."""
    from telluride_decoding_torch.decide import attention_decoder
    rng = np.random.RandomState(9)
    lengths = (40, 10, 25)
    r1s = [np.exp(-0.4 + 0.6 * rng.randn(n)) for n in lengths]
    r2s = [np.exp(-1.5 + 0.9 * rng.randn(n)) for n in lengths]

    def decoders():
        decs = [attention_decoder.create_attention_decoder('ssd', device=cuda)
                for _ in lengths]
        for dec, r1, r2 in zip(decs, r1s, r2s):
            dec.tune(r1[:8], r2[:8])
        return decs
    by_call, by_sequence = decoders(), decoders()
    want = [[dec.attention(a, b) for a, b in zip(r1, r2)]
            for dec, r1, r2 in zip(by_call, r1s, r2s)]
    windows = ssd_update.ssd_update.launches
    sequences = ssd_update.ssd_sequence.launches
    got = attention_decoder.StateSpaceAttentionDecoder.attention_sequences(
        by_sequence, r1s, r2s)
    assert ssd_update.ssd_update.launches == windows
    assert ssd_update.ssd_sequence.launches == sequences + 1
    assert got == want
    for a, b in zip(by_call, by_sequence):
        assert (a.calls, a.z_dyn, a.eta_dyn) == (b.calls, b.z_dyn, b.eta_dyn)
        assert np.array_equal(a._r1_buf, b._r1_buf)
        assert np.array_equal(a._r2_buf, b._r2_buf)
        assert torch.equal(ssd_update.pack(list(a._state)),
                           ssd_update.pack(list(b._state)))
        assert a.attention(0.3, 0.2) == b.attention(0.3, 0.2)


@pytest.mark.cuda
def test_infer_pair_async_on_card_matches_infer_pair(cuda):
    """infer_pair_async: one K1 launch, the scores copied back without
    blocking; np.asarray of each handle (and harvest) waits and gives
    infer_pair's scores bit for bit."""
    from telluride_decoding_torch.decode.infer_decoder import CCADecoder
    from telluride_decoding_torch.models import convert
    rng = np.random.RandomState(6)
    f1, f2, d, n = 40, 5, 3, 600
    flat = {'mean1': rng.randn(1, f1), 'mean2': rng.randn(1, f2),
            'rot1': rng.randn(f1, d) * 0.1, 'rot2': rng.randn(f2, d) * 0.3}
    x1 = rng.randn(n, f1).astype(np.float32)
    x2 = (x1[:, :f2] + rng.randn(n, f2)).astype(np.float32)
    out = np.zeros((n, 1), np.float32)
    batches = [({'input_1': x1[i:i + 100], 'input_2': x2[i:i + 100]},
                out[i:i + 100]) for i in range(0, n, 100)]
    cpu = CCADecoder(convert.cca_params_from_numpy(flat, 'cpu'),
                     reduction='lda', device='cpu')
    cpu.train(batches[::-1], batches, window_size=10)
    card = CCADecoder(convert.cca_params_from_numpy(flat, cuda),
                      reduction='lda', device=cuda)
    card.model_params = cpu.model_params
    args = (x1[:32], x2[:32], x2[32:64], out[:32], out[:32])
    before = decode_kernel.fused_cca_decode.launches
    pending = card.infer_pair_async(*args)
    assert decode_kernel.fused_cca_decode.launches == before + 1
    want = card.infer_pair(*args)
    got_a, got_b = (np.asarray(p) for p in pending)
    np.testing.assert_array_equal(got_a, want[0])
    np.testing.assert_array_equal(got_b, want[1])
    for g, w in zip(pending.harvest(), want):
        np.testing.assert_array_equal(g, w)


def _operands(folded):
    return decode_kernel.kernel_operands(folded), folded.rot1.shape[1]


@pytest.mark.cuda
@pytest.mark.parametrize('f1,f2,d', [(2553, 31, 10), (10, 10, 10)])
@pytest.mark.parametrize('pair', [False, True])
def test_fused_cca_decode_op_matches_plain(cuda, f1, f2, d, pair):
    """The op tdt::fused_cca_decode_f32 on the card (the served pair of
    32 frames at codelab width and at a deep CCA's F = 10): one K1 launch
    a call, the plain version's scores, and the very bits of
    fused_cca_decode on the same parameters."""
    rng = np.random.RandomState(f1 + d)
    folded = _folded(cuda, rng, f1, f2, d)
    x1, x2a, x2b = _f32_windows(cuda, f1, 32, 1, f1, f2)
    (rot1, rot2, consts), dims = _operands(folded)
    before = decode_kernel.fused_cca_decode.launches
    got = torch.ops.tdt.fused_cca_decode_f32(x1, x2a, x2b if pair else None,
                                             rot1, rot2, consts, dims)
    assert decode_kernel.fused_cca_decode.launches == before + 1
    want = torch.stack([decode_kernel.fused_cca_decode_reference(
        folded, x1, s) for s in (x2a, x2b)])
    torch.testing.assert_close(got, want if pair else want[0], **F32_TOL)
    direct = decode_kernel.fused_cca_decode(folded, x1, x2a,
                                            x2b if pair else None)
    assert torch.equal(got, direct)


@pytest.mark.cuda
def test_fused_cca_decode_op_refuses_what_the_kernel_does_not_take(cuda):
    rng = np.random.RandomState(3)
    folded = _folded(cuda, rng, 40, 5, 3)
    x1, x2a, _ = _f32_windows(cuda, 1, 8, 1, 40, 5)
    (rot1, rot2, consts), dims = _operands(folded)
    op = torch.ops.tdt.fused_cca_decode_f32
    with pytest.raises(ValueError):      # bf16 windows: no op form.
        op(x1.bfloat16(), x2a.bfloat16(), None, rot1, rot2, consts, dims)
    with pytest.raises(ValueError):      # Operands not in kernel form.
        op(x1, x2a, None, folded.rot1, folded.rot2, consts, dims)
    with pytest.raises(ValueError):      # Parameters on another device.
        op(x1, x2a, None, rot1.cpu(), rot2.cpu(), consts.cpu(), dims)


def _served_cca_decoder(device, seed=6, f1=40, f2=5, d=3):
    """A CCA decoder with an LDA trained on the CPU, on ``device``."""
    from telluride_decoding_torch.decode.infer_decoder import CCADecoder
    from telluride_decoding_torch.models import convert
    rng = np.random.RandomState(seed)
    flat = {'mean1': rng.randn(1, f1), 'mean2': rng.randn(1, f2),
            'rot1': rng.randn(f1, d) * 0.1, 'rot2': rng.randn(f2, d) * 0.3}
    n = 600
    x1 = rng.randn(n, f1).astype(np.float32)
    x2 = (x1[:, :f2] + rng.randn(n, f2)).astype(np.float32)
    out = np.zeros((n, 1), np.float32)
    batches = [({'input_1': x1[i:i + 100], 'input_2': x2[i:i + 100]},
                out[i:i + 100]) for i in range(0, n, 100)]
    cpu = CCADecoder(convert.cca_params_from_numpy(flat, 'cpu'),
                     reduction='lda', device='cpu')
    cpu.train(batches[::-1], batches, window_size=10)
    decoder = CCADecoder(convert.cca_params_from_numpy(flat, device),
                         reduction='lda', device=device)
    decoder.model_params = cpu.model_params
    return decoder, (x1, x2, out)


@pytest.mark.cuda
@pytest.mark.parametrize('export_on', ['cuda', 'cpu'])
def test_artifact_on_card_equals_live_decoder(cuda, tmp_path, export_on):
    """An artifact of a CCA decoder with lda, exported on the card or on
    the CPU and served on the card: one K1 launch a pair (the launch
    counter counts it), and infer_pair_async a PendingPair of the same
    scores. Exported on the card, the scores are the live decoder's bit
    for bit (the same launch on the same operands); exported on the CPU,
    whose float32 products fold K1's constants in another order, within
    K1's float32 bound (F32_TOL: r1 - c1 cancels, so the fold's rounding
    shows relative to the score)."""
    from telluride_decoding_torch.decode import aot
    exporter, _ = _served_cca_decoder(cuda if export_on == 'cuda' else 'cpu')
    artifact = str(tmp_path / 'artifact')
    aot.export_decoder(exporter, artifact, input_widths=(40, 5),
                       output_width=1)
    exported = aot.load_exported_decoder(artifact, cuda)
    live, (x1, x2, out) = _served_cca_decoder(cuda)
    for frames in (1, 32, 77):
        args = (x1[:frames], x2[:frames], x2[100:100 + frames],
                out[:frames], out[:frames])
        before = decode_kernel.fused_cca_decode.launches
        got = exported.infer_pair(*args)
        assert decode_kernel.fused_cca_decode.launches == before + 1
        want = live.infer_pair(*args)
        for g, w in zip(got, want):
            if export_on == 'cuda':
                np.testing.assert_array_equal(g, w)
            else:
                np.testing.assert_allclose(g, w, **F32_TOL)
        pending = exported.infer_pair_async(*args)
        for g, w in zip(pending.harvest(), got):
            np.testing.assert_array_equal(g, w)


# -- the decoder's resident push plans (decode/push_plan.py) -----------------

PLAN_WIDTHS = [(2553, 31, 10, 32), (1408, 31, 5, 16)]   # codelab, KULeuven


def _plan_params(rng, dims):
    from telluride_decoding_torch.decode.infer_decoder import (
        CorrelationParamsTuple, ModelParamsTuple)
    from telluride_decoding_torch.solvers.lda import LdaParams
    zeros = np.zeros(dims)
    return ModelParamsTuple(
        CorrelationParamsTuple(1, zeros, zeros, zeros, zeros,
                               0.1 * rng.randn(dims), 0.1 * rng.randn(dims),
                               1.0 + rng.rand(dims)),
        LdaParams(rng.randn(dims, 1), np.zeros((dims, 1)), np.array([0, 1]),
                  np.zeros((2, dims)), 0.1, 0.5))


def _cca_weights(rng, f1, f2, dims):
    return {'mean1': 0.1 * rng.randn(1, f1), 'mean2': 0.1 * rng.randn(1, f2),
            'rot1': rng.randn(f1, dims) / np.sqrt(f1),
            'rot2': rng.randn(f2, dims) / np.sqrt(f2)}


def _plan_decoder(cuda, f1, f2, dims, seed):
    """A served CCA decoder with the LDA reduction from seeded weights,
    as the benchmark's serving cells build it."""
    from telluride_decoding_torch.decode.infer_decoder import CCADecoder
    from telluride_decoding_torch.models.cca import BrainModelCCA
    rng = np.random.RandomState(seed)
    model = BrainModelCCA.from_numpy(_cca_weights(rng, f1, f2, dims), cuda)
    decoder = CCADecoder(model, reduction='lda', device=cuda)
    decoder.model_params = _plan_params(rng, dims)
    return decoder


def _push_args(rng, rows, f1, f2):
    return (rng.randn(rows, f1).astype(np.float32),
            rng.randn(rows, f2).astype(np.float32),
            rng.randn(rows, f2).astype(np.float32),
            np.zeros((rows, 1), np.float32), np.zeros((rows, 1), np.float32))


def _todays_scores(decoder, args):
    """infer_pair without a plan: inputs already on the card take the
    path the decoder took before plans (one K1 launch, two reads)."""
    return decoder.infer_pair(*(torch.as_tensor(a, device=decoder.device)
                                for a in args))


def _plan_counts():
    """(K1 launches, graph replays, graph captures, host waits) so far;
    the counters count inside a profiler."""
    from telluride_decoding_torch.utils import profiling
    counters = profiling.recorded().counters
    return (decode_kernel.fused_cca_decode.launches,
            counters.get(profiling.GRAPH_REPLAYS, 0),
            counters.get(profiling.GRAPH_CAPTURES, 0),
            counters.get(profiling.HOST_WAITS, 0))


def _counted_push(decoder, args):
    before = _plan_counts()
    got = decoder.infer_pair(*args)
    return got, tuple(b - a for a, b in zip(before, _plan_counts()))


def _assert_same_bits(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.float32
        np.testing.assert_array_equal(g, w)


@pytest.fixture
def profiled():
    from torch.profiler import ProfilerActivity, profile
    from telluride_decoding_torch.utils import profiling
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        yield
    profiling.reset()


@pytest.mark.cuda
@pytest.mark.parametrize('f1,f2,dims,rows', PLAN_WIDTHS)
def test_push_plan_scores_equal_todays_path(cuda, profiled, f1, f2, dims,
                                            rows):
    """200 pushes of fresh inputs after a shorter first one: the two
    first sights take the path without a plan (five host waits), the
    second full push captures, every later one replays (one wait); one
    K1 launch a push, and the scores are the same bits throughout."""
    decoder = _plan_decoder(cuda, f1, f2, dims, seed=f1)
    rng = np.random.RandomState(1)
    for push in range(202):
        args = _push_args(rng, rows - 3 if push == 0 else rows, f1, f2)
        want = _todays_scores(decoder, args)
        got, counts = _counted_push(decoder, args)
        _assert_same_bits(got, want)
        assert counts == {0: (1, 0, 0, 5), 1: (1, 0, 0, 5),
                          2: (1, 1, 1, 1)}.get(push, (1, 1, 0, 1)), push
    assert len(decoder._push_plans) == 1


@pytest.mark.cuda
@pytest.mark.parametrize('refit', ['model', 'lda'])
def test_push_plan_after_a_refit_mid_stream(cuda, profiled, refit):
    """A refit (the model's params_version, or new statistics and LDA)
    gives new operands, so a new key: its first push takes the path
    without a plan, its second captures, and the scores are the new
    parameters' bits. infer_pair_async keeps the path without a plan."""
    f1, f2, dims, rows = PLAN_WIDTHS[1]
    decoder = _plan_decoder(cuda, f1, f2, dims, seed=3)
    rng = np.random.RandomState(2)
    for _ in range(3):
        _counted_push(decoder, _push_args(rng, rows, f1, f2))
    args = _push_args(rng, rows, f1, f2)
    old, counts = _counted_push(decoder, args)
    assert counts == (1, 1, 0, 1)
    fresh = np.random.RandomState(9)
    if refit == 'model':
        decoder.decoding_model.set_params({
            k: torch.as_tensor(v) for k, v in
            _cca_weights(fresh, f1, f2, dims).items()})
    else:
        decoder.model_params = _plan_params(fresh, dims)
    for push in range(4):
        want = _todays_scores(decoder, args)
        got, counts = _counted_push(decoder, args)
        _assert_same_bits(got, want)
        assert not np.array_equal(got[0], old[0])
        assert counts == [(1, 0, 0, 5), (1, 1, 1, 1), (1, 1, 0, 1),
                          (1, 1, 0, 1)][push], push
    assert len(decoder._push_plans) == 2
    before = _plan_counts()
    pending = decoder.infer_pair_async(*args)
    _assert_same_bits(pending.harvest(), want)
    after = _plan_counts()
    assert (after[0] - before[0], after[1] - before[1]) == (1, 0)


@pytest.mark.cuda
def test_push_plan_outlives_an_eviction_of_its_operands(cuda, profiled):
    """prepared_operands' LRU drops the operands a live graph reads: the
    plan holds them, so a replay after the allocator has handed out
    fresh memory still reads them; the decoder's next pushes make new
    operands, a new key, and the same scores."""
    import gc
    import weakref
    f1, f2, dims, rows = PLAN_WIDTHS[0]
    decoder = _plan_decoder(cuda, f1, f2, dims, seed=4)
    rng = np.random.RandomState(3)
    for _ in range(3):
        _counted_push(decoder, _push_args(rng, rows, f1, f2))
    ((operands, plan),) = decoder._push_plans._plans.values()
    held = weakref.ref(operands.rot1)
    del operands
    decode_kernel._prepared.clear()
    gc.collect()
    torch.cuda.empty_cache()
    assert held() is not None
    junk = [torch.full_like(t, float('nan'))
            for t in plan._operands[:3] for _ in range(4)]
    args = _push_args(rng, rows, f1, f2)
    _assert_same_bits(plan.run(*args[:3]), _todays_scores(decoder, args))
    for push in range(3):
        args = _push_args(rng, rows, f1, f2)
        want = _todays_scores(decoder, args)
        got, counts = _counted_push(decoder, args)
        _assert_same_bits(got, want)
        assert counts[1:3] == [(0, 0), (1, 1), (1, 0)][push]
    del junk
