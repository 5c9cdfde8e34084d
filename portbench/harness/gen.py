"""Seeded inputs of a run: recordings and decoder weights, made on the
run's device from ``--seed``.

The recordings follow chip_smoke.py's ``synthetic_recordings``: each
talker's intensity is |N(0, 1)| at knots every 10 frames, linearly
interpolated; the EEG is the attended talker's intensity through a
planted TRF of ``trf_lags`` lags (N(0, 1) * exp(-lag / 8) per channel)
plus white noise. Here the recipe runs as a few large torch calls on a
``torch.Generator`` of the run's device, so that set-up stays short at a
serving session's length. The convolution is a product with the lag
matrix of the intensity (cuBLAS, deterministic for given shapes), so one
seed gives the same inputs on every run of one device type.
"""

from __future__ import annotations

import numpy as np
import torch


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on ``device`` for one named stream of a run's seed:
    the weights and the recordings draw from separate streams."""
    state = np.random.SeedSequence([seed % 2 ** 64, stream]).generate_state(
        1, np.uint64)[0]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(state))
    return gen


def envelopes(gen, count: int, frames: int, device) -> torch.Tensor:
    """[count, frames] positive intensity envelopes, knots every 10
    frames."""
    knots = frames // 10 + 2
    raw = torch.randn((count, knots), generator=gen, device=device).abs()
    idx = torch.linspace(0, knots - 1.001, frames, dtype=torch.float64,
                         device=device)
    lo = idx.long()
    frac = (idx - lo).float()
    return (1 - frac) * raw[:, lo] + frac * raw[:, lo + 1]


def planted_trf(gen, channels: int, lags: int, device) -> torch.Tensor:
    """[channels, lags] random TRF with an exponential decay."""
    decay = torch.exp(-torch.arange(lags, device=device) / 8.0)
    return torch.randn((channels, lags), generator=gen,
                       device=device) * decay


def eeg(gen, attended: torch.Tensor, trf: torch.Tensor,
        noise: float) -> torch.Tensor:
    """[..., frames, channels]: ``attended`` [..., frames] through the
    causal TRF (np.convolve(attended, trf[c])[:frames]) plus noise."""
    lags = trf.shape[1]
    padded = torch.nn.functional.pad(attended, (lags - 1, 0))
    # Row t of the lag matrix holds attended[t], attended[t-1], ...
    lagged = padded.unfold(-1, lags, 1).flip(-1)
    clean = lagged @ trf.T
    return clean + noise * torch.randn(clean.shape, generator=gen,
                                       device=attended.device)


def host(t: torch.Tensor) -> np.ndarray:
    return np.ascontiguousarray(t.float().cpu().numpy())


def serve_session(cfg: dict, mix: dict, seed: int, device):
    """(eeg [L, C], audio1 [L, 1], audio2 [L, 1]) host float32 arrays of
    one two-talker session; attention alternates between the talkers
    every ``attention_segment_frames``."""
    gen = generator(seed, 1, device)
    frames = mix['session_frames']
    talkers = envelopes(gen, 2, frames, device)
    trf = planted_trf(gen, cfg['eeg_channels'], cfg['trf_lags'], device)
    segment = torch.arange(frames, device=device) // mix[
        'attention_segment_frames']
    attended = torch.where(segment % 2 == 0, talkers[0], talkers[1])
    return (host(eeg(gen, attended, trf, cfg['eeg_noise'])),
            host(talkers[0][:, None]), host(talkers[1][:, None]))


def decoder_weights(cfg: dict, seed: int, device) -> dict:
    """The CCA rotations and means, correlation statistics and scaled
    LDA of a serving decoder, as float64 host arrays (the configuration's
    ``assumed``: seeded, not fitted)."""
    gen = generator(seed, 0, device)
    f1 = cfg['eeg_channels'] * (cfg['eeg_pre'] + 1 + cfg['eeg_post'])
    f2 = cfg['audio_channels'] * (cfg['audio_pre'] + 1 + cfg['audio_post'])
    dims = cfg['cca_dims']

    def normal(shape, sd):
        return torch.randn(shape, generator=gen, device=device,
                           dtype=torch.float64) * sd
    out = {'rot1': normal((f1, dims), 0.5 / f1 ** 0.5),
           'rot2': normal((f2, dims), 0.5 / f2 ** 0.5),
           'mean1': normal((1, f1), 0.1), 'mean2': normal((1, f2), 0.1),
           'corr_mean_x': normal((dims,), 0.1),
           'corr_mean_y': normal((dims,), 0.1),
           'corr_power': 1.0 + torch.rand((dims,), generator=gen,
                                          device=device,
                                          dtype=torch.float64),
           'lda_w': normal((dims, 1), 1.0 / dims ** 0.5)}
    out = {k: v.cpu().numpy() for k, v in out.items()}
    # Stored in float32 by the model files; the reference takes them so.
    out = {k: v.astype(np.float32).astype(np.float64) for k, v in out.items()}
    out['lda_slope'] = 0.1
    out['lda_intercept'] = 0.5
    return out


def sweep_subject(cfg: dict, mix: dict, seed: int, subject: int, device):
    """One subject's per-file raw streams in the layout of
    engine.ContextSpec (cli.regression's ``_per_file_raw``): x [n +
    x_post, C] and y [n + y_post, 1] host float32 arrays a file, zero rows
    past the file's n frames; and the ContextSpec's four lags."""
    gen = generator(seed, 2 + subject, device)
    files, frames = mix['files'], mix['frames']
    attended = envelopes(gen, files, frames, device)
    trf = planted_trf(gen, cfg['eeg_channels'], cfg['trf_lags'], device)
    x = eeg(gen, attended, trf, cfg['eeg_noise'])
    lags = (cfg['eeg_pre'], cfg['eeg_post'],
            cfg['audio_pre'] if mix['y_lags'] else 0,
            cfg['audio_post'] if mix['y_lags'] else 0)
    x = torch.nn.functional.pad(x, (0, 0, 0, lags[1]))
    y = torch.nn.functional.pad(attended[..., None], (0, 0, 0, lags[3]))
    xs, ys = host(x), host(y)
    return list(xs), list(ys), lags
