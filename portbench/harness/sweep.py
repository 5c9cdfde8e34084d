"""Sweep cells: leave-one-file-out sweeps over a lambda grid, back to
back, through ``sweep/engine.py`` as ``cli/regression.py`` drives it.

Set-up draws each subject's raw per-file EEG and intensity from the seed
in the layout ``Regression._per_file_raw`` hands the engine after its
read stage (host arrays, lags applied on the card by K2), and runs the
mix's warm-up sweeps. The window sweeps the subjects in turn, each sweep
with a ``StageTimer`` as the driver passes one, until the run's seconds
have passed; a sweep ends when its grid is on the host. After the window
``reference/sweep.py`` recomputes each subject's grid from its raw
streams, and every grid the window returned is compared with it.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from portbench.harness import common, gen, trace
from portbench.reference import sweep as ref_sweep


def lambdas_of(mix: dict):
    return [10.0 ** e for e in mix['lambda_exponents']]


def reference_grids(subjects, mix, device, precision='float64'):
    """Each subject's [lambda, file] grid by the reference."""
    return [ref_sweep.grid(xs, ys, mix['frames'], lags, lambdas_of(mix),
                           mix['model'], device, precision)
            for xs, ys, lags in subjects]


def moments_gap(got: dict, want: dict) -> float:
    """The largest gap of one file's moments, each entry of the product
    matrix of [x | y] against the reference's over sqrt(S_ii S_jj), each
    sum over sqrt(count S_ii): its scale in the sums it came from."""
    def square(m):
        return np.block([[m['sxx'], m['sxy']], [m['sxy'].T, m['syy']]])
    ref = square(want)
    diag = np.sqrt(np.diag(ref))
    gaps = [np.abs(square(got) - ref) / np.outer(diag, diag),
            np.abs(np.concatenate([got['sum_x'], got['sum_y']]) -
                   np.concatenate([want['sum_x'], want['sum_y']])) /
            np.sqrt(want['count'] * np.diag(ref)),
            [abs(got['count'] - want['count'])]]
    return max(common.max_abs(g) for g in gaps)


def compare(grids, want, moments=None, want_moments=None) -> dict:
    """The numbers that decide ``correct``: the largest gap between a
    grid the window returned and its subject's reference grid, and the
    moments gap of the one file whose moments were kept."""
    values = {'grid_err': common.max_abs(np.concatenate(
        [(grid - want[s]).ravel() for s, grid in grids]))}
    values['moments_err'] = (float('nan') if moments is None else
                             moments_gap(moments, want_moments))
    return values


class MomentsTap:
    """Keeps, on the host, the moments of one file of one sweep (both
    drawn from the seed among the window's first two sweeps): the
    benchmark's wrapper around the engine's ``per_file_stats``."""

    def __init__(self, engine, seed: int, files: int):
        rng = np.random.default_rng([seed % 2 ** 64, 11])
        self.sweep, self.file = int(rng.integers(2)), int(rng.integers(files))
        self.subject = None
        self.calls = 0
        self.kept = None
        self._engine, self._inner = engine, engine.per_file_stats

        def per_file_stats(*args, **kwargs):
            stats = self._inner(*args, **kwargs)
            if self.calls == self.sweep:
                self.kept = {k: (float(v[self.file]) if k == 'count' else
                                 v[self.file].double().cpu().numpy())
                             for k, v in stats._asdict().items()}
            self.calls += 1
            return stats
        engine.per_file_stats = per_file_stats

    def close(self):
        self._engine.per_file_stats = self._inner


def run(cfg: dict, mix: dict, limits: dict, seed: int, seconds: float,
        traced: bool, device, process_start: float) -> common.Outcome:
    from telluride_decoding_torch.sweep import engine
    from telluride_decoding_torch.utils.profiling import StageTimer
    cuda = device.type == 'cuda'
    model = mix['model']
    sweep = (engine.ridge_jackknife_sweep if model == 'ridge' else
             engine.cca_jackknife_sweep)
    lambdas = lambdas_of(mix)
    stages = {'start': time.perf_counter() - process_start}
    subjects = [gen.sweep_subject(cfg, mix, seed, s, device)
                for s in range(mix['subjects'])]
    stages['inputs'] = time.perf_counter() - process_start
    lags = subjects[0][2]
    context = engine.ContextSpec(*lags)

    def run_sweep(subject, timer):
        xs, ys, _ = subjects[subject]
        return sweep(xs, ys, lambdas, context=context, device=device,
                     timer=timer).correlations

    for i in range(mix['warmup_sweeps']):
        run_sweep(i % len(subjects), StageTimer('warmup'))
    if cuda:
        torch.cuda.synchronize(device)
    timer = StageTimer('window')
    grids = []
    tap = MomentsTap(engine, seed, mix['files'])
    stages['warmup'] = time.perf_counter() - process_start
    tracer = trace.Slice(traced, device, trace.SECONDS)
    t_begin = time.perf_counter()
    setup_s = t_begin - process_start
    while True:
        subject = len(grids) % len(subjects)
        grids.append((subject, run_sweep(subject, timer)))
        t1 = time.perf_counter()
        done = t1 - t_begin >= seconds
        tracer.tick(t1 - t_begin, last=done)
        if done:
            break
    window_s = t1 - t_begin
    tap.close()
    sweeps = len(grids)
    fits = sweeps * len(lambdas) * mix['files']
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    x_pre, x_post, y_pre, y_post = lags
    readings = {
        'kind': 'sweep', 'model': model, 'window_s': window_s,
        'setup_stages_s': stages,
        'sweeps': sweeps, 'stages_s': timer.as_dict(),
        'files': mix['files'], 'frames': mix['frames'],
        'lambdas': len(lambdas),
        'x_channels': cfg['eeg_channels'], 'x_lags': x_pre + 1 + x_post,
        'y_channels': cfg['audio_channels'], 'y_lags': y_pre + 1 + y_post,
        # The raw rows a file holds on the card, as the engine pads them.
        'raw_rows': mix['frames'] + max(x_post, y_post)}
    reduced = tracer.reduce()
    if reduced is not None:
        readings['trace'] = reduced
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    want = reference_grids(subjects, mix, device)
    subject = tap.sweep % len(subjects)
    xs, ys, _ = subjects[subject]
    want_moments = ref_sweep.file_moments(xs[tap.file], ys[tap.file],
                                          mix['frames'], lags, device)
    checks = common.checks_from(
        compare(grids, want, tap.kept, want_moments), limits)
    readings['reference_s'] = time.perf_counter() - t_ref
    e2e = {'sweep_fits_per_s': fits / window_s, 'setup_s': setup_s}
    return common.Outcome(attempted=fits, failed=0, end_to_end=e2e,
                          readings=readings, checks=checks,
                          memory_peak_bytes=int(peak), trace=reduced)
