"""The port's first slice as a whole vs the JAX package, at small size.

The same synthetic recordings (chip_smoke.synthetic_recordings: EEG from
the attended speaker through a random TRF plus noise, a served stream
whose attention switches at its midpoint) go through

  JAX:  fit (stacked arrays) -> Decoder.train -> save -> serve_stream
  port: fit_streaming (raw files, per-file lag stack) -> Decoder.train
        -> save -> cli.serve.main(argv) with an .npz

Decisions must be identical. Scores agree within 1e-3: the two fits
accumulate the moments in another order (per file vs concatenated) and
solve with different float32 LAPACK backends, which moves the rotations
by about 1e-5 relative; the served scores are window means of LDA
projections of order one.
"""

import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest

from telluride_decoding_tpu.cli import serve as jax_serve
from test_torch_infer_decoder import (jax_model_dir, port_model_dir,
                                      recordings)

import chip_smoke
from telluride_decoding_torch.cli import serve
from telluride_decoding_torch.ops.decode_kernel import fused_cca_decode
from telluride_decoding_torch.ops.lagstack import lag_stack

SLICE_TOL = 1e-3
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_slice_matches_jax(tmp_path):
    train, (eeg, a1, a2) = recordings()
    jax_dir, port_dir = str(tmp_path / 'jax'), str(tmp_path / 'port')
    jax_dprime = jax_model_dir(jax_dir, train)
    port_dprime = port_model_dir(port_dir, train)
    assert port_dprime == pytest.approx(jax_dprime, rel=1e-3)

    want = jax_serve.serve_stream(jax_dir, eeg, a1, a2, chunk_size=32,
                                  reduction='lda', decision='wta',
                                  window_width=100, window_step=50)
    stream = str(tmp_path / 'stream.npz')
    out = str(tmp_path / 'decisions.jsonl')
    np.savez(stream, eeg=eeg, audio1=a1, audio2=a2)
    serve.main(['--serve_model_dir', port_dir, '--serve_input', stream,
                '--serve_output', out, '--chunk_size', '32',
                '--serve_window_width', '100', '--serve_window_step', '50',
                '--serve_decoder', 'wta', '--serve_device', 'cpu'])
    with open(out) as f:
        got = [json.loads(line) for line in f][:-1]
    assert [(d['window'], d['attend_speaker1']) for d in got] == \
        [(d['window'], d['attend_speaker1']) for d in want]
    for g, w in zip(got, want):
        assert g['score1'] == pytest.approx(w['score1'], abs=SLICE_TOL)
        assert g['score2'] == pytest.approx(w['score2'], abs=SLICE_TOL)
    # The planted switch is found (the chip smoke test's own check).
    chip_smoke.check_decisions(want, {'windows': len(want)},
                               stream_frames=eeg.shape[0])


def test_chip_smoke_slice_runs_on_cpu(tmp_path):
    """chip_smoke's main-path phase at a small size with the plain
    versions: CPU tensors never launch a kernel."""
    launches = (lag_stack.launches, fused_cca_decode.launches)
    contexts = (0, 4, 2, 2)
    decisions, summary, stream, _ = chip_smoke.run_slice(
        'cpu', str(tmp_path), channels=12, files=2, frames=3000,
        stream_frames=3000, dims=4, contexts=contexts)
    assert chip_smoke.check_decisions(decisions, summary, 3000) > 0.9
    assert chip_smoke.check_against_plain(decisions, str(tmp_path), stream,
                                          contexts) <= chip_smoke.SERVE_TOL
    assert (lag_stack.launches, fused_cca_decode.launches) == launches


def test_chip_smoke_fails_without_card_and_alone():
    """No card: non-zero exit, no result. Alone in a directory: the same,
    whatever the machine."""
    proc = subprocess.run([sys.executable, 'chip_smoke.py'], cwd=REPO,
                          stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                          text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    with tempfile.TemporaryDirectory() as alone:
        with open(os.path.join(REPO, 'chip_smoke.py')) as f:
            source = f.read()
        with open(os.path.join(alone, 'chip_smoke.py'), 'w') as f:
            f.write(source)
        env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
        proc = subprocess.run([sys.executable, 'chip_smoke.py'], cwd=alone,
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
