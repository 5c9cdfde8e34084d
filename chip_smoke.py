#!/usr/bin/env python3
"""GPU smoke test of the PyTorch port (telluride_decoding_torch).

Builds the hand-written CUDA kernels from telluride_decoding_torch/csrc
and the native TFRecord codec, checks each kernel against its plain
PyTorch version on the card at the shapes the main paths give it, then
drives the main paths once:

  codelab path (69 EEG channels x 37 lags = 2553 columns, 1 audio
  channel x 31 lags, 10 canonical dimensions, 100 Hz): seeded synthetic
  recordings written as TFRecords -> file-wise CCA fit (lag stack kernel
  K2 + moments + solve) -> decoder training -> streaming serve through
  ``telluride_decoding_torch.cli.serve.main`` (fused CCA decode kernel
  K1 per chunk);

  ingest path, at KULeuven width (64 EEG channels x 22 lags = 1408
  columns, intensity x 31 lags, 5 canonical dimensions, 32 Hz): a seeded
  KULeuven-shaped cache (one subject, 8 trials of 6 minutes of 128 Hz
  EEG, 4 int16 wavs at 44.1 kHz) -> ``cli.regression_data.main``
  (intensity envelopes by kernel K3) -> TFRecords, held against a CPU
  ingest -> TFExampleData -> fit (K2) -> training -> serve of the
  held-out trial (K1), whose attention switches at its midpoint;

  decoding path, at codelab width: 5 seeded TFRecord files of 12000
  frames -> ``telluride_decoding_torch.cli.decoding.main`` twice (CCA
  with the streamed fit, K2; linear with the dense fit) -> results.txt,
  model and decoder_model.json -> the saved CCA decoder's
  ``test_by_window_means`` over the held-out file (K1 over all of its
  frames in one launch), once against each speaker;

  sweep path, the codelab's jackknife x lambda sweep at full width: 40
  seeded TFRecord files of 3300 frames -> ``cli.regression.main`` twice
  (jens_memory_linear: 360 ridge fits; jens_memory_cca: 360 CCA fits),
  9 lambdas, raw channels to the card and each file lag-stacked there by
  K2 inside the moments -> per-lambda results.txt and the CSV;

  cohort path, the codelab's cross-subject analysis at full width: 22
  seeded subjects x 40 TFRecord trials of about 3300 frames (908 MB) ->
  ``telluride_decoding_torch.cli.cohort.main`` (7,920 ridge fits, a
  prefetch thread reading subject k+1 while subject k sweeps, K2 once a
  trial) -> the cohort CSV, the per-subject CSVs and the summary table;
  then, on its first subjects, eager against streaming loading, a CCA
  cohort, two partition processes joined through part files, and host
  lag stacking;

  attention path, at codelab width: a seeded two-speaker corpus (3 train
  files attending speaker 1, an 18000-frame test file whose attention
  switches three times) -> a CCA model through ``cli.decoding.main`` ->
  ``cli.infer.main --comparison_test`` (reductions first and lda x
  decision rules wta, stepped and ssd x windows of 10 to 1000 frames:
  K1 twice a pair; the state-space decoder's kernel S1 once an ssd pair,
  its sequence form deciding all six window sizes) -> the codelab
  stream served with ``--serve_decoder ssd`` (S1's window form once a
  window), synchronous and pipelined -> one TCP session of
  ``serve_socket`` -> ``--selftest``;

  raw-recording ingest: a lab's own seeded recordings (8 trials of 6
  minutes: stereo wavs at 44.1 kHz with trigger pulses added by
  ``cli.add_trigger.main``, EDF of 64 EEG channels and a TRIG channel at
  512 Hz starting a planted lead before the audio, a BrainVision copy of
  one trial) -> the ingest API (EdfBrainDataFile, trigger onsets, the
  lead by mode histogram and Theil-Sen, fix_eeg_offset, intensity by
  K3, EEG resampled to 64 Hz, z-score, TFRecords) -> ``cli.decoding.main``
  (CCA at the KULeuven preset's contexts: streamed fit, K2) -> the
  decoder's frame scores over the test trial (K1); then a seeded
  Telluride2015.mat and one jens_impaired subject (a ds-eeg-snhl.tar of
  a 24-bit BDF, the events TSV and the stimuli features) through
  ``cli.regression_data.main --internet file://...`` (download, untar,
  ingest) -> ``cli.regression.main`` (telluride4_linear,
  telluride4_cca, jens_impaired_linear; K2);

  model files: the decoding path's linear model through
  ``cli.export_keras --saved-model`` and back through
  ``cli.migrate_saved_model``; the codelab model written in the layout
  tf_keras writes for the reference's subclassed CCA (saved_model.pb,
  keras_metadata.pb, positional variables/) and served as it is by
  ``cli.serve`` (K1 a chunk) beside its native directory, then
  migrated; its weights' bundle read from snappy index blocks; and a
  CCA SavedModel of ``export_saved_model``, which migration refuses;

  SGD families, on the decoding path's corpus at codelab width:
  ``cli.decoding.main`` with ``--dnn_regressor fullyconnected`` (hidden
  20-20, batches of 512, torch autograd and Adam), ``dcca`` (two towers
  trained on the deep-CCA loss, 10 canonical dimensions; its decoder's
  frame scores through K1 on the towers' outputs) and ``classifier``
  with mismatch batches, and the classifier on the reference's
  classifier corpus; the DCCA directory serving phase 4's stream and a
  stream of the corpus's own subject (K1 a chunk); an SGD cohort of 4
  subjects x 10 trials through ``cli.cohort.main`` with checkpoints,
  rerun from them.

Decisions must track the planted switch, served scores must match a
CPU decode of the same stream with the plain versions, the decoding
driver's results.txt on the card must match the CPU's on a shorter copy
of its corpus, and the sweep's grids must match the CPU's on a short
copy and host lag stacking at full width, with the best lambda's mean
held-out r above the planted TRF's matched filter's less a margin. The
cohort's best mean r meets the same gate; its streaming and eager runs
must give bit-identical grids, its partitioned run the single run's
cohort CSV, and its short copy the CPU's grids. The infer sweep's lda +
wta accuracy must be above 0.9 at windows of 400 frames or more, and its
accuracies equal the same sweep's on the CPU (ssd within one window's
share); both serving modes and the TCP session must give the same
decisions; S1's window form must match its plain version on the card
over the test file's windows, and its sequence form the window form bit
for bit over an ssd pair's six streams and the plain version over their
first windows. The raw ingest's planted leads must be recovered within
one EEG sample by both estimators, its BrainVision copy must read within
one EDF quantum of the EDF, its records on the card within INGEST_TOL of
the same ingest on the CPU, the lab experiment's d' above 1 and each
corpus sweep's best mean r at or above its planted matched filter's less
SWEEP_MARGIN. Exported and migrated weights must keep their bits, the
linear model its predictions, the reference-layout CCA directory must
serve the native directory's scores and decisions bit for bit, the
snappy bundle must read as the uncompressed one, and the CCA export
must be refused with the JAX package's text. The DNN and the DCCA must
reach d' above 1, the classifier accuracy above 0.9 on the reference's
corpus, the DCCA's served scores must match a serve on the CPU with the
plain versions within SERVE_TOL with the same decisions, the streamed
DNN fit on the card the CPU's within SGD_CARD_TOL, K1 its plain version
at F1 = F2 = D = 10, and the resumed SGD cohort the first run's CSV.

Run from the root of a checkout on a machine with one CUDA card:

  python3 chip_smoke.py

Without a card, or outside a checkout, it exits non-zero and prints no
result. The line before the last holds the kernels' numbers as JSON; the
last line is {"ok": true, "device": {...}}.
"""

import collections
import contextlib
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np

from tools import raw_recordings, snappy_blocks

IN1_CHANNELS, PRE, POST = 69, 0, 36            # 69 x 37 = 2553 columns.
IN2_PRE, IN2_POST = 15, 15                     # 1 x 31 columns.
CCA_DIMS = 10
TRAIN_FILES, TRAIN_FRAMES, STREAM_FRAMES = 4, 12000, 6000
DECODING_FILES, SHORT_FRAMES = 5, 3000         # cli.decoding corpus.
# The codelab's jackknife x lambda sweep (bench.py:366-404): 40 trials of
# 3300 frames, 9 lambdas, EEG 69 x 37 = 2553 columns; and its short copy
# for the card-against-CPU check (files, frames, post context).
SWEEP_FILES, SWEEP_FRAMES = 40, 3300
SWEEP_LAMBDAS = np.logspace(-6, 2, 9)
SWEEP_SHORT = (8, 1000, 8)
SWEEP_TOL = 1e-4                               # Grids, card vs CPU / host.
SWEEP_MARGIN = 0.05                            # Below the matched filter.
# The codelab's cross-subject analysis (examples/make_synthetic_cohort.py):
# 22 subjects x 40 trials of 3300 - (t mod 5) * 37 frames, 69 EEG
# channels, a planted 37-lag TRF driving intensity; at 9 lambdas 7,920
# ridge fits. The checks run on its first few subjects, and a short copy
# (subjects, trials, frames, post context) runs on card and CPU.
COHORT_SUBJECTS, COHORT_TRIALS, COHORT_NOISE = 22, 40, 0.3
COHORT_FEW, COHORT_HOST = 4, 2
COHORT_SHORT = (3, 8, 1000, 8)
PARTITION_TOL = 1e-6                           # Joined vs single cohort CSV.
FLAGSHIP = (512, 100)                          # Windows x frames.
# KULeuven CCA preset (telluride_decoding_tpu/cli/regression.py:453-469,
# :520-525): EEG post context 21 (64 x 22 = 1408 columns), intensity
# pre/post 15 (31 columns), 5 canonical dimensions, 32 Hz.
KULEUVEN = dict(channels=64, eeg_fs=128, audio_fs=44100, seconds=360,
                trials=8, tracks=4, frame_rate=32, dims=5,
                contexts=(0, 21, 15, 15))
F32_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_TOL = dict(rtol=1e-3, atol=1e-3)
K3_TOL = dict(rtol=0, atol=1e-4)
SERVE_TOL = 1e-4
INGEST_TOL = 1e-4
SOSFILT_TOL = 1e-3
RESULTS_TOL = 1e-3                             # results.txt, card vs CPU.
DPRIME_REL_TOL = 1e-2
HBM_BYTES_PER_S = 3.35e12                      # H100 SXM, data sheet.
FP32_FLOPS = 67e12                             # fp32 on the CUDA cores, same.
SERVE_ROWS = 32                                # Frames in a served chunk.
F32_SYMBOL = 'fused_cca_decode_cluster_kernel'  # K1's float32 kernel.
# Phase 11: the state-space decoder (kernel S1) and the infer sweep. The
# infer corpus: train files attending speaker 1, a test file whose
# attention switches every INFER_SEGMENT frames (three switches).
S1_WINDOW = 'ssd_window_kernel'                # S1's window form.
SSD_TOL = 1e-4                                 # z, eta, p, bounds: S1 vs plain.
SSD_ERROR_BAR = 0.15                           # tests/test_attention_decoder.py.
INFER_TRAIN_FILES, INFER_SEGMENT, INFER_SEGMENTS = 3, 4500, 4
INFER_GATE = 0.9                               # lda + wta at >= 400 frames.
# Window sizes of the CPU's ssd sweep (the plain SSD takes about 0.2 s a
# window on a CPU, so the CPU check of ssd covers the large windows).
INFER_CPU_SSD_SIZES = [700, 1000]
# S1's sequence form against its plain version on the card: the first
# windows of each stream of an ssd pair (the plain SSD takes some 0.7 s a
# window step there).
SSD_PLAIN_WINDOWS = 3
REPO = os.path.dirname(os.path.abspath(__file__))
BUILD = os.path.join(REPO, 'build')
CODELAB_DIR = os.path.join(BUILD, 'chip_smoke_model')   # Phase 4's model.
DECODING_DIR = os.path.join(BUILD, 'decoding')          # Phase 8's work.
# Phase 13: the text with which models/migrate.py (as the JAX package's,
# telluride_decoding_tpu/models/migrate.py:133-138) refuses a CCA
# SavedModel written by export_saved_model: its two Dense kernels.
CCA_EXPORT_REFUSAL = (
    "Reference SavedModel has 2 dense kernels "
    "(['layer_with_weights-0/kernel/.ATTRIBUTES/VARIABLE_VALUE', "
    "'layer_with_weights-1/kernel/.ATTRIBUTES/VARIABLE_VALUE']) — a "
    "DNN/classifier model. Only the deterministic families (linear "
    "regression, CCA) migrate; retrain DNNs natively with cli.decoding.")
# Phase 14: the SGD families on phase 8's corpus at codelab width, with the
# decoding driver's flag defaults (hidden 20-20, batch 512) and SGD_EPOCHS
# epochs at SGD_LR, the JAX suite's DNN rate (tests/test_decoding.py:192):
# at the default 0.05 the DNN dies on this corpus in both packages (the
# first epoch's loss 1.2e4 in JAX, then a constant output, d' nan; on the
# CPU at a quarter of the frames) and the JAX DCCA turns NaN; the card
# against the CPU over the short copy's
# streamed DNN fit, its parameters within SGD_CARD_TOL (float32 sums in
# another order through some 20 Adam steps, TF32 off); the SGD cohort of
# SGD_COHORT subjects x trials at post context SGD_COHORT_POST (69 x 5 =
# 345 columns: the per-fold host lag stack at 37 lags would take most of
# the phase) over the lambdas of SGD_COHORT_LAMBDAS.
SGD_EPOCHS = 20
SGD_LR = 0.001
SGD_DIR = os.path.join(BUILD, 'sgd')
SGD_CARD_TOL = 1e-3
SGD_STREAM_BATCH = 256
SGD_COHORT, SGD_COHORT_POST = (4, 10), 4
SGD_COHORT_LAMBDAS = '1e-4,1e-2,1'
SGD_TIMED_STEPS = 20
# The classifier's gate (accuracy above 0.9) is the reference's CI bar on
# its own two-input corpus (reference test/brain_model_test.py:813-849,
# rebuilt in tools/ab_reference.py:539-610), at its flags; on phase 8's
# corpus a frame's EEG says too little about whether its intensity is
# the matched one (0.55 on the CPU at 6000 frames a file), so there the
# accuracy is reported, not gated.
CLASSIFIER_FLAGS = ['--input_field', 'x1', '--input2_field', 'x2',
                    '--output_field', 'label', '--attended_field=',
                    '--dnn_regressor', 'classifier', '--hidden_units', '20',
                    '--learning_rate', '0.001', '--epoch_count', '30',
                    '--batch_size', '128', '--shuffle_buffer_size', '0',
                    '--train_file_pattern', 'trainset',
                    '--validate_file_pattern', 'heldout',
                    '--test_file_pattern', 'heldout']
# Phase 15: AOT artifacts of the models of phases 4 (the codelab CCA,
# lda), 14 (the DCCA, lda) and 8 (linear, first), served on phase 4's
# stream beside their directories: the CCA's scores bit for bit (one K1
# launch on the same operands); the others' within AOT_TOL of the live
# decoder's, relative to the larger of 1 and the score, and in the
# decision records (scores rounded to RECORD_UNIT) within AOT_TOL +
# RECORD_UNIT. The CCA artifact exported on the CPU folds K1's constants
# with the CPU's float32 products, so it is held to SERVE_TOL, the bound
# of a card decode against a CPU decode.
AOT_DIR = os.path.join(BUILD, 'aot')
AOT_TOL = 1e-6
RECORD_UNIT = 1e-6
AOT_HOST_REPS = 200
# S1's chain measurements (s1_bound): a source of their own that includes
# S1's, built beside the kernel library, not into it.
S1_CHAIN_SOURCE = os.path.join(REPO, 'chip_smoke_csrc', 's1_chain.cu')
S1_LATENCY_KINDS = ('fadd', 'mufu_ex2', 'fadd_mufu_rcp', 'expf', 'fdiv_rn',
                    'newton_step', 'newton_step_serial')


def log(*parts):
    print(*parts, flush=True)


@contextlib.contextmanager
def environ(**values):
    """Sets environment variables (strings) for a block."""
    saved = {key: os.environ.get(key) for key in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for key, value in saved.items():
            if value is None:
                del os.environ[key]
            else:
                os.environ[key] = value


def time_ms(torch, fn, reps=20, warmup=3):
    """Mean milliseconds per call over ``reps`` calls, CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def interleaved_ms(torch, kernel_fn, plain_fn, reps=20):
    """(kernel_ms, plain_ms), each the mean of two timings taken in the
    order plain, kernel, kernel, plain."""
    p1 = time_ms(torch, plain_fn, reps)
    k1 = time_ms(torch, kernel_fn, reps)
    k2 = time_ms(torch, kernel_fn, reps)
    p2 = time_ms(torch, plain_fn, reps)
    return (k1 + k2) / 2, (p1 + p2) / 2


def device_ms(torch, fn, symbol, reps=10, attempts=2):
    """Mean device time in ms of the kernel whose name holds ``symbol``
    over ``reps`` calls, as torch.profiler records it; None when the
    profiler saw no such kernel in ``attempts`` sessions (in one whole
    run a session late in the run saw none of K1's launches, where the
    same phase run alone did), and then the keys it saw are logged."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    for _ in range(attempts):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total_us, count = 0.0, 0
        for event in prof.key_averages():
            if symbol in event.key:
                total_us += getattr(event, 'device_time_total',
                                    getattr(event, 'cuda_time_total', 0.0))
                count += event.count
        if count:
            return total_us / count / 1e3
    log('device_ms: no %s among the profiler\'s keys %s'
        % (symbol, sorted({e.key for e in prof.key_averages()})[:12]))
    return None


def device_busy(torch, fn):
    """(wall s, kernel s, copy s) of one call of ``fn`` under
    torch.profiler: the card's busy time split into kernels and memory
    copies/sets, beside the host clock. The busy times are None when the
    profiler saw no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernel_us = copy_us = 0.0
    for event in prof.events():
        if event.device_type != DeviceType.CUDA:
            continue
        us = event.time_range.elapsed_us()
        if 'memcpy' in event.name.lower() or 'memset' in event.name.lower():
            copy_us += us
        else:
            kernel_us += us
    if kernel_us == copy_us == 0.0:
        return wall, None, None
    return wall, kernel_us / 1e6, copy_us / 1e6


def fmt_busy(busy):
    wall, kernel_s, copy_s = busy
    if kernel_s is None:
        return '%.3f s, device time not measured' % wall
    return ('%.3f s, the card busy %.4f s in kernels and %.4f s in copies '
            '(idle %.1f%%)' % (wall, kernel_s, copy_s,
                               100 * (1 - (kernel_s + copy_s) / wall)))


def fmt_ms(ms):
    return 'not measured' if ms is None else '%.4f ms' % ms


def bound_ms(num_bytes):
    """Least time for the bytes at the card's memory rate."""
    return num_bytes / HBM_BYTES_PER_S * 1e3


def bound(num_bytes, fp32_flops):
    """(ms, 'bytes' or 'operations'): the larger of the bytes at the
    card's memory rate and the fp32 operations at its CUDA-core rate."""
    ops_ms = fp32_flops / FP32_FLOPS * 1e3
    bytes_ms = bound_ms(num_bytes)
    return (bytes_ms, 'bytes') if bytes_ms >= ops_ms else (ops_ms,
                                                          'operations')


def max_err(torch, got, want):
    return float(torch.max(torch.abs(got.float() - want.float())))


def require_close(torch, what, got, want, tol):
    if not torch.allclose(got.float(), want.float(), **tol):
        raise AssertionError('%s disagrees with its plain version: max abs '
                             'err %g (tolerance %s)'
                             % (what, max_err(torch, got, want), tol))
    return max_err(torch, got, want)


def decode_params(torch, rng, f1, f2, dims, device):
    """Random CCA + LDA decode parameters in the JAX bench schema."""
    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)
    return {'mean1': t(rng.randn(1, f1)), 'mean2': t(rng.randn(1, f2)),
            'rot1': t(rng.randn(f1, dims) * 0.02),
            'rot2': t(rng.randn(f2, dims) * 0.2),
            'corr_mean_x': t(rng.randn(dims) * 0.1),
            'corr_mean_y': t(rng.randn(dims) * 0.1),
            'corr_power': t(1.0 + rng.rand(dims)),
            'lda_w': t(rng.randn(dims, 2)), 'lda_slope': t(1.3),
            'lda_intercept': t(-0.25)}


def sass_functions(library):
    """{function name: its SASS lines} of the library, as cuobjdump
    lists them; None without cuobjdump."""
    tool = shutil.which('cuobjdump') or '/usr/local/cuda/bin/cuobjdump'
    if not os.path.exists(tool):
        return None
    sass = subprocess.run([tool, '-sass', str(library)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True, check=True).stdout
    functions, lines = {}, None
    for line in sass.splitlines():
        if 'Function :' in line:
            lines = functions.setdefault(line.split(':', 1)[1].strip(), [])
        elif lines is not None:
            lines.append(line)
    return functions


# SASS as cuobjdump lists it: address, guard predicate, opcode, operands.
SASS_LINE = re.compile(r'/\*([0-9a-f]+)\*/\s+(@!?U?P[0-9T]\s+)?'
                       r'([A-Z][A-Z0-9_.]*)\s*([^;]*);')
SASS_REGISTER = re.compile(r'\bU?[RP]\d+\b')   # RZ, PT: no dependence.
SASS_NO_DEST = {'ST', 'STG', 'STS', 'STL', 'RED', 'BRA', 'BSSY', 'BSYNC',
                'EXIT', 'CALL', 'RET', 'NOP', 'BAR', 'WARPSYNC', 'YIELD'}


def sass_class(opcode):
    """What a SASS instruction on a dependent chain is weighed as: 'fp32'
    (FADD, FMUL, FFMA), 'mufu_<op>', 'shfl' or 'other'."""
    base, _, rest = opcode.partition('.')
    if base in ('FADD', 'FMUL', 'FFMA'):
        return 'fp32'
    if base == 'MUFU':
        return 'mufu_' + rest.split('.')[0].lower()
    return 'shfl' if base == 'SHFL' else 'other'


def _sass_dests(opcode, operands):
    """How many leading operands an instruction writes."""
    base = opcode.split('.')[0]
    if base in SASS_NO_DEST:
        return 0
    predicate = [bool(re.fullmatch(r'U?P[0-9T]', o)) for o in operands]
    if base.endswith('SETP') or base == 'FCHK':
        return (predicate + [False]).index(False)
    if base == 'SHFL':
        return 2
    return 1 + (len(operands) > 1 and predicate[1])


def sass_chain(lines, cycles):
    """The heaviest chain of dependent instructions in the SASS ``lines``
    of a straight-line kernel, from the register its only global load
    (LDG) writes to the one its only global store (STG) stores. Each
    instruction weighs ``cycles[sass_class(opcode)]``, 0 where the class
    is not there. Returns (cycles, {class: count}, opcodes in order).

    A division is walked on its fast path: a branch on a predicate FCHK
    wrote is taken when negated (@!P: no special case) and not
    otherwise; another guarded branch, a backward one or a CALL on the
    walk raises."""
    code = []
    for line in lines:
        match = SASS_LINE.search(line)
        if match:
            addr, guard, opcode, operands = match.groups()
            code.append((int(addr, 16), (guard or '').strip(), opcode,
                         [o.strip() for o in operands.split(',')
                          if o.strip()]))
    index = {addr: i for i, (addr, _, _, _) in enumerate(code)}
    ready = {}          # register: (cycles, opcodes) of the chain into it
    checked = set()     # predicates FCHK wrote last
    loads, i = 0, 0
    while i < len(code):
        addr, guard, opcode, operands = code[i]
        base = opcode.split('.')[0]
        i += 1
        if base == 'BRA':
            if guard and guard.lstrip('@!') not in checked:
                raise ValueError('guarded branch at %#x is not a division '
                                 'check' % addr)
            if guard and not guard.startswith('@!'):
                continue
            target = int(operands[-1], 16)
            if target <= addr:
                raise ValueError('backward branch at %#x: not straight-line'
                                 % addr)
            i = index[target]
            continue
        if base in ('CALL', 'EXIT', 'RET'):
            raise ValueError('%s at %#x before the store' % (base, addr))
        if base == 'STG':
            stored = SASS_REGISTER.findall(operands[-1])
            if loads != 1 or not stored or stored[0] not in ready:
                raise ValueError('the store at %#x does not hang on the '
                                 'kernel\'s one load' % addr)
            weight, path = ready[stored[0]]
            return weight, dict(collections.Counter(map(sass_class, path))), \
                list(path)
        n = _sass_dests(opcode, operands)
        dests = [r for o in operands[:n] for r in SASS_REGISTER.findall(o)]
        sources = [r for o in operands[n:] for r in SASS_REGISTER.findall(o)]
        if guard:       # A guarded write keeps the old value when off.
            sources += SASS_REGISTER.findall(guard) + dests
        links = [ready[r] for r in sources if r in ready]
        if base == 'LDG':
            loads += 1
            link = (0.0, ())
        elif links:
            # Of equally heavy links, the longer: an unweighed instruction
            # (a shuffle) on one branch of a select stays counted.
            weight, path = max(links, key=lambda link: (link[0],
                                                        len(link[1])))
            link = (weight + cycles.get(sass_class(opcode), 0.0),
                    path + (opcode,))
        else:
            link = None
        for dest in dests:
            if link is None:
                ready.pop(dest, None)
            else:
                ready[dest] = link
        checked = (checked | set(dests) if base == 'FCHK'
                   else checked - set(dests))
    raise ValueError('no global store')


def hmma_count(library, symbol='fused_cca_decode_mma_kernel'):
    """Tensor-core (HMMA) instructions in the SASS of the kernel whose
    name holds ``symbol``; None without cuobjdump."""
    functions = sass_functions(library)
    if functions is None:
        return None
    return sum('HMMA' in line for name, lines in functions.items()
               if symbol in name for line in lines)


def phase_device(torch):
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], stdout=subprocess.PIPE, text=True,
        check=True).stdout.strip().splitlines()[0]
    capability = torch.cuda.get_device_capability(0)
    log('phase 1 device: %s | torch %s cuda %s | capability %s'
        % (smi, torch.__version__, torch.version.cuda, capability))
    if capability != (9, 0):
        raise AssertionError('needs compute capability (9, 0) for sm_90a, '
                             'got %s' % (capability,))
    from telluride_decoding_torch import _native, kernels
    t0 = time.perf_counter()
    chain_build = s1_chain_build()      # nvcc runs beside the library's.
    path = kernels.build()
    log('phase 1 build: %s in %.1f s' % (path, time.perf_counter() - t0))
    t0 = time.perf_counter()
    log('phase 1 native codec: %s in %.1f s'
        % (_native.build(), time.perf_counter() - t0))
    log('phase 1 S1 chain measurements (%s): %s'
        % (os.path.relpath(S1_CHAIN_SOURCE, REPO),
           s1_chain_library(chain_build)))
    log_lines = (kernels.BUILD_DIR / 'build.log').read_text().splitlines()
    entry, spills = None, ''
    for line in log_lines:
        if 'Compiling entry function' in line:
            entry, spills = line.split("'")[1], ''
        elif entry and 'spill stores' in line:
            spills = line.strip()
        elif entry and 'registers' in line and (
                'lag_stack' in entry or F32_SYMBOL in entry or
                'envelope' in entry or 'mma' in entry or
                'ssd' in entry):
            log('phase 1 ptxas: %s: %s; %s' % (
                entry, line.split(':', 1)[1].strip(), spills))
            entry = None
    hmma = hmma_count(path)
    log('phase 1 SASS: %s HMMA instructions in fused_cca_decode_mma_kernel'
        % ('cuobjdump not found, not counted' if hmma is None else hmma))
    if hmma == 0:
        raise AssertionError('the bf16 decode kernel has no tensor-core '
                             'instruction')
    return smi, hmma


def phase_lagstack(torch, device):
    from telluride_decoding_torch.ops.lagstack import (lag_stack,
                                                       lag_stack_reference)
    gen = torch.Generator(device=device).manual_seed(0)
    worst = 0.0
    for n, c, pre, post in [(TRAIN_FRAMES, IN1_CHANNELS, PRE, POST),
                            (STREAM_FRAMES, 1, IN2_PRE, IN2_POST),
                            (SWEEP_FRAMES + POST, IN1_CHANNELS, PRE, POST),
                            (SWEEP_FRAMES + POST, 1, IN2_PRE, IN2_POST),
                            (11520, 64, 0, 21), (1237, 5, 3, 2),
                            (7, 3, 5, 9)]:
        x = torch.randn((n, c), generator=gen, device=device)
        got = lag_stack(x, pre, post)
        want = lag_stack_reference(x, pre, post)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError('lag_stack kernel is not bit-exact at %s'
                                 % ((n, c, pre, post),))
        worst = max(worst, max_err(torch, got, want))
    x = torch.randn((TRAIN_FRAMES, IN1_CHANNELS), generator=gen,
                    device=device)
    ms, plain_ms = interleaved_ms(
        torch, lambda: lag_stack(x, PRE, POST),
        lambda: lag_stack_reference(x, PRE, POST))
    out_bytes = TRAIN_FRAMES * IN1_CHANNELS * (PRE + 1 + POST) * 4
    limit = bound_ms(x.numel() * 4 + out_bytes)
    on_device = device_ms(torch, lambda: lag_stack(x, PRE, POST),
                          'lag_stack_kernel')
    log('phase 2 lag_stack: bit-exact at 7 shapes; [%d, %d] pre %d post %d: '
        'kernel %.4f ms (%.0f GB/s written), on the device %s, plain %.4f '
        'ms, bound %.4f ms'
        % (TRAIN_FRAMES, IN1_CHANNELS, PRE, POST, ms, out_bytes / ms / 1e6,
           fmt_ms(on_device), plain_ms, limit))
    return {'max_abs_err': worst, 'ms': ms, 'plain_ms': plain_ms,
            'bound_ms': limit, 'bound_by': 'bytes'}


def host_ms(torch, fn, reps=200):
    """Mean host milliseconds per call of ``fn`` over ``reps`` calls
    with no synchronisation between them: what the caller's thread
    spends to enqueue one call."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    ms = (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize()
    return ms


def phase_decode_f32(torch, device, symbol=F32_SYMBOL):
    """K1's float32 kernel (the serving decode) against its plain version
    at the serving shapes, T = 1 and N in {11, 28, 32} frames a chunk
    (single and pair form) at codelab (2553 + 31, D 10) and KULeuven
    (1408 + 31, D 5) width, and at N = 4096. For the serving pair at N =
    32 at both widths and the pair at N = 4096 (codelab width): the
    call's time (CUDA events over back-to-back calls), its host time,
    the kernel's device time (torch.profiler, kernels whose name holds
    ``symbol``), the plain version's time, the bound (bytes or
    operations), and the read floor: one torch.sum of the same x1 (call
    and device time)."""
    from telluride_decoding_torch.ops.decode_kernel import (
        fold_decode_params, fused_cca_decode, fused_cca_decode_reference)
    rng = np.random.RandomState(1)
    gen = torch.Generator(device=device).manual_seed(1)
    f2 = IN2_PRE + 1 + IN2_POST
    widths = (('codelab', IN1_CHANNELS * (PRE + 1 + POST), CCA_DIMS),
              ('KULeuven', KULEUVEN['channels'] * (KULEUVEN['contexts'][0] +
                                                   1 + KULEUVEN['contexts'][1]),
               KULEUVEN['dims']))
    worst, timed = 0.0, {}
    for name, f1, dims in widths:
        folded = fold_decode_params(decode_params(torch, rng, f1, f2, dims,
                                                  device))
        param_bytes = sum(p.numel() * p.element_size() for p in folded)
        for n in (11, 28, SERVE_ROWS, 4096):
            x1, x2a, x2b = (torch.randn((n, 1, f), generator=gen,
                                        device=device) for f in (f1, f2, f2))
            want_a = fused_cca_decode_reference(folded, x1, x2a)
            want_b = fused_cca_decode_reference(folded, x1, x2b)
            worst = max(worst, require_close(
                torch, 'fused_cca_decode %s T=1 N=%d' % (name, n),
                fused_cca_decode(folded, x1, x2a), want_a, F32_TOL))
            worst = max(worst, require_close(
                torch, 'fused_cca_decode %s pair N=%d' % (name, n),
                fused_cca_decode(folded, x1, x2a, x2b),
                torch.stack([want_a, want_b]), F32_TOL))
            if n != SERVE_ROWS and not (n == 4096 and name == 'codelab'):
                continue

            def call():
                return fused_cca_decode(folded, x1, x2a, x2b)
            ms, plain_ms = interleaved_ms(
                torch, call,
                lambda: (fused_cca_decode_reference(folded, x1, x2a),
                         fused_cca_decode_reference(folded, x1, x2b)))
            # r1, r2 of both streams and the two scores, as multiply-adds.
            flops = 2 * n * dims * (f1 + 2 * f2 + 4)
            limit, limited_by = bound(
                (x1.numel() + 2 * x2a.numel()) * 4 + param_bytes + 2 * n * 4,
                flops)
            timed['%s_%d' % (name, n)] = dict(
                ms=ms, plain_ms=plain_ms, host_ms=host_ms(torch, call),
                device_ms=device_ms(torch, call, symbol),
                read_floor_ms=time_ms(torch, lambda: torch.sum(x1)),
                read_floor_device_ms=device_ms(
                    torch, lambda: torch.sum(x1), 'reduce_kernel'),
                bound_ms=limit, bound_by=limited_by)
    for key, t in timed.items():
        log('phase 3 fused_cca_decode float32 pair %s: call %.4f ms, host '
            '%.4f ms, on the device %s, plain %.4f ms, bound %.4f ms (%s), '
            'read floor torch.sum(x1) %.4f ms (on the device %s)'
            % (key, t['ms'], t['host_ms'], fmt_ms(t['device_ms']),
               t['plain_ms'], t['bound_ms'], t['bound_by'],
               t['read_floor_ms'], fmt_ms(t['read_floor_device_ms'])))
    log('phase 3 fused_cca_decode float32: matches plain within %s at T=1 N '
        'in {11, 28, 32, 4096}, single and pair, at 2553 + 31 (D 10) and '
        '1408 + 31 (D 5); max abs err %.3g' % (F32_TOL, worst))
    return worst, timed


def phase_decode(torch, device):
    """K1 against its plain version: the float32 kernel at the serving
    shapes (phase_decode_f32), the bf16 tensor-core kernel at the
    flagship (512 windows x 100 frames x 2553 + 31) and at KULeuven
    width, timed at the flagship beside its bound."""
    from telluride_decoding_torch.ops.decode_kernel import (
        fold_decode_params, fused_cca_decode, fused_cca_decode_reference)
    worst, f32 = phase_decode_f32(torch, device)
    rng = np.random.RandomState(1)
    f1, f2 = IN1_CHANNELS * (PRE + 1 + POST), IN2_PRE + 1 + IN2_POST
    folded = fold_decode_params(decode_params(torch, rng, f1, f2, CCA_DIMS,
                                              device))
    param_bytes = sum(p.numel() * p.element_size() for p in folded)
    gen = torch.Generator(device=device).manual_seed(1)
    w, t = FLAGSHIP
    ku_f1 = KULEUVEN['channels'] * (KULEUVEN['contexts'][0] + 1 +
                                    KULEUVEN['contexts'][1])
    ku = fold_decode_params(decode_params(torch, rng, ku_f1, f2,
                                          KULEUVEN['dims'], device))
    for name, params, width in (('KULeuven', ku, ku_f1),
                                ('flagship', folded, f1)):
        x1 = torch.randn((w, t, width), generator=gen,
                         device=device).to(torch.bfloat16)
        x2 = torch.randn((w, t, f2), generator=gen,
                         device=device).to(torch.bfloat16)
        x2b = torch.randn((w, t, f2), generator=gen,
                          device=device).to(torch.bfloat16)
        want = fused_cca_decode_reference(params, x1, x2)
        worst = max(worst, require_close(
            torch, 'fused_cca_decode %s bf16' % name,
            fused_cca_decode(params, x1, x2), want, BF16_TOL))
        worst = max(worst, require_close(
            torch, 'fused_cca_decode %s bf16 pair' % name,
            fused_cca_decode(params, x1, x2, x2b),
            torch.stack([want, fused_cca_decode_reference(params, x1, x2b)]),
            BF16_TOL))
    ms, plain_ms = interleaved_ms(
        torch, lambda: fused_cca_decode(folded, x1, x2),
        lambda: fused_cca_decode_reference(folded, x1, x2), reps=10)
    on_device = device_ms(torch, lambda: fused_cca_decode(folded, x1, x2),
                          'fused_cca_decode_mma_kernel')
    floor_ms = time_ms(torch, lambda: torch.sum(x1), reps=10)
    in_bytes = (x1.numel() + x2.numel()) * 2
    limit = bound_ms(in_bytes + param_bytes + w * 4)
    log('phase 3 fused_cca_decode bf16: matches plain at %d x %d x %d + %d '
        '(flagship) and x %d (KULeuven), single and pair; flagship: kernel '
        '%.4f ms (%.0f GB/s), on the device %s, plain %.4f ms, bound %.4f '
        'ms (%.0f%% of the kernel time, %s of the device time), read floor '
        'torch.sum(x1) %.4f ms (%.0f GB/s)'
        % (w, t, f1, f2, ku_f1, ms, in_bytes / ms / 1e6, fmt_ms(on_device),
           plain_ms, limit, 100 * limit / ms,
           'not measured' if on_device is None else
           '%.0f%%' % (100 * limit / on_device), floor_ms,
           x1.numel() * 2 / floor_ms / 1e6))
    # The entry's own numbers are the main paths' call, the float32
    # serving pair at codelab width; the rest under their shapes' names.
    serve = f32['codelab_%d' % SERVE_ROWS]
    result = dict(serve, max_abs_err=worst,
                  bf16_flagship={'ms': ms, 'plain_ms': plain_ms,
                                 'bound_ms': limit, 'device_ms': on_device,
                                 'read_floor_ms': floor_ms})
    result.update({'f32_' + key: t for key, t in f32.items()
                   if key != 'codelab_%d' % SERVE_ROWS})
    return result


def phase_frontend(torch, device):
    """K3 against its plain version at the ingest shape, the gate shape
    of tpu_checks.py and a bucketed (valid_len) call."""
    from telluride_decoding_torch.ops.fused_frontend import (
        fused_envelope_lagstack, fused_envelope_lagstack_reference)
    sizes = KULEUVEN
    ingest_n = sizes['seconds'] * sizes['audio_fs']
    valid_len = 1000000
    cases = [
        ('ingest', ingest_n, float(sizes['audio_fs']),
         float(sizes['frame_rate']), dict(window=1.0, exponent=1.0)),
        ('gate', 10 * 16000, 16000.0, 100.0,
         dict(window=2.0, exponent=float(np.log10(2)), pre=3, post=3)),
        ('valid_len', 1 << 20, 16000.0, 100.0,
         dict(window=2.0, pre=2, post=1, valid_len=valid_len,
              valid_out=int(round(valid_len / 16000 * 100)))),
    ]
    gen = torch.Generator(device=device).manual_seed(3)
    worst, result = 0.0, None
    for name, n, fs_in, fs_out, args in cases:
        audio = torch.randn((n,), generator=gen, device=device)

        def kernel():
            return fused_envelope_lagstack(audio, fs_in, fs_out, **args)

        def plain():
            return fused_envelope_lagstack_reference(audio, fs_in, fs_out,
                                                     **args)
        got = kernel()
        worst = max(worst, require_close(
            torch, 'fused_envelope_lagstack %s' % name, got, plain(),
            K3_TOL))
        ms, plain_ms = interleaved_ms(torch, kernel, plain, reps=10)
        num_bytes = args.get('valid_len', n) * 4 + got.numel() * 4
        limit = bound_ms(num_bytes)
        on_device = device_ms(torch, kernel, 'envelope_lagstack_kernel')
        log('phase 5 fused_envelope_lagstack %s: [%d] %g -> %g Hz %s -> %s;'
            ' kernel %.4f ms (%.0f GB/s), on the device %s, plain %.4f ms, '
            '%.1f MB moved, bound %.4f ms (%.0f%% of the kernel time)'
            % (name, n, fs_in, fs_out, args, tuple(got.shape), ms,
               num_bytes / ms / 1e6, fmt_ms(on_device), plain_ms,
               num_bytes / 1e6, limit, 100 * limit / ms))
        if name == 'ingest':
            result = {'ms': ms, 'plain_ms': plain_ms, 'bound_ms': limit,
                      'bound_by': 'bytes'}
    result['max_abs_err'] = worst
    return result


def phase_sosfilt(torch, device):
    """The streaming EEG highpass on the card vs scipy in float64, at
    the tpu_checks.py gate (4th order 0.5 Hz at 128 Hz, [46080, 64])."""
    import scipy.signal
    from telluride_decoding_torch.signal import filters
    rng = np.random.RandomState(4)
    x = rng.randn(46080, 64).astype(np.float32)
    sos = filters.butter_sos(4, 0.5, 'hp', fs=128.0)
    want, _ = scipy.signal.sosfilt(sos, x.astype(np.float64), axis=0,
                                   zi=np.zeros((sos.shape[0], 2, 64)))
    xt = torch.from_numpy(x).to(device)
    got, _ = filters.sosfilt(sos, xt)
    err = float(np.max(np.abs(got.cpu().numpy() - want)))
    if not err < SOSFILT_TOL:
        raise AssertionError('sosfilt differs from scipy by %g' % err)
    ms = time_ms(torch, lambda: filters.sosfilt(sos, xt), reps=5)
    log('phase 6 sosfilt: [46080, 64] 4th-order 0.5 Hz highpass at 128 Hz: '
        'max abs err %.3g vs scipy float64 (limit %g), %.3f ms on the card'
        % (err, SOSFILT_TOL, ms))


def _speaker(rng, n):
    """A positive, smooth intensity envelope (10 Hz knots at 100 Hz)."""
    raw = np.abs(rng.randn(n // 10 + 2))
    idx = np.linspace(0, raw.shape[0] - 1.001, n)
    lo = idx.astype(int)
    frac = idx - lo
    return ((1 - frac) * raw[lo] + frac * raw[lo + 1]).astype(
        np.float32)[:, None]


def planted_trf(rng, channels):
    """The random TRF (channels x 25 lags) the synthetic EEG is made
    with: the first draw of synthetic_recordings' generator."""
    lags = np.arange(25)
    return rng.randn(channels, lags.size) * np.exp(-lags / 8.0)


def synthetic_recordings(seed, channels, files, frames, stream_frames):
    """Training files (eeg, attended, unattended) and a served stream
    whose attention moves from speaker 1 to speaker 2 at its midpoint."""
    rng = np.random.RandomState(seed)
    trf = planted_trf(rng, channels)

    def eeg(attended):
        n = attended.shape[0]
        clean = np.stack([np.convolve(attended[:, 0], trf[c])[:n]
                          for c in range(channels)], axis=1)
        return (clean + 2.0 * rng.randn(n, channels)).astype(np.float32)
    train = []
    for _ in range(files):
        a1, a2 = _speaker(rng, frames), _speaker(rng, frames)
        train.append((eeg(a1), a1, a2))
    a1, a2 = _speaker(rng, stream_frames), _speaker(rng, stream_frames)
    switch = (np.arange(stream_frames) >= stream_frames // 2)[:, None]
    stream = (eeg(np.where(switch, a2, a1)), a1, a2)
    return train, stream


def write_records(recordings, data_dir):
    """One TFRecord file per (eeg, attended, unattended) recording, with
    the fields eeg, intensity and intensity2."""
    from telluride_decoding_torch.data import records
    for i, (eeg, a1, a2) in enumerate(recordings):
        records.convert_data_to_tfrecords(
            {'eeg': eeg, 'intensity': a1, 'intensity2': a2},
            os.path.join(data_dir, 'trial_%02d.tfrecords' % i))


def brain_data(data_dir, device, in2, frame_rate, contexts, out='intensity',
               **patterns):
    """TFExampleData: eeg (input_1), ``in2`` (input_2) and ``out``
    (output), lag contexts (pre, post, in2 pre, in2 post)."""
    from telluride_decoding_torch.data.brain_data import TFExampleData
    pre, post, pre2, post2 = contexts
    return TFExampleData('eeg', out, frame_rate, pre_context=pre,
                         post_context=post, in2_fields=in2,
                         in2_pre_context=pre2, in2_post_context=post2,
                         data_dir=data_dir, device=device, **patterns)


def stacked_batches(data, mode):
    """(input_dict, output) per file of ``mode``, lag stacked on the
    data's device (kernel K2 on CUDA)."""
    import torch
    from telluride_decoding_torch.ops.lagstack import lag_stack

    def stack(a, pre, post):
        return lag_stack(torch.as_tensor(a, device=data.device), pre, post)
    for _, (in1, in2, out, _) in data.iter_file_arrays(
            mode, temporal_context=False):
        n = min(in1.shape[0], in2.shape[0], out.shape[0])
        yield ({'input_1': stack(in1, data.in1_pre_context,
                                 data.in1_post_context)[:n],
                'input_2': stack(in2, data.in2_pre_context,
                                 data.in2_post_context)[:n]}, out[:n])


def fit_and_save(model_dir, attended, unattended, dims, mode='train'):
    """CCA fit from the attended pairing's files, decoder training on
    unattended vs attended, saved as a model directory; returns times."""
    from telluride_decoding_torch.decode.infer_decoder import CCADecoder
    from telluride_decoding_torch.models.cca import BrainModelCCA
    times = {}
    t0 = time.perf_counter()
    model = BrainModelCCA(cca_dims=dims, regularization_lambda=1e-3,
                          device=attended.device)
    model.fit_streaming(attended, mode)
    times['fit_s'] = time.perf_counter() - t0
    t0 = time.perf_counter()
    decoder = CCADecoder(model, reduction='lda', device=attended.device)
    times['dprime'] = decoder.train(stacked_batches(unattended, mode),
                                    stacked_batches(attended, mode),
                                    window_size=100)
    model.add_metadata({'pre_context': attended.in1_pre_context,
                        'post_context': attended.in1_post_context,
                        'input2_pre_context': attended.in2_pre_context,
                        'input2_post_context': attended.in2_post_context,
                        'dnn_regressor': 'cca'})
    model.save(model_dir)
    decoder.save_parameters(os.path.join(model_dir, 'decoder_model.json'))
    times['train_s'] = time.perf_counter() - t0
    return times


def serve_stream(model_dir, stream, device, frame_rate, extra=()):
    """Serves (eeg, audio1, audio2) through cli.serve.main, with
    ``extra`` flags; returns the decision records, the summary line and
    the serve seconds."""
    from telluride_decoding_torch.cli import serve
    stream_path = os.path.join(model_dir, 'stream.npz')
    out_path = os.path.join(model_dir, 'decisions.jsonl')
    np.savez(stream_path, eeg=stream[0], audio1=stream[1], audio2=stream[2])
    t0 = time.perf_counter()
    serve.main(['--serve_model_dir', model_dir, '--serve_input', stream_path,
                '--serve_output', out_path, '--chunk_size', '32',
                '--serve_window_width', '100', '--serve_window_step', '50',
                '--serve_decoder', 'wta', '--serve_frame_rate',
                str(frame_rate), '--serve_device', str(device),
                *extra])
    seconds = time.perf_counter() - t0
    with open(out_path) as f:
        lines = [json.loads(line) for line in f]
    return [l for l in lines if 'window' in l], lines[-1], seconds


def run_slice(device, model_dir, channels=IN1_CHANNELS, files=TRAIN_FILES,
              frames=TRAIN_FRAMES, stream_frames=STREAM_FRAMES,
              dims=CCA_DIMS, contexts=(PRE, POST, IN2_PRE, IN2_POST)):
    """Codelab path: records, fit, train, save and serve; returns
    (decisions, summary, stream, times)."""
    train, stream = synthetic_recordings(7, channels, files, frames,
                                         stream_frames)
    data_dir = os.path.join(model_dir, 'records')
    shutil.rmtree(data_dir, ignore_errors=True)
    write_records(train, data_dir)
    patterns = dict(train_file_pattern='trial')
    times = fit_and_save(
        model_dir,
        brain_data(data_dir, device, 'intensity', 100, contexts, **patterns),
        brain_data(data_dir, device, 'intensity2', 100, contexts,
                   **patterns), dims)
    decisions, summary, times['serve_s'] = serve_stream(model_dir, stream,
                                                        device, 100)
    return decisions, summary, stream, times


def planted_share(decisions, stream_frames, frame_rate=100.0):
    """Share of windows on the planted side of the stream's midpoint
    switch."""
    switch_s = (stream_frames // 2) / frame_rate
    return sum(d['attend_speaker1'] != (d['time_s'] >= switch_s)
               for d in decisions) / len(decisions)


def check_decisions(decisions, summary, stream_frames=STREAM_FRAMES,
                    frame_rate=100.0):
    """Fraction of windows on the planted side of the switch; raises
    unless it is above 0.9 and every score is finite."""
    if not decisions or summary.get('windows') != len(decisions):
        raise AssertionError('serve produced %d decisions, summary %s'
                             % (len(decisions), summary))
    scores = [d[k] for d in decisions for k in ('score1', 'score2')]
    if not np.all(np.isfinite(scores)):
        raise AssertionError('non-finite served scores')
    correct = planted_share(decisions, stream_frames, frame_rate)
    if correct <= 0.9:
        raise AssertionError('decisions track the switch in only %.3f of '
                             'windows' % correct)
    return correct


def check_against_plain(decisions, model_dir, stream,
                        contexts=(PRE, POST, IN2_PRE, IN2_POST)):
    """Served window scores vs a CPU decode of the same stream with the
    plain versions (the served scores are rounded to 6 decimals)."""
    from telluride_decoding_torch.cli import serve
    from telluride_decoding_torch.ops.lagstack import lag_stack_np
    pre, post, pre2, post2 = contexts
    eeg, a1, a2 = stream
    n = eeg.shape[0] - max(post, post2)
    decoder = serve.load_model(model_dir, 'lda', 'cpu')
    s1, s2 = decoder.infer_pair(lag_stack_np(eeg, pre, post)[:n],
                                lag_stack_np(a1, pre2, post2)[:n],
                                lag_stack_np(a2, pre2, post2)[:n],
                                a1[:n], a2[:n])
    worst = 0.0
    for d in decisions:
        start = d['window'] * 50
        for key, scores in (('score1', s1), ('score2', s2)):
            worst = max(worst, abs(d[key] - float(np.mean(
                scores[start:start + 100]))))
    if worst > SERVE_TOL:
        raise AssertionError('served scores differ from the plain decode by '
                             '%g' % worst)
    return worst


def reset_launches():
    from telluride_decoding_torch.ops.decode_kernel import fused_cca_decode
    from telluride_decoding_torch.ops.fused_frontend import (
        fused_envelope_lagstack)
    from telluride_decoding_torch.ops.lagstack import lag_stack
    from telluride_decoding_torch.ops.ssd_update import (ssd_sequence,
                                                         ssd_update)
    counters = {'fused_cca_decode': fused_cca_decode, 'lag_stack': lag_stack,
                'fused_envelope_lagstack': fused_envelope_lagstack,
                'ssd_update': ssd_update, 'ssd_sequence': ssd_sequence}
    for fn in counters.values():
        fn.launches = 0
    return lambda: {name: fn.launches for name, fn in counters.items()}


def require_launched(launches, names, path):
    for name in names:
        if launches[name] <= 0:
            raise AssertionError('the %s path never launched %s'
                                 % (path, name))


def phase_slice(torch, device, smi):
    model_dir = CODELAB_DIR
    read_launches = reset_launches()
    decisions, summary, stream, times = run_slice(device, model_dir)
    launches = read_launches()
    correct = check_decisions(decisions, summary)
    require_launched(launches, ('lag_stack', 'fused_cca_decode'), 'codelab')
    worst = check_against_plain(decisions, model_dir, stream)
    busy = device_busy(torch, lambda: serve_stream(model_dir, stream, device,
                                                   100))
    log('phase 4 codelab slice: fit %.2f s, train %.2f s (dprime %.2f), '
        'serve %.2f s; %d windows served, %.3f on the planted side of the '
        'switch; latency p50 %.3f ms p95 %.3f ms; served scores within %.2g '
        'of the plain CPU decode; launches %s; profiled serve %s; %s'
        % (times['fit_s'], times['train_s'], times['dprime'],
           times['serve_s'], len(decisions), correct,
           summary['latency_p50_ms'], summary['latency_p95_ms'], worst,
           launches, fmt_busy(busy), smi))
    return launches


def build_kuleuven_cache(cache_dir, seed=5, channels=64, eeg_fs=128,
                         audio_fs=44100, seconds=360, trials=8, tracks=4,
                         **_):
    """A seeded one-subject KULeuven-shaped cache: ``S1.mat`` with
    ``trials`` trials of ``seconds`` of EEG at ``eeg_fs`` (float32), the
    attended ear alternating L/R, and ``tracks`` mono int16 wavs at
    ``audio_fs``: a noise carrier times a slow positive envelope. The
    EEG is the attended track's envelope through a random TRF plus
    noise; in the last trial, the held-out one, it follows the attended
    track for the first half and the other for the second. Returns the
    held-out trial's name."""
    import scipy.io as spio
    import scipy.io.wavfile
    rng = np.random.RandomState(seed)
    os.makedirs(os.path.join(cache_dir, 'stimuli'), exist_ok=True)
    n_eeg, n_audio = seconds * eeg_fs, seconds * audio_fs
    names = ['part%d_track%d' % (k // 2 + 1, k % 2 + 1)
             for k in range(tracks)]
    envelopes = []
    for name in names:
        env = raw_recordings.slow_envelope(rng, n_eeg, eeg_fs)
        envelopes.append(env)
        audio_env = np.interp(np.arange(n_audio) / audio_fs,
                              np.arange(n_eeg) / eeg_fs, env)
        wav = 3000.0 * audio_env * rng.randn(n_audio)
        scipy.io.wavfile.write(
            os.path.join(cache_dir, 'stimuli', name + '.wav'), audio_fs,
            np.clip(wav, -32767, 32767).astype(np.int16))
        del audio_env, wav
    lags = np.arange(16)
    trf = rng.randn(channels, lags.size) * np.exp(-lags / 4.0)
    mat_trials = np.empty((trials,), object)
    for t in range(trials):
        pair = [(2 * t) % tracks, (2 * t + 1) % tracks]
        ear = 'L' if t % 2 == 0 else 'R'
        attended = envelopes[pair[0 if ear == 'L' else 1]]
        if t == trials - 1:
            other = envelopes[pair[1 if ear == 'L' else 0]]
            attended = np.where(np.arange(n_eeg) < n_eeg // 2, attended,
                                other)
        clean = np.stack([np.convolve(attended, trf[c])[:n_eeg]
                          for c in range(channels)], axis=1)
        eeg = (clean + 2.0 * rng.randn(n_eeg, channels)).astype(np.float32)
        mat_trials[t] = {'attended_ear': ear,
                         'stimuli': np.array([names[k] for k in pair],
                                             dtype=object),
                         'RawData': {'EegData': eeg},
                         'FileHeader': {'SampleRate': float(eeg_fs)}}
    spio.savemat(os.path.join(cache_dir, 'S1.mat'),
                 {'preproc_trials': mat_trials})
    return 'S1_T%d' % (trials - 1)


def ingest(cache_dir, tf_dir, device, frame_rate):
    """Runs regression_data.main on the cache; returns its seconds."""
    from telluride_decoding_torch.cli import regression_data
    shutil.rmtree(tf_dir, ignore_errors=True)
    t0 = time.perf_counter()
    rc = regression_data.main(['--type', 'kuleuven', '--cache_dir',
                               cache_dir, '--tf_output_dir', tf_dir,
                               '--desired_frame_rate', str(frame_rate),
                               '--device', str(device)])
    if rc != 0:
        raise AssertionError('regression_data.main returned %d' % rc)
    return time.perf_counter() - t0


def compare_ingests(got_dir, want_dir):
    """Max abs difference over every field of every file of two ingests;
    raises unless the file sets are equal and it is within INGEST_TOL."""
    from telluride_decoding_torch.data import records

    def files(d):
        return sorted(os.path.relpath(os.path.join(root, f), d)
                      for root, _, names in os.walk(d)
                      for f in names if f.endswith('.tfrecords'))
    names = files(got_dir)
    if not names or names != files(want_dir):
        raise AssertionError('ingests wrote different files: %s vs %s'
                             % (names, files(want_dir)))
    worst = 0.0
    for name in names:
        got = records.read_tfrecords(os.path.join(got_dir, name))
        want = records.read_tfrecords(os.path.join(want_dir, name))
        if set(got) != set(want):
            raise AssertionError('%s: fields %s vs %s'
                                 % (name, sorted(got), sorted(want)))
        for k in want:
            if got[k].shape != want[k].shape:
                raise AssertionError('%s:%s shape %s vs %s' % (
                    name, k, got[k].shape, want[k].shape))
            worst = max(worst, float(np.max(np.abs(got[k] - want[k]))))
    if worst > INGEST_TOL:
        raise AssertionError('ingest on %s differs from the CPU ingest by %g'
                             % (got_dir, worst))
    return worst, len(names)


def run_ingest_slice(device, work_dir, compare_device='cpu', **sizes):
    """Ingest path: cache -> TFRecords (on ``device`` and, to compare,
    on ``compare_device``) -> fit -> train -> serve of the held-out
    trial. Returns (decisions, summary, stream, times, launches,
    model_dir), the launches counted over the path on ``device`` alone."""
    from telluride_decoding_torch.data import records
    sizes = dict(KULEUVEN, **sizes)
    rate, contexts = sizes['frame_rate'], sizes['contexts']
    cache_dir = os.path.join(work_dir, 'kuleuven_cache')
    shutil.rmtree(cache_dir, ignore_errors=True)
    t0 = time.perf_counter()
    held_out = build_kuleuven_cache(cache_dir, **sizes)
    times = {'cache_s': time.perf_counter() - t0}
    tf_dir = os.path.join(work_dir, 'kuleuven_tf')
    compare_dir = os.path.join(work_dir, 'kuleuven_tf_' + compare_device)
    times['compare_ingest_s'] = ingest(cache_dir, compare_dir,
                                       compare_device, rate)
    model_dir = os.path.join(work_dir, 'kuleuven_model')
    shutil.rmtree(model_dir, ignore_errors=True)
    read_launches = reset_launches()
    times['ingest_s'] = ingest(cache_dir, tf_dir, device, rate)
    patterns = dict(train_file_pattern='allbut',
                    validate_file_pattern=held_out + r'\.tfrecords',
                    test_file_pattern=held_out + r'\.tfrecords')
    times.update(fit_and_save(
        model_dir,
        brain_data(tf_dir, device, 'intensity', rate, contexts, **patterns),
        brain_data(tf_dir, device, 'intensity2', rate, contexts,
                   **patterns), sizes['dims']))
    held = records.read_tfrecords(os.path.join(tf_dir, 'S1',
                                               held_out + '.tfrecords'))
    stream = (held['eeg'], held['intensity'], held['intensity2'])
    decisions, summary, times['serve_s'] = serve_stream(model_dir, stream,
                                                        device, rate)
    launches = read_launches()
    times['ingest_err'], times['files'] = compare_ingests(tf_dir,
                                                          compare_dir)
    return decisions, summary, stream, times, launches, model_dir


def ingest_split(torch, device, work_dir):
    """Host times of the ingest's parts: the subject's .mat load; on one
    track the wav read, the host-to-device copy of the samples and the
    whole envelope call (copy, K3, copy back); one trial's TFRecord
    write."""
    import scipy.io.wavfile
    from telluride_decoding_torch.cli import regression_data
    from telluride_decoding_torch.data import records
    from telluride_decoding_torch.signal.preprocess import AudioFeatures
    cache = os.path.join(work_dir, 'kuleuven_cache')
    t0 = time.perf_counter()
    regression_data.loadmat(os.path.join(cache, 'S1.mat'))
    loadmat_s = time.perf_counter() - t0
    wav = os.path.join(cache, 'stimuli', 'part1_track1.wav')
    t0 = time.perf_counter()
    fs, data = scipy.io.wavfile.read(wav)
    read_s = time.perf_counter() - t0
    audio = data.astype(np.float32) / 32767.0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.from_numpy(audio).to(device)
    torch.cuda.synchronize()
    h2d_s = time.perf_counter() - t0
    features = AudioFeatures('split', fs, KULEUVEN['frame_rate'],
                             device=device)
    t0 = time.perf_counter()
    features.compute_intensity(audio[:, None])
    envelope_s = time.perf_counter() - t0
    trial = os.path.join(work_dir, 'kuleuven_tf', 'S1', 'S1_T0.tfrecords')
    arrays = records.read_tfrecords(trial)
    t0 = time.perf_counter()
    records.convert_data_to_tfrecords(arrays, os.path.join(
        work_dir, 'split_write.tfrecords'))
    write_s = time.perf_counter() - t0
    return {'loadmat_s': loadmat_s, 'wav_read_s': read_s, 'h2d_s': h2d_s,
            'h2d_bytes': audio.nbytes, 'envelope_s': envelope_s,
            'record_write_s': write_s}


def phase_ingest_slice(torch, device, smi, k3_ms):
    contexts = KULEUVEN['contexts']
    (decisions, summary, stream, times, launches,
     model_dir) = run_ingest_slice(device, BUILD)
    if launches['fused_envelope_lagstack'] != 2 * KULEUVEN['trials']:
        raise AssertionError('the ingest launched K3 %d times, not %d'
                             % (launches['fused_envelope_lagstack'],
                                2 * KULEUVEN['trials']))
    require_launched(launches, ('lag_stack', 'fused_cca_decode'), 'ingest')
    correct = check_decisions(decisions, summary, stream[0].shape[0],
                              KULEUVEN['frame_rate'])
    worst = check_against_plain(decisions, model_dir, stream, contexts)
    split = ingest_split(torch, device, BUILD)
    busy = device_busy(torch, lambda: ingest(
        os.path.join(BUILD, 'kuleuven_cache'),
        os.path.join(BUILD, 'kuleuven_tf_profiled'), device,
        KULEUVEN['frame_rate']))
    width = KULEUVEN['channels'] * (contexts[0] + 1 + contexts[1])
    log('phase 7 ingest slice: cache %.1f s; ingest on the card %.2f s, on '
        'the CPU %.2f s; %d files agree within %.2g; subject .mat load '
        '%.4f s; per track: wav read %.4f s, host-to-device %.4f s (%.1f MB '
        'pageable, %.2f GB/s), K3 %.4f ms, whole envelope call %.4f s; per '
        'trial: TFRecord write %.4f s; profiled ingest %s'
        % (times['cache_s'], times['ingest_s'], times['compare_ingest_s'],
           times['files'], times['ingest_err'], split['loadmat_s'],
           split['wav_read_s'], split['h2d_s'], split['h2d_bytes'] / 1e6,
           split['h2d_bytes'] / split['h2d_s'] / 1e9, k3_ms,
           split['envelope_s'], split['record_write_s'], fmt_busy(busy)))
    log('phase 7 ingest slice: fit at %d + %d columns %.2f s, train %.2f s '
        '(dprime %.2f), serve %.2f s; %d windows served, %.3f on the planted '
        'side of the switch; latency p50 %.3f ms p95 %.3f ms; served scores '
        'within %.2g of the plain CPU decode; launches %s; %s'
        % (width, contexts[2] + 1 + contexts[3], times['fit_s'],
           times['train_s'], times['dprime'], times['serve_s'],
           len(decisions), correct, summary['latency_p50_ms'],
           summary['latency_p95_ms'], worst, launches, smi))
    return launches


def decoding_corpus(data_dir, files=DECODING_FILES, frames=TRAIN_FRAMES,
                    short_dir=None, short_frames=SHORT_FRAMES):
    """The decoding driver's corpus at codelab width: ``files`` seeded
    recordings of ``frames`` frames as TFRecords (trial_00 ..), the last
    the test file; with ``short_dir``, a shorter copy there too: the
    first ``short_frames`` frames of the first two files and of the test
    file."""
    train, _ = synthetic_recordings(8, IN1_CHANNELS, files, frames, 100)
    shutil.rmtree(data_dir, ignore_errors=True)
    write_records(train, data_dir)
    if short_dir:
        from telluride_decoding_torch.data import records
        shutil.rmtree(short_dir, ignore_errors=True)
        os.makedirs(short_dir)
        for i in (0, 1, files - 1):
            eeg, a1, a2 = (a[:short_frames] for a in train[i])
            records.convert_data_to_tfrecords(
                {'eeg': eeg, 'intensity': a1, 'intensity2': a2},
                os.path.join(short_dir, 'trial_%02d.tfrecords' % i))
    return 'trial_%02d' % (files - 1)


def read_results(summary_dir):
    """results.txt's Final_Testing numbers as {name: value}."""
    results = {}
    with open(os.path.join(summary_dir, 'results.txt')) as f:
        for line in f:
            if line.startswith('Final_Testing/'):
                name, value = line.split(': ')
                results[name[len('Final_Testing/'):]] = float(value)
    return results


def run_decoding(kind, data_dir, work_dir, device, test_file,
                 contexts=(PRE, POST, IN2_PRE, IN2_POST), dims=CCA_DIMS,
                 frame_rate=100, extra=()):
    """One run of ``cli.decoding.main``, at codelab width unless told
    otherwise (CCA with the streamed fit, the dense linear fit, or an SGD
    family with the flags' defaults), with ``extra`` flags; returns
    (results.txt as {name: value}, the StageTimer's report, seconds,
    model dir)."""
    import io
    from telluride_decoding_torch.cli import decoding
    pre, post, pre2, post2 = contexts
    summary_dir = os.path.join(work_dir, kind + '_summary')
    model_dir = os.path.join(work_dir, kind + '_model')
    for d in (summary_dir, model_dir):
        shutil.rmtree(d, ignore_errors=True)
    argv = ['--tfexample_dir', data_dir, '--input_field', 'eeg',
            '--output_field', 'intensity', '--attended_field=',
            '--pre_context', str(pre), '--post_context', str(post),
            '--train_file_pattern', 'allbut',
            '--validate_file_pattern', test_file,
            '--test_file_pattern', test_file, '--correlation_frames', '100',
            '--regularization_lambda', '0.001', '--summary_dir',
            summary_dir, '--saved_model_dir', model_dir, '--device',
            str(device), '--dnn_regressor', kind, '--frame_rate',
            str(frame_rate)]
    if kind in ('cca', 'dcca', 'classifier'):
        argv += ['--input2_field', 'intensity', '--input2_pre_context',
                 str(pre2), '--input2_post_context', str(post2),
                 '--cca_dimensions', str(dims)]
    if kind == 'cca':
        argv += ['--streaming_fit']
    argv += list(extra)
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = decoding.main(argv)
    seconds = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError('cli.decoding.main returned %d' % rc)
    text = out.getvalue()
    report = text[text.index('run_decoding_experiment timing:'):].strip()
    results = read_results(summary_dir)
    if not all(np.isfinite(v) for v in results.values()):
        raise AssertionError('%s results.txt has non-finite numbers: %s'
                             % (kind, results))
    return results, report, seconds, model_dir


def window_accuracy(model_dir, data_dir, device, test_file):
    """test_by_window_means over the test file with 100-frame windows,
    once with the attended intensity as input_2 and output, once with
    the unattended one; returns (share of windows where the attended
    stream's mean beats the other's, the number of windows, the decoder,
    the attended dataset)."""
    from telluride_decoding_torch.decode.infer_decoder import create_decoder
    decoder = create_decoder(model_dir, reduction='lda', device=device)
    decoder.load_decoding_model(model_dir)
    decoder.restore_parameters(os.path.join(model_dir, 'decoder_model.json'))
    means, datasets = [], []
    for in2 in ('intensity', 'intensity2'):
        datasets.append(brain_data(
            data_dir, device, in2, 100, (PRE, POST, IN2_PRE, IN2_POST),
            out=in2, test_file_pattern=test_file, final_batch_size=512,
            shuffle_buffer_size=0).create_dataset('test'))
        scores, _ = decoder.test_by_window_means(datasets[-1], 100)
        if not scores.size or not np.all(np.isfinite(scores)):
            raise AssertionError('test_by_window_means gave %d windows, '
                                 'finite: %s' % (scores.size,
                                                 np.all(np.isfinite(scores))))
        means.append(scores)
    return (float(np.mean(means[0] > means[1])), means[0].size, decoder,
            datasets[0])


def time_frame_scores(torch, decoder, dataset):
    """K1 at the driver's evaluation shape: the test split's frames as
    windows of one frame, single form, with the decoder's folded
    parameters; call, host and device ms beside the bound and the
    plain version."""
    from telluride_decoding_torch.ops.decode_kernel import (
        fused_cca_decode, fused_cca_decode_reference)
    in1, in2, _, _ = dataset.all_arrays()
    keep = (in1.shape[0] // dataset.batch_size) * dataset.batch_size
    x1 = decoder._tensor(in1[:keep])[:, None, :]
    x2 = decoder._tensor(in2[:keep])[:, None, :]
    folded = decoder._pipeline.folded
    n, f1, f2 = keep, x1.shape[-1], x2.shape[-1]
    param_bytes = sum(p.numel() * p.element_size() for p in folded)
    want = fused_cca_decode_reference(folded, x1, x2)
    err = require_close(torch, 'fused_cca_decode frame_scores W=%d' % n,
                        fused_cca_decode(folded, x1, x2), want, F32_TOL)

    def call():
        return fused_cca_decode(folded, x1, x2)
    ms, plain_ms = interleaved_ms(
        torch, call, lambda: fused_cca_decode_reference(folded, x1, x2))
    limit, limited_by = bound(
        (x1.numel() + x2.numel()) * 4 + param_bytes + n * 4,
        2 * n * CCA_DIMS * (f1 + f2 + 2))
    return dict(windows=n, frames=1, f1=f1, f2=f2, dims=CCA_DIMS, ms=ms,
                plain_ms=plain_ms, host_ms=host_ms(torch, call),
                device_ms=device_ms(torch, call, F32_SYMBOL),
                bound_ms=limit, bound_by=limited_by, max_abs_err=err)


def fit_seconds(torch, device, data_dir, test_file):
    """The two fits alone at codelab width, timed on the host with the
    card synchronised (the files are in the reader's cache by now): the
    CCA model's streamed fit (K2, moments, solve) and the linear model's
    dense fit, split into the host's lag-stacked train split
    (create_dataset) and the fit (copy to the card, moments, ridge
    solve)."""
    from telluride_decoding_torch.models.brain_model import (
        BrainModelLinearRegression)
    from telluride_decoding_torch.models.cca import BrainModelCCA
    patterns = dict(train_file_pattern='allbut',
                    validate_file_pattern=test_file,
                    test_file_pattern=test_file)
    data = brain_data(data_dir, device, 'intensity', 100,
                      (PRE, POST, IN2_PRE, IN2_POST), **patterns)
    model = BrainModelCCA(data.spec_dataset(), cca_dims=CCA_DIMS,
                          regularization_lambda=1e-3, device=device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.fit_streaming(data, 'train')
    torch.cuda.synchronize()
    times = {'cca_streamed_fit_s': time.perf_counter() - t0}
    data = brain_data(data_dir, device, None, 100, (PRE, POST, 0, 0),
                      **patterns)
    t0 = time.perf_counter()
    train = data.create_dataset('train')
    times['linear_dataset_s'] = time.perf_counter() - t0
    model = BrainModelLinearRegression(data.spec_dataset(), 1e-3,
                                       device=device)
    t0 = time.perf_counter()
    model.fit(train)
    torch.cuda.synchronize()
    times['ridge_fit_s'] = time.perf_counter() - t0
    times['train_frames'] = train.num_frames
    return times


def compare_results(got, want, what):
    """results.txt numbers of the card and the CPU; returns the largest
    absolute difference (d' relative)."""
    if set(got) != set(want):
        raise AssertionError('%s: results %s vs %s' % (what, got, want))
    worst = {'numbers': 0.0, 'dprime': 0.0}
    for key, value in want.items():
        if key == 'dprime':
            worst['dprime'] = max(worst['dprime'],
                                  abs(got[key] - value) / abs(value))
        else:
            worst['numbers'] = max(worst['numbers'], abs(got[key] - value))
    if worst['numbers'] > RESULTS_TOL or worst['dprime'] > DPRIME_REL_TOL:
        raise AssertionError('%s: card %s vs CPU %s differ by %s' % (
            what, got, want, worst))
    return worst


def phase_decoding(torch, device, smi):
    """The experiment driver at codelab width: a CCA model with the
    streamed fit (K2) and a linear model with the dense fit, each from
    TFRecords to results.txt, the model and decoder_model.json; then
    the saved CCA decoder over the test file by 100-frame window means
    (K1, one launch a call). Then the card against the CPU: both runs on
    a shorter copy of the corpus on each, and the card's frame scores
    against the CPU's plain decode of the same model."""
    from telluride_decoding_torch.cli import serve
    start = time.perf_counter()
    work = DECODING_DIR
    data_dir = os.path.join(work, 'records')
    short_dir = os.path.join(work, 'records_short')
    test_file = decoding_corpus(data_dir, short_dir=short_dir)
    runs = {}
    read_launches = reset_launches()
    for kind in ('cca', 'linear'):
        runs[kind] = run_decoding(kind, data_dir, work, device, test_file)
    correct, windows, decoder, attended = window_accuracy(
        runs['cca'][3], data_dir, device, test_file)
    launches = read_launches()
    require_launched(launches, ('lag_stack', 'fused_cca_decode'),
                     'decoding')
    for kind, (results, _, _, _) in runs.items():
        if not results.get('dprime', 0.0) > 1.0:
            raise AssertionError('%s: dprime %s is not above 1'
                                 % (kind, results.get('dprime')))
    if correct <= 0.9:
        raise AssertionError('the attended stream wins only %.3f of the '
                             'windows' % correct)
    # The card's frame scores (K1) against the plain decode on the CPU.
    cpu_data = brain_data(data_dir, 'cpu', 'intensity', 100,
                          (PRE, POST, IN2_PRE, IN2_POST),
                          test_file_pattern=test_file, final_batch_size=512,
                          shuffle_buffer_size=0)
    card_scores, _ = decoder.frame_scores(attended)
    cpu_scores, _ = serve.load_model(runs['cca'][3], 'lda', 'cpu') \
        .frame_scores(cpu_data.create_dataset('test'))
    score_err = float(np.max(np.abs(card_scores - cpu_scores)))
    if card_scores.shape != cpu_scores.shape or score_err > SERVE_TOL:
        raise AssertionError('frame scores on the card differ from the CPU '
                             'plain decode by %g' % score_err)
    k1 = time_frame_scores(torch, decoder, attended)
    fits = fit_seconds(torch, device, data_dir, test_file)
    short = {}
    for kind in ('cca', 'linear'):
        card, card_report, card_s, _ = run_decoding(
            kind, short_dir, work + '_card', device, test_file)
        cpu, cpu_report, cpu_s, _ = run_decoding(
            kind, short_dir, work + '_cpu', 'cpu', test_file)
        short[kind] = dict(compare_results(card, cpu, kind + ' short copy'),
                           card_s=card_s, cpu_s=cpu_s,
                           reports={'card': card_report, 'CPU': cpu_report})
    for kind, (results, report, seconds, _) in runs.items():
        log('phase 8 decoding %s (%s fit) on the card: %.2f s; results %s'
            % (kind, 'streamed' if kind == 'cca' else 'dense', seconds,
               json.dumps(results)))
        for line in report.splitlines()[1:]:
            log('phase 8 decoding %s stage %s' % (kind, line.strip()))
    log('phase 8 decoding: test_by_window_means over %s, 100-frame '
        'windows: the attended stream wins %.3f of %d windows; card frame '
        'scores within %.2g of the CPU plain decode; launches %s'
        % (test_file, correct, windows, score_err, launches))
    log('phase 8 fused_cca_decode float32 frame_scores single W=%d T=1 '
        '%d + %d D %d: call %.4f ms, host %.4f ms, on the device %s, plain '
        '%.4f ms, bound %.4f ms (%s), max abs err %.3g'
        % (k1['windows'], k1['f1'], k1['f2'], k1['dims'], k1['ms'],
           k1['host_ms'], fmt_ms(k1['device_ms']), k1['plain_ms'],
           k1['bound_ms'], k1['bound_by'], k1['max_abs_err']))
    log('phase 8 fits alone (%d train frames): CCA streamed fit %.3f s; '
        'linear: lag-stacked train split on the host %.3f s, ridge fit '
        '(copy, moments, solve) %.3f s'
        % (fits['train_frames'], fits['cca_streamed_fit_s'],
           fits['linear_dataset_s'], fits['ridge_fit_s']))
    for kind, t in short.items():
        log('phase 8 decoding %s short copy (2 x %d train + %d test '
            'frames): card %.2f s, CPU %.2f s; results.txt numbers within '
            '%.3g, dprime within %.3g relative'
            % (kind, SHORT_FRAMES, SHORT_FRAMES, t['card_s'], t['cpu_s'],
               t['numbers'], t['dprime']))
        for where, report in t['reports'].items():
            log('phase 8 decoding %s short copy stages on the %s: %s'
                % (kind, where, '; '.join(
                    ' '.join(line.split()[:3])
                    for line in report.splitlines()[1:])))
    log('phase 8 decoding: %.1f s in all; %s'
        % (time.perf_counter() - start, smi))
    return launches, k1


def sweep_corpus(data_dir, short_dir, seed=9):
    """The sweep's corpus: SWEEP_FILES seeded recordings of SWEEP_FRAMES
    frames as TFRecords, and its short copy (the first files' first
    frames); returns the held-out r of the planted TRF's matched filter,
    the mean over files of corr(sum_c sum_k trf[c, k] eeg[t + k, c],
    intensity[t]). That decoder is linear in the 37-lag EEG window (its
    lags reach 24), and a (lag 0 intensity, matched filter) pair is in
    the CCA's spaces, so the best lambda's mean held-out r of either
    sweep should reach it, less a little for the fit's estimation error
    (SWEEP_MARGIN)."""
    from telluride_decoding_torch.data import records
    train, _ = synthetic_recordings(seed, IN1_CHANNELS, SWEEP_FILES,
                                    SWEEP_FRAMES, 100)
    trf = planted_trf(np.random.RandomState(seed), IN1_CHANNELS)
    shutil.rmtree(data_dir, ignore_errors=True)
    write_records(train, data_dir)
    files, frames, _ = SWEEP_SHORT
    shutil.rmtree(short_dir, ignore_errors=True)
    os.makedirs(short_dir)
    for i in range(files):
        eeg, a1, a2 = (a[:frames] for a in train[i])
        records.convert_data_to_tfrecords(
            {'eeg': eeg, 'intensity': a1, 'intensity2': a2},
            os.path.join(short_dir, 'trial_%02d.tfrecords' % i))
    return float(np.mean([raw_recordings.matched_filter_r(eeg, a1[:, 0],
                                                          trf)
                          for eeg, a1, _ in train]))


def run_regression(torch, test_name, data_dir, work_dir, device, post,
                   device_context=True):
    """One run of ``cli.regression.main`` over the lambda grid; returns
    the CSV's [lambdas, files] grid, seconds, the driver's stage report,
    K2's launches and the card's peak allocation."""
    import io
    from telluride_decoding_torch.cli import regression
    from telluride_decoding_torch.ops.lagstack import lag_stack
    summary_dir = os.path.join(work_dir, test_name + '_summary')
    csv_file = os.path.join(work_dir, test_name + '.csv')
    shutil.rmtree(summary_dir, ignore_errors=True)
    argv = ['--tfexample_dir', data_dir, '--test_name', test_name,
            '--post_context', str(post), '--regularization_list',
            ','.join(repr(float(l)) for l in SWEEP_LAMBDAS),
            '--summary_base_dir', summary_dir, '--results_csv_file',
            csv_file, '--device', str(device)]
    on_card = torch.device(device).type == 'cuda'
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    before = lag_stack.launches
    out = io.StringIO()
    t0 = time.perf_counter()
    with environ(TDT_DEVICE_CONTEXT='1' if device_context else '0'), \
            contextlib.redirect_stdout(out):
        rc = regression.main(argv)
    seconds = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError('cli.regression.main returned %d' % rc)
    text = out.getvalue()
    grid = np.loadtxt(csv_file, delimiter=',', ndmin=2)[:, 1:]
    if not np.all(np.isfinite(grid)):
        raise AssertionError('%s: the grid has non-finite correlations'
                             % test_name)
    return dict(grid=grid, seconds=seconds,
                report=text[text.index('jackknife_over_regularizations '
                                       'timing:'):].strip(),
                launches=lag_stack.launches - before,
                peak_gb=(torch.cuda.max_memory_allocated() / 1e9
                         if on_card else None))


def grid_seconds(torch, device, data_dir):
    """The grid programs alone on the codelab sweep's moments, timed on
    the host with the card synchronised: ridge at 9 lambdas through the
    Cholesky path and through the eig path (force_eig), the evidence for
    the 24-lambda switch on the card, and the same for CCA; each twice,
    and the largest difference between the two paths' grids."""
    from telluride_decoding_torch.cli import decoding, regression
    from telluride_decoding_torch.ops.covariance import MomentStats
    from telluride_decoding_torch.sweep import engine
    lam = torch.as_tensor(np.float32(SWEEP_LAMBDAS), device=device)
    out = {}
    for test_name, fast, slow in (
            ('jens_memory_linear', engine._ridge_sweep_program,
             engine._ridge_eig_program),
            ('jens_memory_cca', engine._cca_sweep_program_chol,
             engine._cca_sweep_program)):
        opts = decoding.DecodingOptions(tfexample_dir=data_dir,
                                        post_context=POST)
        preset = regression.select_regression_object(test_name, opts,
                                                      device=device)
        preset.preset_flags()
        data = regression.get_brain_data_object(opts, device)
        xs, ys, ctx = preset._per_file_raw(data, sorted(data.all_files()))
        stats = engine.per_file_stats(xs, ys, True, context=ctx,
                                      device=device)
        total = MomentStats(*(s.sum(0) for s in stats))
        grids = {}
        for path, program in (('cholesky', fast), ('eig', slow)):
            seconds = []
            for _ in range(2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                grids[path] = program(stats, total, lam).cpu().numpy()
                seconds.append(time.perf_counter() - t0)
            out['%s_%s_s' % (opts.dnn_regressor, path)] = seconds
        out['%s_paths_differ' % opts.dnn_regressor] = float(
            np.max(np.abs(grids['cholesky'] - grids['eig'])))
        del stats, total
    return out


def fmt_gb(gb):
    return 'not measured' if gb is None else '%.2f GB' % gb


def stage_line(report):
    return '; '.join(' '.join(line.split()[:3])
                     for line in report.splitlines()[1:])


def phase_sweep(torch, device, smi):
    """The jackknife x lambda sweep at the codelab's full width through
    ``cli.regression.main``: 360 ridge fits (jens_memory_linear) and 360
    CCA fits (jens_memory_cca, intensity lags 15/15, 5 dimensions) over
    40 files of 3300 frames at 69 x 37 = 2553 EEG columns, raw channels
    to the card and each file lag-stacked there by K2. Gates: K2
    launched in both runs, finite grids, the best lambda's mean r above
    the planted matched filter's less SWEEP_MARGIN, the card within
    SWEEP_TOL of the CPU on a short copy and of host lag stacking
    (TDT_DEVICE_CONTEXT=0) at full width."""
    start = time.perf_counter()
    work = os.path.join(BUILD, 'sweep')
    data_dir = os.path.join(work, 'records')
    short_dir = os.path.join(work, 'records_short')
    matched_r = sweep_corpus(data_dir, short_dir)
    threshold = matched_r - SWEEP_MARGIN
    runs = {}
    read_launches = reset_launches()
    for test_name in ('jens_memory_linear', 'jens_memory_cca'):
        runs[test_name] = run_regression(torch, test_name, data_dir, work,
                                         device, POST)
    launches = read_launches()
    for test_name, run in runs.items():
        require_launched({'lag_stack': run['launches']}, ('lag_stack',),
                         test_name + ' sweep')
        best = float(np.max(np.mean(run['grid'], axis=1)))
        run['best_mean_r'] = best
        if run['grid'].shape != (SWEEP_LAMBDAS.size, SWEEP_FILES):
            raise AssertionError('%s: grid shape %s'
                                 % (test_name, run['grid'].shape))
        if not best > threshold:
            raise AssertionError(
                '%s: best mean held-out r %.4f is not above %.4f (the '
                'matched filter %.4f less %g)' % (test_name, best,
                                                  threshold, matched_r,
                                                  SWEEP_MARGIN))
        host = run_regression(torch, test_name, data_dir, work + '_host',
                              device, POST, device_context=False)
        run['host'] = host
        run['host_differs'] = float(np.max(np.abs(host['grid'] -
                                                  run['grid'])))
        if run['host_differs'] > SWEEP_TOL:
            raise AssertionError('%s: device context and host stacking '
                                 'differ by %g' % (test_name,
                                                   run['host_differs']))
        files, frames, post = SWEEP_SHORT
        card = run_regression(torch, test_name, short_dir, work + '_card',
                              device, post)
        cpu = run_regression(torch, test_name, short_dir, work + '_cpu',
                             'cpu', post)
        run['short'] = dict(card=card, cpu=cpu, differs=float(
            np.max(np.abs(card['grid'] - cpu['grid']))))
        if run['short']['differs'] > SWEEP_TOL:
            raise AssertionError('%s short copy: card and CPU grids differ '
                                 'by %g' % (test_name,
                                            run['short']['differs']))
    grids = grid_seconds(torch, device, data_dir)
    for test_name, run in runs.items():
        log('phase 9 sweep %s: %d lambdas x %d files at %d columns on the '
            'card: %.2f s (%s); best mean held-out r %.4f (gate %.4f: the '
            'planted matched filter %.4f less %g); K2 launches %d; peak '
            'allocated %s; %s'
            % (test_name, SWEEP_LAMBDAS.size, SWEEP_FILES,
               IN1_CHANNELS * (PRE + 1 + POST), run['seconds'],
               stage_line(run['report']), run['best_mean_r'], threshold,
               matched_r, SWEEP_MARGIN, run['launches'],
               fmt_gb(run['peak_gb']), smi))
        log('phase 9 sweep %s host-stacked (TDT_DEVICE_CONTEXT=0): %.2f s '
            '(%s); peak allocated %s; grid within %.3g of the device '
            'context run; %s'
            % (test_name, run['host']['seconds'],
               stage_line(run['host']['report']),
               fmt_gb(run['host']['peak_gb']), run['host_differs'], smi))
        short = run['short']
        log('phase 9 sweep %s short copy (%d files x %d frames, post %d): '
            'card %.2f s (%s), CPU %.2f s (%s); grids within %.3g; %s'
            % ((test_name,) + SWEEP_SHORT +
               (short['card']['seconds'], stage_line(short['card']['report']),
                short['cpu']['seconds'], stage_line(short['cpu']['report']),
                short['differs'], smi)))
    log('phase 9 grid programs alone at 9 lambdas (two runs each): ridge '
        'Cholesky %s s, ridge eig (force_eig) %s s, paths within %.3g; '
        'CCA Cholesky %s s, CCA eig %s s, paths within %.3g; %s'
        % (['%.3f' % t for t in grids['linear_cholesky_s']],
           ['%.3f' % t for t in grids['linear_eig_s']],
           grids['linear_paths_differ'],
           ['%.3f' % t for t in grids['cca_cholesky_s']],
           ['%.3f' % t for t in grids['cca_eig_s']],
           grids['cca_paths_differ'], smi))
    log('phase 9 sweep: %.1f s in all; launches %s; %s'
        % (time.perf_counter() - start, launches, smi))
    return launches


def cohort_corpus(root, short_root, subjects=COHORT_SUBJECTS,
                  trials=COHORT_TRIALS):
    """The cohort's corpus as TFRecords: ``subjects`` subjects
    (subj00, ...) of ``trials`` trials, trial t of 3300 - (t mod 5) *
    37 frames of 69-channel white EEG and intensity = the EEG's 37-lag
    stack times a seeded TRF plus noise (the geometry of
    examples/make_synthetic_cohort.py; the response is summed lag by lag,
    so no [frames, 2553] stack is made); and the short copy, the first
    frames of the first trials of the first subjects. Returns the mean
    over trials of the planted TRF's r (corr(response, intensity)), the
    matched filter's, and the corpus's bytes on disk."""
    from telluride_decoding_torch.data import records
    lags = PRE + 1 + POST
    weights = (np.random.RandomState(0).randn(IN1_CHANNELS * lags, 1)
               / np.sqrt(IN1_CHANNELS * lags)).astype(np.float32)
    weights = weights.reshape(lags, IN1_CHANNELS)
    short_subjects, short_trials, short_frames, _ = COHORT_SHORT
    shutil.rmtree(root, ignore_errors=True)
    shutil.rmtree(short_root, ignore_errors=True)
    rs, nbytes = [], 0
    for s in range(subjects):
        rng = np.random.RandomState(100 + s)
        name = 'subj%02d' % s
        os.makedirs(os.path.join(root, name))
        for t in range(trials):
            frames = SWEEP_FRAMES - (t % 5) * lags
            eeg = rng.randn(frames, IN1_CHANNELS).astype(np.float32)
            padded = np.concatenate(
                [eeg, np.zeros((lags - 1, IN1_CHANNELS), np.float32)])
            response = sum(padded[k:k + frames] @ weights[k]
                           for k in range(lags))
            intensity = (response + COHORT_NOISE * rng.randn(frames)
                         ).astype(np.float32)[:, None]
            rs.append(np.corrcoef(response, intensity[:, 0])[0, 1])
            path = os.path.join(root, name, 'trial%02d.tfrecords' % t)
            records.convert_data_to_tfrecords(
                {'eeg': eeg, 'intensity': intensity}, path)
            nbytes += os.path.getsize(path)
            if s < short_subjects and t < short_trials:
                os.makedirs(os.path.join(short_root, name), exist_ok=True)
                records.convert_data_to_tfrecords(
                    {'eeg': eeg[:short_frames],
                     'intensity': intensity[:short_frames]},
                    os.path.join(short_root, name,
                                 'trial%02d.tfrecords' % t))
    return float(np.mean(rs)), nbytes


def cohort_argv(post):
    """The model flags of a ridge cohort run over the lambda grid."""
    return ['--input_field', 'eeg', '--output_field', 'intensity',
            '--post_context', str(post), '--regularization_list',
            ','.join(repr(float(l)) for l in SWEEP_LAMBDAS)]


def read_cohort_outputs(work, names):
    """The cohort CSV's [lambdas, 3] rows and each subject's [lambdas,
    trials] grid from its CSV (float32 values in shortest repr, so equal
    grids read back equal)."""
    summary = np.loadtxt(os.path.join(work, 'cohort.csv'), delimiter=',',
                         skiprows=1, ndmin=2)
    grids = {name: np.loadtxt(os.path.join(work, 'subject_%s.csv' % name),
                              delimiter=',', ndmin=2)[:, 1:]
             for name in names}
    return summary, grids


def run_cohort(torch, subjects, work, device, post=POST, extra=(),
               environment=None):
    """One in-process run of ``cli.cohort.main`` over ``subjects`` (a
    {name: dir} dict, passed as --subject_dir); returns its outputs, the
    printed table, seconds, K2's launches and the card's peak
    allocation."""
    import io
    from telluride_decoding_torch.cli import cohort
    from telluride_decoding_torch.ops.lagstack import lag_stack
    shutil.rmtree(work, ignore_errors=True)
    argv = [a for d in subjects.values() for a in ('--subject_dir', d)]
    argv += cohort_argv(post) + list(extra) + [
        '--cohort_csv_file', os.path.join(work, 'cohort.csv'),
        '--results_csv_file', os.path.join(work, 'subject.csv'),
        '--device', str(device)]
    on_card = torch.device(device).type == 'cuda'
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    before = lag_stack.launches
    out = io.StringIO()
    t0 = time.perf_counter()
    with environ(**(environment or {})), contextlib.redirect_stdout(out):
        rc = cohort.main(argv)
    seconds = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError('cli.cohort.main returned %d' % rc)
    text = out.getvalue()
    table = text[text.index('Cohort sweep over'):].strip()
    summary, grids = read_cohort_outputs(work, subjects)
    for name, grid in grids.items():
        if not np.all(np.isfinite(grid)):
            raise AssertionError('cohort subject %s: non-finite '
                                 'correlations' % name)
    return dict(summary=summary, grids=grids, table=table, seconds=seconds,
                launches=lag_stack.launches - before,
                peak_gb=(torch.cuda.max_memory_allocated() / 1e9
                         if on_card else None))


def run_partitions(subjects, work, device, count=2):
    """``count`` processes of ``python -m telluride_decoding_torch.cli.
    cohort --num_partitions count`` on the one card, started together and
    joined through part files by partition 0; returns partition 0's
    cohort CSV rows, its stdout and the seconds until both ended."""
    shutil.rmtree(work, ignore_errors=True)
    base = [sys.executable, '-m', 'telluride_decoding_torch.cli.cohort']
    base += [a for d in subjects.values() for a in ('--subject_dir', d)]
    base += cohort_argv(POST) + [
        '--device', str(device), '--num_partitions', str(count),
        '--partition_dir', os.path.join(work, 'parts')]
    env = dict(os.environ, PYTHONPATH=REPO)
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        base + ['--partition_index', str(i), '--cohort_csv_file',
                os.path.join(work, 'cohort_%d.csv' % i)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for i in range(count)]
    try:
        outs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    seconds = time.perf_counter() - t0
    for i, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError('partition %d exited %d:\n%s'
                                 % (i, p.returncode, out[-3000:]))
    if 'Cohort sweep over %d partitions' % count not in outs[0]:
        raise AssertionError('partition 0 printed no joined summary:\n%s'
                             % outs[0][-3000:])
    summary = np.loadtxt(os.path.join(work, 'cohort_0.csv'), delimiter=',',
                         skiprows=1, ndmin=2)
    return summary, outs[0], seconds


def cohort_options():
    """The linear cohort's DecodingOptions and lambdas, as cli.cohort.main
    parses them."""
    from telluride_decoding_torch.cli import cohort, decoding, regression
    args = cohort.build_parser().parse_args(cohort_argv(POST))
    opts = decoding.DecodingOptions().set_flags(args)
    opts.dnn_regressor = 'linear'
    return opts, regression.parse_regularization_values(
        args.regularization_list)


def cohort_subject_stages(device, name, data_dir, pads):
    """One subject of the cohort swept alone, unpipelined, with its
    stages timed (read: the prefetch worker's TFRecord load; moments and
    grid with the card synchronised): the per-subject cost the pipelined
    run's wall time is held against. Returns the stage seconds and the
    grid."""
    from telluride_decoding_torch.cli import cohort
    from telluride_decoding_torch.sweep import engine
    from telluride_decoding_torch.utils.profiling import StageTimer
    opts, lambdas = cohort_options()
    timer = StageTimer('cohort subject')
    with timer.stage('read'):
        _, (xs, ys) = cohort._load_subject(name, data_dir, opts, True, 'cpu')
    result = engine.ridge_jackknife_sweep(
        xs, ys, lambdas, context=cohort.cohort_context(opts),
        pad_files_to=pads[0], pad_frames_to=pads[1], device=device,
        timer=timer)
    return timer.as_dict(), result.correlations


def sweep_preloaded(torch, device, subjects):
    """The cohort loaded eagerly (timed), then the pipelined
    ``multi_subject_sweep`` over the loaded arrays with no reading thread
    beside it (timed with the card synchronised): what the pipeline costs
    when no read competes with it. Returns both seconds and the grids."""
    from telluride_decoding_torch.cli import cohort
    from telluride_decoding_torch.sweep import engine
    opts, lambdas = cohort_options()
    t0 = time.perf_counter()
    loaded, context = cohort.load_cohort(subjects, opts, device)
    load_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = engine.multi_subject_sweep(loaded, lambdas, context=context,
                                         device=device)
    torch.cuda.synchronize()
    return load_s, time.perf_counter() - t0, {
        name: res.correlations for name, res in results.items()}


def max_grid_diff(got, want):
    """The largest difference between ``got``'s grids and ``want``'s
    grids of the same subjects."""
    return max(float(np.max(np.abs(got[name] - want[name])))
               for name in got)


def phase_cohort(torch, device, smi):
    """The whole-cohort sweep at the codelab's full width through
    ``cli.cohort.main``: 22 subjects x 40 trials, 9 lambdas (7,920 ridge
    fits) at 69 x 37 = 2553 columns, raw channels to the card and each
    trial lag-stacked there by K2. Gates: K2 launched once a trial, finite
    grids of every subject, the best lambda's cohort mean r above the
    planted matched filter's less SWEEP_MARGIN. On the first COHORT_FEW
    subjects: eager loading bit-identical to streaming, a CCA cohort
    (the jens_memory_cca fields; finite, above the same gate), two
    partition processes whose joined cohort CSV is within PARTITION_TOL
    of the single run's, and host lag stacking (TDT_DEVICE_CONTEXT=0, on
    COHORT_HOST subjects) within SWEEP_TOL; the short copy on card and
    CPU within SWEEP_TOL."""
    from telluride_decoding_torch.cli import cohort, decoding
    start = time.perf_counter()
    work = os.path.join(BUILD, 'cohort')
    root = os.path.join(work, 'records')
    short_root = os.path.join(work, 'records_short')
    t0 = time.perf_counter()
    matched_r, nbytes = cohort_corpus(root, short_root)
    corpus_s = time.perf_counter() - t0
    threshold = matched_r - SWEEP_MARGIN
    log('phase 10 cohort corpus: %d subjects x %d trials, %.1f MB of '
        'TFRecords written in %.1f s; planted matched filter r %.4f'
        % (COHORT_SUBJECTS, COHORT_TRIALS, nbytes / 1e6, corpus_s,
           matched_r))
    subjects = cohort.discover_subjects(root, [])
    names = list(subjects)

    read_launches = reset_launches()
    main = run_cohort(torch, subjects, os.path.join(work, 'linear'), device)
    launches = read_launches()
    require_launched(launches, ('lag_stack',), 'cohort')
    if main['launches'] != COHORT_SUBJECTS * COHORT_TRIALS:
        raise AssertionError('cohort: K2 launched %d times for %d trials'
                             % (main['launches'],
                                COHORT_SUBJECTS * COHORT_TRIALS))
    if not main['table'].startswith('Cohort sweep over %d subjects, %d '
                                    'lambdas:' % (COHORT_SUBJECTS,
                                                  SWEEP_LAMBDAS.size)):
        raise AssertionError('cohort table: %s' % main['table'])
    for name, grid in main['grids'].items():
        if grid.shape != (SWEEP_LAMBDAS.size, COHORT_TRIALS):
            raise AssertionError('cohort %s: grid shape %s'
                                 % (name, grid.shape))
    best = float(np.max(main['summary'][:, 1]))
    if not best > threshold:
        raise AssertionError(
            'cohort: best mean held-out r %.4f is not above %.4f (the '
            'matched filter %.4f less %g)' % (best, threshold, matched_r,
                                              SWEEP_MARGIN))
    pads = cohort.prescan_cohort(
        subjects, decoding.DecodingOptions(input_field='eeg',
                                           output_field='intensity'))
    stages, alone = cohort_subject_stages(device, names[0],
                                          subjects[names[0]], pads)
    alone_differs = float(np.max(np.abs(alone - main['grids'][names[0]])))
    if alone_differs > SWEEP_TOL:
        raise AssertionError('cohort: subject %s swept alone differs from '
                             'its cohort grid by %g' % (names[0],
                                                        alone_differs))
    per_subject = sum(stages.values())
    load_s, sweep_s, preloaded = sweep_preloaded(torch, device, subjects)
    preloaded_differs = max_grid_diff(preloaded, main['grids'])
    if preloaded_differs > SWEEP_TOL:
        raise AssertionError('cohort: the sweep of the preloaded cohort '
                             'differs by %g' % preloaded_differs)
    busy = device_busy(torch, lambda: run_cohort(
        torch, subjects, os.path.join(work, 'linear_profiled'), device))
    log('phase 10 cohort linear: %d subjects x %d trials x %d lambdas = %d '
        'ridge fits at %d columns on the card: %.2f s; one subject alone '
        '(unpipelined): read %.1f ms, moments %.1f ms, grid %.1f ms, so %d '
        'subjects in series %.2f s (the pipelined run takes %.3f of it); '
        'the cohort loaded first in %.2f s, then swept in %.2f s with no '
        'reading thread (grids within %.3g); '
        'profiled rerun %s; peak allocated %s; K2 launches %d; best mean '
        'held-out r %.4f (gate %.4f: the planted matched filter %.4f less '
        '%g); subject %s alone within %.3g of its cohort grid; %s'
        % (COHORT_SUBJECTS, COHORT_TRIALS, SWEEP_LAMBDAS.size,
           COHORT_SUBJECTS * COHORT_TRIALS * SWEEP_LAMBDAS.size,
           IN1_CHANNELS * (PRE + 1 + POST), main['seconds'],
           1e3 * stages['read'], 1e3 * stages['moments'],
           1e3 * stages['grid'], COHORT_SUBJECTS,
           COHORT_SUBJECTS * per_subject,
           main['seconds'] / (COHORT_SUBJECTS * per_subject), load_s,
           sweep_s, preloaded_differs, fmt_busy(busy), fmt_gb(main['peak_gb']), main['launches'], best,
           threshold, matched_r, SWEEP_MARGIN, names[0], alone_differs,
           smi))

    few = {name: subjects[name] for name in names[:COHORT_FEW]}
    stream = run_cohort(torch, few, os.path.join(work, 'few_stream'),
                        device)
    eager = run_cohort(torch, few, os.path.join(work, 'few_eager'), device,
                       extra=['--nostreaming_cohort'])
    for name in few:
        if not np.array_equal(stream['grids'][name], eager['grids'][name]):
            raise AssertionError(
                'cohort subject %s: eager and streaming grids differ by %g'
                % (name, float(np.max(np.abs(stream['grids'][name] -
                                             eager['grids'][name])))))
    if not np.array_equal(stream['summary'], eager['summary']):
        raise AssertionError('cohort CSV: eager and streaming differ')
    log('phase 10 cohort %d subjects, streaming against --nostreaming_'
        'cohort: bit-identical grids and cohort CSV; streaming %.2f s '
        '(peak %s), eager %.2f s (peak %s); %s'
        % (COHORT_FEW, stream['seconds'], fmt_gb(stream['peak_gb']),
           eager['seconds'], fmt_gb(eager['peak_gb']), smi))

    cca = run_cohort(torch, few, os.path.join(work, 'few_cca'), device,
                     extra=['--dnn_regressor', 'cca', '--input2_field',
                            'intensity', '--input2_pre_context', '15',
                            '--input2_post_context', '15',
                            '--output_field', 'eeg', '--cca_dimensions',
                            '5'])
    cca_best = float(np.max(cca['summary'][:, 1]))
    if cca['launches'] != 2 * COHORT_FEW * COHORT_TRIALS:
        raise AssertionError('CCA cohort: K2 launched %d times'
                             % cca['launches'])
    if not cca_best > threshold:
        raise AssertionError('CCA cohort: best mean held-out r %.4f is not '
                             'above %.4f' % (cca_best, threshold))
    log('phase 10 cohort CCA (jens_memory_cca fields, intensity lags '
        '15/15, %d subjects): %d fits in %.2f s; best mean held-out r %.4f '
        '(gate %.4f); K2 launches %d; peak allocated %s; %s'
        % (COHORT_FEW, COHORT_FEW * COHORT_TRIALS * SWEEP_LAMBDAS.size,
           cca['seconds'], cca_best, threshold, cca['launches'],
           fmt_gb(cca['peak_gb']), smi))

    joined, _, part_s = run_partitions(few, os.path.join(work, 'parts'),
                                       device)
    joined_differs = float(np.max(np.abs(joined - stream['summary'])))
    # The JAX suite's own criterion for its partitioned driver
    # (assert_allclose: atol 1e-6 and its default rtol 1e-7, which
    # admits a flip of the sixth significant digit %g prints).
    if not np.allclose(joined, stream['summary'], rtol=1e-7,
                       atol=PARTITION_TOL):
        raise AssertionError('partitioned cohort CSV differs from the '
                             'single run by %g' % joined_differs)
    log('phase 10 cohort partitioned: 2 processes of python -m '
        'telluride_decoding_torch.cli.cohort on the one card, %d subjects, '
        'joined through part files in %.2f s (process start included); '
        'cohort CSV within %.3g of the single run (limit %g + 1e-7 '
        'relative); %s' % (COHORT_FEW, part_s, joined_differs,
                           PARTITION_TOL, smi))

    two = {name: subjects[name] for name in names[:COHORT_HOST]}
    host = run_cohort(torch, two, os.path.join(work, 'host'), device,
                      environment={'TDT_DEVICE_CONTEXT': '0'})
    host_differs = max_grid_diff(host['grids'], stream['grids'])
    if host_differs > SWEEP_TOL:
        raise AssertionError('cohort: host stacking and device context '
                             'differ by %g' % host_differs)
    log('phase 10 cohort host-stacked (TDT_DEVICE_CONTEXT=0, %d subjects): '
        '%.2f s, peak allocated %s; grids within %.3g of the device '
        'context run; %s' % (COHORT_HOST, host['seconds'],
                             fmt_gb(host['peak_gb']), host_differs, smi))

    short_subjects = cohort.discover_subjects(short_root, [])
    post = COHORT_SHORT[3]
    card = run_cohort(torch, short_subjects, os.path.join(work, 'short_card'),
                      device, post=post)
    cpu = run_cohort(torch, short_subjects, os.path.join(work, 'short_cpu'),
                     'cpu', post=post)
    short_differs = max(max_grid_diff(card['grids'], cpu['grids']),
                        float(np.max(np.abs(card['summary'] -
                                            cpu['summary']))))
    if short_differs > SWEEP_TOL:
        raise AssertionError('cohort short copy: card and CPU differ by %g'
                             % short_differs)
    log('phase 10 cohort short copy (%d subjects x %d trials x %d frames, '
        'post %d): card %.2f s, CPU %.2f s; grids and cohort CSV within '
        '%.3g; %s' % (COHORT_SHORT + (card['seconds'], cpu['seconds'],
                                      short_differs, smi)))
    shutil.rmtree(work, ignore_errors=True)
    log('phase 10 cohort: %.1f s in all; launches %s; %s'
        % (time.perf_counter() - start, launches, smi))
    return launches


def infer_corpus(data_dir, seed=11, channels=IN1_CHANNELS,
                 train_files=INFER_TRAIN_FILES, frames=TRAIN_FRAMES,
                 segment=INFER_SEGMENT, segments=INFER_SEGMENTS):
    """The infer sweep's two-speaker corpus as TFRecords with the fields
    eeg, intensity, intensity2 and attend: ``train_files`` files of
    ``frames`` frames attending speaker 1 (train_00 ..), and one test
    file whose attended speaker alternates every ``segment`` frames,
    speaker 1 first (test_00)."""
    from telluride_decoding_torch.data import records
    rng = np.random.RandomState(seed)
    trf = planted_trf(rng, channels)

    def recording(n, labels):
        a1, a2 = _speaker(rng, n), _speaker(rng, n)
        attended = np.where(labels[:, None] > 0, a2, a1)[:, 0]
        clean = np.stack([np.convolve(attended, trf[c])[:n]
                          for c in range(channels)], axis=1)
        eeg = (clean + 2.0 * rng.randn(n, channels)).astype(np.float32)
        return {'eeg': eeg, 'intensity': a1, 'intensity2': a2,
                'attend': labels.astype(np.float32)[:, None]}
    shutil.rmtree(data_dir, ignore_errors=True)
    for i in range(train_files):
        records.convert_data_to_tfrecords(
            recording(frames, np.zeros(frames)),
            os.path.join(data_dir, 'train_%02d.tfrecords' % i))
    labels = (np.arange(segment * segments) // segment) % 2
    records.convert_data_to_tfrecords(
        recording(labels.size, labels),
        os.path.join(data_dir, 'test_00.tfrecords'))
    return labels


def train_infer_model(data_dir, model_dir, device):
    """A CCA model at codelab width through ``cli.decoding.main`` on the
    train files, the LDA trained on them too (the test file stays
    unseen); returns seconds."""
    import io
    from telluride_decoding_torch.cli import decoding
    shutil.rmtree(model_dir, ignore_errors=True)
    argv = ['--tfexample_dir', data_dir, '--input_field', 'eeg',
            '--output_field', 'intensity', '--attended_field', 'attend',
            '--input2_field', 'intensity', '--dnn_regressor', 'cca',
            '--pre_context', str(PRE), '--post_context', str(POST),
            '--input2_pre_context', str(IN2_PRE), '--input2_post_context',
            str(IN2_POST), '--cca_dimensions', str(CCA_DIMS),
            '--streaming_fit', '--regularization_lambda', '0.001',
            '--train_file_pattern', 'train', '--validate_file_pattern',
            'train', '--test_file_pattern', 'train',
            '--correlation_frames', '100', '--summary_dir',
            model_dir + '_summary', '--saved_model_dir', model_dir,
            '--device', str(device)]
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        rc = decoding.main(argv)
    if rc != 0:
        raise AssertionError('cli.decoding.main returned %d' % rc)
    return time.perf_counter() - t0


def start_cpu_infer(data_dir, model_dir, out_path):
    """The same sweep on the CPU in a process of its own (plain versions;
    wta and stepped at every size, ssd at INFER_CPU_SSD_SIZES), started
    now so that it runs beside the card's work; returns the process."""
    code = (
        'import json, sys, torch\n'
        'torch.set_num_threads(4)\n'
        'from telluride_decoding_torch.cli import infer\n'
        'a = json.loads(sys.argv[1])\n'
        'out = {}\n'
        'for decoders, sizes in ((["wta", "stepped"], a["sizes"]),\n'
        '                        (["ssd"], a["ssd_sizes"])):\n'
        '    got = infer.run_comparison_test(\n'
        '        a["model"], a["data"], ["train"], ["test"], "intensity",\n'
        '        "intensity2", None, reduction_list=["first", "lda"],\n'
        '        decoder_list=decoders, window_list=sizes, device="cpu")\n'
        '    out.update({"%s %s" % k: v for k, v in got.items()})\n'
        'with open(a["out"], "w") as f:\n'
        '    json.dump(out, f)\n')
    from telluride_decoding_torch.cli import infer
    args = json.dumps(dict(model=model_dir, data=data_dir, out=out_path,
                           sizes=infer.WINDOW_LIST,
                           ssd_sizes=INFER_CPU_SSD_SIZES))
    return subprocess.Popen(
        [sys.executable, '-c', code, args], cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES=''),
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)


def run_infer_main(data_dir, model_dir, device):
    """``cli.infer.main --comparison_test`` on the card; returns
    {(reduction, decoder): (accuracy dict, seconds)}."""
    import io
    from telluride_decoding_torch.cli import infer
    runs = {}
    run_reduction_test = infer.run_reduction_test

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        result = run_reduction_test(*args, **kwargs)
        runs[(args[4], args[5])] = (result, time.perf_counter() - t0)
        return result
    infer.run_reduction_test = timed
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            rc = infer.main(['--tf_dir', data_dir, '--model_dir', model_dir,
                             '--train_files', 'train', '--test_files',
                             'test', '--audio_label', 'intensity',
                             '--comparison_test', '--device', str(device)])
    finally:
        infer.run_reduction_test = run_reduction_test
    if rc != 0 or len(runs) != 6:
        raise AssertionError('cli.infer.main: rc %s, %d pairs' % (rc,
                                                                  len(runs)))
    return runs


def check_infer(card, cpu, test_frames):
    """The gates of the sweep: lda + wta above INFER_GATE at windows of
    400 frames or more; the card's dicts equal the CPU's for wta and
    stepped, and within one window's share for ssd where the CPU ran it."""
    accuracy = card[('lda', 'wta')][0]
    low = {size: a for size, a in accuracy.items()
           if size >= 400 and not a > INFER_GATE}
    if low:
        raise AssertionError('lda + wta accuracy %s is not above %g'
                             % (low, INFER_GATE))
    worst = 0.0
    for key, want in cpu.items():
        reduction, decoder = key.split()
        got = card[(reduction, decoder)][0]
        for size, value in want.items():
            size = int(size)
            windows = (test_frames - size) // (size // 2) + 1
            diff = abs(got[size] - value)
            limit = 1.0 / windows if decoder == 'ssd' else 0.0
            if diff > limit + 1e-12:
                raise AssertionError('%s at %d frames: card %r, CPU %r'
                                     % (key, size, got[size], value))
            worst = max(worst, diff)
    return worst


def serve_decisions(model_dir, stream_path, device, pipeline):
    """``cli.serve.main --serve_decoder ssd`` over a stream file;
    returns (decisions, summary, seconds)."""
    from telluride_decoding_torch.cli import serve
    out = os.path.join(model_dir, 'decisions_ssd_%d.jsonl' % pipeline)
    argv = ['--serve_model_dir', model_dir, '--serve_input', stream_path,
            '--serve_output', out, '--chunk_size', str(SERVE_ROWS),
            '--serve_decoder', 'ssd', '--serve_device', str(device)]
    t0 = time.perf_counter()
    serve.main(argv + (['--serve_pipeline'] if pipeline else []))
    seconds = time.perf_counter() - t0
    with open(out) as f:
        lines = [json.loads(line) for line in f]
    return [l for l in lines if 'window' in l], lines[-1], seconds


def ssd_tracking_error(decisions, switch_s, k_w, k_b):
    """Share of decisions on the wrong side of the planted switch, each
    counted at its fixed lag: window i decides window i - k_b."""
    times = [d['time_s'] for d in decisions]
    wrong = [decisions[i]['attend_speaker1'] == (times[i - k_b] >= switch_s)
             for i in range(k_w, len(decisions))]
    return float(np.mean(wrong))


def stream_lines(stream):
    """``stream`` as the line protocol's JSON chunks of SERVE_ROWS
    frames, one a line."""
    eeg, a1, a2 = stream
    return ''.join(json.dumps({'eeg': eeg[s:s + SERVE_ROWS].tolist(),
                               'audio1': a1[s:s + SERVE_ROWS].tolist(),
                               'audio2': a2[s:s + SERVE_ROWS].tolist()})
                   + '\n' for s in range(0, eeg.shape[0], SERVE_ROWS))


def tcp_session(model_dir, stream, device):
    """One session of ``serve_socket`` on loopback (port 0,
    max_sessions=1) with the stream as JSON lines of SERVE_ROWS frames;
    returns (the session's decisions, serve_lines' on the same lines)."""
    import io
    import queue
    import socket
    import threading
    from telluride_decoding_torch.cli import serve
    lines = stream_lines(stream)
    bound, box = queue.Queue(), {}

    def listen():
        try:
            box['counts'] = serve.serve_socket(
                model_dir, 'tcp://127.0.0.1:0', device=device,
                decision='ssd', max_sessions=1,
                on_bound=lambda h, p: bound.put((h, p)))
        except Exception as error:     # Reported by the main thread.
            box['error'] = error
            bound.put(None)
    thread = threading.Thread(target=listen, daemon=True)
    thread.start()
    address = bound.get(timeout=120)
    if address is None:
        raise AssertionError('serve_socket failed: %r' % box.get('error'))
    received = b''
    with socket.create_connection(address, timeout=120) as conn:
        conn.sendall(lines.encode())
        conn.shutdown(socket.SHUT_WR)
        while True:
            chunk = conn.recv(1 << 16)
            if not chunk:
                break
            received += chunk
    thread.join(timeout=120)
    if thread.is_alive() or 'error' in box:
        raise AssertionError('serve_socket did not end its session: %r'
                             % box.get('error'))
    got = [json.loads(l) for l in received.decode().splitlines() if l]
    want = serve.serve_lines(model_dir, io.StringIO(lines), device=device,
                             decision='ssd')
    if box['counts'] != [len(got)]:
        raise AssertionError('session counts %s for %d decisions'
                             % (box['counts'], len(got)))
    return got, want


def same_decisions(got, want):
    keys = ('window', 'time_s', 'score1', 'score2', 'attend_speaker1')
    return len(got) == len(want) > 0 and all(
        [g[k] for k in keys] == [w[k] for k in keys]
        for g, w in zip(got, want))


def sm_clock_mhz(torch, fn, calls):
    """The SM clock in MHz as nvidia-smi reads it while ``calls`` calls
    of ``fn`` (enqueued first) keep the card busy."""
    for _ in range(calls):
        fn()
    clock = subprocess.run(
        ['nvidia-smi', '--query-gpu=clocks.sm', '--format=csv,noheader,'
         'nounits'], stdout=subprocess.PIPE, text=True,
        check=True).stdout.split()[0]
    torch.cuda.synchronize()
    return float(clock)


def s1_split(torch, device, dec):
    """S1's window form at the shape of ``dec`` (the factory's decoder) on
    a seeded state updated in place: device ms a window at (outer,
    inner, newton) trip counts (20, 1, 10), (20, 1, 0) and (1, 1, 10).
    The first two differ by the Newton steps alone (outer x k_w x newton
    of them), so their difference over that count is one Newton step.
    Also the SM clock under that load. A time the profiler did not see
    is None, and so is the step it would give."""
    from telluride_decoding_torch.ops import ssd_update as ops
    k_w = dec.k_w
    rng = np.random.RandomState(0)
    a_0 = 2 + 0.2 ** 2 / 5
    consts = ops.constants_views(torch.tensor(
        [-0.3994, -1.5103, 641.13, 4043.4, 375.81, 6279.1, a_0,
         0.2 * (a_0 - 1), 1.0], device=device))
    state = ops.state_views(torch.cat([
        torch.tensor([-0.3994, -1.5103, 1.7060, 0.64395]),
        torch.zeros(2 * (k_w + 1)), torch.full((k_w,), 0.3),
        torch.zeros(k_w)]).to(device), k_w)
    r1 = torch.as_tensor(np.exp(-0.4 + 0.6 * rng.randn(k_w)),
                         dtype=torch.float32, device=device)
    r2 = torch.as_tensor(np.exp(-1.5 + 0.9 * rng.randn(k_w)),
                         dtype=torch.float32, device=device)

    def update(trips):
        return lambda: ops.ssd_update(state, r1, r2, consts, *trips, k_w)
    trips = (dec.outer_iter, dec.inner_iter, dec.newton_iter)
    split = {}
    for cut in (trips, trips[:2] + (0,), (1, 1, dec.newton_iter)):
        split['%d/%d/%d' % cut] = device_ms(torch, update(cut), S1_WINDOW,
                                            reps=20)
    clock = sm_clock_mhz(torch, update(trips), 2000)
    full, rest = list(split.values())[:2]
    newton_ns = (None if None in (full, rest) else
                 (full - rest) / (trips[0] * k_w * trips[2]) * 1e6)
    return dict(split_ms=split, newton_step_ns=newton_ns,
                sm_clock_mhz=clock,
                newton_step_cycles=(None if newton_ns is None else
                                    newton_ns * clock / 1e3))


def s1_against_plain(torch, device, model_dir, data_dir):
    """S1 against its plain version on the card over the test file's
    100-frame window scores (two speakers, lda): the decider runs S1 a
    window, each window's input state is kept, and the plain version
    replays every window from the same state in one batched call on the
    card. Returns the numbers of the kernels line and the check."""
    from telluride_decoding_torch.cli import infer
    from telluride_decoding_torch.decide import attention_decoder
    from telluride_decoding_torch.decode.infer_decoder import Decoder
    from telluride_decoding_torch.ops import ssd_update as ops
    decoder = infer.load_model(model_dir, 'lda', device)
    _, bd1, _, bd2 = infer.get_data_for_model(
        data_dir, ['train'], ['test'], decoder, 'intensity', 'intensity2',
        include_train=False)
    s1, l1 = decoder.frame_scores(bd1)
    s2, _ = decoder.frame_scores(bd2)
    c1, labels = Decoder.window_means(s1, l1, 100)
    c2, _ = Decoder.window_means(s2, l1, 100)
    dec = attention_decoder.create_attention_decoder('ssd', window_step=50,
                                                     device=device)
    first = infer.find_first_segment(labels)
    dec.tune(c1[:first], c2[:first])
    k_w = dec.k_w
    sizes = ops._state_sizes(k_w)
    states, rs, got, after = [], [], [], []
    for a, b in zip(c1, c2):
        before = ops.packed_buffer(dec._state, sizes).clone()
        p = dec.attention(a, b)
        if dec.calls >= k_w:
            states.append(before)
            rs.append((dec._r1_buf.copy(), dec._r2_buf.copy()))
            got.append(p)
            after.append(ops.packed_buffer(dec._state, sizes).clone())
    r1 = torch.as_tensor(np.stack([r[0] for r in rs]), device=device)
    r2 = torch.as_tensor(np.stack([r[1] for r in rs]), device=device)
    consts = dec._constants()
    new_state, _, _ = ops.ssd_update_reference(
        ops.state_views(torch.stack(states), k_w), r1, r2, consts,
        dec.outer_iter, dec.inner_iter, dec.newton_iter, k_w)
    # The new states hold the window's z (z_smooth) and eta.
    diff = (torch.stack(after) - ops.pack(list(new_state))).abs()
    err = float(diff.max())
    field_err = {f: float(getattr(ops.state_views(diff, k_w), f).max())
                 for f in ops.SsdState._fields}
    # p, lower, upper from the plain z and eta, as the decider forms them.
    at = -1 - dec.k_f
    z_at = new_state.z_smooth[:, at].cpu().numpy().astype(np.float64)
    eta_at = new_state.eta[:, at].cpu().numpy().astype(np.float64)
    half = dec.c0 * np.sqrt(np.maximum(eta_at, 0.0))
    want = np.stack([1 / (1 + np.exp(-z_at)), 1 / (1 + np.exp(-(z_at - half))),
                     1 / (1 + np.exp(-(z_at + half)))], 1)
    have = np.array(got)
    p_err = float(np.max(np.abs(have - want)))
    clear = np.abs(want[:, 0] - 0.5) > SSD_TOL
    same = np.array_equal(have[clear, 0] >= 0.5, want[clear, 0] >= 0.5)

    def call():
        return dec.attention(c1[0], c2[0])
    host = host_ms(torch, call, reps=100)
    ms = time_ms(torch, call, reps=50)
    dev = device_ms(torch, call, S1_WINDOW, reps=20)
    state = ops.state_views(states[0].clone(), k_w)
    plain_ms = time_ms(torch, lambda: ops.ssd_update_reference(
        state, r1[0], r2[0], consts, dec.outer_iter, dec.inner_iter,
        dec.newton_iter, k_w), reps=2, warmup=1)
    # Bytes: state in and out, r1, r2, constants, z and eta. Operations:
    # per EM round and window position about 30 (E-step), 16 (M-step
    # sums), 10 Newton steps of 9 and 26 more (filter, smoother, eta).
    num_bytes = 4 * (2 * (6 + 4 * k_w) + 2 * k_w + 9 + 2 * k_w)
    flops = dec.outer_iter * k_w * (30 + 16 + dec.newton_iter * 9 + 26)
    limit, limited_by = bound(num_bytes, flops)
    log('phase 11 ssd_update (S1) k_w %d over %d windows of the test file: '
        'the new states within %.3g of the plain version on the card (%s), '
        'p and bounds within %.3g, %d decisions clear of 0.5 %s; per '
        'window: call %.4f ms, host %.4f ms, on the device %s; plain '
        'version on the card %.1f ms'
        % (k_w, len(got), err, json.dumps(field_err), p_err,
           int(clear.sum()), 'identical' if same else 'NOT identical', ms,
           host, fmt_ms(dev), plain_ms))
    if not (err <= SSD_TOL and p_err <= SSD_TOL and same):
        raise AssertionError('ssd_update disagrees with its plain version '
                             '(tolerance %g abs)' % SSD_TOL)
    return dict(windows=len(got), k_w=k_w, ms=ms, host_ms=host,
                device_ms=dev, plain_ms=plain_ms, bound_ms=limit,
                bound_by=limited_by, max_abs_err=err)


def ssd_pair_streams(device, scores):
    """The six streams of an ssd pair as ``run_reduction_test`` forms
    them (WINDOW_LIST sizes over the test file's frame scores): fresh
    tuned decoders and their window correlations."""
    from telluride_decoding_torch.cli import infer
    from telluride_decoding_torch.decide import attention_decoder
    from telluride_decoding_torch.decode.infer_decoder import Decoder
    (s1, l1), (s2, l2) = scores
    decoders, r1s, r2s = [], [], []
    for size in infer.WINDOW_LIST:
        c1, _ = Decoder.window_means(s1, l1, size)
        c2, labels = Decoder.window_means(s2, l2, size)
        c1, c2 = [float(v) for v in c1], [float(v) for v in c2]
        dec = attention_decoder.create_attention_decoder(
            'ssd', window_step=size // 2, device=device)
        first = infer.find_first_segment(np.asarray(labels))
        if first:
            dec.tune(c1[:first], c2[:first])
        decoders.append(dec)
        r1s.append(c1)
        r2s.append(c2)
    return decoders, r1s, r2s


def cut_sequence(launch, windows):
    """The first ``windows`` windows of each stream of a sequence launch's
    arguments (states copied)."""
    import torch
    k_w, offsets = launch['k_w'], launch['offsets']
    keep = [slice(lo, min(hi, lo + k_w - 1 + windows))
            for lo, hi in zip(offsets, offsets[1:])]
    return dict(launch, states=launch['states'].clone(),
                r1_series=torch.cat([launch['r1_series'][k] for k in keep]),
                r2_series=torch.cat([launch['r2_series'][k] for k in keep]),
                offsets=np.cumsum([0] + [k.stop - k.start for k in keep]))


def s1_sequence_check(torch, device, model_dir, data_dir):
    """S1's sequence form on the card: the six streams of an ssd pair
    (lda) in one launch, bit for bit against the window form over the
    same streams (decisions, z, eta and the final states), and within
    SSD_TOL of ssd_sequence_reference on the card over the first
    SSD_PLAIN_WINDOWS windows of each stream; the whole launch's device
    ms (CUDA events), per window of its longest stream."""
    from telluride_decoding_torch.cli import infer
    from telluride_decoding_torch.ops import ssd_update as ops
    decoder = infer.load_model(model_dir, 'lda', device)
    _, bd1, _, bd2 = infer.get_data_for_model(
        data_dir, ['train'], ['test'], decoder, 'intensity', 'intensity2',
        include_train=False)
    scores = (decoder.frame_scores(bd1), decoder.frame_scores(bd2))
    by_sequence, r1s, r2s = ssd_pair_streams(device, scores)
    by_window = ssd_pair_streams(device, scores)[0]
    # The launch attention_sequences makes for fresh decoders: the states
    # and constants as they are now, each stream's whole series of
    # correlations |mean + offset| (offset 0) in float32.
    first = by_sequence[0]
    states, consts = ops.stack_streams([d._state for d in by_sequence],
                                       [d._constants() for d in by_sequence])
    launch = dict(
        states=states, consts=consts,
        r1_series=torch.as_tensor(np.abs(np.concatenate(r1s)),
                                  dtype=torch.float32, device=device),
        r2_series=torch.as_tensor(np.abs(np.concatenate(r2s)),
                                  dtype=torch.float32, device=device),
        offsets=np.cumsum([0] + [len(r) for r in r1s]),
        outer_iter=first.outer_iter, inner_iter=first.inner_iter,
        newton_iter=first.newton_iter, k_w=first.k_w, at=-1 - first.k_f)
    before = (ops.ssd_update.launches, ops.ssd_sequence.launches)
    got = type(first).attention_sequences(by_sequence, r1s, r2s)
    t0 = time.perf_counter()
    want = [[dec.attention(a, b) for a, b in zip(r1, r2)]
            for dec, r1, r2 in zip(by_window, r1s, r2s)]
    window_s = time.perf_counter() - t0
    windows = ops.sequence_windows(launch['offsets'], launch['k_w'])
    if (ops.ssd_sequence.launches - before[1] != 1 or
            ops.ssd_update.launches - before[0] != sum(windows)):
        raise AssertionError('the sequence check launched S1 %d / %d times'
                             % (ops.ssd_sequence.launches - before[1],
                                ops.ssd_update.launches - before[0]))
    same = got == want and all(
        a.z_dyn == b.z_dyn and a.eta_dyn == b.eta_dyn and torch.equal(
            ops.pack(list(a._state)), ops.pack(list(b._state)))
        for a, b in zip(by_sequence, by_window))
    if not same:
        raise AssertionError('the sequence form differs from the window '
                             'form over the same streams')
    # The whole launch again, timed alone; it must be the one
    # attention_sequences made (the decoders' z_dyn and eta_dyn past
    # their k_w seeds).
    timed = dict(launch, states=launch['states'].clone())
    result = []
    seq_ms = time_ms(torch, lambda: result.append(ops.ssd_sequence(**timed)),
                     reps=1, warmup=0)
    decided = [[z, eta] for d in by_sequence
               for z, eta in zip(d.z_dyn[d.k_w:], d.eta_dyn[d.k_w:])]
    if result[0][1].cpu().tolist() != decided:
        raise AssertionError('the timed sequence launch is not the one '
                             'attention_sequences made')
    cut = cut_sequence(launch, SSD_PLAIN_WINDOWS)
    kernel_states, kernel_out = ops.ssd_sequence(
        **dict(cut, states=cut['states'].clone()))
    t0 = time.perf_counter()
    want_states, want_out = ops.ssd_sequence_reference(**cut)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3 / SSD_PLAIN_WINDOWS
    err = max(max_err(torch, kernel_out, want_out),
              max_err(torch, kernel_states, want_states))
    log('phase 11 ssd_sequence (S1, sequence form): %d streams, %s windows, '
        'one launch; decisions, z, eta and states bit for bit those of %d '
        'window launches (%.2f s); the whole launch %.1f ms on the device, '
        '%.4f ms a window of its longest stream; against the plain version '
        'on the card over %d windows a stream within %.3g (plain %.1f ms a '
        'window step)' % (len(windows), windows, sum(windows), window_s,
                          seq_ms, seq_ms / max(windows), SSD_PLAIN_WINDOWS,
                          err, plain_ms))
    if not err <= SSD_TOL:
        raise AssertionError('ssd_sequence disagrees with its plain version '
                             '(tolerance %g abs)' % SSD_TOL)
    return dict(sequence_windows=windows, sequence_ms=seq_ms,
                sequence_ms_per_window=seq_ms / max(windows),
                sequence_max_abs_err=err, sequence_plain_ms=plain_ms)


def s1_chain_build():
    """Starts nvcc on S1_CHAIN_SOURCE (with the S1 source it includes)
    into a library under build/s1_chain/ named by their hash, unless it
    is there; returns (path, the nvcc process or None)."""
    from telluride_decoding_torch import kernels
    digest = hashlib.sha256(' '.join(kernels.NVCC_FLAGS).encode())
    for source in (S1_CHAIN_SOURCE, kernels.CSRC_DIR / 'ssd_update.cu'):
        with open(source, 'rb') as f:
            digest.update(f.read())
    path = os.path.join(BUILD, 's1_chain',
                        'libs1_chain_%s.so' % digest.hexdigest()[:16])
    if os.path.exists(path):
        return path, None
    os.makedirs(os.path.dirname(path), exist_ok=True)
    nvcc = shutil.which('nvcc') or '/usr/local/cuda/bin/nvcc'
    return path, subprocess.Popen(
        [nvcc, *kernels.NVCC_FLAGS, '-shared', S1_CHAIN_SOURCE, '-o',
         path + '.tmp'], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)


def s1_chain_library(build=None):
    """The S1 chain library's path once built: waits for ``build`` (what
    s1_chain_build returned), or builds it now; raises if nvcc failed."""
    path, proc = build or s1_chain_build()
    if proc is not None:
        output, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError('nvcc failed on %s (rc %d):\n%s'
                               % (S1_CHAIN_SOURCE, proc.returncode,
                                  output[-4000:]))
        os.replace(path + '.tmp', path)
    return path


def s1_latencies(torch, device, library):
    """SM cycles of one dependent instruction of each S1_LATENCY_KINDS on
    one warp of ``device`` (tdt_s1_latency in S1_CHAIN_SOURCE)."""
    import ctypes
    from telluride_decoding_torch import kernels
    lib = ctypes.CDLL(library)
    lib.tdt_s1_latency.argtypes = [ctypes.c_void_p] * 3
    lib.tdt_s1_latency.restype = ctypes.c_int
    out = torch.zeros(len(S1_LATENCY_KINDS), device=device)
    sink = torch.zeros_like(out)
    kernels.check(lib.tdt_s1_latency(out.data_ptr(), sink.data_ptr(),
                                     kernels.stream_handle(device)),
                  's1_latency')
    return dict(zip(S1_LATENCY_KINDS, out.tolist()))


def s1_bound(torch, device, dec):
    """S1's chain bound: the dependent chain of one Newton step
    (newton_step in csrc/ssd_update.cu) as this build's SASS has it
    (S1_CHAIN_SOURCE's s1_newton_step; s1_newton_step_serial, its three
    divisions in series, beside it), weighed with the latencies measured
    here, times the Newton steps of a window of ``dec`` (the factory's
    decoder) at the SM clock under load; with the Newton/rest split
    (s1_split). Instructions on the chain other than FP32 and MUFU (a
    shuffle, a select) are counted but weigh nothing, their latencies
    not measured, so the bound stays below what the chain takes."""
    library = s1_chain_library()
    lat = s1_latencies(torch, device, library)
    cycles = {'fp32': lat['fadd'], 'mufu_ex2': lat['mufu_ex2'],
              'mufu_rcp': lat['fadd_mufu_rcp'] - lat['fadd']}
    functions = sass_functions(library)
    if functions is None:
        raise AssertionError('cuobjdump not found: S1\'s chain is not '
                             'counted')
    step, counts, path = sass_chain(functions['s1_newton_step'], cycles)
    serial, serial_counts, _ = sass_chain(
        functions['s1_newton_step_serial'], cycles)
    split = s1_split(torch, device, dec)
    clock = split['sm_clock_mhz']
    steps = dec.outer_iter * dec.k_w * dec.newton_iter
    chain_ms = steps * step / (clock * 1e3)
    cycles_in_filter = split['newton_step_cycles']
    log('phase 11 S1 split (window form, k_w %d), device ms a window at '
        'outer/inner/newton trips: %s; one Newton step %s cycles inside '
        'the filter; SM clock %.0f MHz; latencies in cycles %s; one Newton '
        'step\'s chain in the SASS: %s = %.1f cycles (%s); with serial '
        'divisions: %s = %.1f cycles; chain bound: %d Newton steps, %.4f '
        'ms a window'
        % (dec.k_w,
           json.dumps({k: v if v is None else round(v, 4)
                       for k, v in split['split_ms'].items()}),
           'not measured' if cycles_in_filter is None else
           '%.1f' % cycles_in_filter, clock,
           json.dumps({k: round(v, 2) for k, v in lat.items()}),
           json.dumps(counts), step, ' '.join(path),
           json.dumps(serial_counts), serial, steps, chain_ms))
    return dict(chain_bound_ms=chain_ms, chain_cycles_per_step=step,
                chain_instructions=counts,
                chain_serial_cycles_per_step=serial,
                chain_serial_instructions=serial_counts,
                newton_split_ms=split['split_ms'],
                newton_step_cycles=split['newton_step_cycles'],
                sm_clock_mhz=clock, latency_cycles=lat)


def phase_attention(torch, device, smi):
    """The state-space decoder (S1) and the rest of serving at codelab
    width. Main path (counted launches): ``cli.infer.main
    --comparison_test`` on a seeded two-speaker corpus (reductions first
    and lda x wta, stepped and ssd x WINDOW_LIST; two K1 launches a pair,
    one launch of S1's sequence form an ssd pair and none of its window
    form), then the phase-4 stream served with
    ``--serve_decoder ssd`` synchronous and ``--serve_pipeline``, one TCP
    session of ``serve_socket`` and ``--selftest``. Checks: the sweep's
    gates (check_infer, against the same sweep on the CPU in a process
    of its own), identical decisions of the two serving modes, the TCP
    session and serve_lines, the SSD's tracking of the planted switch,
    S1's window form against its plain version on the card
    (s1_against_plain), its sequence form against the window form and
    the plain version (s1_sequence_check), and S1's Newton/rest split,
    latency table and chain bound (s1_bound)."""
    from telluride_decoding_torch.cli import infer, serve
    from telluride_decoding_torch.decide import attention_decoder
    ssd = attention_decoder.create_attention_decoder('ssd', device='cpu')
    start = time.perf_counter()
    work = os.path.join(BUILD, 'attention')
    data_dir = os.path.join(work, 'records')
    model_dir = os.path.join(work, 'cca_model')
    cpu_out = os.path.join(work, 'infer_cpu.json')
    t0 = time.perf_counter()
    labels = infer_corpus(data_dir)
    corpus_s = time.perf_counter() - t0
    train_s = train_infer_model(data_dir, model_dir, device)
    cpu_proc = start_cpu_infer(data_dir, model_dir, cpu_out)
    try:
        read_launches = reset_launches()
        card = run_infer_main(data_dir, model_dir, device)
        infer_launches = read_launches()
        for (reduction, decoder), (accuracy, seconds) in card.items():
            log('phase 11 infer %s + %s on the card: %.2f s; accuracy %s'
                % (reduction, decoder, seconds, json.dumps(accuracy)))
        log('phase 11 infer: corpus %d + 1 files (test %d frames, %d '
            'switches) in %.1f s; CCA model through cli.decoding.main %.2f '
            's; launches %s' % (INFER_TRAIN_FILES, labels.size,
                                INFER_SEGMENTS - 1, corpus_s, train_s,
                                infer_launches))
        slice_dir = CODELAB_DIR
        stream_path = os.path.join(slice_dir, 'stream.npz')
        with np.load(stream_path) as data:
            stream = (data['eeg'], data['audio1'], data['audio2'])
        served = {pipeline: serve_decisions(slice_dir, stream_path, device,
                                            pipeline)
                  for pipeline in (False, True)}
        for pipeline, (decisions, summary, seconds) in served.items():
            log('phase 11 serve ssd %s: %d windows in %.2f s, latency p50 '
                '%.3f ms p95 %.3f ms'
                % ('pipelined' if pipeline else 'synchronous',
                   len(decisions), seconds, summary['latency_p50_ms'],
                   summary['latency_p95_ms']))
        tcp_got, tcp_want = tcp_session(slice_dir, stream, device)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(open(os.devnull, 'w')):
            if serve.main(['--selftest', '--serve_device', str(device)]):
                raise AssertionError('--selftest failed')
        selftest_s = time.perf_counter() - t0
        launches = read_launches()
        require_launched(infer_launches, ('fused_cca_decode',
                                          'ssd_sequence'), 'infer')
        ssd_pairs = sum(decoder == 'ssd' for _, decoder in card)
        if (infer_launches['ssd_sequence'] != ssd_pairs or
                infer_launches['ssd_update']):
            raise AssertionError(
                'the infer sweep launched S1 %d times in sequence form and '
                '%d in window form for %d ssd pairs (one and none a pair)'
                % (infer_launches['ssd_sequence'],
                   infer_launches['ssd_update'], ssd_pairs))
        require_launched(launches, ('fused_cca_decode', 'ssd_update'),
                         'attention')
        s1 = s1_against_plain(torch, device, model_dir, data_dir)
        s1.update(s1_sequence_check(torch, device, model_dir, data_dir))
        s1.update(s1_bound(torch, device, ssd))
        _, cpu_err = cpu_proc.communicate(timeout=600)
        if cpu_proc.returncode != 0:
            raise AssertionError('CPU infer sweep failed: %s'
                                 % cpu_err[-2000:])
    finally:
        if cpu_proc.poll() is None:
            cpu_proc.kill()
            cpu_proc.wait()
    with open(cpu_out) as f:
        cpu = json.load(f)
    worst = check_infer(card, cpu, labels.size)
    sync, piped = served[False], served[True]
    if not same_decisions(piped[0], sync[0]):
        raise AssertionError('pipelined ssd decisions differ from the '
                             'synchronous ones')
    if not same_decisions(tcp_got, tcp_want):
        raise AssertionError('the TCP session differs from serve_lines')
    error = ssd_tracking_error(sync[0], (STREAM_FRAMES // 2) / 100.0,
                               ssd.k_w, ssd.k_b)
    if not error < SSD_ERROR_BAR:
        raise AssertionError('ssd decisions miss the planted switch in %.3f '
                             'of windows' % error)
    log('phase 11 infer: card vs CPU (wta, stepped at %s, ssd at %s) '
        'within %.3g' % (infer.WINDOW_LIST, INFER_CPU_SSD_SIZES, worst))
    log('phase 11 serve ssd: pipelined decisions identical to synchronous; '
        'error against the planted switch at a lag of %d windows %.3f '
        '(bar %g); TCP session of %d decisions identical to serve_lines; '
        'selftest %.2f s; launches %s'
        % (ssd.k_b, error, SSD_ERROR_BAR, len(tcp_got), selftest_s,
           launches))
    log('phase 11: %.1f s in all; %s' % (time.perf_counter() - start, smi))
    return launches, s1


# Phase 12: ingest of raw recordings. A lab's own recordings (one subject
# of LAB['trials'] trials: EDF of 64 EEG channels and TRIG at 512 Hz,
# stereo int16 wavs at 44.1 kHz with add_trigger's pulses, one event per
# 5 s) and two corpora through the downloader over file:// URLs:
# Telluride4 (an assumed shape: the repo does not record the corpus's
# channel count or trial length) and one jens_impaired subject at
# ds-eeg-snhl's documented geometry (BDF, 64 channels at 512 Hz, 48
# trials of 50 s, 32 of them with a masker; one subject of 44).
LAB = dict(trials=8, seconds=360, channels=64, eeg_fs=512, audio_fs=44100,
           frame_rate=64, event_every=5, lead_samples=(128, 1024))
LAB_CONTEXTS, LAB_DIMS = (0, 21, 15, 15), 5     # The KULeuven CCA preset's.
TELLURIDE4 = dict(trials=32, tracks=4, channels=64, frames=3840)
IMPAIRED = dict(channels=64, fs=512, trials=48, dual=32, frames=25600)


def check_leads(leads, planted, onsets, eeg_fs):
    """Both estimates within one EEG sample of the planted lead, no
    outlier, and every audio onset found in both channels."""
    for name, (mode, theil_sen, outliers, n_audio, n_eeg) in leads.items():
        for what, value in (('mode histogram', mode),
                            ('Theil-Sen', theil_sen)):
            if abs(value - planted[name]) > 1.0 / eeg_fs:
                raise AssertionError(
                    '%s: the %s lead %.6f s is more than one EEG sample '
                    'from the planted %.6f s' % (name, what, value,
                                                 planted[name]))
        if outliers or not n_audio == n_eeg == len(onsets[name]):
            raise AssertionError('%s: %d outliers, %d audio and %d EEG '
                                 'onsets of %d' % (name, outliers, n_audio,
                                                   n_eeg, len(onsets[name])))


def check_brainvision(eeg_dir, name='trial_01'):
    """The BrainVision copy against the EDF read; raises unless it is
    within one EDF quantum. Returns the largest difference in quanta."""
    worst = raw_recordings.brainvision_quanta(eeg_dir, name)
    if worst > 1.0:
        raise AssertionError('the BrainVision copy differs from the EDF '
                             'read by %.3f quanta' % worst)
    return worst


@contextlib.contextmanager
def timed_calls(seconds, *targets):
    """Adds the seconds of every call of each (owner, name) in
    ``targets`` to seconds[name] for the block."""
    saved = [(owner, name, getattr(owner, name)) for owner, name in targets]

    def timed(name, fn):
        def call(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                seconds[name] = (seconds.get(name, 0.0) +
                                 time.perf_counter() - t0)
        return call
    for owner, name, fn in saved:
        setattr(owner, name, timed(name, fn))
    try:
        yield seconds
    finally:
        for owner, name, fn in saved:
            setattr(owner, name, fn)


def corpus_main(type_, url, cache_dir, tf_dir, device, data_class):
    """``cli.regression_data.main`` with ``--internet url``; returns its
    seconds split by stage: the download (download_from_gdrive), the rest
    of download_data (extraction), the .mat loads, the BDF read, the
    events TSV, z-score, TFRecord write and ingest_data in all."""
    from telluride_decoding_torch.cli import regression_data as rd
    from telluride_decoding_torch.io import ingest
    for d in (cache_dir, tf_dir):
        shutil.rmtree(d, ignore_errors=True)
    seconds = collections.OrderedDict()
    t0 = time.perf_counter()
    with timed_calls(seconds, (rd, 'download_from_gdrive'),
                     (data_class, 'download_data'), (rd, 'loadmat'),
                     (rd.edf_io, 'read_edf'), (rd, '_read_events'),
                     (ingest.BrainExperiment, 'z_score_all_data'),
                     (ingest.BrainExperiment, 'write_all_data'),
                     (data_class, 'ingest_data')), \
            contextlib.redirect_stdout(sys.stderr):
        rc = rd.main(['--type', type_, '--internet', url, '--cache_dir',
                      cache_dir, '--tf_output_dir', tf_dir, '--device',
                      str(device)])
    seconds['main'] = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError('regression_data.main --type %s returned %d'
                             % (type_, rc))
    seconds['extract'] = (seconds.pop('download_data') -
                          seconds['download_from_gdrive'])
    return seconds


def tree_bytes(path):
    return sum(os.path.getsize(os.path.join(root, f))
               for root, _, files in os.walk(path) for f in files)


def fmt_stages(stages):
    return ', '.join('%s %.3f s' % item for item in stages.items())


def sweep_gate(run, test_name, threshold, matched_r, files):
    best = float(np.max(np.mean(run['grid'], axis=1)))
    if run['grid'].shape != (SWEEP_LAMBDAS.size, files):
        raise AssertionError('%s: grid shape %s' % (test_name,
                                                    run['grid'].shape))
    if not best >= threshold:
        raise AssertionError('%s: best mean held-out r %.4f is below %.4f '
                             '(the matched filter %.4f less %g)'
                             % (test_name, best, threshold, matched_r,
                                SWEEP_MARGIN))
    return best


def lab_frame_scores(model_dir, data_dir, device, test_file, rate,
                     contexts=LAB_CONTEXTS):
    """The saved lab decoder's frame scores over the test split
    (``Decoder.frame_scores``: one K1 launch over the split on a card);
    returns the scores."""
    from telluride_decoding_torch.decode.infer_decoder import create_decoder
    decoder = create_decoder(model_dir, reduction='lda', device=device)
    decoder.load_decoding_model(model_dir)
    decoder.restore_parameters(os.path.join(model_dir, 'decoder_model.json'))
    dataset = brain_data(data_dir, device, 'intensity', rate, contexts,
                         test_file_pattern=test_file, final_batch_size=512,
                         shuffle_buffer_size=0).create_dataset('test')
    scores, _ = decoder.frame_scores(dataset)
    if not scores.size or not np.all(np.isfinite(scores)):
        raise AssertionError('the lab decoder scored %d frames, finite: %s'
                             % (scores.size, np.all(np.isfinite(scores))))
    return scores


def record_lag_stacks():
    """Starts counting the (n, c, pre, post) of every K2 launch: the
    kernel library that the wrapper fetches at each call is wrapped.
    Returns (the counts, a function that stops the counting)."""
    from telluride_decoding_torch import kernels
    real = kernels.library
    shapes = collections.Counter()

    class Recording:
        def __init__(self, lib):
            self._lib = lib

        def __getattr__(self, name):
            return getattr(self._lib, name)

        def tdt_lag_stack_f32(self, x, out, n, c, pre, post, stream):
            shapes[(n, c, pre, post)] += 1
            return self._lib.tdt_lag_stack_f32(x, out, n, c, pre, post,
                                               stream)
    kernels.library = lambda: Recording(real())

    def stop():
        kernels.library = real
    return shapes, stop


def check_lag_stack_shapes(torch, device, shapes, seed=12):
    """K2 against lag_stack_reference, bit for bit, on random inputs at
    each (n, c, pre, post) in ``shapes``."""
    from telluride_decoding_torch.ops.lagstack import (lag_stack,
                                                       lag_stack_reference)
    gen = torch.Generator(device=device).manual_seed(seed)
    for n, c, pre, post in sorted(shapes):
        x = torch.randn((n, c), generator=gen, device=device)
        if not torch.equal(lag_stack(x, pre, post),
                           lag_stack_reference(x, pre, post)):
            raise AssertionError('lag_stack kernel is not bit-exact at %s'
                                 % ((n, c, pre, post),))


def bounded_moments_check(torch, test_name, data_dir, post, device):
    """A sweep's per-file moments in the bounded-memory regime (one file
    uploaded and stacked by K2 at a time) on the card against the same
    regime on the CPU (lag_stack_reference), over the preset's own files
    and context; raises unless every moment is within SWEEP_TOL of the
    largest of its kind. Returns (largest relative difference, files,
    seconds on the card, seconds on the CPU)."""
    from telluride_decoding_torch.cli import decoding, regression
    from telluride_decoding_torch.sweep import engine
    args = regression.build_parser().parse_args(
        ['--tfexample_dir', data_dir, '--test_name', test_name,
         '--post_context', str(post), '--device', str(device)])
    flags = decoding.DecodingOptions().set_flags(args)
    reg = regression.select_regression_object(test_name, flags,
                                              device=device)
    reg.preset_flags()
    data = regression.get_brain_data_object(flags, 'cpu')
    xs, ys, ctx = reg._per_file_raw(data, sorted(data.all_files(-1)))
    seconds = []
    stats = []
    for on in (device, 'cpu'):
        t0 = time.perf_counter()
        stats.append(engine.per_file_stats(xs, ys, want_syy=True,
                                           batch_bytes=0, context=ctx,
                                           device=on))
        if on != 'cpu':
            torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    worst = 0.0
    for name, got, want in zip(stats[0]._fields, *stats):
        scale = float(want.abs().max()) or 1.0
        err = float((got.cpu() - want).abs().max()) / scale
        if not err <= SWEEP_TOL:
            raise AssertionError('%s bounded-memory moments: %s on the card '
                                 'differ from the CPU by %g of its largest'
                                 % (test_name, name, err))
        worst = max(worst, err)
    return worst, len(xs), seconds[0], seconds[1]


def phase_raw_ingest(torch, device, smi):
    """Ingest of raw recordings, end to end on the card. (a) A lab's own
    recordings (build_lab_recordings) through the ingest API
    (lab_ingest: EDF, triggers, both lead estimates, fix_eeg_offset, K3)
    into TFRecords, then ``cli.decoding.main`` with the KULeuven CCA
    preset's contexts (streamed fit, K2; evaluation, K1). (b) A seeded
    Telluride2015.mat through ``cli.regression_data.main --internet
    file://...`` and ``cli.regression.main`` with telluride4_linear and
    telluride4_cca (K2). (c) One jens_impaired subject staged as
    ds-eeg-snhl.tar through the downloader and jens_impaired_linear
    (K2). Checks: the planted leads within one EEG sample by both
    estimators, the BrainVision copy within one EDF quantum, the card's
    records within INGEST_TOL of the same ingest on the CPU, d' above 1,
    and each sweep's best mean r at or above its matched filter's less
    SWEEP_MARGIN; K1, K2 and K3 launched on the path."""
    import pathlib
    import tarfile
    from telluride_decoding_torch.cli import regression_data as rd
    from telluride_decoding_torch.io import ingest
    from telluride_decoding_torch.signal import preprocess
    start = time.perf_counter()
    work = os.path.join(BUILD, 'raw_ingest')
    shutil.rmtree(work, ignore_errors=True)
    lab_root = os.path.join(work, 'lab')
    t0 = time.perf_counter()
    planted, names, onsets = raw_recordings.build_lab_recordings(lab_root,
                                                                 **LAB)
    build_s = {'lab recordings': time.perf_counter() - t0}
    staged_bytes = {'lab recordings': tree_bytes(lab_root)}
    t0 = time.perf_counter()
    t4_stage = os.path.join(work, 'stage', 'Telluride2015.mat')
    t4_matched = raw_recordings.build_telluride4_mat(t4_stage,
                                                     **TELLURIDE4)
    build_s['Telluride2015.mat'] = time.perf_counter() - t0
    staged_bytes['Telluride2015.mat'] = os.path.getsize(t4_stage)
    t0 = time.perf_counter()
    tree = os.path.join(work, 'stage', 'ds-eeg-snhl')
    hi_matched = raw_recordings.build_impaired_subject(tree, **IMPAIRED)
    archive = os.path.join(work, 'stage', 'ds-eeg-snhl.tar')
    with tarfile.open(archive, 'w') as tar:
        tar.add(tree, arcname='ds-eeg-snhl')
    shutil.rmtree(tree)
    build_s['ds-eeg-snhl.tar'] = time.perf_counter() - t0
    staged_bytes['ds-eeg-snhl.tar'] = os.path.getsize(archive)
    rate, eeg_fs = LAB['frame_rate'], LAB['eeg_fs']
    lab_tf = os.path.join(work, 'lab_tf')
    runs = {}
    k2_shapes, stop_recording = record_lag_stacks()
    read_launches = reset_launches()
    leads, lab_stages, _ = raw_recordings.lab_ingest(
        ingest, preprocess, lab_root, lab_tf, names, rate, eeg_fs,
        device=device)
    test_file = 'trial_%02d' % LAB['trials']
    decoding_results, decoding_report, decoding_s, lab_model = run_decoding(
        'cca', lab_tf, os.path.join(work, 'lab_decoding'), device, test_file,
        contexts=LAB_CONTEXTS, dims=LAB_DIMS, frame_rate=rate)
    card_scores = lab_frame_scores(lab_model, lab_tf, device, test_file,
                                   rate)
    lab_launches = read_launches()
    with environ(TMPDIR=os.path.join(work, 'tmp')):
        os.makedirs(os.environ['TMPDIR'])
        t4_cache, t4_tf = (os.path.join(work, 'telluride4_' + d)
                           for d in ('cache', 'tf'))
        t4_stages = corpus_main('telluride4', pathlib.Path(t4_stage).as_uri(),
                                t4_cache, t4_tf, device,
                                rd.RegressionDataTelluride4)
        for test_name, post in (('telluride4_linear', 20),
                                ('telluride4_cca', 21)):
            runs[test_name] = run_regression(torch, test_name, t4_tf, work,
                                             device, post)
        hi_cache, hi_tf = (os.path.join(work, 'impaired_' + d)
                           for d in ('cache', 'tf'))
        hi_stages = corpus_main('jens_impaired',
                                pathlib.Path(archive).as_uri(), hi_cache,
                                hi_tf, device, rd.RegressionDataJensImpaired)
        runs['jens_impaired_linear'] = run_regression(
            torch, 'jens_impaired_linear', os.path.join(hi_tf, 'subject_01'),
            work, device, 20)
    launches = read_launches()
    stop_recording()
    require_launched(launches, ('lag_stack', 'fused_cca_decode',
                                'fused_envelope_lagstack'), 'raw ingest')
    if sum(k2_shapes.values()) != launches['lag_stack']:
        raise AssertionError('recorded %d K2 launches of %d'
                             % (sum(k2_shapes.values()),
                                launches['lag_stack']))
    # K2 at every shape this path gave it, and the jens_impaired sweep's
    # bounded-memory moments (K2 on each file) against the CPU.
    check_lag_stack_shapes(torch, device, k2_shapes)
    bounded = bounded_moments_check(torch, 'jens_impaired_linear',
                                    os.path.join(hi_tf, 'subject_01'), 20,
                                    device)
    if lab_launches['fused_envelope_lagstack'] != LAB['trials']:
        raise AssertionError('the lab ingest launched K3 %d times, not %d'
                             % (lab_launches['fused_envelope_lagstack'],
                                LAB['trials']))
    check_leads(leads, planted, onsets, eeg_fs)
    bv_quanta = check_brainvision(os.path.join(lab_root, 'eeg'))
    if not decoding_results.get('dprime', 0.0) > 1.0:
        raise AssertionError('the lab experiment\'s dprime %s is not above '
                             '1' % decoding_results.get('dprime'))
    bars = {'telluride4_linear': t4_matched, 'telluride4_cca': t4_matched,
            'jens_impaired_linear': hi_matched}
    files = {'telluride4_linear': TELLURIDE4['trials'],
             'telluride4_cca': TELLURIDE4['trials'],
             'jens_impaired_linear': IMPAIRED['trials']}
    for test_name, run in runs.items():
        run['best_mean_r'] = sweep_gate(run, test_name,
                                        bars[test_name] - SWEEP_MARGIN,
                                        bars[test_name], files[test_name])
    # The card against the CPU: the same lab ingest with the plain
    # versions.
    cpu_tf = os.path.join(work, 'lab_tf_cpu')
    t0 = time.perf_counter()
    cpu_leads, cpu_stages, _ = raw_recordings.lab_ingest(
        ingest, preprocess, lab_root, cpu_tf, names, rate, eeg_fs,
        device='cpu')
    cpu_s = time.perf_counter() - t0
    if cpu_leads != leads:
        raise AssertionError('leads on the CPU %s vs the card %s'
                             % (cpu_leads, leads))
    ingest_err, n_files = compare_ingests(lab_tf, cpu_tf)
    cpu_scores = lab_frame_scores(lab_model, lab_tf, 'cpu', test_file, rate)
    score_err = float(np.max(np.abs(card_scores - cpu_scores)))
    if card_scores.shape != cpu_scores.shape or score_err > SERVE_TOL:
        raise AssertionError('the lab frame scores on the card differ from '
                             'the CPU plain decode by %g' % score_err)
    busy = device_busy(torch, lambda: raw_recordings.lab_ingest(
        ingest, preprocess, lab_root, os.path.join(work, 'lab_tf_profiled'),
        names, rate, eeg_fs, device=device))
    written = {'lab records': tree_bytes(lab_tf),
               'Telluride4 records': tree_bytes(t4_tf),
               'jens_impaired records': tree_bytes(hi_tf)}
    log('phase 12 raw ingest: staged inputs %s in %s; %s'
        % (json.dumps(staged_bytes), fmt_stages(build_s), smi))
    log('phase 12 lab ingest (%d trials x %d s, %d EEG channels + TRIG at %d '
        'Hz EDF, %d Hz stereo wavs, K3 to %d Hz) on the card: %s; on the '
        'CPU %.2f s (%s); %d files within %.2g of the CPU; BrainVision copy '
        'within %.3f EDF quanta; profiled ingest %s'
        % (LAB['trials'], LAB['seconds'], LAB['channels'], eeg_fs,
           LAB['audio_fs'], rate, fmt_stages(lab_stages), cpu_s,
           fmt_stages(cpu_stages), n_files, ingest_err, bv_quanta,
           fmt_busy(busy)))
    log('phase 12 lab leads (planted s, mode histogram s, Theil-Sen s, '
        'onsets): %s' % json.dumps({
            name: [planted[name], lead[0], round(lead[1], 7), lead[3]]
            for name, lead in leads.items()}))
    log('phase 12 lab decoding (CCA, contexts %s, %d dims, streamed fit) on '
        'the card: %.2f s; results %s; stages %s; frame scores of %s (%d '
        'frames, one K1 launch) within %.2g of the CPU plain decode; '
        'launches %s'
        % (LAB_CONTEXTS, LAB_DIMS, decoding_s, json.dumps(decoding_results),
           stage_line(decoding_report), test_file, card_scores.size,
           score_err, lab_launches))
    for what, stages in (('Telluride4', t4_stages),
                         ('jens_impaired', hi_stages)):
        log('phase 12 %s through the downloader: %s' % (what,
                                                        fmt_stages(stages)))
    for test_name, run in runs.items():
        log('phase 12 sweep %s: %d lambdas x %d files: %.2f s (%s); best mean '
            'held-out r %.4f (bar %.4f: the matched filter %.4f less %g); K2 '
            'launches %d; peak allocated %s'
            % (test_name, SWEEP_LAMBDAS.size, files[test_name],
               run['seconds'], stage_line(run['report']), run['best_mean_r'],
               bars[test_name] - SWEEP_MARGIN, bars[test_name], SWEEP_MARGIN,
               run['launches'], fmt_gb(run['peak_gb'])))
    log('phase 12 K2 bit-exact at the %d shapes of its %d launches on the '
        'path ([n, c] pre post: launches): %s'
        % (len(k2_shapes), sum(k2_shapes.values()),
           json.dumps({'[%d, %d] %d %d' % shape: count
                       for shape, count in sorted(k2_shapes.items())})))
    log('phase 12 jens_impaired bounded-memory moments (%d files, K2 on '
        'each): the card %.3f s, the CPU %.3f s; largest difference %.3g '
        'of the moment\'s largest (tolerance %g)'
        % (bounded[1], bounded[2], bounded[3], bounded[0], SWEEP_TOL))
    log('phase 12: bytes written %s; launches %s; %.1f s in all; %s'
        % (json.dumps(written), launches, time.perf_counter() - start, smi))
    return launches


def quiet_call(fn, *args):
    """Seconds of one call of ``fn``, its printed lines dropped."""
    import io
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        fn(*args)
    return time.perf_counter() - t0


def saved_model_files(model_dir):
    """(model.json as a dict, weights.npz's arrays) of a model directory."""
    with open(os.path.join(model_dir, 'model.json')) as f:
        meta = json.load(f)
    with np.load(os.path.join(model_dir, 'weights.npz')) as npz:
        return meta, {k: npz[k] for k in npz.files}


def require_same_bits(got, want, what):
    """Raises unless two {name: array} dicts hold the same names, dtypes,
    shapes and bytes (of each element of a string array)."""
    def same(g, w):
        if g.dtype != w.dtype or g.shape != w.shape:
            return False
        if w.dtype == object:
            return list(g.reshape(-1)) == list(w.reshape(-1))
        return g.tobytes() == w.tobytes()
    if sorted(got) != sorted(want) or not all(same(got[k], want[k])
                                              for k in want):
        raise AssertionError('%s: %s differ from %s' % (
            what, {k: (v.dtype, v.shape) for k, v in got.items()},
            {k: (v.dtype, v.shape) for k, v in want.items()}))


def snappy_bundle(work, weights, meta):
    """The codelab CCA weights as a bundle in the reference's positional
    layout, and a copy whose index blocks are snappy; returns the two
    reads, each with its seconds."""
    from telluride_decoding_torch.data.records import masked_crc32c
    from telluride_decoding_torch.io import tf_checkpoint
    plain = os.path.join(work, 'bundle', 'variables')
    packed = os.path.join(work, 'bundle_snappy', 'variables')
    for prefix in (plain, packed):
        os.makedirs(os.path.dirname(prefix))
    tensors = {'variables/%d/.ATTRIBUTES/VARIABLE_VALUE' % i: weights[name]
               for i, name in enumerate(('mean1', 'mean2', 'rot1', 'rot2'))}
    for attr in ('telluride_metadata', 'telluride_inputs',
                 'telluride_output'):
        if meta.get(attr):
            tensors['%s/.ATTRIBUTES/VARIABLE_VALUE' % attr] = np.array(
                meta[attr].encode('utf-8'), dtype=object)
    tf_checkpoint.write_tensor_bundle(plain, tensors)
    blocks = snappy_blocks.snappy_index(plain + '.index', packed + '.index',
                                        masked_crc32c)
    shutil.copyfile(plain + '.data-00000-of-00001',
                    packed + '.data-00000-of-00001')
    reads = {}
    for name, prefix in (('uncompressed', plain), ('snappy', packed)):
        t0 = time.perf_counter()
        reads[name] = (tf_checkpoint.read_tensor_bundle(prefix),
                       time.perf_counter() - t0)
    sizes = {name: os.path.getsize(prefix + '.index')
             for name, prefix in (('uncompressed', plain),
                                  ('snappy', packed))}
    return reads, blocks, sizes


def phase_model_files(torch, device, smi):
    """Model files on the card: phase 8's linear model exported as a
    SavedModel and migrated back (the same bits, the same predictions on
    the test file); phase 4's CCA model written in the layout tf_keras
    writes for the reference's subclassed CCA (saved_model.pb and
    keras_metadata.pb of export_keras --saved-model, a positional
    variables/ of --variables, decoder_model.json), served directly by
    cli.serve (K1) with scores and decisions bit-identical to the native
    directory's, then migrated (the same weights, config and telluride
    strings); the CCA weights' bundle read back from snappy index blocks;
    and the copied refusal of a CCA SavedModel written by
    export_saved_model."""
    from telluride_decoding_torch.cli import export_keras
    from telluride_decoding_torch.cli import migrate_saved_model, serve
    from telluride_decoding_torch.io.saved_model_pb import export_saved_model
    from telluride_decoding_torch.models.brain_model import load_model
    from telluride_decoding_torch.models.migrate import (
        load_reference_saved_model)
    from telluride_decoding_torch.ops.lagstack import lag_stack_np
    start = time.perf_counter()
    linear_src = os.path.join(DECODING_DIR, 'linear_model')
    for path in (CODELAB_DIR, linear_src):
        if not os.path.isfile(os.path.join(path, 'model.json')):
            raise AssertionError('phase 13 reads the models of phases 4 and '
                                 '8; %s has none' % path)
    work = os.path.join(BUILD, 'model_files')
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    dev = ['--device', str(device)]
    export_s, migrate_s = {}, {}
    read_launches = reset_launches()
    # 1. Linear: a SavedModel and back.
    linear_sm = os.path.join(work, 'linear_saved_model')
    linear_back = os.path.join(work, 'linear_migrated')
    export_s['saved_model linear'] = quiet_call(
        export_keras.app_main, dev + ['--saved-model', linear_src, linear_sm])
    migrate_s['linear'] = quiet_call(migrate_saved_model.app_main,
                                     dev + [linear_sm, linear_back])
    require_same_bits(saved_model_files(linear_back)[1],
                      saved_model_files(linear_src)[1],
                      'migrated linear weights')
    test_file = 'trial_%02d' % (DECODING_FILES - 1)
    test = brain_data(os.path.join(DECODING_DIR, 'records'), device, None,
                      100, (PRE, POST, 0, 0), test_file_pattern=test_file,
                      shuffle_buffer_size=0).create_dataset('test')
    predictions = [load_model(d, device).predict(test)
                   for d in (linear_src, linear_back)]
    if not np.array_equal(predictions[0], predictions[1]):
        raise AssertionError('the migrated linear model predicts otherwise')
    # 2. The reference layout of the CCA model.
    reference = os.path.relpath(os.path.join(work, 'reference_cca'))
    export_s['saved_model cca'] = quiet_call(
        export_keras.app_main, dev + ['--saved-model', CODELAB_DIR,
                                      reference])
    shutil.rmtree(os.path.join(reference, 'variables'))
    export_s['variables cca'] = quiet_call(
        export_keras.app_main, dev + ['--variables', CODELAB_DIR, reference])
    # 3. Served as it is, beside the native directory.
    with np.load(os.path.join(CODELAB_DIR, 'stream.npz')) as data:
        stream = (data['eeg'], data['audio1'], data['audio2'])
    served = {}
    for name, model_dir in (('native', CODELAB_DIR),
                            ('reference', reference)):
        served[name] = serve_stream(model_dir, stream, device, 100)
    launches = read_launches()
    require_launched(launches, ('fused_cca_decode',), 'model_files')
    if not same_decisions(served['reference'][0], served['native'][0]):
        raise AssertionError('the reference-layout directory serves other '
                             'scores or decisions than the native one')
    eeg, a1, a2 = stream
    correct = check_decisions(*served['reference'][:2],
                              stream_frames=eeg.shape[0])
    n = eeg.shape[0] - max(POST, IN2_POST)
    frames = (lag_stack_np(eeg, PRE, POST)[:n],
              lag_stack_np(a1, IN2_PRE, IN2_POST)[:n],
              lag_stack_np(a2, IN2_PRE, IN2_POST)[:n], a1[:n], a2[:n])
    scores = {name: serve.load_model(d, 'lda', device).infer_pair(*frames)
              for name, d in (('native', CODELAB_DIR),
                              ('reference', reference))}
    if not all(np.array_equal(g, w) for g, w in zip(scores['reference'],
                                                    scores['native'])):
        raise AssertionError('the reference-layout directory scores the '
                             'stream otherwise than the native one')
    # 4. Migrated to a native directory.
    migrated = os.path.join(work, 'reference_cca_migrated')
    migrate_s['cca'] = quiet_call(migrate_saved_model.app_main,
                                  dev + [reference, migrated])
    source_meta, source_weights = saved_model_files(CODELAB_DIR)
    migrated_meta, migrated_weights = saved_model_files(migrated)
    require_same_bits(migrated_weights, source_weights,
                      'migrated CCA weights')
    # The SavedModel carries no lambda: it migrates as 0.0, as in JAX.
    lambdas = (source_meta['config'].pop('regularization_lambda'),
               migrated_meta['config'].pop('regularization_lambda'))
    if migrated_meta != source_meta or lambdas[1] != 0.0:
        raise AssertionError('migrated model.json %s (lambda %s) differs '
                             'from the source\'s %s'
                             % (migrated_meta, lambdas[1], source_meta))
    # 5. Snappy index blocks.
    reads, blocks, sizes = snappy_bundle(work, source_weights, source_meta)
    require_same_bits(reads['snappy'][0], reads['uncompressed'][0],
                      'snappy bundle')
    # 6. The copied refusal: export_saved_model writes the CCA model with
    # two Dense kernels, which migration refuses as a DNN.
    exported = os.path.join(work, 'cca_export')
    t0 = time.perf_counter()
    export_saved_model(load_model(CODELAB_DIR, device), exported)
    export_s['export_saved_model cca'] = time.perf_counter() - t0
    try:
        load_reference_saved_model(exported, device=device)
    except ValueError as error:
        refusal = str(error)
    else:
        raise AssertionError('a CCA SavedModel of export_saved_model '
                             'migrated; the JAX package refuses it')
    if refusal != CCA_EXPORT_REFUSAL:
        raise AssertionError('refused with %r, not the JAX text %r'
                             % (refusal, CCA_EXPORT_REFUSAL))
    log('phase 13 model files: linear SavedModel and back: weights '
        'bit-identical, %d test-file predictions identical; the reference '
        'layout of the codelab CCA (%s) served as it is: %d windows, %.3f on '
        'the planted side, scores and decisions bit-identical to the native '
        'directory\'s; migrated weights bit-identical, config and telluride '
        'strings equal (lambda %s -> %s); snappy bundle (%d blocks, index %d '
        '-> %d bytes) reads equal; CCA export refused with the JAX text'
        % (predictions[0].shape[0], reference, len(served['reference'][0]),
           correct, lambdas[0], lambdas[1], blocks, sizes['uncompressed'],
           sizes['snappy']))
    log('phase 13 model_files: ' + json.dumps({
        'export_s': export_s,
        'bundle_read_s': {k: v[1] for k, v in reads.items()},
        'migrate_s': migrate_s,
        'serve_p50_ms': {k: v[1]['latency_p50_ms'] for k, v in served.items()},
        'serve_p95_ms': {k: v[1]['latency_p95_ms'] for k, v in served.items()},
        'k1_launches': launches['fused_cca_decode']}))
    log('phase 13: launches %s; %.1f s in all; %s'
        % (launches, time.perf_counter() - start, smi))
    return launches


def decisions_match(got, want, tol=SERVE_TOL, what='served'):
    """The same windows and decisions, scores within ``tol`` (0: the
    same bits); returns the largest score difference."""
    if len(got) != len(want) or not got:
        raise AssertionError('%s: %d served windows against %d'
                             % (what, len(got), len(want)))
    worst = 0.0
    for g, w in zip(got, want):
        if (g['window'], g['attend_speaker1']) != (w['window'],
                                                   w['attend_speaker1']):
            raise AssertionError('%s: decisions differ: %s vs %s'
                                 % (what, g, w))
        worst = max(worst, abs(g['score1'] - w['score1']),
                    abs(g['score2'] - w['score2']))
    if worst > tol:
        raise AssertionError('%s: scores differ by %g (limit %g)'
                             % (what, worst, tol))
    return worst


def epoch_profile(torch, device, data_dir, test_file, epochs=2):
    """The DNN's dense fit (hidden 20-20, batches of 512, SGD_LR): the
    seconds of the host's lag-stacked train split (create_dataset), of a
    fit of one epoch and of ``epochs`` epochs (host clock, the card
    synchronised), the steps an epoch, and the busy split of device_busy
    over a profiled fit of ``epochs`` epochs."""
    from telluride_decoding_torch.models.brain_model import BrainModelDNN
    data = brain_data(data_dir, device, None, 100, (PRE, POST, 0, 0),
                      train_file_pattern='allbut',
                      validate_file_pattern=test_file,
                      test_file_pattern=test_file, final_batch_size=512)
    t0 = time.perf_counter()
    train = data.create_dataset('train')
    times = {'train_split_s': time.perf_counter() - t0}
    model = BrainModelDNN(data.spec_dataset(), [20, 20], device=device)
    model.compile(learning_rate=SGD_LR)
    for count in (1, epochs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.fit(train, epochs=count)
        torch.cuda.synchronize()
        times['fit_%d_epochs_s' % count] = time.perf_counter() - t0
    busy = device_busy(torch, lambda: model.fit(train, epochs=epochs))
    params = model._trainable(0)
    opt = model._optimizer(params)
    x = torch.as_tensor(train.all_arrays()[0][:512], device=device)
    y = torch.as_tensor(train.all_arrays()[2][:512], device=device)
    times['syncs_a_step'] = host_syncs(
        torch, lambda: model._step(params, opt, x, x, y, None))
    return times, -(-train.num_frames // 512), busy


def host_syncs(torch, fn):
    """How often one call of ``fn`` makes the host wait for the card, as
    torch's sync debug mode reports it (one warning a synchronising
    call)."""
    import warnings
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode('warn')
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter('always')
            fn()
    finally:
        torch.cuda.set_sync_debug_mode('default')
    return sum('synchroniz' in str(w.message) for w in caught)


def dcca_step_split(torch, model, x1, x2):
    """ms of one DCCA step on a batch (SGD_TIMED_STEPS of them, host
    clock, the card synchronised at the end), and of its parts: the
    towers' products forward and back, cca_loss forward and back on
    fixed tower outputs, and its three eigh calls forward alone; the
    host syncs of a step; the step's busy split under device_busy."""
    from telluride_decoding_torch.solvers import cca as cca_solver
    params = model._trainable(0)
    opt = model._optimizer(params)
    batch = {'input_1': x1, 'input_2': x2}

    def timed(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(SGD_TIMED_STEPS):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / SGD_TIMED_STEPS * 1e3

    def towers():
        h1 = model._tower(params, 1, x1)
        h2 = model._tower(params, 2, x2)
        (h1.sum() + h2.sum()).backward()
    with torch.no_grad():
        h = [model._tower(params, i + 1, x) for i, x in enumerate((x1, x2))]

    def loss():
        a, b = (t.detach().requires_grad_(True) for t in h)
        cca_solver.cca_loss(a, b, model._cca_dims, model._reg,
                            model._reg).backward()
    sym = [torch.eye(model._cca_dims, device=x1.device) + 0.1 * t.T @ t /
           t.shape[0] for t in h]

    def eighs():
        for m in (sym[0], sym[1], sym[0] @ sym[1]):
            torch.linalg.eigh(m)
    step = lambda: model._step(params, opt, x1, x2, None, None)  # noqa: E731
    split = dict(step_ms=timed(step), towers_ms=timed(towers),
                 cca_loss_ms=timed(loss), eigh3_ms=timed(eighs),
                 syncs_a_step=host_syncs(torch, step))
    wall, kernel_s, copy_s = device_busy(
        torch, lambda: [step() for _ in range(SGD_TIMED_STEPS)])
    split['step_device_ms'] = (None if kernel_s is None else
                               (kernel_s + copy_s) / SGD_TIMED_STEPS * 1e3)
    split['step_idle'] = (None if kernel_s is None else
                          1 - (kernel_s + copy_s) / wall)
    return split


def time_dcca_k1(torch, decoder, attended, unattended):
    """K1 at the DCCA decoder's shapes, F1 = F2 = D = 10: the test
    split's frames (windows of one frame, single form) and a served pair
    of SERVE_ROWS frames, both on the towers' outputs, against the plain
    version; call, host and device ms beside the bound."""
    from telluride_decoding_torch.ops.decode_kernel import (
        f32_plan, fused_cca_decode, fused_cca_decode_reference)
    model = decoder.decoding_model
    folded = decoder._pipeline.folded
    in1, in2, _, _ = attended.all_arrays()
    keep = (in1.shape[0] // attended.batch_size) * attended.batch_size
    with torch.no_grad():
        h1 = model.tower(1, in1[:keep])[:, None, :].contiguous()
        h2 = model.tower(2, in2[:keep])[:, None, :].contiguous()
        h2b = model.tower(2, unattended.all_arrays()[1][:SERVE_ROWS])[
            :, None, :].contiguous()
    param_bytes = sum(p.numel() * p.element_size() for p in folded)
    dims = folded.rot1.shape[1]
    sms = torch.cuda.get_device_properties(h1.device).multi_processor_count
    timed = {}
    for name, args in (('frame_scores', (h1, h2)),
                       ('serve_pair', (h1[:SERVE_ROWS], h2[:SERVE_ROWS],
                                       h2b))):
        n = args[0].shape[0]
        want = torch.stack([fused_cca_decode_reference(folded, args[0], x)
                            for x in args[1:]])
        err = require_close(
            torch, 'fused_cca_decode DCCA %s W=%d F=%d' % (name, n, dims),
            fused_cca_decode(folded, *args).reshape(want.shape), want,
            F32_TOL)

        def call():
            return fused_cca_decode(folded, *args)
        ms, plain_ms = interleaved_ms(
            torch, call, lambda: [fused_cca_decode_reference(folded, args[0],
                                                             x)
                                  for x in args[1:]])
        streams = len(args) - 1
        limit, limited_by = bound(
            (args[0].numel() + streams * args[1].numel()) * 4 + param_bytes
            + streams * n * 4, 2 * n * dims * (2 * dims + 2) * streams)
        timed[name] = dict(windows=n, frames=1, f1=dims, f2=dims, dims=dims,
                           streams=streams,
                           cluster=f32_plan(n, 1, dims, dims, sms)[0],
                           ms=ms, plain_ms=plain_ms,
                           host_ms=host_ms(torch, call),
                           device_ms=device_ms(torch, call, F32_SYMBOL),
                           bound_ms=limit, bound_by=limited_by,
                           max_abs_err=err)
    return timed


def streamed_fit_card_vs_cpu(device, data_dir, test_file):
    """The DNN's streamed fit (hidden 20-20, SGD_LR, batches of
    SGD_STREAM_BATCH) over the short copy's train files, on the card and
    on the CPU from one initialisation; returns (steps, the largest
    parameter and loss differences)."""
    from telluride_decoding_torch.models.brain_model import BrainModelDNN
    import torch
    fits = []
    init = None
    steps = []
    for where in (device, 'cpu'):
        data = brain_data(data_dir, where, None, 100, (PRE, POST, 0, 0),
                          train_file_pattern='allbut',
                          validate_file_pattern=test_file,
                          test_file_pattern=test_file)
        model = BrainModelDNN(data.spec_dataset(), [20, 20], device=where)
        model.compile(learning_rate=SGD_LR)
        if init is None:
            init = model._init_params(torch.Generator().manual_seed(0))
        model.set_params(init)
        step = model._step
        model._step = lambda *a: steps.append(1) or step(*a)
        history = model.fit_streaming(data, 'train',
                                      batch_size=SGD_STREAM_BATCH)
        fits.append((history['loss'],
                     {k: v.cpu().numpy() for k, v in model.params.items()}))
    (card_loss, card), (cpu_loss, cpu) = fits
    param_err = max(float(np.max(np.abs(card[k] - cpu[k]))) for k in cpu)
    loss_err = float(np.max(np.abs(np.subtract(card_loss, cpu_loss))))
    if param_err > SGD_CARD_TOL or loss_err > SGD_CARD_TOL:
        raise AssertionError('the streamed DNN fit on the card differs from '
                             'the CPU\'s by %g (parameters) and %g (loss)'
                             % (param_err, loss_err))
    return len(steps) // 2, param_err, loss_err


def classifier_corpus(directory, n_train=6000, n_test=3000, seed=55):
    """The reference's classifier corpus: x1 [n, 3], a label that is 1
    for about 31% of the frames, and x2 = 2 x1[:, :2] where the label is
    1, noise where it is 0."""
    from telluride_decoding_torch.data import records
    rng = np.random.RandomState(seed)
    shutil.rmtree(directory, ignore_errors=True)
    os.makedirs(directory)
    for n, name in ((n_train, 'trainset'), (n_test, 'heldout')):
        x1 = rng.randn(n, 3).astype(np.float32)
        label = (rng.randn(n, 1) > 0.5).astype(np.float32)
        x2 = (label * 2 * x1[:, :2] +
              (1 - label) * rng.randn(n, 2)).astype(np.float32)
        records.convert_data_to_tfrecords(
            {'x1': x1, 'x2': x2, 'label': label},
            os.path.join(directory, name + '.tfrecords'))


def run_classifier(work, device):
    """cli.decoding.main of the classifier on its reference corpus;
    returns (results.txt as {name: value}, seconds)."""
    import io
    from telluride_decoding_torch.cli import decoding
    corpus = os.path.join(work, 'classifier_corpus')
    classifier_corpus(corpus)
    summary = os.path.join(work, 'classifier_reference_summary')
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        if decoding.main(CLASSIFIER_FLAGS + [
                '--tfexample_dir', corpus, '--summary_dir', summary,
                '--device', str(device)]) != 0:
            raise AssertionError('cli.decoding.main failed')
    return read_results(summary), time.perf_counter() - t0


def run_sgd_cohort(subjects, work, device):
    """``cli.cohort.main`` of a fullyconnected cohort with per-subject
    checkpoints, then the same command again, which must restore every
    subject and write the same CSV; returns (seconds of each run, the
    cohort CSV)."""
    import io
    from telluride_decoding_torch.cli import cohort
    ckpt = os.path.join(work, 'checkpoints')
    shutil.rmtree(ckpt, ignore_errors=True)
    argv = ['--input_field', 'eeg', '--output_field', 'intensity',
            '--post_context', str(SGD_COHORT_POST), '--dnn_regressor',
            'fullyconnected', '--epoch_count', '2',
            '--regularization_list', SGD_COHORT_LAMBDAS,
            '--sweep_checkpoint_dir', ckpt, '--device', str(device)]
    for path in subjects.values():
        argv += ['--subject_dir', path]
    texts, seconds = [], []
    for run in range(2):
        csv = os.path.join(work, 'cohort_%d.csv' % run)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            if cohort.main(argv + ['--cohort_csv_file', csv]) != 0:
                raise AssertionError('cli.cohort.main failed')
        seconds.append(time.perf_counter() - t0)
        with open(csv) as f:
            texts.append(f.read())
    if texts[0] != texts[1]:
        raise AssertionError('the resumed SGD cohort wrote another CSV:\n%s'
                             '\n%s' % tuple(texts))
    return seconds, texts[0]


def phase_sgd(torch, device, smi):
    """The SGD families on the card, through cli.decoding.main on phase
    8's corpus: (a) the DNN at the flag defaults, d' above 1, with its
    epoch and step times, peak allocation and idle share; (b) the DCCA
    (10 canonical dimensions), d' above 1, its step split, and its
    decoder's frame scores over the test file through K1 on the towers'
    outputs; (c) the match-mismatch classifier on phase 8's corpus
    (accuracy reported) and on the reference's classifier corpus
    (accuracy above 0.9);
    (e) the DCCA directory serving phase 4's stream and a stream of
    phase 8's subject (K1 a chunk), scores within SERVE_TOL of a serve on
    the CPU with the plain versions and the same decisions; (g) an SGD
    cohort with checkpoints, rerun and resumed to the same CSV. Those are
    the main path, whose launches are counted. Then, not counted: (d)
    the streamed DNN fit on the card against the CPU, and (f) K1 against
    its plain version at F1 = F2 = D = 10 (the frame scores and a served
    pair, cluster 16). Returns (launches, K1's numbers at F = 10)."""
    from telluride_decoding_torch.cli import cohort as cohort_cli
    start = time.perf_counter()
    on_card = str(device).startswith('cuda')
    work = SGD_DIR
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    data_dir = os.path.join(DECODING_DIR, 'records')
    short_dir = os.path.join(DECODING_DIR, 'records_short')
    test_file = 'trial_%02d' % (DECODING_FILES - 1)
    if not os.path.isdir(short_dir):
        decoding_corpus(data_dir, short_dir=short_dir)
    codelab_stream = os.path.join(CODELAB_DIR, 'stream.npz')
    if os.path.isfile(codelab_stream):
        with np.load(codelab_stream) as data:
            streams = {'phase 4': (data['eeg'], data['audio1'],
                                   data['audio2'])}
    else:
        streams = {'phase 4': synthetic_recordings(
            7, IN1_CHANNELS, TRAIN_FILES, TRAIN_FRAMES, STREAM_FRAMES)[1]}
    # A stream of phase 8's subject: the train files of its corpus come
    # first from the same generator.
    streams['phase 8 subject'] = synthetic_recordings(
        8, IN1_CHANNELS, DECODING_FILES, TRAIN_FRAMES, STREAM_FRAMES)[1]
    cohort_root = os.path.join(work, 'cohort')
    cohort_corpus(cohort_root, os.path.join(work, 'cohort_short'),
                  *SGD_COHORT)
    subjects = cohort_cli.discover_subjects(cohort_root, [])
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    read_launches = reset_launches()
    runs, peaks = {}, {}
    epochs = ['--epoch_count', str(SGD_EPOCHS), '--learning_rate',
              str(SGD_LR)]
    for kind, extra in (('fullyconnected', epochs), ('dcca', epochs),
                        ('classifier', epochs + ['--mismatch_batch'])):
        runs[kind] = run_decoding(kind, data_dir, work, device, test_file,
                                  extra=extra)
        if on_card:
            peaks[kind] = torch.cuda.max_memory_allocated() / 2**30
            torch.cuda.reset_peak_memory_stats()
    classifier, classifier_s = run_classifier(work, device)
    dcca_dir = runs['dcca'][3]
    correct, windows, decoder, attended = window_accuracy(
        dcca_dir, data_dir, device, test_file)
    served, shares, serve_err = {}, {}, {}
    for name, stream in streams.items():
        path = os.path.join(work, name.replace(' ', '_'))
        shutil.copytree(dcca_dir, path)
        served[name] = serve_stream(path, stream, device, 100)
        shares[name] = planted_share(served[name][0], stream[0].shape[0])
    cohort_s, cohort_csv = run_sgd_cohort(subjects, work, device)
    launches = read_launches()
    require_launched(launches, ('fused_cca_decode',), 'sgd')
    for kind in ('fullyconnected', 'dcca'):
        if not runs[kind][0]['dprime'] > 1.0:
            raise AssertionError('%s: dprime %s is not above 1'
                                 % (kind, runs[kind][0]['dprime']))
    if not classifier['accuracy'] > 0.9:
        raise AssertionError('classifier: accuracy %s on the reference\'s '
                             'corpus is not above 0.9'
                             % classifier['accuracy'])
    # The served scores and decisions against a serve on the CPU.
    for name, stream in streams.items():
        path = os.path.join(work, name.replace(' ', '_') + '_cpu')
        shutil.copytree(dcca_dir, path)
        serve_err[name] = decisions_match(
            served[name][0], serve_stream(path, stream, 'cpu', 100)[0])
    # Not counted: the streamed fit card against CPU, K1 at F = 10.
    steps, param_err, loss_err = streamed_fit_card_vs_cpu(
        device, short_dir, test_file)
    k1 = {}
    if on_card:
        unattended = brain_data(
            data_dir, device, 'intensity2', 100,
            (PRE, POST, IN2_PRE, IN2_POST), out='intensity2',
            test_file_pattern=test_file, final_batch_size=512,
            shuffle_buffer_size=0).create_dataset('test')
        k1 = time_dcca_k1(torch, decoder, attended, unattended)
        fit_times, epoch_steps, busy = epoch_profile(torch, device,
                                                     data_dir, test_file)
        # Epochs 2..n of a fit: its upload and first epoch apart.
        epoch_s = fit_times['fit_2_epochs_s'] - fit_times['fit_1_epochs_s']
        in1, in2, _, _ = attended.all_arrays()
        split = dcca_step_split(
            torch, decoder.decoding_model,
            decoder._tensor(in1[:512]), decoder._tensor(in2[:512]))
    for kind, (results, report, seconds, _) in runs.items():
        log('phase 14 sgd %s (dense fit, %d epochs) on the card: %.2f s; '
            'results %s%s' % (kind, SGD_EPOCHS, seconds, json.dumps(results),
                              '; peak allocation %.3f GiB' % peaks[kind]
                              if kind in peaks else ''))
        for line in report.splitlines()[1:]:
            log('phase 14 sgd %s stage %s' % (kind, line.strip()))
    if on_card:
        log('phase 14 sgd DNN dense fit alone (hidden 20-20, batch 512, lr '
            '%g): train split on the host %.3f s; fits of 1 and 2 epochs '
            '%.3f and %.3f s, so %.3f s an epoch of %d steps, %.3f ms a step '
            '(host clock), %d host syncs a step; profiled fit of two '
            'epochs: %s; %s'
            % (SGD_LR, fit_times['train_split_s'],
               fit_times['fit_1_epochs_s'], fit_times['fit_2_epochs_s'],
               epoch_s, epoch_steps, epoch_s / epoch_steps * 1e3,
               fit_times['syncs_a_step'], fmt_busy(busy), 'on the device %.4f ms a step'
               % ((busy[1] + busy[2]) / (2 * epoch_steps) * 1e3)
               if busy[1] is not None else 'device time not measured'))
        log('phase 14 sgd DCCA step split (batch 512, D 10, ms): %s'
            % json.dumps(split))
    log('phase 14 sgd classifier on the reference\'s corpus (6000 + 3000 '
        'frames, hidden 20, lr 0.001, 30 epochs of batches of 128): %.2f '
        's; results %s (the gate: accuracy above 0.9)'
        % (classifier_s, json.dumps(classifier)))
    log('phase 14 sgd DCCA decoder: test_by_window_means over %s, 100-frame '
        'windows: the attended stream wins %.3f of %d windows'
        % (test_file, correct, windows))
    for name in streams:
        log('phase 14 sgd DCCA serve of the %s stream: %d windows, %.3f on '
            'the planted side (the server\'s bar: 0.9), %.1f s, p50 %s ms, '
            'p95 %s ms; card scores within %.2g of the CPU serve, decisions '
            'identical'
            % (name, len(served[name][0]), shares[name], served[name][2],
               served[name][1].get('latency_p50_ms'),
               served[name][1].get('latency_p95_ms'), serve_err[name]))
    log('phase 14 sgd streamed DNN fit, card against CPU: %d steps of %d '
        'at lr %g, parameters within %.3g, losses within %.3g (limit %g)'
        % (steps, SGD_STREAM_BATCH, SGD_LR, param_err, loss_err,
           SGD_CARD_TOL))
    for name, t in k1.items():
        log('phase 14 fused_cca_decode float32 DCCA %s W=%d T=1 F=%d (%d '
            'stream(s), cluster %d): call %.4f ms, host %.4f ms, on the '
            'device %s, plain %.4f ms, bound %.4f ms (%s), max abs err %.3g'
            % (name, t['windows'], t['f1'], t['streams'], t['cluster'],
               t['ms'], t['host_ms'], fmt_ms(t['device_ms']), t['plain_ms'],
               t['bound_ms'], t['bound_by'], t['max_abs_err']))
    log('phase 14 sgd cohort (%d subjects x %d trials, post context %d, '
        'lambdas %s): %.2f s, resumed from its checkpoints in %.2f s with '
        'the same CSV: %s'
        % (SGD_COHORT[0], SGD_COHORT[1], SGD_COHORT_POST, SGD_COHORT_LAMBDAS,
           cohort_s[0], cohort_s[1], cohort_csv.replace('\n', ' ')))
    log('phase 14 sgd: launches %s; %.1f s in all; %s'
        % (launches, time.perf_counter() - start, smi))
    return launches, k1


def served_chunks(frames, chunk, delay):
    """Pushes of a replay of ``frames`` frames in chunks of ``chunk`` that
    score rows, one K1 launch each for a fused decode: every push after
    the first ``delay`` frames (the largest post context) have arrived."""
    return sum(min(k * chunk, frames) > delay
               for k in range(1, -(-frames // chunk) + 1))


def run_aot(device, models, stream, work):
    """Phase 15's main path on ``device``. ``models`` maps a name to
    (model directory, reduction, export flags); the first is a CCA
    model with lda. Each is exported with cli.export_aot.app_main on
    ``device`` and ``stream`` is served through cli.serve.main from the
    artifact (with no --serve_reduction: the artifact's own) and from
    the directory (with the reduction). The first artifact also serves
    pipelined and through one serve_lines session, and is exported again
    on the CPU and served on ``device``. Returns the artifacts, the
    export seconds, each serve's (decisions, summary, seconds, K1
    launches) and the serve_lines decisions."""
    import io
    from telluride_decoding_torch.cli import export_aot, serve
    from telluride_decoding_torch.ops.decode_kernel import fused_cca_decode
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    artifacts, export_s, served = {}, {}, {}

    def replay(key, path, extra=()):
        before = fused_cca_decode.launches
        decisions, summary, seconds = serve_stream(path, stream, device, 100,
                                                   extra)
        served[key] = (decisions, summary, seconds,
                       fused_cca_decode.launches - before)
    first = next(iter(models))
    exports = [(name, str(device), name) for name in models]
    exports.append((first + ' exported on the cpu', 'cpu', first))
    for key, on, name in exports:
        model_dir, reduction, flags = models[name]
        artifacts[key] = os.path.join(work, key.replace(' ', '_'))
        export_s[key] = quiet_call(export_aot.app_main, [
            model_dir, artifacts[key], '--reduction', reduction,
            '--device', on, *flags])
    for name, (model_dir, reduction, _) in models.items():
        native = os.path.join(work, name + '_dir')
        shutil.copytree(model_dir, native, ignore=shutil.ignore_patterns(
            'records*', 'stream.npz', '*.jsonl'))
        replay(name + ' dir', native, ['--serve_reduction', reduction])
        replay(name, artifacts[name])
    replay(first + ' pipelined', artifacts[first], ['--serve_pipeline'])
    replay(first + ' exported on the cpu',
           artifacts[first + ' exported on the cpu'])
    lines = serve.serve_lines(artifacts[first],
                              io.StringIO(stream_lines(stream)),
                              device=device)
    return artifacts, export_s, served, lines


def stream_frames(stream, params, frames=None):
    """The served inputs of ``stream`` (its first ``frames`` rows), lag
    stacked with the contexts of a model's experiment ``params``: the
    five arguments of infer_pair."""
    from telluride_decoding_torch.ops.lagstack import lag_stack_np
    pre, post = params.get('pre_context', 0), params.get('post_context', 0)
    pre2 = params.get('input2_pre_context', 0)
    post2 = params.get('input2_post_context', 0)
    eeg, a1, a2 = stream
    n = eeg.shape[0] - max(post, post2) if frames is None else frames
    return (lag_stack_np(eeg, pre, post)[:n],
            lag_stack_np(a1, pre2, post2)[:n],
            lag_stack_np(a2, pre2, post2)[:n], a1[:n], a2[:n])


def artifact_score_diff(artifact, model_dir, reduction, stream, device):
    """The largest difference between an artifact's infer_pair scores of
    the whole stream and its directory's live decoder's, relative to the
    larger of 1 and the score."""
    from telluride_decoding_torch.cli import serve
    from telluride_decoding_torch.decode import aot
    live = serve.load_model(model_dir, reduction, device)
    args = stream_frames(stream, live.decoding_model_params)
    got = aot.load_exported_decoder(artifact, device).infer_pair(*args)
    want = live.infer_pair(*args)
    return max(float(np.max(np.abs(g - w) / np.maximum(1.0, np.abs(w))))
               for g, w in zip(got, want))


def check_aot(served, lines, models, stream, delay, on_card):
    """Phase 15's checks of the served decision records; returns the
    largest score differences."""
    first = next(iter(models))
    worst = {}
    near = AOT_TOL + RECORD_UNIT
    for name in models:
        worst[name] = decisions_match(
            served[name][0], served[name + ' dir'][0],
            0.0 if name == first else near,
            '%s artifact against its directory' % name)
    for key, tol in ((first + ' pipelined', 0.0),
                     (first + ' exported on the cpu', SERVE_TOL)):
        worst[key] = decisions_match(served[key][0], served[first][0],
                                     tol, key)
    worst[first + ' serve_lines'] = decisions_match(
        lines, served[first][0], 0.0, first + ' serve_lines session')
    if not all(np.all(np.isfinite([d[k] for d in served[key][0]
                                   for k in ('score1', 'score2')]))
               for key in served):
        raise AssertionError('non-finite served scores')
    if on_card:
        chunks = served_chunks(stream[0].shape[0], SERVE_ROWS, delay)
        for key, (_, _, _, launches) in served.items():
            k1 = key.split(' ')[0] in ('cca', 'dcca')
            if launches != (chunks if k1 else 0):
                raise AssertionError(
                    '%s launched K1 %d times for %d served chunks'
                    % (key, launches, chunks))
    return worst


def refuse_jax_artifact(work, device):
    """A JAX package artifact (program infer_pair.shlo) is refused with
    the port's text; returns it."""
    from telluride_decoding_torch.cli import serve
    from telluride_decoding_torch.decode import aot
    path = os.path.join(work, 'jax_artifact')
    os.makedirs(path)
    with open(os.path.join(path, aot.MANIFEST_NAME), 'w') as f:
        json.dump({'format_version': 1, 'program': 'infer_pair.shlo',
                   'reduction': 'lda', 'platforms': ['tpu', 'cpu']}, f)
    try:
        serve._load_serving_decoder(path, None, device)
    except ValueError as error:
        text = str(error)
    else:
        raise AssertionError('a JAX artifact was served')
    if text != aot.jax_artifact_refusal(path):
        raise AssertionError('a JAX artifact refused with %r' % text)
    return text


def aot_call_times(artifact, model_dir, reduction, stream, device,
                   reps=AOT_HOST_REPS):
    """Load and first-call seconds of an artifact, and the host ms of one
    ``infer_pair`` of a served chunk (SERVE_ROWS frames), artifact
    against the live decoder of its directory: perf_counter over ``reps``
    calls each, in the order artifact, live, live, artifact (each call
    reads its scores back)."""
    from telluride_decoding_torch.cli import serve
    from telluride_decoding_torch.decode import aot
    t0 = time.perf_counter()
    exported = aot.load_exported_decoder(artifact, device)
    load_s = time.perf_counter() - t0
    live = serve.load_model(model_dir, reduction, device)
    args = stream_frames(stream, live.decoding_model_params, SERVE_ROWS)
    t0 = time.perf_counter()
    exported.infer_pair(*args)
    first_s = time.perf_counter() - t0
    live.infer_pair(*args)
    ms = {'artifact': [], 'live': []}
    for key in ('artifact', 'live', 'live', 'artifact'):
        decoder = exported if key == 'artifact' else live
        t0 = time.perf_counter()
        for _ in range(reps):
            decoder.infer_pair(*args)
        ms[key].append((time.perf_counter() - t0) / reps * 1e3)
    return load_s, first_s, {k: float(np.mean(v)) for k, v in ms.items()}


def phase_aot(torch, device, smi):
    """AOT artifacts on the card: phase 4's codelab CCA model (lda), phase
    14's DCCA (lda) and phase 8's linear model (first) exported through
    cli.export_aot, and phase 4's stream served from each artifact
    through cli.serve.main beside its directory; the CCA artifact also
    pipelined, through serve_lines, and exported on the CPU and served
    on the card; a JAX artifact refused. The CCA's served scores must be
    the directory's bit for bit, the DCCA's and the linear model's within
    AOT_TOL with the same decisions, and each CCA or DCCA serve must
    launch K1 once a served chunk. Then, not counted: load, first-call
    and host times of infer_pair, artifact against live decoder."""
    start = time.perf_counter()
    models = collections.OrderedDict([
        ('cca', (CODELAB_DIR, 'lda', ['--input_widths', '%d,%d' % (
            IN1_CHANNELS * (PRE + 1 + POST), IN2_PRE + 1 + IN2_POST),
            '--output_width', '1'])),
        ('dcca', (os.path.join(SGD_DIR, 'dcca_model'), 'lda', [])),
        ('linear', (os.path.join(DECODING_DIR, 'linear_model'), 'first',
                    []))])
    for model_dir, _, _ in models.values():
        if not os.path.isfile(os.path.join(model_dir, 'model.json')):
            raise AssertionError('phase 15 reads the models of phases 4, 8 '
                                 'and 14; %s has none' % model_dir)
    with np.load(os.path.join(CODELAB_DIR, 'stream.npz')) as data:
        stream = (data['eeg'], data['audio1'], data['audio2'])
    delay = max(POST, IN2_POST)
    read_launches = reset_launches()
    artifacts, export_s, served, lines = run_aot(device, models, stream,
                                                 AOT_DIR)
    launches = read_launches()
    require_launched(launches, ('fused_cca_decode',), 'aot')
    on_card = str(device).startswith('cuda')
    worst = check_aot(served, lines, models, stream, delay, on_card)
    raw = {key: artifact_score_diff(artifacts[key], models[name][0],
                                    models[name][1], stream, device)
           for key, name in (('cca', 'cca'), ('dcca', 'dcca'),
                             ('linear', 'linear'),
                             ('cca exported on the cpu', 'cca'))}
    if (raw['cca'] != 0.0 or max(raw['dcca'], raw['linear']) > AOT_TOL
            or raw['cca exported on the cpu'] > SERVE_TOL):
        raise AssertionError('artifact scores of the whole stream differ '
                             'from the live decoders\': %s' % raw)
    refusal = refuse_jax_artifact(AOT_DIR, device)
    times = {name: aot_call_times(artifacts[name], models[name][0],
                                  models[name][1], stream, device)
             for name in models}
    for key, (decisions, summary, seconds, k1) in served.items():
        log('phase 15 aot serve %s: %d windows, %.1f s, p50 %s ms, p95 %s '
            'ms, K1 launches %d'
            % (key, len(decisions), seconds, summary.get('latency_p50_ms'),
               summary.get('latency_p95_ms'), k1))
    log('phase 15 aot: served scores against the directory (0: the same '
        'bits): %s; infer_pair over the whole stream against the live '
        'decoder (relative): %s; each K1 serve launched K1 once for each '
        'of its %d served chunks; JAX artifact refused: %s'
        % (json.dumps(worst), json.dumps(raw),
           served_chunks(stream[0].shape[0], SERVE_ROWS, delay), refusal))
    log('phase 15 aot: ' + json.dumps({
        'export_s': export_s,
        'load_s': {k: v[0] for k, v in times.items()},
        'first_call_s': {k: v[1] for k, v in times.items()},
        'infer_pair_host_ms': {k: v[2] for k, v in times.items()},
        'serve_p50_ms': {k: v[1].get('latency_p50_ms')
                         for k, v in served.items()},
        'serve_p95_ms': {k: v[1].get('latency_p95_ms')
                         for k, v in served.items()},
        'k1_launches': {k: v[3] for k, v in served.items()}}))
    log('phase 15 aot: launches %s; %.1f s in all; %s'
        % (launches, time.perf_counter() - start, smi))
    return launches


def main():
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device is available.', file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from telluride_decoding_torch.device import cuda_device
    device = cuda_device(0)
    smi, hmma = phase_device(torch)
    k2 = phase_lagstack(torch, device)
    k1 = phase_decode(torch, device)
    codelab = phase_slice(torch, device, smi)
    k3 = phase_frontend(torch, device)
    phase_sosfilt(torch, device)
    kuleuven = phase_ingest_slice(torch, device, smi, k3['ms'])
    decoding, k1_frame_scores = phase_decoding(torch, device, smi)
    sweep = phase_sweep(torch, device, smi)
    cohort = phase_cohort(torch, device, smi)
    attention, s1 = phase_attention(torch, device, smi)
    raw_ingest = phase_raw_ingest(torch, device, smi)
    model_files = phase_model_files(torch, device, smi)
    sgd, k1_dcca = phase_sgd(torch, device, smi)
    aot = phase_aot(torch, device, smi)
    launches = {name: codelab[name] + kuleuven[name] + decoding[name] +
                sweep[name] + cohort[name] + attention[name] +
                raw_ingest[name] + model_files[name] + sgd[name] + aot[name]
                for name in kuleuven}
    common = dict(route='cuda', library_ms=None)
    kernels = [
        dict(name='fused_cca_decode',
             source='telluride_decoding_torch/csrc/decode_kernel.cu',
             replaces='telluride_decoding_tpu/ops/decode_kernel.py:123',
             launches=launches['fused_cca_decode'], hmma_in_sass=hmma,
             f32_frame_scores=k1_frame_scores,
             f32_dcca_frame_scores=k1_dcca['frame_scores'],
             f32_dcca_serve_pair=k1_dcca['serve_pair'], **k1, **common),
        dict(name='lag_stack',
             source='telluride_decoding_torch/csrc/lagstack.cu',
             replaces='telluride_decoding_tpu/ops/lagstack.py:93',
             launches=launches['lag_stack'], **k2, **common),
        dict(name='fused_envelope_lagstack',
             source='telluride_decoding_torch/csrc/fused_frontend.cu',
             replaces='telluride_decoding_tpu/ops/fused_frontend.py:157',
             launches=launches['fused_envelope_lagstack'], **k3, **common),
        dict(name='ssd_update',
             source='telluride_decoding_torch/csrc/ssd_update.cu',
             replaces='telluride_decoding_tpu/decide/attention_decoder.py:88',
             launches=launches['ssd_update'],
             sequence_launches=launches['ssd_sequence'],
             note='port of a jitted XLA program (_ssd_update), not of a '
                  'Pallas kernel; two forms over one window update: '
                  'ssd_window_kernel (launches, ms: serving) and '
                  'ssd_sequence_kernel (sequence_*: the infer sweep); '
                  'bounded by the latency of a chain of dependent Newton '
                  'steps (chain_bound_ms: chain_instructions of one step '
                  'counted in this build\'s SASS, weighed with '
                  'latency_cycles measured in this run), not by bytes or '
                  'operations (bound_ms)', **s1, **common),
    ]
    log(smi)
    log(json.dumps({'kernels': kernels}))
    log(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
