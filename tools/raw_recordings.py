"""Seeded raw recordings and corpora for the raw-recording ingest, and
a lab's ingest through either package's ingest API.

``chip_smoke.py`` (phase 12) drives them at full size on a card, and the
CPU tests (tests/test_torch_raw_ingest.py, test_torch_corpora.py,
test_torch_brainvision.py) at their own small sizes; the sizes live with
each caller, so a change to the chip script's phases does not change
what the tests compare. Nothing here imports a package of the repo at
import time: the builders write files with the port's writers, and
``lab_ingest`` takes the ingest and preprocess modules of either package.

  * build_lab_recordings: a lab's own stereo wavs (speech-like carrier
    and trigger pulses through cli.add_trigger.main) and EDF recordings
    (EEG through a planted TRF, and a Natus TRIG channel) with a planted
    lead per trial; trial 1 also as a BrainVision pair (write_bv_file).
  * build_telluride4_mat: a Telluride2015.mat with a planted TRF.
  * build_impaired_subject: one ds-eeg-snhl subject (BDF, events TSV,
    stimulus features).
  * lab_ingest: BrainExperiment of (wav, EdfBrainDataFile) trials,
    triggers, both lead estimates, fix_eeg_offset, intensity, EEG
    resample, z-score and TFRecords.
  * brainvision_quanta: the BrainVision copy against the EDF read.
"""

import collections
import contextlib
import os
import sys
import time

import numpy as np


def slow_envelope(rng, n, fs):
    """A positive envelope with knots every quarter second."""
    step = max(1, int(fs // 4))
    raw = 0.3 + np.abs(rng.randn(n // step + 2))
    idx = np.arange(n) / step
    lo = idx.astype(int)
    frac = idx - lo
    return (1 - frac) * raw[lo] + frac * raw[lo + 1]


def matched_filter_r(eeg, intensity, trf):
    """corr(sum_c sum_k trf[c, k] eeg[t + k, c], intensity[t]): the
    held-out r of the planted TRF's matched filter on one recording."""
    pred = np.zeros(eeg.shape[0])
    for k in range(trf.shape[1]):
        pred[:eeg.shape[0] - k] += eeg[k:] @ trf[:, k]
    return float(np.corrcoef(pred, intensity)[0, 1])


# The Natus level code of an EDF trigger channel (find_eeg_trigger_times):
# level k is written as (k + 32768) / NATUS_GAIN + NATUS_OFFSET, the
# middle of the raw interval that the fix rounds to k.
NATUS_GAIN, NATUS_OFFSET = -0.0063606452364314, 5151600


def decaying_trf(rng, channels, lags=16):
    """A random TRF, [channels, lags], decaying over four lags."""
    lag = np.arange(lags)
    return rng.randn(channels, lags) * np.exp(-lag / 4.0)


def respond(envelope, trf):
    """[n, channels]: the envelope through each channel's TRF."""
    n = envelope.shape[0]
    return np.stack([np.convolve(envelope, trf[c])[:n]
                     for c in range(trf.shape[0])], axis=1)


def build_lab_recordings(root, seed=12, trials=8, seconds=360, channels=64,
                         eeg_fs=512, audio_fs=44100, event_every=5,
                         lead_samples=(128, 1024), **_):
    """A lab's own recordings of one subject under ``root``: per trial,
    ``audio/trial_NN.wav`` (stereo int16: a noise carrier times a slow
    envelope, as build_kuleuven_cache's, and the trigger pulses that
    ``cli.add_trigger.main`` adds, one per ``event_every`` s) and
    ``eeg/trial_NN.edf`` (16-bit EDF of ``channels`` EEG channels and
    TRIG at ``eeg_fs``). The EEG recording starts a planted lead of
    ``lead_samples`` EEG samples before the audio: it follows the
    envelope through a random TRF from the lead on, and TRIG carries
    each audio onset, in the Natus level code, from the first EEG sample
    at or after it. Trial 1 is also written as a BrainVision pair.
    Returns ({trial: planted lead in s}, [EEG channel names],
    {trial: audio onsets})."""
    import scipy.io.wavfile
    from telluride_decoding_torch.cli import add_trigger
    from telluride_decoding_torch.io import edf
    rng = np.random.RandomState(seed)
    audio_dir, eeg_dir = os.path.join(root, 'audio'), os.path.join(root,
                                                                   'eeg')
    for d in (audio_dir, eeg_dir):
        os.makedirs(d, exist_ok=True)
    trf = decaying_trf(rng, channels)
    names = ['EEG%02d' % (c + 1) for c in range(channels)]
    n_eeg, n_audio = seconds * eeg_fs, seconds * audio_fs
    leads, onsets = {}, {}
    for t in range(trials):
        name = 'trial_%02d' % (t + 1)
        env = slow_envelope(rng, n_eeg, eeg_fs)
        carrier = 3000.0 * np.interp(np.arange(n_audio) / audio_fs,
                                     np.arange(n_eeg) / eeg_fs, env)
        carrier *= rng.randn(n_audio)
        raw_wav = os.path.join(audio_dir, name + '_raw.wav')
        scipy.io.wavfile.write(raw_wav, audio_fs, np.clip(
            carrier, -32767, 32767).astype(np.int16))
        del carrier
        wav = os.path.join(audio_dir, name + '.wav')
        with contextlib.redirect_stdout(sys.stderr):
            add_trigger.main(['--input_filename', raw_wav,
                              '--output_filename', wav,
                              '--number_of_events=-%d' % event_every],
                             rng=np.random.RandomState(seed * 100 + t))
        os.remove(raw_wav)
        _, stereo = scipy.io.wavfile.read(wav)
        pulses = stereo[:, 1] > 0
        onsets[name] = np.flatnonzero(pulses[1:] & ~pulses[:-1]) + 1
        if pulses[0]:
            onsets[name] = np.concatenate([[0], onsets[name]])
        del stereo, pulses
        lead = int(rng.randint(lead_samples[0], lead_samples[1] + 1))
        leads[name] = lead / float(eeg_fs)
        total = lead + n_eeg + eeg_fs
        eeg = 2.0 * rng.randn(total, channels)
        eeg[lead:lead + n_eeg] += respond(env, trf)
        level = np.zeros(total)
        # The first EEG sample at or after each audio onset (exact
        # integer ceiling), shifted by the lead; pulses of 0.1 s.
        for s in -(-onsets[name] * eeg_fs // audio_fs) + lead:
            level[s:s + eeg_fs // 10] = 1.0
        signals = [eeg[:, c] for c in range(channels)]
        signals.append((level + 32768) / NATUS_GAIN + NATUS_OFFSET)
        edf.write_edf(os.path.join(eeg_dir, name + '.edf'), signals,
                      names + ['TRIG'], [float(eeg_fs)] * (channels + 1))
        if t == 0:
            write_bv_file(os.path.join(eeg_dir, name + '.vhdr'),
                          np.stack(signals, axis=1), names + ['TRIG'], eeg_fs)
    return leads, names, onsets


def write_bv_file(header_filename, data, channel_names, sample_rate,
                  resolutions=None, unit='uV'):
    """Writes [N, C] samples as a .vhdr + .eeg pair in the form
    read_bv_file reads: multiplexed IEEE_FLOAT_32 of data / resolution,
    SamplingInterval in microseconds, DataFile as '$b.eeg'."""
    if not header_filename.endswith('.vhdr'):
        header_filename += '.vhdr'
    data = np.asarray(data, np.float64)
    num_channels = data.shape[1]
    if len(channel_names) != num_channels:
        raise ValueError('%d channel names for %d channels.'
                         % (len(channel_names), num_channels))
    if resolutions is None:
        resolutions = [1.0] * num_channels
    lines = ['Brain Vision Data Exchange Header File Version 1.0', '',
             '[Common Infos]', 'DataFile=$b.eeg',
             'DataFormat=BINARY', 'DataOrientation=MULTIPLEXED',
             'NumberOfChannels=%d' % num_channels,
             'SamplingInterval=%r' % (1e6 / sample_rate), '',
             '[Binary Infos]', 'BinaryFormat=IEEE_FLOAT_32', '',
             '[Channel Infos]']
    lines += ['Ch%d=%s,,%r,%s' % (c + 1, name, float(resolution), unit)
              for c, (name, resolution) in enumerate(
                  zip(channel_names, resolutions))]
    with open(header_filename, 'w') as fp:
        fp.write('\n'.join(lines) + '\n')
    samples = (data / np.asarray(resolutions, np.float64)).astype('<f4')
    with open(header_filename[:-len('.vhdr')] + '.eeg', 'wb') as f:
        f.write(samples.tobytes())


def lab_ingest(ingest_module, preprocess_module, root, tf_dir, channel_names,
               frame_rate=64, eeg_fs=512, **device):
    """A lab's ingest through the ingest API of either package: a
    BrainExperiment of (wav, EdfBrainDataFile) trials; per trial the
    audio and EEG onsets (remove_close_times), the lead by the mode
    histogram and by Theil-Sen, fix_eeg_offset by the former, the
    intensity of audio channel 0 at ``frame_rate`` (K3 on a CUDA
    device) and the EEG channels resampled to ``frame_rate``; then the
    experiment's z-score and TFRecords. ``device`` goes to the port's
    AudioFeatures and Preprocessor (the JAX ones take none). Returns
    ({trial: (mode lead, Theil-Sen lead, outliers, audio onsets, EEG
    onsets)}, {stage: s}, [files])."""
    stages = collections.OrderedDict()

    def stage(name, t0):
        stages[name] = stages.get(name, 0.0) + time.perf_counter() - t0
    names = sorted(f[:-len('.edf')]
                   for f in os.listdir(os.path.join(root, 'eeg'))
                   if f.endswith('.edf'))
    exp = ingest_module.BrainExperiment(
        {n: [n, ingest_module.EdfBrainDataFile(n)] for n in names},
        os.path.join(root, 'audio'), os.path.join(root, 'eeg'),
        frame_rate=frame_rate)
    t0 = time.perf_counter()
    exp.load_all_data()
    stage('wav and EDF read', t0)
    leads = {}
    for trial in exp.iterate_trials():
        t0 = time.perf_counter()
        audio_times = ingest_module.remove_close_times(
            trial.find_audio_trigger_times(1))
        eeg_times = ingest_module.remove_close_times(
            trial.find_eeg_trigger_times('TRIG')[0])
        mode = ingest_module.find_temporal_offset_via_mode_histogram(
            audio_times, eeg_times, max_time=4.0, fs=eeg_fs)
        theil_sen, outliers = (
            ingest_module.find_temporal_offset_via_linear_regression(
                audio_times, eeg_times, verbose=False))
        trial.fix_eeg_offset(mode)
        leads[trial.trial_name] = (mode, float(theil_sen), outliers,
                                   len(audio_times), len(eeg_times))
        stage('triggers and fix_eeg_offset', t0)
        t0 = time.perf_counter()
        features = preprocess_module.AudioFeatures(
            'intensity', trial.sound_fs, frame_rate, **device)
        trial.add_model_feature('intensity', features.compute_intensity(
            trial.sound_data[:, 0]))
        stage('intensity', t0)
        t0 = time.perf_counter()
        trial.assemble_brain_data(list(channel_names))
        resampler = preprocess_module.Preprocessor('eeg', eeg_fs, frame_rate,
                                                   **device)
        trial.add_model_feature('eeg', resampler.resample(
            trial.model_features['eeg']))
        stage('EEG gather and resample', t0)
    t0 = time.perf_counter()
    exp.z_score_all_data()
    stage('z-score', t0)
    t0 = time.perf_counter()
    os.makedirs(tf_dir, exist_ok=True)
    files = exp.write_all_data(tf_dir)
    stage('TFRecord write', t0)
    return leads, stages, files


def brainvision_quanta(eeg_dir, name='trial_01'):
    """The largest difference of the BrainVision copy from the EDF read,
    channel by channel over the recording (the EDF read also holds the
    zeros that pad its last data record), in EDF quanta ((physical max -
    min) / 65535). Raises if the two name different channels."""
    from telluride_decoding_torch.io import ingest
    from telluride_decoding_torch.io.brainvision import BvBrainDataFile
    bv, edf_file = BvBrainDataFile(name), ingest.EdfBrainDataFile(name)
    bv.load_all_data(eeg_dir)
    edf_file.load_all_data(eeg_dir)
    if bv.signal_names != edf_file.signal_names:
        raise AssertionError('BrainVision channels %s vs EDF %s'
                             % (bv.signal_names, edf_file.signal_names))
    headers = ingest.parse_edf_file(os.path.join(
        eeg_dir, name + '.edf'))['signal_headers']
    worst = 0.0
    for h, channel in zip(headers, bv.signal_names):
        quantum = (h['physical_max'] - h['physical_min']) / 65535.0
        got = bv.signal_values(channel)
        diff = np.max(np.abs(got - edf_file.signal_values(channel)[
            :got.shape[0]]))
        worst = max(worst, diff / quantum)
    return worst


def build_telluride4_mat(path, seed=13, trials=32, tracks=4, channels=64,
                         frames=3840, noise=2.0):
    """A seeded Telluride2015.mat: ``tracks`` audio intensity tracks at
    64 Hz, and ``trials`` EEG trials, trial i following track i mod
    ``tracks`` through a planted TRF plus noise. Returns the mean over
    trials of the TRF's matched-filter r."""
    import scipy.io as spio
    rng = np.random.RandomState(seed)
    trf = decaying_trf(rng, channels)
    wav = np.empty((tracks,), object)
    eeg = np.empty((trials,), object)
    for k in range(tracks):
        wav[k] = slow_envelope(rng, frames, 64)[:, None]
    rs = []
    for i in range(trials):
        attended = wav[i % tracks][:, 0]
        eeg[i] = respond(attended, trf) + noise * rng.randn(frames, channels)
        rs.append(matched_filter_r(eeg[i], attended, trf))
    os.makedirs(os.path.dirname(path), exist_ok=True)
    spio.savemat(path, {'data': {'eeg': eeg, 'wav': wav}})
    return float(np.mean(rs))


def build_impaired_subject(root, seed=14, subject=1, channels=64, fs=512,
                           trials=48, dual=32, frames=25600, gap=512,
                           noise=2.0, split_events=False):
    """One subject in ds-eeg-snhl's tree under ``root`` (the layout of
    tests/conftest.py:build_impaired_tree): a 24-bit BDF of ``channels``
    at ``fs`` holding ``trials`` trials of ``frames`` samples apart by
    ``gap``, the EEG following each trial's target feature through a
    planted TRF; the events TSV (targetonset, and maskeronset a few
    samples later for the first ``dual`` trials; with ``split_events``
    its second half in ``_run-2_events.tsv``); derivatives/stimuli .mat
    features at the EEG's rate. Returns the mean over trials of the
    TRF's matched-filter r."""
    import scipy.io as spio
    from telluride_decoding_torch.io import edf
    rng = np.random.RandomState(seed)
    sub = 'sub-%03d' % subject
    eeg_dir = os.path.join(root, sub, 'eeg')
    stimuli = os.path.join(root, 'derivatives', 'stimuli',
                           'sub%03d' % subject)
    for d in (eeg_dir, os.path.join(stimuli, 'target'),
              os.path.join(stimuli, 'masker')):
        os.makedirs(d, exist_ok=True)
    trf = decaying_trf(rng, channels)
    eeg = noise * rng.randn(trials * (frames + gap) + gap, channels)
    rows, rs = [], []
    for trial in range(1, trials + 1):
        start = gap + (trial - 1) * (frames + gap)
        target = slow_envelope(rng, frames, fs)
        eeg[start:start + frames] += respond(target, trf)
        rs.append(matched_filter_r(eeg[start:start + frames], target, trf))
        rows.append(('targetonset', start, 'n/a'))
        spio.savemat(os.path.join(stimuli, 'target', 't%03d.mat' % trial),
                     {'dat': {'feat': target}})
        if trial <= dual:
            rows.append(('maskeronset', start + int(rng.randint(
                1, min(64, frames // 2))),
                         'stim/m%03d.wav' % trial))
            spio.savemat(os.path.join(stimuli, 'masker', 'm%03d.mat' % trial),
                         {'dat': {'feat': slow_envelope(rng, frames, fs)}})
    events = os.path.join(eeg_dir, '%s_task-selectiveattention_events.tsv'
                          % sub)
    parts = ([rows[:len(rows) // 2], rows[len(rows) // 2:]]
             if split_events else [rows])
    for path, part in zip([events, events.replace('_events.tsv',
                                                  '_run-2_events.tsv')],
                          parts):
        with open(path, 'w') as f:
            f.write('trigger_type\tsample\tstim_file\n')
            f.writelines('%s\t%d\t%s\n' % row for row in part)
    edf.write_edf(os.path.join(eeg_dir, '%s_task-selectiveattention_eeg.bdf'
                               % sub),
                  [eeg[:, c] for c in range(channels)],
                  ['C%d' % (c + 1) for c in range(channels)],
                  [float(fs)] * channels, bdf=True)
    return float(np.mean(rs))
