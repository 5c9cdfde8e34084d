"""Download and ingestion of the standard AAD corpora into TFRecords
(port of cli/regression_data.py).

Ported: the MATLAB struct loader, the downloader (a .part file, the
Google Drive confirm-token retry; an HTML page or an empty body never
reaches the cache), the README.txt summary writer, the ``locations``
registry with the JAX URLs, and the four corpora: Telluride4 (one
.mat), the COCOHA/Jens memory corpus (the codelab's; a zip of one .mat
per subject), jens_impaired (ds-eeg-snhl, a tar of BDF EEG aligned to
its target and masker features by the events TSV) and KULeuven (Das et
al. 2016; raw audio becomes an intensity envelope by kernel K3 on the
card). The flags keep the JAX names, plus ``--device``:

  python -m telluride_decoding_torch.cli.regression_data --type kuleuven \\
      [--internet URL] [--cache_dir D] [--tf_output_dir T] \\
      [--desired_frame_rate 32] [--device cuda|cpu] [--force]

``--internet file:///path/archive`` fetches from a local file, so the
whole download runs offline. When the download fails, ``main`` says so
and returns 1. Where the JAX driver insists on the whole corpus before
it ingests, this one ingests the subjects the cache holds. Archives are
staged under $TMPDIR, as in the JAX driver.
"""

from __future__ import annotations

import argparse
import collections
import csv
import glob
import html
import http.cookiejar
import os
import re
import shutil
import sys
import tarfile
import urllib.parse
import urllib.request
import zipfile
from typing import List, Optional

import numpy as np
import scipy.io as spio

from telluride_decoding_torch import device as device_policy
from telluride_decoding_torch.data import records as records_io
from telluride_decoding_torch.io import edf as edf_io
from telluride_decoding_torch.io import ingest
from telluride_decoding_torch.signal import preprocess
from telluride_decoding_torch.utils.stdio import LateBoundStdout

regression_data_print = LateBoundStdout()


def _tmp_dir() -> str:
    """Where archives are staged: $TMPDIR, else /tmp."""
    return os.environ.get('TMPDIR') or '/tmp'


def make_if_not_exists(directory: str):
    os.makedirs(directory, exist_ok=True)


def loadmat(filename: str):
    """Loads a MATLAB file with structs as nested dictionaries."""

    def _todict(matobj):
        out = {}
        for field in matobj._fieldnames:
            elem = matobj.__dict__[field]
            if isinstance(elem, spio.matlab.mat_struct):
                out[field] = _todict(elem)
            else:
                out[field] = elem
        return out

    data = spio.loadmat(filename, struct_as_record=False, squeeze_me=True)
    for key in data:
        if isinstance(data[key], spio.matlab.mat_struct):
            data[key] = _todict(data[key])
    return data


def _fetch_to_file(opener, url: str, path: str):
    with opener.open(url, timeout=60) as response, open(path, 'wb') as f:
        while True:
            chunk = response.read(512 * 1024)
            if not chunk:
                break
            f.write(chunk)


def _looks_like_html(path: str) -> bool:
    with open(path, 'rb') as f:
        head = f.read(2048).lstrip()
    return head[:1] == b'<' or b'<html' in head.lower()


def download_from_gdrive(url: str, output: str,
                         debug: bool = False) -> Optional[str]:
    """HTTP (or file://) download with Google Drive's interstitial page
    handled; returns ``output``, or None with manual instructions.

    A large Drive file answers with an HTTP-200 HTML page ("can't scan
    for viruses") instead of the payload. The body goes to a .part file
    first; if it looks like HTML, the confirm-token retry runs once with
    the cookies kept. An HTML page or an empty body never reaches
    ``output``: the cache checks only that a file exists, so either
    would poison it for good."""
    del debug
    part = output + '.part'
    try:
        os.makedirs(os.path.dirname(os.path.abspath(output)), exist_ok=True)
        opener = urllib.request.build_opener(
            urllib.request.HTTPCookieProcessor(http.cookiejar.CookieJar()))
        _fetch_to_file(opener, url, part)
        wants_html = output.lower().endswith(('.htm', '.html'))
        if not wants_html and _looks_like_html(part):
            with open(part, 'rb') as f:
                page = f.read(65536).decode('utf-8', 'replace')
            params = dict(re.findall(
                r'name="(id|export|confirm|uuid)" value="([^"]*)"', page))
            action = re.search(r'action="([^"]+)"', page)
            if action and 'confirm' in params:
                # The form's action, unescaped and resolved against the
                # request URL; its own query string is extended.
                base = urllib.parse.urljoin(url,
                                            html.unescape(action.group(1)))
                sep = '&' if '?' in base else '?'
                retry_url = base + sep + urllib.parse.urlencode(params)
                _fetch_to_file(opener, retry_url, part)
            else:
                token = re.search(r'confirm=([0-9A-Za-z_-]+)', page)
                if token:
                    sep = '&' if '?' in url else '?'
                    _fetch_to_file(opener,
                                   url + sep + 'confirm=' + token.group(1),
                                   part)
        if not wants_html and _looks_like_html(part):
            os.remove(part)
            print('Download of %s returned an HTML page, not the file '
                  '(Google Drive confirmation could not be completed). '
                  'Fetch it manually to %s.' % (url, output),
                  file=regression_data_print)
            return None
        if os.path.getsize(part) == 0:
            os.remove(part)
            print('Download of %s produced an empty file. Fetch it '
                  'manually to %s.' % (url, output),
                  file=regression_data_print)
            return None
        os.replace(part, output)
        return output
    except Exception as error:
        try:
            if os.path.exists(part):
                os.remove(part)
        except Exception:
            pass
        print('Download of %s failed (%s). Fetch it manually to %s.' %
              (url, error, output), file=regression_data_print)
        return None


def write_summary(cache_dir: str, tf_dir: str, frame_rate: float,
                  all_ingested_files: Optional[List[str]] = None):
    """README.txt: provenance + feature shapes + per-file record counts."""
    readme_file = os.path.join(tf_dir, 'README.txt')
    with open(readme_file, 'w') as fp:
        print('These files were ingested from:', cache_dir, file=fp)
        print('Using:', sys.argv, file=fp)
        print('With a output frame rate of %gHz' % frame_rate, file=fp)
        if all_ingested_files:
            features = records_io.discover_feature_shapes(
                all_ingested_files[0])
            print('\nFeature shapes are:', file=fp)
            for k, v in features.items():
                print('\t%s: %s' % (k, v), file=fp)
            print('\nAll ingested files:', file=fp)
            for filename in all_ingested_files:
                count, error = records_io.count_tfrecords(filename)
                error_string = 'READ ERROR' if error else ''
                print('\t%s: %d records (%s seconds) %s' %
                      (filename, count, count / float(frame_rate),
                       error_string), file=fp)


def _ingest_experiment(trial_dict, tf_dir: str,
                       frame_rate: float) -> List[str]:
    """Loads, z-scores and writes one subject's trials."""
    exp = ingest.BrainExperiment(trial_dict, '.', '.', frame_rate=frame_rate)
    exp.load_all_data()
    exp.z_score_all_data()
    for trial in exp.iterate_trials():
        trial.assemble_brain_data('eeg_data')
    os.makedirs(tf_dir, exist_ok=True)
    return exp.write_all_data(tf_dir)


class RegressionData:
    """Base: download and ingest with idempotence checks."""

    def __init__(self, device='cuda'):
        self.device = device_policy.resolve(device)

    def download_data(self, url: str, cache_dir: str,
                      debug: bool = False) -> bool:
        """Writes the cache's README.txt; a corpus's own download_data
        fetches its files first."""
        del debug
        make_if_not_exists(cache_dir)
        readme_file = os.path.join(cache_dir, 'README.txt')
        with open(readme_file, 'w') as fp:
            fp.write('These files were downloaded\nFrom %s\nTo %s\n'
                     'Using: %s\n' % (url, cache_dir, sys.argv))
        return True

    def is_data_local(self, cache_dir: str) -> bool:
        raise NotImplementedError

    def is_data_ingested(self, tf_dir: str) -> bool:
        raise NotImplementedError

    def ingest_data(self, cache_dir: str, tf_dir: str,
                    desired_frame_rate: float):
        raise NotImplementedError


class RegressionDataTelluride4(RegressionData):
    """Telluride 2015 four-subject dataset (one .mat archive)."""

    @property
    def name(self):
        return 'Telluride4'

    def is_data_local(self, cache_dir):
        return os.path.exists(os.path.join(cache_dir, 'Telluride2015.mat'))

    def download_data(self, url, cache_dir, debug=False):
        make_if_not_exists(cache_dir)
        cache_file = os.path.join(cache_dir, 'Telluride2015.mat')
        if not download_from_gdrive(url, cache_file, debug=debug):
            return False
        return super().download_data(url, cache_dir)

    def is_data_ingested(self, tf_dir, num_files=32):
        return len(glob.glob(os.path.join(tf_dir,
                                          '*.tfrecords'))) == num_files

    def ingest_data(self, cache_dir, tf_dir, desired_frame_rate):
        """32 trials x (eeg + intensity/ones/attended) -> TFRecords."""
        mat_objects = loadmat(os.path.join(cache_dir,
                                           'Telluride2015.mat'))['data']
        eeg_signals = mat_objects['eeg']
        audio_signals = mat_objects['wav']
        if audio_signals.shape[0] != 4:
            raise ValueError('Incorrect shapes for audio_signals (%s)' %
                             str(audio_signals.shape))
        if eeg_signals.shape[0] != 32:
            raise ValueError('Incorrect shapes for eeg_signals (%s)' %
                             str(eeg_signals.shape))
        trial_dict = {}
        for i in range(eeg_signals.shape[0]):
            audio = audio_signals[i % 4]
            sound_dict = {
                'intensity': audio,
                'ones': np.ones(audio.shape, dtype=audio.dtype),
                'attended_speaker': np.zeros(audio.shape,
                                             dtype=audio.dtype),
            }
            trial_dict['trial_{:02d}'.format(i + 1)] = [
                sound_dict,
                ingest.MemoryBrainDataFile({'eeg_data': eeg_signals[i]})]
        all_files = _ingest_experiment(trial_dict, tf_dir,
                                       desired_frame_rate)
        write_summary(cache_dir, tf_dir, desired_frame_rate, all_files)


class RegressionDataJensMemory(RegressionData):
    """COCOHA/Jens 22-subject memory dataset (one .mat per subject)."""

    @property
    def name(self):
        return 'Jens'

    def is_data_local(self, cache_dir, num_subjects=22):
        if not os.path.exists(cache_dir):
            return False
        found = [f for f in os.listdir(cache_dir) if f.endswith('mat')]
        if found and len(found) != num_subjects:
            print('Found %d/%d subjects in %s; ingesting those.'
                  % (len(found), num_subjects, cache_dir))
        return bool(found)

    def download_data(self, url, cache_dir, debug=False):
        tmp_jens_dir = os.path.join(_tmp_dir(), 'jens_raw_data')
        make_if_not_exists(tmp_jens_dir)
        archive = os.path.join(tmp_jens_dir, 'DATA.zip')
        if not download_from_gdrive(url, archive, debug=debug):
            return False
        with zipfile.ZipFile(archive) as zf:
            zf.extractall(tmp_jens_dir)
        make_if_not_exists(cache_dir)
        for f in sorted(os.listdir(tmp_jens_dir)):
            if f.endswith('.mat'):
                os.replace(os.path.join(tmp_jens_dir, f),
                           os.path.join(cache_dir, f))
        return super().download_data(url, cache_dir)

    def is_data_ingested(self, tf_dir, num_subjects=22, num_trials=40):
        if os.path.exists(tf_dir):
            return sum(
                len(glob.glob(os.path.join(sdir, '*.tfrecords')))
                for sdir in glob.glob(os.path.join(tf_dir, 'subject_*'))
            ) >= num_trials * num_subjects
        return False

    def ingest_data(self, cache_dir, tf_dir, desired_frame_rate):
        """Per subject: 40 trials of eeg[69] + intensity[1] at 64 Hz."""
        mat_files_list = sorted(glob.glob(os.path.join(cache_dir, '*.mat')))
        os.makedirs(tf_dir, exist_ok=True)
        print('Ingesting %d files of Jens data.' % len(mat_files_list))
        all_ingested_files = []
        for sid, mat_file in enumerate(mat_files_list):
            mat_object = loadmat(mat_file)['data']
            fs = mat_object['fsample']
            trial_dict = {}
            for trial_idx, trial in enumerate(mat_object['trial']):
                eeg_signal = trial[:69, :].T
                audio_signal = trial[69:70, :].T
                p_eeg = preprocess.Preprocessor(
                    'eeg', fs, desired_frame_rate, device=self.device)
                p_audio = preprocess.Preprocessor(
                    'audio', fs, desired_frame_rate, device=self.device)
                trial_dict['trial_{:02d}'.format(trial_idx + 1)] = [
                    {'intensity': p_audio.resample(audio_signal)},
                    ingest.MemoryBrainDataFile(
                        {'eeg_data': p_eeg.resample(eeg_signal)},
                        sr=desired_frame_rate)]
            all_ingested_files.extend(_ingest_experiment(
                trial_dict,
                os.path.join(tf_dir, 'subject_{:02d}'.format(sid + 1)),
                desired_frame_rate))
        write_summary(cache_dir, tf_dir, desired_frame_rate,
                      all_ingested_files)


def _read_events(path: str) -> List[dict]:
    """The rows of a BIDS events TSV, in file order, keyed by its header
    (what pandas.read_csv(path, sep='\\t') gives, row for row)."""
    with open(path, newline='') as f:
        return list(csv.DictReader(f, delimiter='\t'))


def _sample(value: str) -> int:
    return int(float(value))


class RegressionDataJensImpaired(RegressionData):
    """Hearing-impaired dataset (ds-eeg-snhl, Fuglsang et al. 2020): BDF
    EEG aligned to target/masker audio features by the events TSV."""

    num_subjects = 44

    @property
    def name(self):
        return 'JensImpaired'

    def is_data_local(self, cache_dir):
        if not os.path.exists(cache_dir):
            return False
        found = [f for f in os.listdir(cache_dir) if f.startswith('sub-')]
        if found and len(found) != self.num_subjects:
            print('Found %d/%d subjects in %s; ingesting those.'
                  % (len(found), self.num_subjects, cache_dir))
        return bool(found)

    def download_data(self, url, cache_dir, debug=False):
        archive = os.path.join(_tmp_dir(), 'ds-eeg-snhl.tar')
        if download_from_gdrive(url, archive, debug=debug):
            make_if_not_exists(cache_dir)
            with tarfile.open(archive) as tf:
                tf.extractall(cache_dir, filter='data')
            # The archive wraps everything in ds-eeg-snhl/: hoist it, as
            # the manual instructions' `mv ds-eeg-snhl/* .` does. The
            # fresh extraction replaces what an earlier attempt left.
            wrapper = os.path.join(cache_dir, 'ds-eeg-snhl')
            if os.path.isdir(wrapper):
                for name in os.listdir(wrapper):
                    dst = os.path.join(cache_dir, name)
                    if os.path.isdir(dst):
                        shutil.rmtree(dst)
                    os.replace(os.path.join(wrapper, name), dst)
                os.rmdir(wrapper)
            return super().download_data(url, cache_dir)
        print('To download manually, use: wget -c {} -O {}/{}'.format(
            url, cache_dir, 'ds-eeg-snhl.tar'), file=regression_data_print)
        print(' cd %s; tar xvf ds-eeg-snhl.tar; mv ds-eeg-snhl/* .' %
              cache_dir, file=regression_data_print)
        return False

    def is_data_ingested(self, tf_dir, num_subjects=44, num_trials=48):
        if os.path.exists(tf_dir):
            return sum(
                len(glob.glob(os.path.join(tf_dir, sdir, '*.tfrecords')))
                for sdir in os.listdir(tf_dir)) >= num_trials * num_subjects
        return False

    @staticmethod
    def subject_events(cache_dir: str, subject_dir: str, sid: int):
        """(target onsets, [(masker trial, masker onset)]) in file order
        from the subject's events TSV; subject 24 (sid 23) has a second
        part, _run-2_events.tsv, read after the first."""
        events_file = os.path.join(
            cache_dir, subject_dir,
            'eeg/{}_task-selectiveattention_events.tsv'.format(subject_dir))
        rows = _read_events(events_file)
        if sid == 23:
            part2 = events_file.replace('_events.tsv', '_run-2_events.tsv')
            if os.path.exists(part2):
                rows += _read_events(part2)
        starts = [_sample(r['sample']) for r in rows
                  if r['trigger_type'] == 'targetonset']
        maskers = [(int(r['stim_file'].split('/')[-1][1:-4]),
                    _sample(r['sample'])) for r in rows
                   if r['trigger_type'] == 'maskeronset']
        return starts, maskers

    def ingest_data(self, cache_dir, tf_dir, desired_frame_rate):
        """Aligns 48 trials a subject of BDF EEG to the target/masker
        features via the events TSV. As in the JAX driver, the EEG is
        chopped at the BDF's own rate, the experiment is given
        frame_rate=512 and each trial's data file sr=desired_frame_rate
        (ROADMAP.md section 3)."""
        frame_rate = 512
        make_if_not_exists(tf_dir)
        all_dirs_sub = sorted(f for f in os.listdir(cache_dir)
                              if f.startswith('sub-'))
        for sid, subject_dir in enumerate(all_dirs_sub):
            tf_dir_subject = os.path.join(tf_dir,
                                          'subject_{:02d}'.format(sid + 1))
            if os.path.exists(os.path.join(tf_dir_subject, 'README.txt')):
                continue
            start_samples, maskers = self.subject_events(
                cache_dir, subject_dir, sid)
            if len(start_samples) != 48 or len(maskers) != 32:
                raise ValueError(
                    'Incorrect event counts for subject %s: %d/48 and '
                    '%d/32' % (subject_dir, len(start_samples),
                               len(maskers)))
            eeg_file = os.path.join(
                cache_dir, subject_dir,
                'eeg/{}_task-selectiveattention_eeg.bdf'.format(
                    subject_dir))
            sigbufs = np.stack(edf_io.read_edf(eeg_file)['signal_list'],
                               axis=1)
            stimuli = os.path.join(cache_dir, 'derivatives/stimuli',
                                   'sub{:03d}'.format(sid + 1))
            trial_dict = {}
            for trial_idx in range(1, 49):
                target = loadmat(os.path.join(
                    stimuli, 'target/t{:03d}.mat'.format(trial_idx))
                )['dat']['feat']
                start = int(start_samples[trial_idx - 1])
                chopped = sigbufs[start:start + target.shape[0], :]
                masker_start = [sample for trial, sample in maskers
                                if trial == trial_idx]
                if masker_start:
                    masker = loadmat(os.path.join(
                        stimuli, 'masker/m{:03d}.mat'.format(trial_idx))
                    )['dat']['feat']
                    diff = int(masker_start[0] - start)
                    if diff < 0:
                        raise ValueError(
                            'Subject %s trial %d: masker starts %d '
                            'samples BEFORE the target; data looks '
                            'corrupt.' % (subject_dir, trial_idx, -diff))
                    if diff > 0:
                        masker = np.concatenate((np.zeros(diff),
                                                 masker[:-diff]))
                    if len(masker) != len(target):
                        raise ValueError(
                            'Subject %s trial %d: masker/target length '
                            'mismatch (%d vs %d).' %
                            (subject_dir, trial_idx, len(masker),
                             len(target)))
                    trial_key = 'trial_{:02d}_dual_speaker'.format(
                        trial_idx)
                else:
                    masker = np.zeros_like(target)
                    trial_key = 'trial_{:02d}_single_speaker'.format(
                        trial_idx)
                trial_dict[trial_key] = [
                    {'attended_intensity': target,
                     'unattended_intensity': masker},
                    ingest.MemoryBrainDataFile({'eeg_data': chopped},
                                               sr=desired_frame_rate)]
            files = _ingest_experiment(trial_dict, tf_dir_subject,
                                       frame_rate)
            write_summary(cache_dir, tf_dir_subject, desired_frame_rate,
                          files)


class RegressionDataKULeuven(RegressionData):
    """KULeuven 16-subject dataset (Das et al. 2016)."""

    num_subjects = 16

    @property
    def name(self):
        return 'KULeuven'

    def _subject_files(self, cache_dir):
        """The S<n>.mat files present, in subject order."""
        paths = [os.path.join(cache_dir, 'S%d.mat' % (s + 1))
                 for s in range(self.num_subjects)]
        return [p for p in paths if os.path.exists(p)]

    def is_data_local(self, cache_dir):
        found = self._subject_files(cache_dir)
        if found and len(found) != self.num_subjects:
            print('Found %d/%d subjects in %s; ingesting those.'
                  % (len(found), self.num_subjects, cache_dir))
        return bool(found)

    def download_data(self, url, cache_dir, debug=False):
        """A fetchable .zip of preprocessed S*.mat files (and stimuli/)
        installs itself; the published dataset needs the authors' Matlab
        preprocess_data first, so any other URL gets instructions."""
        archive = os.path.join(_tmp_dir(), 'kuleuven.zip')
        if url.endswith('.zip') and download_from_gdrive(url, archive,
                                                         debug=debug):
            make_if_not_exists(cache_dir)
            with zipfile.ZipFile(archive) as zf:
                zf.extractall(cache_dir)
            return super().download_data(url, cache_dir)
        print('To download manually, grab data from %s and run the '
              'dataset\'s Matlab preprocess_data, then copy the S*.mat '
              'files to %s' % (url, cache_dir),
              file=regression_data_print)
        return False

    def is_data_ingested(self, tf_dir, num_subjects=16, num_trials=20):
        if os.path.exists(tf_dir):
            num_files = len(glob.glob(os.path.join(tf_dir, 'S*',
                                                   '*.tfrecords')))
            return num_files >= num_trials * num_subjects
        return False

    def ingest_data(self, cache_dir, tf_dir, desired_frame_rate):
        """Per trial: resampled EEG + attended/unattended intensities,
        the intensities by kernel K3 on a CUDA device."""
        os.makedirs(tf_dir, exist_ok=True)
        all_ingested_files = []
        for mat_file in self._subject_files(cache_dir):
            subject = os.path.basename(mat_file)[:-len('.mat')]
            tf_sub_dir = os.path.join(tf_dir, subject)
            trials = loadmat(mat_file)['preproc_trials']
            trial_dict = {}
            for trial_number in range(trials.shape[0]):
                name = '%s_T%d' % (subject, trial_number)
                if os.path.exists(os.path.join(tf_sub_dir,
                                               name + '.tfrecords')):
                    continue
                mat_trial = trials[trial_number]
                ear = mat_trial.attended_ear
                if ear == 'L':
                    attended_track, unattended_track = 0, 1
                elif ear == 'R':
                    attended_track, unattended_track = 1, 0
                else:
                    raise ValueError('Unknown attended ear (%s)' % ear)
                trial_data = ingest.BrainTrial(name)

                def intensity_of(track_name):
                    trial_data.load_sound(
                        track_name,
                        sound_dir=os.path.join(cache_dir, 'stimuli'))
                    features = preprocess.AudioFeatures(
                        track_name, trial_data.sound_fs,
                        desired_frame_rate, device=self.device)
                    return features.compute_intensity(
                        trial_data.sound_data)

                p_eeg = preprocess.Preprocessor(
                    'eeg', mat_trial.FileHeader.SampleRate,
                    desired_frame_rate, device=self.device)
                ds_eeg = p_eeg.resample(mat_trial.RawData.EegData)
                intensity = intensity_of(mat_trial.stimuli[attended_track])
                intensity2 = intensity_of(
                    mat_trial.stimuli[unattended_track])
                trial_dict[name] = [
                    {'intensity': intensity, 'intensity2': intensity2,
                     'attended_speaker': 0 * intensity},
                    ingest.MemoryBrainDataFile({'eeg_data': ds_eeg},
                                               desired_frame_rate)]
            if not trial_dict:
                continue   # Every trial of this subject is on disk.
            all_ingested_files.extend(_ingest_experiment(
                trial_dict, tf_sub_dir, desired_frame_rate))
        write_summary(cache_dir, tf_dir, desired_frame_rate,
                      all_ingested_files)


DataLocation = collections.namedtuple(
    'DataLocation', ['internet', 'cache_dir', 'tf_dir',
                     'desired_frame_rate', 'data_type'])

base_data_dir = '/tmp'

locations = {
    'telluride4': DataLocation(
        'https://drive.google.com/uc?id=0ByZjGXodIlspWmpBcUhvenVQa1k',
        os.path.join(base_data_dir, 'local_cache/telluride4'),
        os.path.join(base_data_dir, 'tf_dir/telluride4_64Hz'),
        64, RegressionDataTelluride4),
    'jens_memory': DataLocation(
        'https://zenodo.org/record/1158410/files/DATA.zip',
        os.path.join(base_data_dir, 'local_cache/jens_memory'),
        os.path.join(base_data_dir, 'tf_dir/jens_memory_64Hz'),
        64, RegressionDataJensMemory),
    'jens_impaired': DataLocation(
        'https://zenodo.org/record/3618205/files/ds-eeg-snhl.tar'
        '?download=1',
        os.path.join(base_data_dir, 'local_cache/jens_impaired'),
        os.path.join(base_data_dir, 'tf_dir/jens_impaired_64Hz'),
        64, RegressionDataJensImpaired),
    'kuleuven': DataLocation(
        'https://zenodo.org/record/3997352#.YTkc755KhLQ',
        os.path.join(base_data_dir, 'local_cache/kuleuven'),
        os.path.join(base_data_dir, 'tf_dir/kuleuven'),
        32, RegressionDataKULeuven),
}


def parse_args(argv):
    parser = argparse.ArgumentParser(
        prog='python -m telluride_decoding_torch.cli.regression_data',
        description=__doc__.split('\n\n')[0], allow_abbrev=False)
    parser.add_argument('--internet', default=None,
                        help='URL override for the download.')
    parser.add_argument('--type', default='telluride4',
                        choices=list(locations),
                        help='Which type of data to ingest.')
    parser.add_argument('--cache_dir', default=None,
                        help='Local cache override.')
    parser.add_argument('--tf_output_dir', default=None,
                        help='TFRecord output override.')
    parser.add_argument('--desired_frame_rate', type=float, default=0,
                        help='Frame rate override for ingestion.')
    parser.add_argument('--force', action='store_true',
                        help='Ignore existing files and force new download '
                        '& ingestion.')
    parser.add_argument('--device', default='cuda',
                        help='Device of the filters and the envelope '
                        'kernel: cuda (default) or cpu.')
    return parser.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(sys.argv[1:] if argv is None else argv)
    database = locations[args.type]
    data_object = database.data_type(device=args.device)
    url = args.internet or database.internet
    cache_dir = args.cache_dir or database.cache_dir
    tf_dir = args.tf_output_dir or database.tf_dir
    desired_frame_rate = (args.desired_frame_rate or
                          database.desired_frame_rate)
    if args.force or not data_object.is_data_local(cache_dir):
        print('Downloading data from Internet (%s) to cache_dir: %s' %
              (url, cache_dir), file=regression_data_print)
        if not data_object.download_data(url, cache_dir):
            print('No %s data available locally, aborting.'
                  % data_object.name, file=sys.stderr)
            return 1
    else:
        print('No need to download data since it is all here:', cache_dir,
              file=regression_data_print)
    if args.force or not data_object.is_data_ingested(tf_dir):
        print('Ingesting data into tf_dir:', tf_dir,
              file=regression_data_print)
        data_object.ingest_data(cache_dir, tf_dir, desired_frame_rate)
    else:
        print('No need to ingest data since it is all here:', tf_dir,
              file=regression_data_print)
    return 0


def app_main():
    sys.exit(main())


if __name__ == '__main__':
    app_main()
