"""Ingestion of the standard AAD corpora from a local cache into
TFRecords (port of cli/regression_data.py).

Ported: the MATLAB struct loader, the README.txt summary writer, the
``locations`` registry, and the local-cache ingest of the KULeuven
corpus (Das et al. 2016; raw audio becomes an intensity envelope by
kernel K3 on the card) and of the COCOHA/Jens memory corpus (the
codelab's). The flags keep the JAX names, plus ``--device``:

  python -m telluride_decoding_torch.cli.regression_data --type kuleuven \\
      --cache_dir D --tf_output_dir T [--desired_frame_rate 32] \\
      [--device cuda|cpu] [--force]

Downloading is not ported: when the cache holds no data, ``main`` says
so and returns 1. Where the JAX driver insists on the whole corpus
before it ingests, this one ingests the subjects the cache holds.
Telluride4 and jens_impaired (EDF) are not ported yet.
"""

from __future__ import annotations

import argparse
import collections
import glob
import os
import sys
from typing import List, Optional

import scipy.io as spio

from telluride_decoding_torch import device as device_policy
from telluride_decoding_torch.data import records as records_io
from telluride_decoding_torch.io import ingest
from telluride_decoding_torch.signal import preprocess


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
    """Base: ingest from a local cache with idempotence checks."""

    def __init__(self, device='cuda'):
        self.device = device_policy.resolve(device)

    def is_data_local(self, cache_dir: str) -> bool:
        raise NotImplementedError

    def is_data_ingested(self, tf_dir: str) -> bool:
        raise NotImplementedError

    def ingest_data(self, cache_dir: str, tf_dir: str,
                    desired_frame_rate: float):
        raise NotImplementedError


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
    'DataLocation', ['cache_dir', 'tf_dir', 'desired_frame_rate',
                     'data_type'])

base_data_dir = '/tmp'

locations = {
    'jens_memory': DataLocation(
        os.path.join(base_data_dir, 'local_cache/jens_memory'),
        os.path.join(base_data_dir, 'tf_dir/jens_memory_64Hz'),
        64, RegressionDataJensMemory),
    'kuleuven': DataLocation(
        os.path.join(base_data_dir, 'local_cache/kuleuven'),
        os.path.join(base_data_dir, 'tf_dir/kuleuven'),
        32, RegressionDataKULeuven),
}


def parse_args(argv):
    parser = argparse.ArgumentParser(
        prog='regression_data', description=__doc__.split('\n\n')[0])
    parser.add_argument('--type', default='kuleuven',
                        choices=sorted(locations),
                        help='Which type of data to ingest.')
    parser.add_argument('--cache_dir', default=None,
                        help='Local cache override.')
    parser.add_argument('--tf_output_dir', default=None,
                        help='TFRecord output override.')
    parser.add_argument('--desired_frame_rate', type=float, default=0,
                        help='Frame rate override for ingestion.')
    parser.add_argument('--force', action='store_true',
                        help='Ignore existing files and force a new '
                        'ingestion.')
    parser.add_argument('--device', default='cuda',
                        help='Device of the filters and the envelope '
                        'kernel: cuda (default) or cpu.')
    return parser.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(sys.argv[1:] if argv is None else argv)
    database = locations[args.type]
    data_object = database.data_type(device=args.device)
    cache_dir = args.cache_dir or database.cache_dir
    tf_dir = args.tf_output_dir or database.tf_dir
    desired_frame_rate = (args.desired_frame_rate or
                          database.desired_frame_rate)
    if not data_object.is_data_local(cache_dir):
        print('No %s data in the local cache %s, and downloading is not '
              'ported: aborting.' % (data_object.name, cache_dir),
              file=sys.stderr)
        return 1
    if args.force or not data_object.is_data_ingested(tf_dir):
        print('Ingesting data into tf_dir:', tf_dir)
        data_object.ingest_data(cache_dir, tf_dir, desired_frame_rate)
    else:
        print('No need to ingest data since it is all here:', tf_dir)
    return 0


if __name__ == '__main__':
    sys.exit(main())
