"""Ingest: raw recordings (audio + brain signals) -> TFRecord files.

Copy of telluride_decoding_tpu/io/ingest.py, on the port's TFRecord
codec (data/records.py) and EDF reader (io/edf.py): BrainSignal, the
trigger alignment (Theil-Sen regression, mode histogram,
remove_close_times), BrainTrial with its trigger finders, BrainDataFile,
LocalCopy, MemoryBrainDataFile, parse_edf_file and EdfBrainDataFile,
BrainExperiment with global z-scoring, and the TFRecord helpers. A file
written here is byte-identical to the JAX package's for the same
arrays. This is host code: the envelope and resampling that an ingest
runs on the card live in signal/preprocess.py.
"""

from __future__ import annotations

import collections
import os
import pickle
from typing import (Any, Callable, Dict, List, Optional, Tuple, Type,
                    Union)

import numpy as np
import scipy.io.wavfile
import scipy.stats

from telluride_decoding_torch.data import records
from telluride_decoding_torch.io import edf as edf_io


def assert_type(var_name: str, var: Any, expected_type: Type[Any]) -> None:
    if not isinstance(var, expected_type):
        raise TypeError(f'{var_name} must be of type {expected_type}, '
                        f'but got value {var} of type {type(var)}')


class BrainSignal:
    """One named brain signal: [num_times, num_channels] at a rate."""

    def __init__(self, name: str, signal, sample_rate: float,
                 data_type: Optional[str] = None):
        assert_type('name', name, str)
        signal = np.asarray(signal)
        if not sample_rate > 0.0:
            raise ValueError('Signal\'s sample rate must be greater than 0.')
        if signal.ndim == 1:
            signal = np.reshape(signal, (-1, 1))
        self._name = name
        self._signal = signal
        self._sr = float(sample_rate)
        self._data_type = data_type

    @property
    def signal(self) -> np.ndarray:
        return self._signal

    @property
    def data_type(self):
        return self._data_type

    @property
    def sr(self) -> float:
        return self._sr

    @property
    def name(self) -> str:
        return self._name

    def fix_offset(self, offset_seconds: float):
        """Drops the first offset_seconds (aligning EEG to audio)."""
        if offset_seconds < 0:
            raise ValueError('Offset_seconds to remove must be >= 0.')
        samples = int(offset_seconds * self._sr)
        if samples > 0:
            self._signal = self._signal[samples:, ]


# -- trigger alignment --------------------------------------------------------

def find_temporal_offset_via_linear_regression(
        audio_trigger_times, eeg_trigger_times,
        verbose: bool = True) -> Tuple[float, int]:
    """Theil-Sen robust regression of eeg times on audio times; returns
    (intercept = eeg lead, outlier count)."""
    num_points = min(len(audio_trigger_times), len(eeg_trigger_times))
    x = np.asarray(audio_trigger_times)[:num_points]
    y = np.asarray(eeg_trigger_times)[:num_points]
    res = scipy.stats.theilslopes(y, x, 0.90)
    intercept = res[1]
    outliers = np.abs(y - (x + intercept)) > 0.1
    return intercept, int(np.count_nonzero(outliers))


def find_temporal_offset_via_mode_histogram(audio_triggers, eeg_triggers,
                                            max_time: float = 0,
                                            fs: float = 0) -> float:
    """Mode of all pairwise (eeg - audio) event differences.

    One broadcast subtraction over every (audio, eeg) pair.
    """
    audio = np.asarray(audio_triggers, np.float64)
    eeg = np.asarray(eeg_triggers, np.float64)
    if fs > 0:
        audio = (audio * fs).astype(np.int64)
        eeg = (eeg * fs).astype(np.int64)
    diffs = (eeg[None, :] - audio[:, None]).reshape(-1)
    if max_time != 0:
        # Without fs the diffs are in seconds/samples as given, so the
        # window is max_time itself; with fs they were scaled to
        # samples above. (max_time * 0 filtered EVERY pair out.)
        window = max_time * fs if fs > 0 else max_time
        diffs = diffs[np.abs(diffs) < window]
    if diffs.size == 0:
        raise ValueError(
            'No trigger-time pairs within max_time=%g (audio %d, eeg '
            '%d onsets) - cannot estimate an offset.' %
            (max_time, audio.size, eeg.size))
    mode, _ = scipy.stats.mode(diffs, axis=None)
    mode = int(mode)
    return mode / float(fs) if fs > 0 else mode


def remove_close_times(times, min_time: float = 0.06) -> np.ndarray:
    """Keeps only onsets separated by at least min_time."""
    times = sorted(times)
    if not times:
        # A dead trigger channel yields zero onsets; return the empty
        # set instead of IndexError-ing on times[0].
        return np.zeros((0,))
    kept = [times[0]]
    last_time = times[0]
    for t in times[1:]:
        if t > last_time + min_time:
            kept.append(t)
        last_time = t
    return np.asarray(kept)


class BrainTrial:
    """One trial: a sound file + brain recordings + derived features."""

    def __init__(self, trial_name: str):
        self._sound_data: Optional[np.ndarray] = None
        self._sound_fs: Optional[float] = None
        self._brain_data: 'collections.OrderedDict[str, BrainSignal]' = (
            collections.OrderedDict())
        self._model_features: Dict[str, np.ndarray] = {}
        if trial_name.endswith('.wav'):
            # Slice, not str.replace, which strips every occurrence.
            trial_name = trial_name[:-len('.wav')]
        self._trial_name = trial_name

    @property
    def model_features(self) -> Dict[str, np.ndarray]:
        return self._model_features

    @model_features.setter
    def model_features(self, new_dict: Dict[str, np.ndarray]):
        assert_type('audio features for trial (new_dict)', new_dict, dict)
        self._model_features = new_dict

    @property
    def brain_data(self):
        return self._brain_data

    @property
    def sound_fs(self):
        return self._sound_fs

    @property
    def sound_data(self):
        return self._sound_data

    @sound_data.setter
    def sound_data(self, new_sound):
        self._sound_data = new_sound

    @property
    def filename(self) -> str:
        return 'dummy_brain_trial'

    @property
    def trial_name(self) -> str:
        return self._trial_name

    def add_model_feature(self, name: str, data):
        assert_type('name', name, str)
        self._model_features[name] = np.asarray(data)

    def summary_string(self) -> str:
        summary = '%d EEG channels' % len(self._brain_data)
        if self._brain_data:
            sample = next(iter(self._brain_data.values()))
            summary += ' with %gs of eeg data' % (
                sample.signal.shape[0] / float(sample.sr))
            if self._sound_data is not None:
                summary += ', %gs of audio data' % (
                    self._sound_data.shape[0] / float(self._sound_fs))
            for k in self._model_features:
                summary += ', %s samples of %s data' % (
                    self._model_features[k].shape, k)
        summary += '.'
        return summary

    def load_sound(self, sound_data, sound_fs: Optional[float] = None,
                   sound_dir: Optional[str] = None):
        """Loads audio from an int16 wav file (scaled by 1/32767) or an
        array."""
        if isinstance(sound_data, str):
            sound_filename = os.path.join(sound_dir or '', sound_data)
            if not sound_filename.endswith('.wav'):
                sound_filename += '.wav'
            try:
                self._sound_fs, data = scipy.io.wavfile.read(sound_filename)
            except FileNotFoundError:
                raise ValueError('Can not open %s to read audio waveform.'
                                 % sound_filename)
            data = data.reshape(data.shape[0], -1)
            self._sound_data = data.astype(np.float32) / 32767.0
        else:
            sound_data = np.asarray(sound_data)
            if not sound_fs or sound_fs <= 0:
                raise ValueError('sound sample rate must be greater than 0.')
            self._sound_data = sound_data.reshape(sound_data.shape[0], -1)
            self._sound_fs = sound_fs

    def load_brain_data(self, eeg_dir: str, brain_data: 'BrainDataFile'):
        assert_type('brain_data', brain_data, BrainDataFile)
        if eeg_dir and not os.path.exists(eeg_dir):
            raise IOError('brain data director %s does not exist.' % eeg_dir)
        if eeg_dir is None and isinstance(brain_data, EdfBrainDataFile):
            # A file-backed EDF needs its directory; without one
            # os.path.join would raise a TypeError deep inside.
            raise IOError('brain data directory is required to load '
                          'EDF file %s.' % brain_data.filename)
        brain_data.load_all_data(eeg_dir)
        for name in brain_data.signal_names:
            signal = brain_data.signal_values(name)
            sr = brain_data.signal_fs(name)
            self._brain_data[name] = BrainSignal(
                name, signal, sr, data_type=brain_data.data_type)

    def iterate_brain_channels(self, data_type: Optional[str] = None):
        for signal in self._brain_data.values():
            if data_type is None or signal.data_type == data_type:
                yield signal

    @staticmethod
    def adjust_data_sizes(data_dict: Dict[str, np.ndarray]
                          ) -> Dict[str, np.ndarray]:
        """Truncates all features to the shortest frame count."""
        if not isinstance(data_dict, dict):
            raise ValueError('data supplied to adjust_data_sizes must be a '
                             'dict.')
        min_size = 1 << 31
        for k in data_dict:
            if data_dict[k].ndim == 1:
                data_dict[k] = np.reshape(data_dict[k], (-1, 1))
            min_size = min(min_size, data_dict[k].shape[0])
        for k in data_dict:
            if data_dict[k].shape[0] != min_size:
                data_dict[k] = data_dict[k][:min_size, :]
        return data_dict

    def find_audio_trigger_times(self, channel_with_trigger: int = 1):
        """Leading edges (0 -> positive) in the audio trigger channel."""
        assert_type('self._sound_data', self._sound_data, np.ndarray)
        if channel_with_trigger >= self._sound_data.shape[1]:
            raise ValueError(
                'Trigger channel (%d) too high for %d-channel audio.' %
                (channel_with_trigger, self._sound_data.shape[1]))
        trig = np.hstack((np.zeros((1,)),
                          self._sound_data[:, channel_with_trigger]))
        edges = np.nonzero(np.logical_and(trig[:-1] == 0, trig[1:] > 0))[0]
        return edges / float(self._sound_fs)

    def find_eeg_trigger_times(self, channel_name: str = 'TRIG'):
        """Trigger onsets in an EEG event channel (with the Natus fix)."""
        if channel_name not in self._brain_data:
            raise ValueError('channel name %s not in brain data %s.' %
                             (channel_name, list(self._brain_data.keys())))
        trigger_signal = self._brain_data[channel_name].signal

        def natus_trigger_fix(x):
            # Level correction constants from Natus for their EDF files.
            return np.floor(-0.0063606452364314 * (x - 5151600) +
                            (-32768) + 0.5)

        fixed = natus_trigger_fix(trigger_signal)
        logical = fixed % 2
        edges = np.logical_and(np.logical_not(logical[:-1]), logical[1:])
        times = np.nonzero(edges)[0] / float(
            self._brain_data[channel_name].sr)
        return times, trigger_signal, fixed

    def find_cognionix_trigger_time(self, channel_name: str = 'EXP32',
                                    level: float = 8000):
        """First time the Cognionix trigger channel exceeds level."""
        if channel_name not in self._brain_data:
            raise ValueError('channel name %s not in brain data %s.' %
                             (channel_name, self._brain_data))
        signal = self._brain_data[channel_name]
        times = np.nonzero(signal.signal > level)[0]
        if times.size:
            return float(times[0]) / float(signal.sr)
        return None

    def fix_eeg_offset(self, offset_seconds: float):
        for signal_name in self._brain_data:
            self._brain_data[signal_name].fix_offset(offset_seconds)

    def assemble_brain_data(self, eeg_channel_names: Union[List[str], str]):
        """Gathers named channels into one [frames, width] 'eeg' feature,
        in recording order (reference ingest.py:559-610)."""
        if not isinstance(eeg_channel_names, (str, list)):
            raise TypeError('eeg_channel_names must be a string or a list '
                            'of strings.')
        if isinstance(eeg_channel_names, str):
            eeg_channel_names = [s.strip()
                                 for s in eeg_channel_names.split(',')]
        if len(set(eeg_channel_names)) != len(eeg_channel_names):
            raise ValueError('Looks like duplicate channel names in '
                             'request: %s' % eeg_channel_names)
        frame_width = 0
        frame_len = 1 << 31
        for k in eeg_channel_names:
            if k not in self._brain_data:
                raise ValueError('Missing feature %s' % k)
            signal = self._brain_data[k].signal
            frame_width += signal.shape[1]
            frame_len = min(frame_len, signal.shape[0])
        columns = []
        for k in self._brain_data:  # Recording (file) order.
            if k in eeg_channel_names:
                columns.append(
                    self._brain_data[k].signal[:frame_len, :])
        eeg_data = np.concatenate(columns, axis=1).astype(np.float32)
        if eeg_data.shape[1] != frame_width:
            raise ValueError('Width mismatch: %d vs %d' %
                             (eeg_data.shape[1], frame_width))
        self._model_features['eeg'] = eeg_data

    def write_data_as_tfrecords(self, tf_dir: str,
                                reverse_data_for_test: bool = False) -> str:
        """Writes all features as <trial>.tfrecords; returns the path."""
        assert_type('tf_dir', tf_dir, str)
        new_data = dict(self._model_features)
        new_data = self.adjust_data_sizes(new_data)
        if reverse_data_for_test:
            # Null-hypothesis fault injection (reference ingest.py:639-642).
            new_data['eeg'] = np.flipud(new_data['eeg'])
        filename = os.path.join(tf_dir, self._trial_name + '.tfrecords')
        convert_data_to_tfrecords(filename, new_data)
        return filename


class BrainDataFile:
    """Virtual reader for one brain-recording file format."""

    def __init__(self, data_filename: str,
                 data_type: Optional[str] = None):
        self._data_filename = data_filename
        self._data_type = data_type

    @property
    def filename(self) -> str:
        return self._data_filename

    @property
    def data_type(self):
        return self._data_type

    def __str__(self) -> str:
        return type(self).__name__ + '(\'' + self._data_filename + '\')'

    @property
    def signal_names(self) -> List[str]:
        raise NotImplementedError

    def signal_values(self, name: str):
        raise NotImplementedError

    def signal_fs(self, name) -> float:
        raise NotImplementedError

    def load_all_data(self, data_dir):
        pass


class LocalCopy:
    """Context manager yielding a local temp copy of a file.

    Readers that cannot open a remote or read-only path get a local
    copy with the same suffix, removed on exit.
    """

    def __init__(self, remote_filename: str):
        self._remote_filename = remote_filename

    def __enter__(self) -> str:
        import shutil
        import tempfile
        _, suffix = os.path.splitext(self._remote_filename)
        self._fp = tempfile.NamedTemporaryFile(suffix=suffix)
        shutil.copyfile(self._remote_filename, self._fp.name)
        return self._fp.name

    def __exit__(self, exception_type, exception_value, traceback):
        self._fp.close()


class MemoryBrainDataFile(BrainDataFile):
    """In-memory {channel: array} data file, for tests and one-offs."""

    def __init__(self, trial_dict: Dict[str, np.ndarray], sr: float = 64,
                 data_type: Optional[str] = None,
                 name: str = 'in_memory'):
        assert_type('trial_dict', trial_dict, dict)
        if sr <= 0.0:
            raise ValueError('Sample rate must be > 0.')
        for channel_name, channel_data in trial_dict.items():
            assert_type('channel_name', channel_name, str)
            if np.asarray(channel_data).ndim > 2:
                raise ValueError('Bad MemoryBrainDataFile shape for %s(%s)'
                                 % (channel_name,
                                    np.asarray(channel_data).shape))
        self._my_data_dict = trial_dict
        self._my_sr = sr
        super().__init__(name, data_type=data_type)

    @property
    def signal_names(self) -> List[str]:
        return list(self._my_data_dict.keys())

    def signal_values(self, name: str):
        return self._my_data_dict.get(name)

    def signal_fs(self, _) -> float:
        return self._my_sr


def parse_edf_file(sample_edf_file: str) -> Dict[str, Any]:
    """EDF parse with the reference's dict layout (via io.edf)."""
    return edf_io.parse_edf_file(sample_edf_file)


class EdfBrainDataFile(BrainDataFile):
    """EDF brain-signal files (pure-Python reader)."""

    def __init__(self, filename, data_type: Optional[str] = None, **kwds):
        self._edf_dict: Dict[str, Any] = {}
        super().__init__(filename, data_type=data_type, **kwds)

    def load_all_data(self, data_dir: str):
        if not os.path.exists(data_dir):
            raise IOError('Data_dir does not exist: %s' % data_dir)
        data_filename = os.path.join(data_dir, self._data_filename)
        if not data_filename.endswith('.edf'):
            data_filename += '.edf'
        if not os.path.exists(data_filename):
            raise IOError('Can not open %s for reading' % data_filename)
        self._edf_dict = edf_io.parse_edf_file(data_filename)

    @property
    def signal_names(self) -> List[str]:
        return self._edf_dict['labels']

    def _channel_index_or_raise(self, name: str) -> int:
        index = self.find_channel_index(name)
        if index is None:
            # Indexing an ndarray with None means np.newaxis - a typo'd
            # channel name would silently return the WHOLE matrix.
            raise ValueError('Channel %r not in EDF signals %s.' %
                             (name, self.signal_names))
        return index

    def signal_values(self, name: str) -> np.ndarray:
        assert_type('name', name, str)
        return self._edf_dict['signals'][self._channel_index_or_raise(name)]

    def signal_fs(self, name: str) -> float:
        assert_type('name', name, str)
        return self._edf_dict['sample_rates'][
            self._channel_index_or_raise(name)]

    def find_channel_index(self, desired_label: str = 'TRIG'):
        if 'labels' not in self._edf_dict:
            raise ValueError('Can not find labels among: %s' %
                             self._edf_dict.keys())
        for index, label in enumerate(self._edf_dict['labels']):
            if label == desired_label:
                return index
        return None


class BrainExperiment:
    """All trials of one experiment + cross-trial z-scoring."""

    @staticmethod
    def delete_suffix(filename: str, suffix: str) -> str:
        if suffix and filename.endswith(suffix):
            filename = filename[:-len(suffix)]
        return filename

    def __init__(self, trial_dict, sound_dir: Optional[str] = None,
                 eeg_dir: Optional[str] = None, frame_rate: float = 64):
        if not isinstance(trial_dict, dict):
            raise TypeError('trial is specified with a dictionary of data '
                            'not %s' % trial_dict)
        if sound_dir:
            assert_type('sound_dir', sound_dir, str)
        if eeg_dir:
            assert_type('eeg_dir', eeg_dir, str)
        self._sound_dir = sound_dir
        self._eeg_dir = eeg_dir
        self._frame_rate = frame_rate
        self._trial_dict = trial_dict
        for k, v in trial_dict.items():
            assert_type('Trial name', k, str)
            assert_type('Trial data', v, list)
        self._data_dict: Dict[str, BrainTrial] = {}
        self._feature_mean: Dict[str, Any] = {}
        self._feature_std: Dict[str, Any] = {}

    def trial_data(self, key: str) -> Optional[BrainTrial]:
        return self._data_dict.get(key)

    def add_sound_data(self, sound_dict: Dict[str, Any],
                       trial: BrainTrial):
        assert_type('Sound dictionary', sound_dict, dict)
        assert_type('Trial argument', trial, BrainTrial)
        if 'audio_data' in sound_dict and 'audio_sr' in sound_dict:
            trial.load_sound(sound_dict['audio_data'],
                             sound_dict['audio_sr'])
            del sound_dict['audio_data']
            del sound_dict['audio_sr']
        if sound_dict:
            trial.model_features = sound_dict

    def iterate_trials(self):
        for trial in self._data_dict.values():
            yield trial

    def load_all_data(self, verbose: bool = False):
        del verbose
        for trial_name, all_data in self._trial_dict.items():
            assert_type('trial_name', trial_name, str)
            this_trial = BrainTrial(trial_name)
            sound_data = all_data[0]
            if isinstance(sound_data, str):
                this_trial.load_sound(sound_data, sound_dir=self._sound_dir)
            elif isinstance(sound_data, dict):
                self.add_sound_data(sound_data, this_trial)
            else:
                raise TypeError('Can not process %s for sounds.' %
                                type(sound_data))
            for eeg_data_item in all_data[1:]:
                this_trial.load_brain_data(self._eeg_dir, eeg_data_item)
            self._data_dict[trial_name] = this_trial

    def summary(self) -> str:
        summary = 'Experiment summary:\n'
        summary += '  Reading sound from: %s\n' % self._sound_dir
        summary += '  Reading EEG data from: %s\n' % self._eeg_dir
        summary += '  Found %d trials\n' % len(self._trial_dict)
        for trial_name, trial_data in self._data_dict.items():
            summary += '    Trial %s: %s\n' % (trial_name,
                                               trial_data.summary_string())
        return summary

    def get_all_feature_data(self, feature_name: str) -> List[np.ndarray]:
        return [t.model_features[feature_name]
                for t in self._data_dict.values()
                if feature_name in t.model_features]

    def zscore_all_features(self, feature_name: str, mean, std):
        if np.max(np.abs(std)) < 1e-10:
            # A near-zero std (constant feature) would explode the
            # normalized values.
            std = 1.0
        for trial_data in self._data_dict.values():
            features = trial_data.model_features
            if feature_name in features:
                features[feature_name] = normalize_data(
                    features[feature_name], mean, std)
            trial_data.model_features = features

    def z_score_all_data(self):
        """Global (all trials) z-score per feature type."""
        first_trial = next(iter(self._data_dict.values()))
        for data_type in list(first_trial.model_features.keys()):
            if data_type == 'ones':
                continue
            all_data = self.get_all_feature_data(data_type)
            mean, std = find_mean_std(all_data)
            self._feature_mean[data_type] = mean
            self._feature_std[data_type] = std
            self.zscore_all_features(data_type, mean, std)

    def save_zscore_data(self, filename: str):
        with open(filename, 'wb') as fp:
            pickle.dump({'mean': self._feature_mean,
                         'std': self._feature_std}, fp)

    def write_all_data(self, tf_dir: str) -> List[str]:
        return [trial.write_data_as_tfrecords(tf_dir)
                for trial in self.iterate_trials()]


def find_mean_std(data_list: List[np.ndarray], columnwise: bool = False):
    """Joint mean/std over a list of arrays (two-pass, streaming)."""
    data_sum = 0.0
    count = 0
    for d in data_list:
        if columnwise:
            data_sum += np.sum(d, axis=0, keepdims=True)
            count += d.shape[0]
        else:
            data_sum += np.sum(d)
            count += np.prod(d.shape)
    data_mean = data_sum / count
    sum2 = 0.0
    for d in data_list:
        centered = d - data_mean
        if columnwise:
            sum2 += np.sum(centered * centered, axis=0, keepdims=True)
        else:
            sum2 += np.sum(centered * centered)
    return data_mean, np.sqrt(sum2 / count)


def normalize_data(a: np.ndarray, data_mean, data_std) -> np.ndarray:
    centered = a - data_mean
    if np.max(np.abs(data_std)) > 0.0:
        return centered / data_std
    return centered


def convert_data_to_tfrecords(filename: str,
                              data_dict: Dict[str, np.ndarray]):
    """Frame-per-record TFRecord writer (reference argument order,
    ingest.py:1118-1172)."""
    assert_type('Input data_dict', data_dict, dict)
    for k, v in data_dict.items():
        if np.asarray(v).ndim != 2:
            raise ValueError('Not 2d shape for key %s: %s' %
                             (k, np.asarray(v).shape))
    records.convert_data_to_tfrecords(data_dict, filename)


discover_feature_shapes = records.discover_feature_shapes
count_tfrecords = records.count_tfrecords


def read_tfrecords(tfrecord_file_name: str, start_frame: int = 0,
                   frame_count: int = 512) -> Dict[str, np.ndarray]:
    """Reads a window of frames (reference ingest.py:1245-1289)."""
    assert_type('tfrecord_file_name', tfrecord_file_name, str)
    full = records.read_tfrecords(tfrecord_file_name)
    return {k: v[start_frame:start_frame + frame_count].astype(np.float32)
            for k, v in full.items()}


def transform_tfrecords(input_file: str, new_tf_dir: str, trial_name: str,
                        transforms: List[Callable]) -> str:
    """Re-writes a TFRecord file with extra computed fields."""
    data_dict = read_tfrecords(input_file)
    for transform_fn in transforms:
        new_name, new_data = transform_fn(data_dict)
        data_dict[new_name] = new_data
    brain_trial = BrainTrial(trial_name)
    for k, v in data_dict.items():
        brain_trial.add_model_feature(k, v)
    return brain_trial.write_data_as_tfrecords(new_tf_dir)
