"""Dataset assembly: file discovery, per-file streams, temporal context
and streamed moments (port of data/brain_data.py).

Files decode to whole [N, C] numpy arrays; lag context is applied per
file, never across file boundaries. ``streaming_moments`` uploads one
raw file at a time, lag-stacks it on the device (kernel K2 on CUDA) and
reduces it to second moments, so covariance fits never hold the
stacked corpus. The file list is shuffled with
``np.random.RandomState(shuffle_seed)`` exactly as in the JAX package,
so both give the same file order and the same ``allbut_NN`` subsets.

Ported: BrainData (field specs through the Preprocessor, allbut
patterns, load_arrays, iter_file_arrays, streaming_moments),
TestBrainData, TFExampleData with its byte-budget LRU, and
create_brain_dataset. The minibatch iterator (create_dataset and
BrainDataset, with mixup and mismatch) is not ported yet.
"""

from __future__ import annotations

import os
import re
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from telluride_decoding_torch import device as device_policy
from telluride_decoding_torch.data import records
from telluride_decoding_torch.ops.covariance import (MomentStats,
                                                     blocked_moments,
                                                     moments_from_arrays)
from telluride_decoding_torch.ops.lagstack import lag_stack, lag_stack_np
from telluride_decoding_torch.signal.preprocess import Preprocessor


def device_file_moments(x_raw: torch.Tensor, y_raw: torch.Tensor,
                        n_true: int, *, pre: int, post: int, pre_y: int,
                        post_y: int, want_syy: bool) -> MomentStats:
    """One file's MomentStats: lag stack (kernel K2) + masked moments.

    Counterpart of _device_file_moments
    (telluride_decoding_tpu/data/brain_data.py:73-103). Rows >= n_true
    are masked out of the sums; rows past the stream end are zeros, the
    lag stack's own edge semantics, so a row near the end sees real
    post-context frames where the buffer holds them.
    """
    x = lag_stack(x_raw, pre, post)
    y = lag_stack(y_raw, pre_y, post_y)
    valid = (torch.arange(x.shape[0], device=x.device) < n_true).float()
    return blocked_moments(x, y, want_syy=want_syy, valid=valid)


def _parse_field_specs(fields: List[str], frame_rate: float, device
                       ) -> Tuple[List[str], List[Optional[str]]]:
    """Splits field names from Preprocessor param-string suffixes.

    'eeg(highpass_cutoff=0.5)' -> base 'eeg' + the full spec (validated
    eagerly by constructing a Preprocessor); plain names pass through
    with a None spec.
    """
    bases: List[str] = []
    specs: List[Optional[str]] = []
    for field in fields:
        if '(' in field:
            if frame_rate <= 0:
                raise ValueError(
                    'A positive frame_rate is required to preprocess '
                    'field %s on the fly.' % field)
            bases.append(Preprocessor(field, frame_rate, frame_rate,
                                      device=device).name)
            specs.append(field)
        else:
            bases.append(field)
            specs.append(None)
    return bases, specs


def _apply_field_spec(spec: Optional[str], arr: np.ndarray,
                      frame_rate: float, device) -> np.ndarray:
    """Runs one field's stream through its Preprocessor param string.

    A fresh Preprocessor per call keeps filter and context state from
    crossing file boundaries.
    """
    arr = np.atleast_2d(np.asarray(arr, np.float32))
    if spec is None:
        return arr
    pp = Preprocessor(spec, frame_rate, frame_rate, device=device)
    return np.asarray(pp.process(arr, reset=True), np.float32)


class BrainData:
    """Base class describing one experiment's data source.

    Subclasses provide ``_get_data_file_names`` (file discovery) and
    ``file_arrays`` (decode one file to raw arrays). ``device`` (default
    ``cuda``) runs the field filters and the streamed moments.
    """

    def __init__(self,
                 in_fields: Union[str, Sequence[str]],
                 out_field: str,
                 frame_rate: float,
                 pre_context: int = 0,
                 post_context: int = 0,
                 in2_fields: Optional[Union[str, Sequence[str]]] = None,
                 in2_pre_context: int = 0,
                 in2_post_context: int = 0,
                 input_offset: int = 0,
                 attended_field: Optional[str] = None,
                 data_dir: Optional[str] = None,
                 data_pattern: str = '',
                 train_file_pattern: str = '',
                 validate_file_pattern: str = '',
                 test_file_pattern: str = '',
                 shuffle_seed: int = 42,
                 device='cuda'):
        if not in_fields:
            raise ValueError('Must specify at least one input field.')
        if not out_field:
            raise ValueError('Must specify an output field.')
        if frame_rate < 0:
            raise ValueError('frame_rate must be >= 0')
        if pre_context < 0 or post_context < 0:
            raise ValueError('context sizes must be >= 0')
        self.device = device_policy.resolve(device)
        if isinstance(in_fields, str):
            in_fields = [in_fields]
        if isinstance(in2_fields, str) and in2_fields:
            in2_fields = [in2_fields]
        self.in1_fields, self._in1_specs = _parse_field_specs(
            list(in_fields), frame_rate, self.device)
        if in2_fields:
            self.in2_fields, self._in2_specs = _parse_field_specs(
                list(in2_fields), frame_rate, self.device)
        else:
            self.in2_fields, self._in2_specs = None, None
        (self.out_field,), (self._out_spec,) = _parse_field_specs(
            [out_field], frame_rate, self.device)
        self.frame_rate = frame_rate
        self.in1_pre_context = pre_context
        self.in1_post_context = post_context
        self.in2_pre_context = in2_pre_context
        self.in2_post_context = in2_post_context
        self.input_offset = input_offset
        self.attended_field = attended_field
        self.data_dir = data_dir
        self.data_pattern = data_pattern
        self.train_file_pattern = train_file_pattern or ''
        self.validate_file_pattern = validate_file_pattern or ''
        self.test_file_pattern = test_file_pattern or ''
        self.features: Dict[str, records.FeatureSpec] = {}
        # Seeded file-list shuffle, as in the JAX package; None asks for
        # fresh randomness.
        self._rng = np.random.RandomState(shuffle_seed)
        self._cached_file_names: List[str] = []
        self.all_files()

    # -- file discovery ----------------------------------------------------

    def _get_data_file_names(self):
        self._cached_file_names = []

    def all_files(self, max_count: int = 0) -> List[str]:
        if not self._cached_file_names:
            self._get_data_file_names()
            if self._cached_file_names:
                self._rng.shuffle(self._cached_file_names)
        if max_count > 0 and len(self._cached_file_names) > max_count:
            return self._cached_file_names[:max_count]
        return self._cached_file_names

    def set_file_patterns(self, train: str, validate: str, test: str):
        self.train_file_pattern = train
        self.validate_file_pattern = validate
        self.test_file_pattern = test

    def filter_file_names(self, mode: str) -> List[str]:
        """Selects this mode's files; supports allbut/allbut_NN."""
        if mode == 'program_test':
            mode = 'test'
        if mode not in ('test', 'validate', 'train'):
            raise ValueError('mode must be one of test, validate or train')
        filename_list = self.all_files()
        if not isinstance(filename_list, list):
            raise TypeError('Filename_list is a %s, not a list.' %
                            type(filename_list))
        if mode == 'train' and self.train_file_pattern.startswith('allbut'):
            if not (self.test_file_pattern and self.validate_file_pattern):
                raise ValueError('Both test and validate must be specified '
                                 'if using allbut pattern')
            test_re = re.compile(self.test_file_pattern)
            validate_re = re.compile(self.validate_file_pattern)
            selected = [f for f in filename_list
                        if not (test_re.search(f) or validate_re.search(f))]
            suffix = self.train_file_pattern[len('allbut'):]
            if suffix.startswith('_'):
                if not suffix[1:].isdigit():
                    raise ValueError('allbut_ spec must be an integer, '
                                     'not %s.' % suffix[1:])
                count = int(suffix[1:])
                if count < len(selected):
                    selected = selected[:count]
            return selected
        pattern = {'test': self.test_file_pattern,
                   'validate': self.validate_file_pattern,
                   'train': self.train_file_pattern}[mode]
        pattern_re = re.compile(pattern)
        return [f for f in filename_list if pattern_re.search(f)]

    # -- raw per-file arrays -----------------------------------------------

    def file_arrays(self, filename: str, cache: bool = True
                    ) -> Tuple[np.ndarray, np.ndarray,
                               np.ndarray, np.ndarray]:
        """Decodes one file into raw (in1, in2, out, attended) arrays;
        cache=False reads through any decoded-file cache without
        populating it."""
        raise NotImplementedError

    def _field(self, spec, arr):
        return _apply_field_spec(spec, arr, self.frame_rate, self.device)

    def _select_fields(self, data: Dict[str, np.ndarray]
                       ) -> Tuple[np.ndarray, np.ndarray,
                                  np.ndarray, np.ndarray]:
        """Assembles (in1, in2, out, attended) from a field dict."""
        missing = set(self.in1_fields) - set(data.keys())
        if missing:
            raise ValueError('Could not find all desired features (%s) in '
                             'data (%s)' % (self.in1_fields,
                                            list(data.keys())))
        in1 = np.concatenate(
            [self._field(spec, data[k])
             for k, spec in zip(self.in1_fields, self._in1_specs)], axis=1)
        if self.out_field == 'ones':
            out = np.ones((in1.shape[0], 1), np.float32)
        else:
            if self.out_field not in data:
                raise ValueError('Could not find output_field **%s** in %s' %
                                 (self.out_field, list(data.keys())))
            out = self._field(self._out_spec, data[self.out_field])
        if self.in2_fields:
            for k in self.in2_fields:
                if k not in data:
                    raise ValueError('Could not find %s in features %s' %
                                     (k, list(data.keys())))
            in2 = np.concatenate(
                [self._field(spec, data[k])
                 for k, spec in zip(self.in2_fields, self._in2_specs)],
                axis=1)
        else:
            in2 = in1[:, :1]  # Dummy, same as reference brain_data.py:818.
        if self.attended_field:
            if self.attended_field not in data:
                raise ValueError('Could not find %s in features %s '
                                 '(pass an empty attended_field for '
                                 'data without one)' %
                                 (self.attended_field,
                                  list(data.keys())))
            attended = data[self.attended_field].astype(np.float32)
        else:
            attended = np.zeros((in1.shape[0], 1), np.float32)
        return in1, in2, out, attended

    # -- temporal context ---------------------------------------------------

    def _add_context(self, in1, in2, out, attended):
        """Applies input_offset + per-stream lag windows to one file."""
        offset = self.input_offset
        if offset > 0:
            in1 = in1[offset:]
        elif offset < 0:
            in2 = in2[-offset:]
            out = out[-offset:]
        in1 = lag_stack_np(in1, self.in1_pre_context, self.in1_post_context)
        in2 = lag_stack_np(in2, self.in2_pre_context, self.in2_post_context)
        # zip-truncate to the shortest stream.
        n = min(in1.shape[0], in2.shape[0], out.shape[0], attended.shape[0])
        return in1[:n], in2[:n], out[:n], attended[:n]

    def load_arrays(self, mode: str, temporal_context: bool = True
                    ) -> Tuple[np.ndarray, np.ndarray,
                               np.ndarray, np.ndarray]:
        """This mode's files as concatenated context-stacked arrays;
        context is applied per file so windows never span files."""
        parts = []
        for filename in self._files_or_raise(mode):
            streams = self.file_arrays(filename)
            if temporal_context and self._needs_context():
                streams = self._add_context(*streams)
            parts.append(streams)
        return tuple(np.concatenate([p[i] for p in parts], axis=0)
                     for i in range(4))

    def _needs_context(self) -> bool:
        return bool(self.in1_pre_context or self.in1_post_context
                    or self.in2_pre_context or self.in2_post_context
                    or self.input_offset)

    # -- bounded-memory streaming -------------------------------------------

    def iter_file_arrays(self, mode: str, temporal_context: bool = True,
                         filenames: Optional[Sequence[str]] = None):
        """Yields (filename, (in1, in2, out, attended)) one file at a
        time, the bounded-memory counterpart of load_arrays.
        ``filenames`` overrides the mode's file list."""
        for filename in (filenames if filenames is not None
                         else self._files_or_raise(mode)):
            streams = self.file_arrays(filename, cache=False)
            if temporal_context and self._needs_context():
                streams = self._add_context(*streams)
            yield filename, streams

    def streaming_moments(self, mode: str = 'train', *,
                          y_source: str = 'output',
                          want_syy: bool = False) -> MomentStats:
        """Covariance sufficient statistics with bounded memory.

        Uploads one raw file at a time and lag-stacks it on the device
        (kernel K2 on CUDA), so peak host memory is one raw file and
        the stacked matrix never crosses the bus. y_source selects the
        second stream: 'output' (ridge targets) or 'input_2' (CCA
        pairs, lag-stacked with the in2 contexts). A nonzero
        input_offset takes the per-file host lag stack instead.
        """
        if y_source not in ('output', 'input_2'):
            raise ValueError("y_source must be 'output' or 'input_2', "
                             'not %s' % y_source)

        def upload(a):
            return device_policy.as_tensor(a, self.device, torch.float32)
        total = None
        if self.input_offset != 0:
            for _, (in1, in2, out, _) in self.iter_file_arrays(mode):
                y = out if y_source == 'output' else in2
                stats = moments_from_arrays(upload(in1), upload(y),
                                            want_syy=want_syy)
                total = stats if total is None else total + stats
            return total
        pre_y, post_y = ((0, 0) if y_source == 'output' else
                         (self.in2_pre_context, self.in2_post_context))
        for filename in self._files_or_raise(mode):
            in1, in2, out, attended = self.file_arrays(filename,
                                                       cache=False)
            y_raw = out if y_source == 'output' else in2
            # As the dense path: lag-stack the full streams, then
            # zip-truncate to the four-way minimum n. Rows near the cut
            # see real post-context frames from beyond n (the fill),
            # zeros past the stream end; rows >= n are masked out.
            n = min(in1.shape[0], in2.shape[0], out.shape[0],
                    attended.shape[0])
            x_fill = min(in1.shape[0], n + self.in1_post_context)
            y_fill = min(y_raw.shape[0], n + post_y)
            rows = max(n, x_fill, y_fill)
            x_p = np.zeros((rows, in1.shape[1]), np.float32)
            x_p[:x_fill] = in1[:x_fill]
            y_p = np.zeros((rows, y_raw.shape[1]), np.float32)
            y_p[:y_fill] = y_raw[:y_fill]
            stats = device_file_moments(
                upload(x_p), upload(y_p), n,
                pre=self.in1_pre_context, post=self.in1_post_context,
                pre_y=pre_y, post_y=post_y, want_syy=want_syy)
            total = stats if total is None else total + stats
        return total

    def _files_or_raise(self, mode: str) -> List[str]:
        filename_list = self.filter_file_names(mode)
        if not filename_list:
            raise ValueError('No files to process in mode %s from '
                             'directory %s: %s' %
                             (mode, self.data_dir, self.all_files()))
        return filename_list

    # -- widths --------------------------------------------------------------

    def input_fields_width(self, input_number: int = 1) -> int:
        if input_number not in (1, 2):
            raise ValueError('Only 1st or 2nd input is supported here.')
        fields = self.in1_fields if input_number == 1 else self.in2_fields
        specs = self._in1_specs if input_number == 1 else self._in2_specs
        if fields:
            widths = []
            for k, spec in zip(fields, specs):
                if k not in self.features:
                    raise TypeError('Can\'t find **%s** in valid features: '
                                    '%s' % (k, list(self.features.keys())))
                widths.append(self._spec_width(
                    spec, self.features[k].shape[0]))
        else:
            widths = [1]
        if input_number == 1:
            ctx = self.in1_pre_context + 1 + self.in1_post_context
        else:
            ctx = self.in2_pre_context + 1 + self.in2_post_context
        return sum(widths) * ctx

    def _spec_width(self, spec: Optional[str], width: int) -> int:
        """Field width after its preprocessing (channel selection)."""
        if spec is None:
            return width
        pp = Preprocessor(spec, self.frame_rate, self.frame_rate,
                          device=self.device)
        if pp.channel_numbers is not None:
            return len(pp.channel_numbers)
        return width


class TestBrainData(BrainData):
    """In-memory dataset fixture (reference TestBrainData,
    brain_data.py:550-642)."""

    __test__ = False   # Library class, not a pytest test class.

    def preserve_test_data(self, input_data, output_data,
                           input2_data=None, attention_data=None):
        input_data = np.asarray(input_data, np.float32)
        output_data = np.asarray(output_data, np.float32)
        if input_data.shape[0] != output_data.shape[0]:
            raise ValueError('input shape (%s) and output shape (%s) are '
                             'not equal.' % (input_data.shape,
                                             output_data.shape))
        if input2_data is None:
            input2_data = np.zeros((input_data.shape[0], 1), np.float32)
        input2_data = np.asarray(input2_data, np.float32)
        if input_data.shape[0] != input2_data.shape[0]:
            raise ValueError('input shape (%s) and input2 shape (%s) are '
                             'not equal.' % (input_data.shape,
                                             input2_data.shape))
        if attention_data is None:
            attention_data = np.zeros((input_data.shape[0], 1), np.float32)
        attention_data = np.asarray(attention_data, np.float32)
        if input_data.shape[0] != attention_data.shape[0]:
            raise ValueError('input shape (%s) and attention shape (%s) are '
                             'not equal.' % (input_data.shape,
                                             attention_data.shape))
        self.saved_input_data = input_data
        self.saved_input2_data = input2_data
        self.saved_output_data = output_data
        self.saved_attention_data = attention_data
        self.features = {
            'input_1': records.FeatureSpec(input_data.shape[1], np.float32),
            'input_2': records.FeatureSpec(input2_data.shape[1], np.float32),
            'output': records.FeatureSpec(output_data.shape[1], np.float32),
            'attention': records.FeatureSpec(attention_data.shape[1],
                                             np.float32),
        }

    def load_arrays(self, mode: str, temporal_context: bool = True):
        if not hasattr(self, 'saved_input_data'):
            raise ValueError('Must call preserve_test_data before '
                             'create_dataset.')
        streams = (self.saved_input_data, self.saved_input2_data,
                   self.saved_output_data, self.saved_attention_data)
        if temporal_context and self._needs_context():
            streams = self._add_context(*streams)
        return streams


class TFExampleData(BrainData):
    """TFRecord-file dataset (reference TFExampleData,
    brain_data.py:645-927), decoded with the port's records codec."""

    # {filename: (mtime, arrays, nbytes)} LRU, most-recent last:
    # invalidated when the file changes, evicted by a byte budget
    # (TDT_FILE_CACHE_BYTES, as in the JAX package).
    _file_cache: 'OrderedDict[str, tuple]' = OrderedDict()
    _file_cache_bytes: int = 0
    _FILE_CACHE_BUDGET = int(os.environ.get('TDT_FILE_CACHE_BYTES',
                                            512 * 1024 * 1024))

    @classmethod
    def _cache_put(cls, filename: str, mtime: float, arrays) -> None:
        nbytes = sum(a.nbytes for a in arrays.values())
        if nbytes > cls._FILE_CACHE_BUDGET:
            return   # One entry over budget would just thrash.
        old = cls._file_cache.pop(filename, None)
        if old is not None:
            cls._file_cache_bytes -= old[2]
        while (cls._file_cache and
               cls._file_cache_bytes + nbytes > cls._FILE_CACHE_BUDGET):
            _, (_, _, evicted) = cls._file_cache.popitem(last=False)
            cls._file_cache_bytes -= evicted
        cls._file_cache[filename] = (mtime, arrays, nbytes)
        cls._file_cache_bytes += nbytes

    def _get_data_file_names(self):
        if not self.data_dir:
            raise ValueError('Missing data_dir in TFExampleData '
                             'initialization. Must specify the source of '
                             'the data (FLAGS.tfrecords).')
        if not isinstance(self.data_dir, str):
            raise TypeError('data_dir must be a string, not a %s (**%s**)' %
                            (type(self.data_dir), self.data_dir))
        names = []
        for path, _, files in os.walk(self.data_dir):
            names += [os.path.join(path, f) for f in files
                      if (f.endswith('.tfrecords') and '-bad-' not in f and
                          self.data_pattern in f)]
        self._cached_file_names = sorted(names)
        if not self._cached_file_names:
            raise ValueError('Should not have an empty list of data files '
                             'from %s.' % self.data_dir)
        self.features = records.discover_feature_shapes(
            self._cached_file_names[0])

    def file_arrays(self, filename: str, cache: bool = True):
        mtime = os.path.getmtime(filename)
        cached = TFExampleData._file_cache.get(filename)
        if cached is not None and cached[0] == mtime:
            TFExampleData._file_cache.move_to_end(filename)
            return self._select_fields(cached[1])
        arrays = records.read_tfrecords(filename)
        if cache:
            TFExampleData._cache_put(filename, mtime, arrays)
        return self._select_fields(arrays)


def create_brain_dataset(data_type: str, in_fields, out_field: str,
                         frame_rate: float, **kwargs) -> BrainData:
    """Factory matching reference create_brain_dataset
    (brain_data.py:959-1048)."""
    if not isinstance(data_type, str):
        raise TypeError('create_brain_dataset type must be a string.')
    if frame_rate <= 0:
        raise ValueError('frame_rate must be greater than 0.')
    # None means "absent" for optional fields and patterns, except
    # shuffle_seed, where None asks for fresh randomness.
    kwargs = {k: v for k, v in kwargs.items()
              if v is not None or k == 'shuffle_seed'}
    if data_type in ('tfrecord', 'tfrecords', 'tfexample'):
        return TFExampleData(in_fields, out_field, frame_rate, **kwargs)
    if data_type == 'test':
        kwargs.pop('attended_field', None)
        return TestBrainData(in_fields, out_field, frame_rate, **kwargs)
    raise TypeError('create_brain_dataset unknown data type %s' % data_type)
