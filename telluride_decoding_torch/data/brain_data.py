"""Dataset assembly: file discovery, per-file streams, temporal context
and streamed moments (port of data/brain_data.py).

Files decode to whole [N, C] numpy arrays; lag context is applied per
file, never across file boundaries. ``streaming_moments`` uploads one
raw file at a time, lag-stacks it on the device (kernel K2 on CUDA) and
reduces it to second moments, so covariance fits never hold the
stacked corpus. The file list is shuffled with
``np.random.RandomState(shuffle_seed)`` exactly as in the JAX package,
so both give the same file order and the same ``allbut_NN`` subsets.

The minibatch iterator (``create_dataset``, ``BrainDataset``) is host
numpy, as in the JAX package, and every shuffle, mixup and mismatch draw
comes from that same generator in the same order, so both packages give
the same batches bit for bit.
"""

from __future__ import annotations

import os
import re
from collections import OrderedDict
from typing import Dict, Iterator, List, Optional, Sequence, Tuple, Union

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
                 initial_batch_size: int = 1000000,
                 final_batch_size: int = 1000,
                 repeat_count: int = 1,
                 shuffle_buffer_size: int = 1000,
                 data_dir: Optional[str] = None,
                 data_pattern: str = '',
                 train_file_pattern: str = '',
                 validate_file_pattern: str = '',
                 test_file_pattern: str = '',
                 shuffle_seed: int = 42,
                 reference_protocol: bool = False,
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
        self.initial_batch_size = initial_batch_size
        self.final_batch_size = final_batch_size
        self.repeat_count = repeat_count
        self.shuffle_buffer_size = shuffle_buffer_size
        self.data_dir = data_dir
        self.data_pattern = data_pattern
        self.train_file_pattern = train_file_pattern or ''
        self.validate_file_pattern = validate_file_pattern or ''
        self.test_file_pattern = test_file_pattern or ''
        # The reference's data protocol: every split is shuffled (unless
        # shuffle_buffer_size is 0), cut to whole final batches and
        # scored as a mean of per-batch metrics
        # (telluride_decoding_tpu/data/brain_data.py:198-207).
        self.reference_protocol = bool(reference_protocol)
        self.features: Dict[str, records.FeatureSpec] = {}
        # Seeded file-list shuffle, as in the JAX package; None asks for
        # fresh randomness. The minibatch iterator draws from it too.
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
        parts = self._load_parts(mode, temporal_context)
        return tuple(np.concatenate([p[i] for p in parts], axis=0)
                     for i in range(4))

    def _load_parts(self, mode: str, temporal_context: bool = True
                    ) -> List[Tuple[np.ndarray, ...]]:
        """Per-file context-stacked streams, in file order."""
        parts = []
        for filename in self._files_or_raise(mode):
            streams = self.file_arrays(filename)
            if temporal_context and self._needs_context():
                streams = self._add_context(*streams)
            parts.append(streams)
        return parts

    # The reference's TFRecord path windows only on a nonzero pre/post
    # context and ignores a lone input_offset; its in-memory test data
    # honors the offset. Under the reference protocol TFExampleData
    # reproduces that (telluride_decoding_tpu/data/brain_data.py:374-392).
    _reference_offset_quirk = False

    def _needs_context(self) -> bool:
        has_context = bool(self.in1_pre_context or self.in1_post_context
                           or self.in2_pre_context
                           or self.in2_post_context)
        if self.reference_protocol and self._reference_offset_quirk:
            return has_context
        return has_context or bool(self.input_offset)

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

    def spec_dataset(self) -> 'BrainDataset':
        """Zero-row BrainDataset carrying only this source's element
        widths, for sizing a model and its metadata without reading the
        corpus."""
        def z(width):
            return np.zeros((0, width), np.float32)
        return BrainDataset(z(self.input_fields_width(1)),
                            z(self.input_fields_width(2)),
                            z(self.output_field_width()), z(1),
                            batch_size=self.final_batch_size,
                            mode='train', shuffle=False)

    def _files_or_raise(self, mode: str) -> List[str]:
        filename_list = self.filter_file_names(mode)
        if not filename_list:
            raise ValueError('No files to process in mode %s from '
                             'directory %s: %s' %
                             (mode, self.data_dir, self.all_files()))
        return filename_list

    # -- batching / dataset iterator ----------------------------------------

    def create_dataset(self, mode: str = 'train',
                       temporal_context: bool = True,
                       mixup_batch: bool = False,
                       mismatch_batch: bool = False) -> 'BrainDataset':
        """An iterable of ({'input_1', 'input_2', 'attended_speaker'},
        output) minibatches over this mode's files."""
        if self.reference_protocol:
            # The reference interleaves the files' frames round-robin
            # before batching; with drop-remainder that decides which
            # frames survive.
            in1, in2, out, attended = _interleave_parts(
                self._load_parts(mode, temporal_context))
        else:
            in1, in2, out, attended = self.load_arrays(mode,
                                                       temporal_context)
        return BrainDataset(in1, in2, out, attended,
                            batch_size=self.final_batch_size,
                            mode=mode,
                            repeat_count=self.repeat_count,
                            shuffle=self.shuffle_buffer_size > 0,
                            mixup_batch=mixup_batch,
                            mismatch_batch=mismatch_batch,
                            rng=self._rng,
                            reference_protocol=self.reference_protocol)

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

    def output_field_width(self) -> int:
        if self.out_field == 'ones':
            return 1
        if self.out_field not in self.features:
            raise ValueError('Could not find output_field **%s** in %s' %
                             (self.out_field, list(self.features.keys())))
        return self._spec_width(self._out_spec,
                                self.features[self.out_field].shape[0])


def _interleave_parts(parts: List[Tuple[np.ndarray, ...]]
                      ) -> Tuple[np.ndarray, ...]:
    """Round-robin frame interleave across per-file streams: frame t of
    file f lands at the position sorted by (t, f), and files that run
    out drop out of the rotation (tf.data interleave, block_length 1)."""
    if len(parts) == 1:
        return parts[0]
    t_idx = np.concatenate([np.arange(p[0].shape[0]) for p in parts])
    f_idx = np.concatenate([np.full(p[0].shape[0], f)
                            for f, p in enumerate(parts)])
    order = np.lexsort((f_idx, t_idx))
    return tuple(
        np.concatenate([p[i] for p in parts], axis=0)[order]
        for i in range(4))


class BrainDataset:
    """An iterable of minibatches over preassembled host arrays
    (telluride_decoding_tpu/data/brain_data.py:592-725).

    Iterating yields ({'input_1', 'input_2', 'attended_speaker'}, output)
    numpy minibatches with drop-remainder semantics; ``all_arrays`` gives
    the whole arrays for one-shot fits and decodes. Every random draw
    (the per-epoch order, mixup and mismatch permutations, and the
    reference protocol's one shuffle at construction) comes from ``rng``
    in the JAX package's order.
    """

    def __init__(self, in1, in2, out, attended, *, batch_size: int,
                 mode: str, repeat_count: int = 1, shuffle: bool = True,
                 mixup_batch: bool = False, mismatch_batch: bool = False,
                 rng: Optional[np.random.RandomState] = None,
                 reference_protocol: bool = False):
        self._batch_size = batch_size
        self._mode = mode
        self._repeat_count = repeat_count if mode == 'train' else 1
        self._shuffle = shuffle and mode != 'program_test'
        self._mixup = mixup_batch
        self._mismatch = mismatch_batch
        self._rng = rng if rng is not None else np.random.RandomState(42)
        # Reference protocol: shuffle (unless off) and drop the frames
        # past floor(N/B)*B once, here, so fits, evaluations and the
        # decoder's training all see the same stream; iteration still
        # re-permutes within the kept frames each epoch.
        self.reference_batch_size = None
        if reference_protocol:
            n = in1.shape[0]
            keep = (n // batch_size) * batch_size
            if keep == 0 and n > 0:
                import warnings
                warnings.warn(
                    'reference_protocol: %d frames < batch_size %d; the '
                    'reference would produce an EMPTY %s dataset '
                    '(drop_remainder). Keeping all frames instead.' %
                    (n, batch_size, mode))
            else:
                order = (self._rng.permutation(n) if self._shuffle
                         else np.arange(n))[:keep]
                in1, in2 = in1[order], in2[order]
                out, attended = out[order], attended[order]
                self.reference_batch_size = batch_size
        self._in1 = in1
        self._in2 = in2
        self._out = out
        self._attended = attended

    @property
    def num_frames(self) -> int:
        return self._in1.shape[0]

    @property
    def batch_size(self) -> int:
        """Minibatch size of the iterator (drop-remainder)."""
        return self._batch_size

    @property
    def has_batch_transforms(self) -> bool:
        """True when iteration applies mixup or mismatch, so the raw
        arrays differ from the iterated stream."""
        return self._mixup or self._mismatch

    def all_arrays(self):
        return self._in1, self._in2, self._out, self._attended

    def iter_one_epoch(self):
        """One epoch of minibatches regardless of repeat_count."""
        saved = self._repeat_count
        self._repeat_count = 1
        try:
            yield from self
        finally:
            self._repeat_count = saved

    @property
    def element_spec(self):
        return ({'input_1': self._in1.shape[1:],
                 'input_2': self._in2.shape[1:],
                 'attended_speaker': self._attended.shape[1:]},
                self._out.shape[1:])

    def __iter__(self) -> Iterator[Tuple[Dict[str, np.ndarray], np.ndarray]]:
        n = self.num_frames
        b = self._batch_size
        for _ in range(self._repeat_count):
            order = (self._rng.permutation(n) if self._shuffle
                     else np.arange(n))
            for start in range(0, n - b + 1, b):
                idx = order[start:start + b]
                x = self._in1[idx]
                x2 = self._in2[idx]
                y = self._out[idx]
                a = self._attended[idx]
                if self._mismatch:
                    x, x2, y, a = self._mismatch_transform(x, x2, y, a)
                if self._mixup:
                    x2 = x2[self._rng.permutation(b)]
                    y = y[self._rng.permutation(b)]
                yield ({'input_1': x, 'input_2': x2,
                        'attended_speaker': a}, y)

    def _mismatch_transform(self, x, x2, y, a):
        """Match-mismatch transform: even rows keep their pairing (label
        0), odd rows get shuffled input_2 (label 1); the two halves are
        concatenated."""
        even_x2 = x2[0::2]
        odd_x2 = x2[1::2][self._rng.permutation(x2[1::2].shape[0])]
        new_x2 = np.concatenate([even_x2, odd_x2], axis=0)
        new_y = np.concatenate([np.zeros((even_x2.shape[0], 1), np.float32),
                                np.ones((odd_x2.shape[0], 1), np.float32)],
                               axis=0)
        new_x = np.concatenate([x[0::2], x[1::2]], axis=0)
        new_a = np.concatenate([a[0::2], a[1::2]], axis=0)
        return new_x, new_x2, new_y, new_a


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

    def _load_parts(self, mode: str, temporal_context: bool = True):
        # One in-memory stream: nothing to interleave.
        return [self.load_arrays(mode, temporal_context)]


class TFExampleData(BrainData):
    """TFRecord-file dataset (reference TFExampleData,
    brain_data.py:645-927), decoded with the port's records codec."""

    _reference_offset_quirk = True

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

    def estimated_stacked_bytes(self, mode: str = 'train') -> int:
        """Rough float32 size of this mode's lag-stacked corpus, from
        the files' sizes over the raw record width (no decode). Proto
        overhead makes it a slight overestimate, the safe side for the
        driver's choice of the streamed fit."""
        raw_width = sum(int(np.prod(s.shape)) or 1
                        for s in self.features.values())
        stacked_width = (self.input_fields_width(1) +
                         self.input_fields_width(2) +
                         self.output_field_width() + 1)
        total_bytes = sum(os.path.getsize(f)
                          for f in self.filter_file_names(mode))
        est_frames = total_bytes // max(raw_width * 4, 1)
        return int(est_frames * stacked_width * 4)


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
