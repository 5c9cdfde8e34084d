"""Experiment driver: train and test one decoding model from flags (port
of cli/decoding.py).

  python -m telluride_decoding_torch.cli.decoding --tfexample_dir D \
      --input_field eeg --output_field intensity --dnn_regressor linear \
      --train_file_pattern allbut --validate_file_pattern trial02 \
      --test_file_pattern trial02 --summary_dir S --saved_model_dir M \
      [--device cpu]

The flags are the JAX driver's, with its names and defaults, parsed by
argparse in absl's forms (``--flag=value``, ``--flag value``,
``--flag`` / ``--noflag`` for booleans), plus ``--device`` (``cuda`` by
default, ``cpu`` for the plain versions of the kernels). It fits a
``linear``, ``linear_with_bias`` or ``cca`` model from TFRecords (the
streamed fit lag-stacks each file on the card with kernel K2), or trains
a ``fullyconnected``, ``classifier`` or ``dcca`` model by SGD (torch
autograd and Adam), evaluates it on the test split, trains the LDA
reducer on attended against mixed-up test batches (a DCCA's frame scores
go through kernel K1 on its towers' outputs; the classifier has no LDA
stage) and writes ``results.txt``, ``model.json`` + ``weights.npz`` and
``decoder_model.json`` as the JAX driver does, so either package loads
the other's artifacts. With ``--dp_fit`` under a process group
(TDT_COORDINATOR, TDT_NUM_PROCESSES and TDT_PROCESS_ID, one process a
rank) an SGD fit is data-parallel over the ranks (``fit(mesh=)``) and
rank 0 writes the artifacts.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import logging
import os
import sys
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

from telluride_decoding_torch import device as device_policy
from telluride_decoding_torch.data import brain_data, records
from telluride_decoding_torch.decode import infer_decoder
from telluride_decoding_torch.models.brain_model import (
    BrainModelClassifier, BrainModelDNN, BrainModelLinearRegression)
from telluride_decoding_torch.models.cca import BrainModelCCA, BrainModelDCCA
from telluride_decoding_torch.parallel import mesh as mesh_lib
from telluride_decoding_torch.parallel import multihost
from telluride_decoding_torch.sweep import engine
from telluride_decoding_torch.utils import profiling


@dataclasses.dataclass
class DecodingOptions:
    """All parameters of one decoding experiment: the JAX driver's
    fields, no more (results.txt's Parameters line lists them)."""

    attended_field: str = 'attend'
    batch_norm: bool = False
    batch_size: int = 512
    cca_dimensions: int = 10
    check_file_pattern: str = ''
    correlation_frames: int = 100
    correlation_reducer: str = 'lda'
    data: str = 'tfrecords'
    debug: bool = False
    dnn_regressor: str = 'fullyconnected'
    dp_fit: bool = False
    dropout: float = 0.0
    epoch_count: int = 100
    frame_rate: float = 100.0
    hidden_units: str = '20-20'
    input2_field: str = ''
    input2_post_context: int = 0
    input2_pre_context: int = 0
    input_offset: int = 0
    input_field: str = 'mel_spectrogram'
    learning_rate: float = 0.05
    loss: str = 'mse'
    min_context: int = 0
    output_field: str = 'envelope'
    post_context: int = 0
    pre_context: int = 0
    random_mixup_batch: bool = False
    mismatch_batch: bool = False
    streaming_fit: bool = False
    protocol: str = 'whole_split'
    regularization_lambda: float = 0.1
    saved_model_dir: Optional[str] = None
    shuffle_buffer_size: int = 100000
    summary_dir: str = '/tmp/tf'
    tensorboard_dir: Optional[str] = None
    test_file_pattern: str = ''
    test_metric: str = 'pearson_correlation_first'
    tfexample_dir: Optional[str] = None
    tfexample_pattern: str = ''
    train_file_pattern: str = ''
    validate_file_pattern: str = ''

    def set_flags(self, all_flags) -> 'DecodingOptions':
        for field in dataclasses.fields(self):
            if hasattr(all_flags, field.name):
                setattr(self, field.name, getattr(all_flags, field.name))
        return self

    def set_from_dict(self, new_values: Dict) -> 'DecodingOptions':
        for k, v in new_values.items():
            setattr(self, k, v)
        return self

    def experiment_parameters(
            self, delimiter: Optional[str] = ','
    ) -> Union[List[str], str]:
        params = dataclasses.asdict(self)
        keys_and_values = ['%s=%s' % (k, params[k]) for k in sorted(params)]
        if delimiter:
            return delimiter.join(keys_and_values)
        return keys_and_values


defaults = DecodingOptions()

# (name, type, default, choices, help): the JAX driver's flags
# (telluride_decoding_tpu/cli/decoding.py:110-248), beyond
# DecodingOptions too (trace_dir and four compatibility flags).
_FLAGS = [
    ('attended_field', str, '', None,
     'Which data field indicates the attended feature.'),
    ('batch_norm', bool, defaults.batch_norm, None,
     'Enable batch normalization in the network.'),
    ('batch_size', int, defaults.batch_size, None,
     'Number of frames (with context) per minibatch'),
    ('cca_dimensions', int, defaults.cca_dimensions, None,
     'Number of dimensions in the CCA analysis'),
    ('check_file_pattern', str, defaults.check_file_pattern, None,
     'A regular expression enabling a file integrity check.'),
    ('correlation_frames', int, defaults.correlation_frames, None,
     'How many frames to combine when estimating correlation'),
    ('correlation_reducer', str, defaults.correlation_reducer,
     ['lda', 'first', 'second', 'mean', 'mean-squared'],
     'How to reduce the correlation vector to a scalar.'),
    ('data', str, defaults.data, ['tfrecords', 'test'],
     'Dataset to use for this experiment.'),
    ('debug', bool, defaults.debug, None, 'Debug prints.'),
    ('dnn_regressor', str, defaults.dnn_regressor,
     ['fullyconnected', 'tf', 'linear', 'linear_with_bias', 'cca',
      'classifier', 'dcca'], 'Model type for this experiment.'),
    ('dp_fit', bool, defaults.dp_fit, None,
     'Data-parallel SGD fit over the ranks of a process group '
     '(TDT_COORDINATOR, TDT_NUM_PROCESSES, TDT_PROCESS_ID; one process a '
     'rank): each minibatch shards across the ranks and gradients '
     'all-reduce; rank 0 writes the results and the model.'),
    ('dropout', float, defaults.dropout, None, 'The dropout rate.'),
    ('epoch_count', int, defaults.epoch_count, None,
     'Number of epochs for SGD models.'),
    ('frame_rate', float, defaults.frame_rate, None,
     'Number of frames per second in TFRecord data'),
    ('hidden_units', str, defaults.hidden_units, None,
     'Hidden layer sizes, dash separated.'),
    ('input_field', str, defaults.input_field, None,
     'Input field to use for predictions.'),
    ('input2_field', str, defaults.input2_field, None,
     'Second input field for two-input methods.'),
    ('input2_pre_context', int, defaults.input2_pre_context, None,
     'Frames of pre context for the second input'),
    ('input2_post_context', int, defaults.input2_post_context, None,
     'Frames of post context for the second input'),
    ('input_offset', int, 0, None,
     'Frames to drop from the first field; negative drops from '
     'second/output field'),
    ('learning_rate', float, defaults.learning_rate, None,
     'Initial learning rate for the optimizer.'),
    ('loss', str, defaults.loss, ['mse', 'pearson'], 'Training loss.'),
    ('min_context', int, defaults.min_context, None,
     'Minimum frames of context for prediction'),
    ('output_field', str, defaults.output_field, None,
     'Output field to predict.'),
    ('pre_context', int, defaults.pre_context, None,
     'Frames of context before prediction'),
    ('post_context', int, defaults.post_context, None,
     'Frames of context after prediction'),
    ('regularization_lambda', float, defaults.regularization_lambda, None,
     'Regularization for linear regression/CCA.'),
    ('random_mixup_batch', bool, defaults.random_mixup_batch, None,
     'Mixup the data so labels are random (kept for flag parity; the '
     'LDA training builds its own mixup set).'),
    ('streaming_fit', bool, defaults.streaming_fit, None,
     'Fit from per-file streamed covariance statistics, each file lag '
     'stacked on the device.'),
    ('mismatch_batch', bool, defaults.mismatch_batch, None,
     'Train in the match-mismatch paradigm.'),
    ('protocol', str, defaults.protocol, ['whole_split', 'reference'],
     'whole_split: fit and evaluate whole ordered splits. reference: '
     'shuffled drop-remainder batches and per-batch metric means, as '
     'the TF reference.'),
    ('saved_model_dir', str, defaults.saved_model_dir, None,
     'Directory in which to save the model.'),
    ('shuffle_buffer_size', int, defaults.shuffle_buffer_size, None,
     'Number of elements to shuffle'),
    ('summary_dir', str, defaults.summary_dir, None,
     'Location of summary files.'),
    ('trace_dir', str, None, None,
     'Write a torch.profiler trace of the experiment here '
     '(trace.json).'),
    ('tensorboard_dir', str, defaults.tensorboard_dir, None,
     'Location of tensorboard files.'),
    ('test_file_pattern', str, defaults.test_file_pattern, None,
     'Regular expression picking testing files.'),
    ('test_metric', str, defaults.test_metric, None,
     'Metric to summarize from the training job.'),
    ('tfexample_dir', str, defaults.tfexample_dir, None,
     'Location of generic TFRecord data'),
    ('tfexample_pattern', str, defaults.tfexample_pattern, None,
     'Substring that data files must contain.'),
    ('train_file_pattern', str, defaults.train_file_pattern, None,
     'Regular expression picking training files.'),
    ('validate_file_pattern', str, defaults.validate_file_pattern, None,
     'Regular expression picking validation files.'),
    # Not stored in DecodingOptions (compatibility).
    ('context_method', str, 'new', ['new', 'old'],
     'Temporal window approach (kept for compatibility).'),
    ('num_input_channels', int, 1, None,
     'Input channels in test simulations.'),
    ('prefetch_buffer_size', int, 100, None,
     'Elements to prefetch (compatibility).'),
    ('run', int, 0, None, 'Parallel-testing run number.'),
]


def _parse_bool(text: str) -> bool:
    value = text.lower()
    if value in ('true', 't', '1', 'yes', 'y'):
        return True
    if value in ('false', 'f', '0', 'no', 'n'):
        return False
    raise argparse.ArgumentTypeError('not a boolean: %r' % text)


def add_flags(parser: argparse.ArgumentParser, flag_specs) -> None:
    """Adds (name, type, default, choices, help) flags in absl's
    spellings: booleans take ``--flag``, ``--flag=value`` and
    ``--noflag``."""
    for name, kind, default, choices, help_text in flag_specs:
        if kind is bool:
            parser.add_argument('--' + name, nargs='?', const=True,
                                default=default, type=_parse_bool,
                                help=help_text)
            parser.add_argument('--no' + name, dest=name,
                                action='store_false',
                                help=argparse.SUPPRESS)
        else:
            parser.add_argument('--' + name, type=kind, default=default,
                                choices=choices, help=help_text)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog='python -m telluride_decoding_torch.cli.decoding',
        description='Train and test one decoding model from TFRecords.',
        allow_abbrev=False)
    add_flags(parser, _FLAGS)
    parser.add_argument('--device', default='cuda',
                        help='torch device to run on (cuda, or cpu for the '
                        'plain versions of the kernels).')
    return parser


def create_brain_model(model_flags: DecodingOptions, input_dataset, *,
                       device):
    """Builds the requested model type (JAX cli/decoding.py:251-304)."""
    if not isinstance(model_flags, DecodingOptions):
        raise TypeError('Model_flags must be a DecodingOptions, not a %s' %
                        type(model_flags))
    kind = model_flags.dnn_regressor
    hidden_units = ([int(x) for x in model_flags.hidden_units.split('-')]
                    if model_flags.hidden_units else [])
    if kind == 'fullyconnected':
        bm = BrainModelDNN(input_dataset, hidden_units,
                           tensorboard_dir=model_flags.tensorboard_dir,
                           dropout=model_flags.dropout,
                           batch_norm=model_flags.batch_norm, device=device)
    elif kind == 'classifier':
        bm = BrainModelClassifier(
            input_dataset, model_flags.hidden_units,
            tensorboard_dir=model_flags.tensorboard_dir, device=device)
    elif kind in ('linear', 'linear_with_bias'):
        bm = BrainModelLinearRegression(
            input_dataset, model_flags.regularization_lambda,
            tensorboard_dir=model_flags.tensorboard_dir, device=device)
    elif kind == 'cca':
        bm = BrainModelCCA(
            input_dataset, cca_dims=model_flags.cca_dimensions,
            regularization_lambda=model_flags.regularization_lambda,
            tensorboard_dir=model_flags.tensorboard_dir, device=device)
    elif kind == 'dcca':
        # The flag reaches the final CCA solve, as in the cca branch.
        bm = BrainModelDCCA(
            input_dataset, cca_dims=model_flags.cca_dimensions,
            hidden_units=hidden_units,
            regularization_lambda=model_flags.regularization_lambda,
            tensorboard_dir=model_flags.tensorboard_dir, device=device)
    elif kind == 'tf':
        raise ValueError(
            "--dnn_regressor tf is a flag-parity value with no "
            "buildable model (the reference's create_brain_model has "
            "no 'tf' branch either, reference decoding.py:279-308); "
            "use linear/linear_with_bias/cca or an SGD family "
            "(fullyconnected/classifier/dcca).")
    else:
        raise TypeError('Unknown model type %s in create_brain_model.' %
                        kind)
    bm.compile(learning_rate=model_flags.learning_rate,
               loss=model_flags.loss)
    return bm


def _auto_streaming_bytes() -> int:
    """TDT_STREAMING_AUTO_BYTES (default 1 GiB; 0 disables)."""
    try:
        # float() first so '1e9'-style values parse too.
        return int(float(os.environ.get('TDT_STREAMING_AUTO_BYTES',
                                        1 << 30)))
    except ValueError:
        logging.warning('Unparseable TDT_STREAMING_AUTO_BYTES=%r; using '
                        'the 1 GB default.',
                        os.environ['TDT_STREAMING_AUTO_BYTES'])
        return 1 << 30


def train_and_test(my_flags: DecodingOptions, test_brain_data,
                   test_brain_model, epochs: int = 1, fit_seed: int = 0
                   ) -> Tuple[Dict[str, float], Dict[str, float]]:
    """Fits on the train split and evaluates on the test split.

    The fit streams the train files (per-file moments, lag stack on the
    device) with --streaming_fit, or, for the deterministic families, on
    its own when the lag-stacked train split would exceed
    TDT_STREAMING_AUTO_BYTES; the reference protocol and mismatch
    batches need the dense fit. The SGD families get --batch_size and
    ``fit_seed`` (their initialisation and batch order), and are never
    switched to the streamed fit on their own: it draws another batch
    stream than the dense fit.
    """
    if not isinstance(test_brain_data, brain_data.BrainData):
        raise TypeError('test_brain_data must be a BrainData object, not a '
                        '%s' % test_brain_data)
    if not isinstance(my_flags, DecodingOptions):
        raise TypeError('Train_and_test needs a DecodingOptions object, '
                        'not %s.' % type(my_flags))
    mismatch = my_flags.mismatch_batch
    streaming_ok = (hasattr(test_brain_model, 'fit_streaming') and
                    not mismatch and my_flags.protocol != 'reference' and
                    isinstance(test_brain_data, brain_data.TFExampleData))
    want_streaming = my_flags.streaming_fit
    sgd_model = isinstance(test_brain_model, (BrainModelDNN,
                                              BrainModelClassifier,
                                              BrainModelDCCA))
    if streaming_ok and not want_streaming and not sgd_model:
        auto_bytes = _auto_streaming_bytes()
        if auto_bytes > 0:
            try:
                estimated = test_brain_data.estimated_stacked_bytes('train')
            except (OSError, ValueError, TypeError, KeyError):
                estimated = 0
            if estimated > auto_bytes:
                logging.info(
                    'Estimated lag-stacked train corpus ~%.1f GB > %.1f '
                    'GB: auto-selecting the bounded-memory streaming fit '
                    '(pass TDT_STREAMING_AUTO_BYTES=0 to disable).',
                    estimated / 2**30, auto_bytes / 2**30)
                want_streaming = True
    fit_kwargs = (dict(batch_size=my_flags.batch_size, seed=fit_seed)
                  if sgd_model else {})
    if my_flags.dp_fit and sgd_model:
        # SGD families only; the deterministic solvers fit from moments.
        mesh = engine.default_mesh('data', device=test_brain_model.device)
        if mesh is not None:
            fit_kwargs['mesh'] = mesh
            logging.info('dp_fit: minibatches sharded over %d ranks '
                         '(backend %s).', mesh.size, mesh.backend)
        else:
            logging.info('dp_fit: one process; the fit runs on %s alone.',
                         test_brain_model.device)
    if want_streaming and streaming_ok:
        train_results = test_brain_model.fit_streaming(
            test_brain_data, 'train', epochs=epochs, **fit_kwargs)
    else:
        if my_flags.streaming_fit:
            reason = ('model %s has no streaming fit'
                      % type(test_brain_model).__name__
                      if not hasattr(test_brain_model, 'fit_streaming')
                      else 'mismatch batches transform the stream'
                      if mismatch else
                      'the reference protocol truncates the stream'
                      if my_flags.protocol == 'reference' else
                      'dataset %s is not file-backed'
                      % type(test_brain_data).__name__)
            logging.warning('--streaming_fit requested but not applicable '
                            '(%s); using the dense whole-array fit.',
                            reason)
        train_dataset = test_brain_data.create_dataset(
            'train', mismatch_batch=mismatch)
        train_results = test_brain_model.fit(train_dataset, epochs=epochs,
                                             **fit_kwargs)
    test_dataset = test_brain_data.create_dataset(
        'test', mismatch_batch=mismatch)
    test_results = test_brain_model.evaluate(test_dataset)
    return train_results, test_results


def write_experiment_summary(my_flags: DecodingOptions,
                             train_results: Dict,
                             test_results: Dict,
                             dprime: Optional[float] = None):
    """Writes results.txt, line for line as the JAX driver does,
    including the PARAMS token's directory substitution."""
    del train_results  # Not written, as in the JAX driver.
    if not isinstance(my_flags, DecodingOptions):
        raise TypeError('Write_experiment_summary needs a DecodingOptions '
                        'object, not %s.' % type(my_flags))
    summary_dir = my_flags.summary_dir
    if not summary_dir:
        return
    if 'PARAMS' in summary_dir:
        summary_dir = summary_dir.replace(
            'PARAMS', my_flags.experiment_parameters(','))
        # Path components are capped at 255 bytes on most filesystems;
        # overlong ones keep a readable prefix plus a hash of the whole.
        parts = []
        for part in summary_dir.split(os.sep):
            if len(part.encode()) > 200:
                digest = hashlib.sha1(part.encode()).hexdigest()[:12]
                part = part[:180] + '...' + digest
            parts.append(part)
        summary_dir = os.sep.join(parts)
    os.makedirs(summary_dir, exist_ok=True)
    results_file = os.path.join(summary_dir, 'results.txt')
    with open(results_file, 'w') as fp:
        fp.write('Parameters: %s\n' % my_flags.experiment_parameters(';'))
        if my_flags.protocol == 'reference':
            fp.write('Protocol: reference (shuffled drop-remainder '
                     'batches of %d, per-batch metric means — the TF '
                     'reference\'s Keras evaluate semantics)\n' %
                     my_flags.batch_size)
        else:
            fp.write('Protocol: whole_split (every test frame, ordered, '
                     'one metric over the full split; reference-style '
                     'numbers need --protocol reference)\n')
        for k in test_results:
            value = test_results[k]
            if isinstance(value, np.ndarray):
                fp.write('Final_Test/%s: %s\n' %
                         (k, ' '.join(str(f)
                                      for f in np.reshape(value, (-1)))))
            else:
                fp.write('Final_Testing/%s: %g\n' % (k, value))
        if dprime is not None:
            fp.write('Final_Testing/dprime: %g\n' % dprime)
    logging.info('Wrote summary results to %s', results_file)


def check_files(exp_data_dir: str, tfexample_pattern: str = '.tfrecords'):
    """Validates every matching TFRecord file."""
    all_files = []
    for path, _, files in os.walk(exp_data_dir):
        all_files += [os.path.join(path, f) for f in files
                      if f.endswith('.tfrecords') and
                      tfexample_pattern in f]
    print('Found %d files for TFExample data analysis.' % len(all_files))
    for f in all_files:
        count, error = records.count_tfrecords(f)
        logging.info('%s: %d%s', f, count, ' (ERROR)' if error else '')


def train_lda_model(brain_dataset, trained_model,
                    my_flags: DecodingOptions, *, device
                    ) -> Tuple[float, infer_decoder.Decoder]:
    """Trains the LDA reducer on the regressor's correlated outputs:
    attended = the test split, unattended = the test split with mixup.
    The datasets are built and iterated in the JAX driver's order, so
    both draw the same batches from the shared generator."""
    if not isinstance(brain_dataset, brain_data.BrainData):
        raise TypeError('Train_lda_model needs BrainData, not %s.' %
                        type(brain_dataset))
    if not callable(trained_model):
        raise TypeError('Trained_model parameter is not a callable '
                        'function, but a %s.' % type(trained_model))
    if isinstance(my_flags, dict):
        my_flags = DecodingOptions().set_from_dict(my_flags)
    attended_data = brain_dataset.create_dataset('test', mixup_batch=False)
    unattended_data = brain_dataset.create_dataset('test', mixup_batch=True)
    decoder = infer_decoder.create_decoder(
        my_flags.dnn_regressor, reduction=my_flags.correlation_reducer,
        model=trained_model, device=device)
    dprime = decoder.train(unattended_data, attended_data,
                           window_size=my_flags.correlation_frames)
    return dprime, decoder


def run_decoding_experiment(my_flags: DecodingOptions, device='cuda'
                            ) -> Tuple[Dict, Dict, float]:
    """Assembles data, trains, evaluates, trains LDA, writes artifacts."""
    if my_flags.debug:
        logging.getLogger().setLevel(logging.DEBUG)
    if (my_flags.pre_context + 1 + my_flags.post_context <
            my_flags.min_context):
        my_flags.post_context = (my_flags.min_context -
                                 (my_flags.pre_context + 1))
    if not my_flags.summary_dir.endswith('/'):
        my_flags.summary_dir = my_flags.summary_dir + '/'

    if my_flags.check_file_pattern:
        check_files(my_flags.tfexample_dir, my_flags.tfexample_pattern)
        return {}, {}, 0.0

    device = device_policy.resolve(device)
    timer = profiling.StageTimer('run_decoding_experiment')

    with timer.stage('data_discovery'):
        test_brain_data = brain_data.create_brain_dataset(
            my_flags.data, my_flags.input_field, my_flags.output_field,
            attended_field=my_flags.attended_field or None,
            frame_rate=my_flags.frame_rate,
            pre_context=my_flags.pre_context,
            post_context=my_flags.post_context,
            in2_fields=my_flags.input2_field or None,
            in2_pre_context=my_flags.input2_pre_context,
            in2_post_context=my_flags.input2_post_context,
            input_offset=my_flags.input_offset,
            final_batch_size=my_flags.batch_size,
            shuffle_buffer_size=my_flags.shuffle_buffer_size,
            data_dir=my_flags.tfexample_dir,
            data_pattern=my_flags.tfexample_pattern,
            train_file_pattern=my_flags.train_file_pattern,
            validate_file_pattern=my_flags.validate_file_pattern,
            test_file_pattern=my_flags.test_file_pattern,
            reference_protocol=my_flags.protocol == 'reference',
            device=device)
        # Widths only: the model and its metadata need no data.
        some_dataset = test_brain_data.spec_dataset()

    test_model = create_brain_model(my_flags, some_dataset, device=device)
    test_model.add_tensorboard_summary(
        'Parameters', my_flags.experiment_parameters(' '))

    with timer.stage('train_and_test'):
        train_results, test_results = train_and_test(
            my_flags, test_brain_data, test_model,
            epochs=my_flags.epoch_count)
    test_model.summary()
    test_model.add_metadata(dataclasses.asdict(my_flags),
                            dataset=some_dataset)

    if my_flags.dnn_regressor == 'classifier':
        # The classifier already outputs a decision probability: no
        # correlation -> LDA stage, as in the JAX driver.
        dprime, final_decoder = 0.0, None
    else:
        with timer.stage('train_lda'):
            dprime, final_decoder = train_lda_model(
                test_brain_data, test_model, my_flags, device=device)

    print('train_and_test got these results: %s and test %s' %
          (train_results, test_results))
    print('Calculated dprime is %g.' % dprime)
    if multihost.process_index() != 0:
        # Under --dp_fit every rank holds the same model; rank 0 writes.
        print(timer.report())
        return train_results, test_results, dprime

    if my_flags.summary_dir:
        write_experiment_summary(my_flags, train_results, test_results,
                                 dprime)
        print('Wrote train/test results to %s.' % my_flags.summary_dir)

    if my_flags.tensorboard_dir and test_model.tensorboard_dir:
        from telluride_decoding_torch.utils import summaries
        writer = summaries.SummaryWriter(
            os.path.join(test_model.tensorboard_dir, 'dprime'))
        writer.scalar('dprime', dprime, step=my_flags.epoch_count)

    if my_flags.saved_model_dir:
        with timer.stage('save_artifacts'):
            test_model.save(my_flags.saved_model_dir)
            if final_decoder is not None:
                final_decoder.save_parameters(
                    os.path.join(my_flags.saved_model_dir,
                                 'decoder_model.json'))
        print('Wrote saved model to %s.' % my_flags.saved_model_dir)
    print(timer.report())
    return train_results, test_results, dprime


def main(argv: Optional[List[str]] = None) -> int:
    logging.basicConfig(level=logging.INFO)
    args = build_parser().parse_args(argv)
    my_flags = DecodingOptions().set_flags(args)
    if my_flags.dp_fit:
        # Env-driven (TDT_COORDINATOR); a no-op without it.
        multihost.initialize(device=args.device)
    device = (mesh_lib.rank_device(args.device, multihost.process_index())
              if multihost.process_count() > 1 else args.device)
    with profiling.trace(args.trace_dir,
                         cuda=device_policy.resolve(device).type == 'cuda'):
        run_decoding_experiment(my_flags, device=device)
    return 0


def app_main():
    sys.exit(main())


if __name__ == '__main__':
    app_main()
