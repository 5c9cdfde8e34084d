"""Regression driver: cross-validated lambda sweeps (port of
cli/regression.py).

  python -m telluride_decoding_torch.cli.regression --tfexample_dir D \\
      --test_name jens_memory_linear --post_context 36 \\
      --regularization_list 1e-6,1e-4,1e-2,1 [--device cpu]

The flags are the JAX driver's, parsed by argparse in absl's forms on
top of the decoding driver's flags, plus ``--device`` (``cuda`` by
default). For ``linear``, ``linear_with_bias`` and ``cca`` models the
whole (lambda x held-out file) grid runs through ``sweep.engine`` from
per-file moments, each file lag-stacked on the card by kernel K2
(``TDT_DEVICE_CONTEXT=0`` stacks on the host instead). ``--protocol
reference`` and the SGD families (``fullyconnected``, ``classifier``,
``dcca``) route each (lambda, file) cell through
``cli.decoding.train_and_test`` (``jackknife_one_model``): one training
run a cell, the same model object refit from its last parameters, as in
the JAX package. The driver writes the JAX driver's per-lambda
``results.txt`` under ``reglambda_{lambda}_test_{file}``, the optional
CSV, and returns {lambda: (mean, std)}.
"""

from __future__ import annotations

import argparse
import collections
import logging
import os
import sys
from typing import List, Optional

import numpy as np

from telluride_decoding_torch import device as device_policy
from telluride_decoding_torch.cli import decoding
from telluride_decoding_torch.data import brain_data
from telluride_decoding_torch.sweep import engine
from telluride_decoding_torch.utils import csv_util, profiling
from telluride_decoding_torch.utils.stdio import LateBoundStdout

regression_print = LateBoundStdout()


def device_context_enabled() -> bool:
    """TDT_DEVICE_CONTEXT=0 reverts the sweep path to host-side lag
    stacking (the default stacks each file on the device, kernel K2, so
    only raw channels cross the bus)."""
    return os.environ.get('TDT_DEVICE_CONTEXT', '1').lower() not in (
        '0', 'off', 'false')


def _tmp_dir(name: str) -> str:
    return os.path.join(os.environ.get('TMPDIR') or '/tmp', name)


def get_brain_data_object(my_flags, device='cuda'
                          ) -> brain_data.TFExampleData:
    if not isinstance(my_flags, decoding.DecodingOptions):
        raise TypeError('get_brain_data_objects needs a DecodingOptions '
                        'object, not %s.' % type(my_flags))
    return brain_data.TFExampleData(
        my_flags.input_field,
        my_flags.output_field,
        my_flags.frame_rate,
        pre_context=my_flags.pre_context,
        post_context=my_flags.post_context,
        in2_fields=my_flags.input2_field or None,
        in2_pre_context=my_flags.input2_pre_context,
        in2_post_context=my_flags.input2_post_context,
        final_batch_size=my_flags.batch_size,
        data_dir=my_flags.tfexample_dir,
        train_file_pattern=my_flags.train_file_pattern,
        validate_file_pattern=my_flags.validate_file_pattern,
        test_file_pattern=my_flags.test_file_pattern,
        shuffle_buffer_size=my_flags.shuffle_buffer_size,
        reference_protocol=my_flags.protocol == 'reference',
        device=device)


def get_brain_model(test_dataset, my_flags, device='cuda'):
    if not isinstance(my_flags, decoding.DecodingOptions):
        raise TypeError('Get_brain_model needs a DecodingOptions object, '
                        'not %s.' % type(my_flags))
    return decoding.create_brain_model(my_flags, test_dataset,
                                       device=device)


def parse_regularization_values(mode_string):
    """'normal' -> 10^-6..10^0; 'test' -> one value; else CSV floats."""
    if isinstance(mode_string, float):
        return [mode_string]
    if not isinstance(mode_string, str):
        raise TypeError('Parse_regularization_values needs a '
                        'comma-separated string, not a %s' % mode_string)
    mode_string = mode_string.lower()
    if mode_string == 'normal':
        return np.power(10, np.arange(-6.0, 0.5, 1))
    if mode_string == 'test':
        return np.power(10, np.arange(-6.0, -5, 1))
    try:
        return np.array([float(tok) for tok in mode_string.split(',')],
                        dtype=np.float32)
    except ValueError:
        raise ValueError('Could not parse regularization values: want '
                         'comma separated list of floats, not %s' %
                         mode_string)


def calculate_stats(run_results, axis=(1,)):
    return np.mean(run_results, axis=axis), np.std(run_results, axis=axis)


def jackknife_one_model(test_brain_data, test_brain_model, model_dir,
                        my_flags, max_test_count: int = -1,
                        test_name: str = 'telluride4',
                        trial_number: int = 0, summary_file=None,
                        test_file: Optional[str] = None) -> List[float]:
    """Leave-one-out loop through train_and_test, one result per
    held-out file (the per-cell route of ``--protocol reference`` and of
    the SGD families)."""
    if not isinstance(my_flags, decoding.DecodingOptions):
        raise TypeError('Jackknife_one_model needs a DecodingOptions '
                        'object, not %s.' % type(my_flags))
    if test_file:
        all_test_files = [test_file]
    else:
        all_test_files = test_brain_data.all_files(max_test_count)
    all_cor = []
    for one_file in sorted(all_test_files):
        test_brain_data.set_file_patterns(my_flags.train_file_pattern,
                                          one_file, one_file)
        if model_dir:
            my_flags.saved_model_dir = os.path.join(
                model_dir, 'test_%s' % os.path.basename(one_file))
        else:
            my_flags.saved_model_dir = None
        _, test_results = decoding.train_and_test(
            my_flags, test_brain_data, test_brain_model,
            epochs=my_flags.epoch_count)
        if my_flags.test_metric not in test_results:
            raise ValueError('Could not find metric %s in results %s.' %
                             (my_flags.test_metric, test_results))
        all_cor.append(test_results[my_flags.test_metric])
    log_entry = ('Jackknife test result test={}, regularization lambda={}, '
                 'trial={}, mean correlation={}, std={}, '
                 'test count={}\n'.format(
                     test_name, my_flags.regularization_lambda,
                     trial_number, np.mean(all_cor), np.std(all_cor),
                     len(all_cor)))
    log_entry += ('Jackknife parameters:' +
                  my_flags.experiment_parameters() + '\n')
    logging.info(log_entry)
    if summary_file:
        if isinstance(summary_file, str):
            with open(summary_file, 'a') as fp:
                fp.write(log_entry)
        else:
            summary_file.write(log_entry)
    return all_cor


class Regression:
    """Base regression test: presets + the jackknife sweep. ``device``
    (default ``cuda``) runs the moments, the grid and the per-cell
    fits; ``timer`` collects the sweep's stages."""

    def __init__(self, my_flags=None, device='cuda'):
        if my_flags and not isinstance(my_flags, decoding.DecodingOptions):
            raise TypeError('Regression init needs a DecodingOptions '
                            'object, not %s.' % type(my_flags))
        self.my_flags = my_flags or decoding.DecodingOptions()
        self.test_name = 'Regression Test Object'
        self.device = device
        self.timer = profiling.StageTimer('jackknife_over_regularizations')

    @property
    def model_type(self):
        return 'Undefined'

    def plot_results(self, regularization_list, run_mean, run_std,
                     plot_base_dir: str = _tmp_dir('plots')):
        from telluride_decoding_torch.utils import plot_util
        os.makedirs(plot_base_dir, exist_ok=True)
        plot_util.plot_mean_std(
            self.test_name, regularization_list, run_mean, run_std,
            png_file_name=os.path.join(plot_base_dir,
                                       self.test_name + '_jack_knife.png'))

    # -- the sweep ------------------------------------------------------------

    def _per_file_arrays(self, test_brain_data, all_files,
                         cache: bool = True):
        """Each file's context-stacked (x, y) pair, stacked on the host.

        cache=False reads through the decoded-file LRU without
        populating it."""
        xs, ys = [], []
        for filename in all_files:
            streams = test_brain_data.file_arrays(filename, cache=cache)
            in1, in2, out, _ = test_brain_data._add_context(*streams)
            xs.append(in1)
            ys.append(in2 if self.my_flags.dnn_regressor == 'cca' else out)
        return xs, ys

    def _per_file_raw(self, test_brain_data, all_files,
                      cache: bool = True):
        """Per-file raw (un-stacked) streams + the engine ContextSpec.

        Layout (engine.ContextSpec): x has n_i + x_post rows, y has
        n_i + y_post rows, where n_i is the file's zip-truncated common
        frame count after input_offset; the moments equal those of
        _add_context's stack-then-truncate (rows near the end keep any
        real frames the stream has past n_i; zero rows pad up where it
        has none, the host stack's zero edges).
        """
        bd = test_brain_data
        cca = self.my_flags.dnn_regressor == 'cca'
        ctx = engine.ContextSpec(
            bd.in1_pre_context, bd.in1_post_context,
            bd.in2_pre_context if cca else 0,
            bd.in2_post_context if cca else 0)

        def clip_pad(a, rows):
            a = np.asarray(a)
            a = a[:, None] if a.ndim == 1 else a
            if a.shape[0] >= rows:
                return a[:rows]
            return np.pad(a, ((0, rows - a.shape[0]), (0, 0)))

        offset = bd.input_offset
        xs, ys = [], []
        for filename in all_files:
            in1, in2, out, att = bd.file_arrays(filename, cache=cache)
            if offset > 0:
                in1 = in1[offset:]
            elif offset < 0:
                # attended is not sliced, as in _add_context, whose zip
                # truncation sees the unsliced attended length.
                in2, out = in2[-offset:], out[-offset:]
            n = min(in1.shape[0], in2.shape[0], out.shape[0],
                    att.shape[0])
            xs.append(clip_pad(in1, n + ctx.x_post))
            ys.append(clip_pad(in2 if cca else out, n + ctx.y_post))
        return xs, ys, ctx

    def jackknife_over_regularizations(self, my_flags,
                                       regularization_list,
                                       test_file: Optional[str] = None,
                                       summary_base_dir: str = '/tmp',
                                       model_base_dir: Optional[str] = None,
                                       max_test_count: int = -1,
                                       checkpoint_dir: Optional[str] = None,
                                       lambda_block: int = 0,
                                       results_csv_file: Optional[str] = None):
        """The full (lambda x held-out file) grid.

        Returns {lambda: (mean, std)} over held-out files, writing the
        reference's per-lambda results.txt summaries and, with
        ``results_csv_file``, the CSV.
        """
        device = device_policy.resolve(self.device)
        test_brain_data = get_brain_data_object(my_flags, device)
        all_files = sorted(test_brain_data.all_files(max_test_count))
        my_flags.train_file_pattern = (my_flags.train_file_pattern or
                                       'allbut')
        regularization_list = np.asarray(regularization_list, np.float64)

        use_fast_path = my_flags.dnn_regressor in ('linear',
                                                   'linear_with_bias',
                                                   'cca')
        if use_fast_path and my_flags.protocol == 'reference':
            # The moments-only engine evaluates whole ordered files; the
            # reference protocol shuffles, drops remainders and averages
            # metrics per batch, so each cell goes through
            # train_and_test instead.
            logging.info('--protocol reference: using the per-cell '
                         'train_and_test jackknife (the one-program '
                         'sweep engine computes whole-file metrics, '
                         'a different evaluation protocol).')
            use_fast_path = False
        if use_fast_path:
            # Leave-one-out stats need all files even when reporting a
            # single test file; compute the full grid and slice below.
            files = all_files
            with self.timer.stage('read_records'):
                if device_context_enabled():
                    xs, ys, ctx = self._per_file_raw(test_brain_data, files)
                else:
                    xs, ys = self._per_file_arrays(test_brain_data, files)
                    ctx = None

            def sweep_block(lambdas_block, file_slice):
                del file_slice
                if my_flags.dnn_regressor == 'cca':
                    res = engine.cca_jackknife_sweep(
                        xs, ys, lambdas_block,
                        dims=my_flags.cca_dimensions, file_names=files,
                        context=ctx, device=device, timer=self.timer)
                else:
                    res = engine.ridge_jackknife_sweep(
                        xs, ys, lambdas_block, file_names=files,
                        context=ctx, device=device, timer=self.timer)
                return res.correlations

            if checkpoint_dir:
                from telluride_decoding_torch.sweep.checkpoint import (
                    run_sweep_with_checkpoints)
                all_runs_results = run_sweep_with_checkpoints(
                    sweep_block, list(regularization_list), files,
                    checkpoint_dir, lambda_block=lambda_block,
                    extra_config={'model': my_flags.dnn_regressor,
                                  'dims': my_flags.cca_dimensions})
            else:
                all_runs_results = sweep_block(regularization_list, None)
            if test_file:
                matches = [i for i, f in enumerate(files)
                           if test_file in f]
                if not matches:
                    raise ValueError('test_file %s not among data files '
                                     '%s' % (test_file, files))
                all_runs_results = all_runs_results[:, matches]
        else:
            num_trials = 1 if test_file else len(all_files)
            all_runs_results = np.zeros((len(regularization_list),
                                         num_trials))
            for i, lamb in enumerate(regularization_list):
                my_flags.regularization_lambda = float(lamb)
                my_flags.validate_file_pattern = test_file or all_files[0]
                my_flags.test_file_pattern = test_file or all_files[0]
                model = get_brain_model(
                    test_brain_data.create_dataset('test'), my_flags,
                    device)
                with self.timer.stage('per_cell_fits'):
                    all_runs_results[i, :] = jackknife_one_model(
                        test_brain_data, model, model_base_dir, my_flags,
                        max_test_count=max_test_count, test_file=test_file)

        # Per-lambda summaries (reference directory scheme:
        # reglambda_{value}_test_{file}).
        for i, lamb in enumerate(regularization_list):
            test_path_part = 'reglambda_{}_test_{}'.format(lamb, test_file)
            full_summary_dir = os.path.join(summary_base_dir,
                                            test_path_part)
            os.makedirs(full_summary_dir, exist_ok=True)
            with open(os.path.join(full_summary_dir, 'results.txt'),
                      'w') as fp:
                row = all_runs_results[i, :]
                fp.write('Jackknife test result test={}, regularization '
                         'lambda={}, trial={}, mean correlation={}, '
                         'std={}, test count={}\n'.format(
                             self.test_name, lamb, 0, np.mean(row),
                             np.std(row), row.shape[0]))
                fp.write('Jackknife parameters:' +
                         my_flags.experiment_parameters() + '\n')

        print(all_runs_results, file=regression_print)
        if results_csv_file:
            csv_util.write_results(results_csv_file,
                                   list(regularization_list),
                                   all_runs_results)
        test_mean, test_std = calculate_stats(all_runs_results)
        mean_std_dict = collections.OrderedDict()
        for i, lamb in enumerate(regularization_list):
            mean_std_dict[lamb] = (test_mean[i], test_std[i])
        return mean_std_dict

    def preset_flags(self):
        """Generic (model-independent) defaults."""
        self.my_flags.batch_norm = True
        self.my_flags.batch_size = 100
        self.my_flags.data = 'tfrecords'
        self.my_flags.epoch_count = 1
        self.my_flags.input_field = 'eeg'
        self.my_flags.loss = 'mse'
        self.my_flags.output_field = 'intensity'
        self.my_flags.shuffle_buffer_size = 100
        if not self.my_flags.train_file_pattern:
            self.my_flags.train_file_pattern = 'allbut'
        return 'Generic'


class RegressionLinear(Regression):

    def preset_flags(self):
        super().preset_flags()
        self.my_flags.dnn_regressor = 'linear'
        if not self.my_flags.post_context:
            self.my_flags.post_context = 20
        self.my_flags.input2_pre_context = 0
        self.my_flags.input2_post_context = 0
        self.my_flags.input2_field = ''
        self.my_flags.test_metric = 'pearson_correlation_first'
        self.my_flags.shuffle_buffer_size = 0
        return 'linear'


class RegressionCCA(Regression):

    def preset_flags(self):
        super().preset_flags()
        self.my_flags.dnn_regressor = 'cca'
        if not self.my_flags.post_context:
            self.my_flags.post_context = 21
        if not self.my_flags.input2_pre_context:
            self.my_flags.input2_pre_context = 15
        if not self.my_flags.input2_post_context:
            self.my_flags.input2_post_context = 15
        self.my_flags.input2_field = 'intensity'
        self.my_flags.output_field = 'eeg'
        self.my_flags.test_metric = 'cca_pearson_correlation_first'
        self.my_flags.shuffle_buffer_size = 0
        self.my_flags.cca_dimensions = 5
        return 'cca'


class JensMemoryCCA(RegressionCCA):
    pass


class JensMemoryLinear(RegressionLinear):
    pass


class Telluride4Linear(RegressionLinear):

    def preset_flags(self):
        super().preset_flags()
        self.my_flags.tfexample_dir = (self.my_flags.tfexample_dir or
                                       'test_data/tf_dir/telluride4_64Hz')
        return 'linear'


class Telluride4CCA(RegressionCCA):

    def preset_flags(self):
        super().preset_flags()
        self.my_flags.tfexample_dir = (self.my_flags.tfexample_dir or
                                       'test_data/tf_dir/telluride4_64Hz')
        return 'cca'


class JensImpairedLinear(RegressionLinear):
    """Hearing-impaired corpus: EEG predicts the attended stimulus
    feature of the events-aligned ingest."""

    def preset_flags(self):
        model_type = super().preset_flags()
        self.my_flags.output_field = 'attended_intensity'
        self.my_flags.frame_rate = 64.0
        return model_type


class KULeuvenLinear(RegressionLinear):
    """KULeuven corpus: EEG predicts the attended-speaker intensity at
    32 Hz."""

    def preset_flags(self):
        model_type = super().preset_flags()
        self.my_flags.frame_rate = 32.0
        return model_type


class KULeuvenCCA(RegressionCCA):

    def preset_flags(self):
        model_type = super().preset_flags()
        self.my_flags.frame_rate = 32.0
        return model_type


class TFRecordsLinear(RegressionLinear):

    def preset_flags(self):
        model_type = super().preset_flags()
        self.my_flags.output_field = 'loudness'
        self.my_flags.batch_size = 100
        return model_type


class TFRecordsCCA(RegressionCCA):

    def preset_flags(self):
        model_type = super().preset_flags()
        self.my_flags.output_field = 'loudness'
        self.my_flags.batch_size = 100
        return model_type


# --test_name values, in the JAX flag's order.
_PRESETS = {
    'telluride4_linear': Telluride4Linear,
    'telluride4_cca': Telluride4CCA,
    'jens_memory_linear': JensMemoryLinear,
    'jens_memory_cca': JensMemoryCCA,
    'jens_impaired_linear': JensImpairedLinear,
    'kuleuven_linear': KULeuvenLinear,
    'kuleuven_cca': KULeuvenCCA,
}
TEST_NAMES = list(_PRESETS)


def select_regression_object(test_name: str, my_flags,
                             device='cuda') -> Regression:
    if not isinstance(my_flags, decoding.DecodingOptions):
        raise TypeError('Select_regression_object needs a DecodingOptions '
                        'object, not %s.' % type(my_flags))
    preset = _PRESETS.get(test_name.lower())
    if preset is None:
        raise TypeError('Illegal test name: {}'.format(test_name))
    return preset(my_flags, device=device)


# (name, type, default, choices, help): the JAX driver's own flags
# (telluride_decoding_tpu/cli/regression.py:47-90).
_FLAGS = [
    ('run_number', int, 1, None,
     'Run number, so each run gets its own summary file.'),
    ('max_test_count', int, -1, None,
     'Number of files to use when jackknifing.'),
    ('regularization_list', str, 'normal', None,
     'Regularization values when training the model'),
    ('test_name', str, 'telluride4_linear', TEST_NAMES,
     'Test to run, in the form datasetname_model.'),
    ('cache', bool, False, None,
     'Should all data just be downloaded to a local cache?'),
    ('test_file', str, None, None,
     'Specify just one test file for jackknifing.'),
    ('model_base_dir', str, _tmp_dir('model'), None,
     'Base directory for models.'),
    ('plot_base_dir', str, _tmp_dir('plots'), None,
     'Where to store images generated by regression tests'),
    ('summary_base_dir', str, _tmp_dir('summary'), None,
     'Directory for final experiment results.'),
    ('results_csv_file', str, None, None,
     'The CSV file to save the results.'),
    ('sweep_checkpoint_dir', str, None, None,
     'Directory for resumable sweep checkpoints: a preempted sweep '
     'restarts from the last finished lambda block.'),
    ('sweep_lambda_block', int, 0, None,
     'Lambdas per checkpoint tile (0 = whole grid).'),
]


def build_parser() -> argparse.ArgumentParser:
    parser = decoding.build_parser()
    parser.prog = 'python -m telluride_decoding_torch.cli.regression'
    parser.description = ('Jackknife x regularization sweep over '
                          'TFRecord files.')
    decoding.add_flags(parser, _FLAGS)
    return parser


def main(argv: Optional[List[str]] = None) -> int:
    logging.basicConfig(level=logging.INFO)
    args = build_parser().parse_args(argv)
    my_flags = decoding.DecodingOptions().set_flags(args)
    test_obj = select_regression_object(args.test_name, my_flags,
                                        device=args.device)
    regularization_values = parse_regularization_values(
        args.regularization_list)
    test_obj.preset_flags()
    with profiling.trace(args.trace_dir,
                         cuda=device_policy.resolve(args.device).type ==
                         'cuda'):
        results = test_obj.jackknife_over_regularizations(
            my_flags, regularization_list=regularization_values,
            summary_base_dir=args.summary_base_dir,
            model_base_dir=args.model_base_dir,
            test_file=args.test_file,
            max_test_count=args.max_test_count,
            checkpoint_dir=args.sweep_checkpoint_dir,
            lambda_block=args.sweep_lambda_block,
            results_csv_file=args.results_csv_file)
    logging.info('Jackknife results are: %s', results)
    print('Jackknife results:', dict(results))
    print(test_obj.timer.report())
    return 0


if __name__ == '__main__':
    sys.exit(main())
