"""Attention-switch evaluation over window sizes (port of cli/infer.py).

  python -m telluride_decoding_torch.cli.infer --tf_dir D --model_dir M \\
      --train_files train --test_files test --audio_label intensity \\
      [--comparison_test] [--device cpu]

A saved model decodes the test split once per speaker (``audio_label``
and ``audio_label`` + "2"): ``frame_scores`` is one launch of kernel K1
over every frame of the split, as windows of one frame. The scores are
then averaged over windows of each size in WINDOW_LIST (50% overlap), a
decision rule (``wta``, ``stepped`` or ``ssd``, the last one launch of
kernel S1 a window on the card) turns each window pair into a decision,
and XOR against the embedded attention labels gives each size's
accuracy. ``--comparison_test`` sweeps the reductions ``first`` and
``lda`` against the three rules.

The flags are the JAX driver's, with its names, defaults and absl
spellings, plus ``--device`` (``cuda`` by default, ``cpu`` for the plain
versions of the kernels).
"""

from __future__ import annotations

import argparse
import collections
import numbers
import os
import sys
from typing import Dict, List, Optional, Tuple

import numpy as np

from telluride_decoding_torch.cli.decoding import add_flags
from telluride_decoding_torch.data import brain_data
from telluride_decoding_torch.decide import attention_decoder
from telluride_decoding_torch.decode import infer_decoder

allowable_decoder_types = ['wta', 'stepped', 'ssd']

WINDOW_LIST = [10, 100, 200, 400, 700, 1000]

_FLAGS = [
    ('tf_dir', str, None, None, 'Location of the data for evaluation.'),
    ('model_dir', str, None, None, 'Location of the saved BrainModel'),
    ('plot_dir', str, None, None, 'Where to store result plots'),
    ('save_results_csv', str, None, None, 'Path to results csv file'),
    ('window_width', int, 1000, None,
     'Frames of data per correlation estimate.'),
    ('window_step', int, 500, None, 'Frames to step the correlation window.'),
    ('window_overlap', float, 0.5, None,
     'Factor of window width for overlapping windows.'),
    ('frame_rate', float, 100, None, 'EEG and audio frame rates in Hz.'),
    ('reduction', str, 'lda',
     ['first', 'second', 'lda', 'mean', 'mean-squared', 'all'],
     'How to reduce decoder dimensionality to a scalar.'),
    ('decoder', str, 'wta', allowable_decoder_types,
     'How to summarize multiple correlation windows.'),
    ('window_test', bool, False, None,
     'Run a test with different window sizes'),
    ('comparison_test', bool, False, None,
     'Run a test with all decoders and infers'),
    ('audio_label', str, 'loudness', None,
     'TFRecord field containing the audio signal. The second speaker is '
     'this label with 2 appended.'),
]


def create_brain_data(tf_dir: str, train_files, test_files, params: Dict,
                      audio_label: str, *, device) -> brain_data.BrainData:
    """Two-speaker dataset builder (reference infer.py:109-170); shuffle
    is off so test windows stay in temporal order."""
    if isinstance(train_files, str):
        train_files = [train_files]
    if isinstance(test_files, str):
        test_files = [test_files]
    attended = params.get('attended_field', 'attend') or 'attend'
    return brain_data.TFExampleData(
        params['input_field'],
        audio_label,
        100,
        pre_context=params['pre_context'],
        post_context=params['post_context'],
        in2_fields=audio_label,
        in2_pre_context=params['input2_pre_context'],
        in2_post_context=params['input2_post_context'],
        attended_field=attended,
        final_batch_size=200,
        repeat_count=1,
        shuffle_buffer_size=0,
        data_dir=tf_dir,
        data_pattern='',
        train_file_pattern='|'.join(train_files),
        validate_file_pattern='',
        test_file_pattern='|'.join(test_files),
        device=device)


def calculate_time_axis(data, window_step: int, window_width: int,
                        frame_rate: float) -> np.ndarray:
    """Window-center times in minutes for a windowed signal."""
    if isinstance(data, numbers.Number):
        num_points = int(data)
    elif isinstance(data, list):
        num_points = len(data)
    elif isinstance(data, np.ndarray):
        num_points = data.shape[0]
    else:
        raise TypeError('Unknown type passed as input argument.')
    return ((np.arange(num_points) * window_step + window_width / 2.0) /
            frame_rate / 60.0)


def get_data_for_model(tf_dir: str, train_files, test_files,
                       model_object: infer_decoder.Decoder,
                       audio_label_1: str, audio_label_2: str,
                       include_train: bool = True):
    """Train and test datasets for both speakers, checked against the
    model, on the decoder's device. include_train=False skips the
    training corpora, which a trained decoder never reads."""
    params = model_object.decoding_model_params
    device = model_object.device
    brain_data_1 = create_brain_data(tf_dir, train_files, test_files,
                                     params, audio_label_1, device=device)
    brain_data_2 = create_brain_data(tf_dir, train_files, test_files,
                                     params, audio_label_2, device=device)
    bd1_test = brain_data_1.create_dataset(mode='program_test')
    bd2_test = brain_data_2.create_dataset(mode='program_test')
    model_object.check_model_and_data(bd1_test)
    model_object.check_model_and_data(bd2_test)
    bd1_train = bd2_train = None
    if include_train:
        bd1_train = brain_data_1.create_dataset(mode='train')
        bd2_train = brain_data_2.create_dataset(mode='train')
        model_object.check_model_and_data(bd1_train)
        model_object.check_model_and_data(bd2_train)
    return bd1_train, bd1_test, bd2_train, bd2_test


def regress_and_correlate(model_object: infer_decoder.Decoder, test_data,
                          window_size: int
                          ) -> Tuple[List[float], List[float]]:
    """Mean decoder score and mean label per analysis window."""
    scores, labels = model_object.test_by_window_means(test_data,
                                                       window_size)
    return [float(s) for s in scores], [float(l) for l in labels]


def load_model(model_dir: str, reducer: str,
               device='cuda') -> infer_decoder.Decoder:
    """Loads the saved model and decoder parameters of a model directory
    (written by either package)."""
    model_object = infer_decoder.create_decoder(model_dir, reduction=reducer,
                                                device=device)
    model_object.load_decoding_model(model_dir)
    decoder_param_filename = os.path.join(model_dir, 'decoder_model.json')
    if not os.path.exists(decoder_param_filename):
        raise IOError('Can not load decoder model parameters from %s' %
                      decoder_param_filename)
    model_object.restore_parameters(decoder_param_filename)
    return model_object


def find_first_segment(labels) -> int:
    """Frame count of the initial constant-attention segment."""
    if isinstance(labels, list):
        labels = np.asarray(labels)
    if not isinstance(labels, np.ndarray):
        raise TypeError('Labels input must be an ndarray, not %s' %
                        type(labels))
    if labels.ndim != 1:
        raise TypeError('Labels input must be one-dimensional, not %s' %
                        str(labels.shape))
    end_section = np.nonzero(np.logical_xor(labels, labels[0]))
    if end_section[0].shape[0]:
        return int(end_section[0][0])
    return 0


def _pyplot():
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    return plt


def run_reduction_test(model_dir: str, tf_dir: str, train_files,
                       test_files, reduction: str, decoder_type: str,
                       audio_label_1: str, audio_label_2: str,
                       plot_dir: Optional[str] = None,
                       frame_rate: float = 100.0,
                       window_list: Optional[List[int]] = None,
                       save_results_csv: Optional[str] = None, *,
                       device='cuda') -> Dict[int, float]:
    """One window-size sweep for a (reduction, decoder) pair; returns
    {window size: fraction of windows decided right}."""
    model_object = load_model(model_dir, reduction, device)
    needs_train = not model_object.correlation_params.count
    bd1_train, bd1_test, bd2_train, bd2_test = get_data_for_model(
        tf_dir, train_files, test_files, model_object,
        audio_label_1, audio_label_2, include_train=needs_train)
    if needs_train:
        model_object.train(bd1_train, bd2_train)

    # Frame scores do not depend on the window size: decode each
    # speaker's split once (one K1 launch each) and window the result.
    s1, l1 = model_object.frame_scores(bd1_test)
    s2, l2 = model_object.frame_scores(bd2_test)
    window_list = window_list or WINDOW_LIST
    d1_sizes, d2_sizes, label_sizes, decoders = [], [], [], []
    for window_size in window_list:
        d1_arr, _ = infer_decoder.Decoder.window_means(s1, l1, window_size)
        d2_arr, lab_arr = infer_decoder.Decoder.window_means(s2, l2,
                                                             window_size)
        d1_results = [float(v) for v in d1_arr]
        d2_results = [float(v) for v in d2_arr]
        labels = [float(v) for v in lab_arr]
        decoder = attention_decoder.create_attention_decoder(
            decoder_type, window_step=window_size // 2,
            frame_rate=frame_rate, device=device)
        end_first_section = find_first_segment(np.asarray(labels))
        if end_first_section:
            decoder.tune(d1_results[:end_first_section],
                         d2_results[:end_first_section])
        d1_sizes.append(d1_results)
        d2_sizes.append(d2_results)
        label_sizes.append(labels)
        decoders.append(decoder)
    # Every size's windows are known: the decision rule takes them all at
    # once (the state-space decoder in one launch of S1).
    decisions = type(decoders[0]).attention_sequences(decoders, d1_sizes,
                                                      d2_sizes)
    window_results = []
    for window_size, d1_results, d2_results, labels, decided in zip(
            window_list, d1_sizes, d2_sizes, label_sizes, decisions):
        window_step = window_size // 2
        attention = np.array(decided, dtype=np.float64)
        labels_col = np.reshape(np.asarray(labels), (-1, 1))
        correct = np.logical_xor(attention[:, 0:1] >= 0.5, labels_col)
        frac_correct = float(np.sum(correct)) / float(len(correct))
        window_results.append(frac_correct)

        if plot_dir:
            plt = _pyplot()
            os.makedirs(plot_dir, exist_ok=True)
            d1 = np.reshape(np.asarray(d1_results), (-1,))
            d2 = np.reshape(np.asarray(d2_results), (-1,))
            t = calculate_time_axis(d1, window_step, window_size,
                                    frame_rate)
            plt.clf()
            attention_decoder.plot_aad_results(d1, t=t, linecolor='blue')
            attention_decoder.plot_aad_results(d2, t=t, linecolor='red')
            scale = max(float(np.max(d1)), float(np.max(d2)))
            attention_decoder.plot_aad_results(
                attention[:, 0] * scale / 2.0, t=t,
                attention_flag=np.reshape(labels_col, (-1,)),
                linecolor='green',
                title='AAD Correlation %gs windows %g%% accuracy.' %
                (window_size / frame_rate, frac_correct * 100.0))
            plt.savefig(os.path.join(
                plot_dir, 'test_results_%s_%s_%05d.png' %
                (reduction, decoder_type, window_size)))

    print('Infer classification result with %s and %s: %s' %
          (reduction, decoder_type, window_results))
    if save_results_csv:
        with open(save_results_csv, 'w') as f:
            f.write('Window size,Accuracy\n')
            for wl, wr in zip(window_list, window_results):
                f.write('{},{}\n'.format(wl, wr))
    if plot_dir:
        plt = _pyplot()
        plt.clf()
        plt.semilogx(window_list, window_results)
        plt.xlabel('Window Size (frames)')
        plt.ylabel('Fraction correct')
        plt.title('Reducing with %s, decoding with %s' %
                  (reduction, decoder_type))
        plt.savefig(os.path.join(plot_dir, 'test_results_%s_%s.png' %
                                 (reduction, decoder_type)))
    return dict(zip(window_list, window_results))


def run_comparison_test(model_dir: str, tf_dir: str, train_files,
                        test_files, audio_label: str, audio_label_2: str,
                        plot_dir: Optional[str],
                        reduction_list: List[str],
                        decoder_list: Optional[List[str]] = None,
                        window_list: Optional[List[int]] = None,
                        frame_rate: float = 100.0, *,
                        device='cuda') -> Dict:
    """Sweeps (reduction x decoder) pairs through run_reduction_test."""
    all_results = collections.OrderedDict()
    for reduction in reduction_list:
        for decoder in decoder_list or allowable_decoder_types:
            all_results[(reduction, decoder)] = run_reduction_test(
                model_dir, tf_dir, train_files, test_files, reduction,
                decoder, audio_label, audio_label_2, plot_dir,
                frame_rate=frame_rate, window_list=window_list,
                device=device)
    if plot_dir:
        plt = _pyplot()
        plt.clf()
        for reduction_decoder, results in all_results.items():
            style = '-' if reduction_decoder[0] == 'lda' else '--'
            sizes = sorted(results.keys())
            plt.semilogx(sizes, [results[s] for s in sizes], style,
                         label='%s %s' % reduction_decoder)
        plt.xlabel('Window Size (frames)')
        plt.ylabel('Fraction correct')
        plt.legend()
        plt.savefig(os.path.join(plot_dir, 'test_results-comparison.png'))
    return all_results


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog='python -m telluride_decoding_torch.cli.infer',
        description='Attention-switch accuracy over window sizes.',
        allow_abbrev=False)
    add_flags(parser, _FLAGS)
    parser.add_argument('--train_files', action='append', default=None,
                        help='Training files for the decoding test '
                        '(repeatable).')
    parser.add_argument('--test_files', action='append', default=None,
                        help='Testing files for performance evaluation '
                        '(repeatable).')
    parser.add_argument('--device', default='cuda',
                        help='torch device to run on (cuda, or cpu for the '
                        'plain versions of the kernels).')
    return parser


def main(argv: Optional[List[str]] = None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.tf_dir and not os.path.exists(args.tf_dir):
        parser.error('Can not find tf_dir: %s' % args.tf_dir)
    if not args.model_dir or not os.path.exists(args.model_dir):
        parser.error('Can not find model_dir: %s' % args.model_dir)
    train_files = args.train_files or []
    test_files = args.test_files or []
    if args.comparison_test:
        run_comparison_test(args.model_dir, args.tf_dir, train_files,
                            test_files, args.audio_label,
                            args.audio_label + '2', args.plot_dir,
                            reduction_list=['first', 'lda'],
                            frame_rate=args.frame_rate, device=args.device)
    else:
        run_reduction_test(args.model_dir, args.tf_dir, train_files,
                           test_files, args.reduction, args.decoder,
                           args.audio_label, args.audio_label + '2',
                           args.plot_dir, frame_rate=args.frame_rate,
                           save_results_csv=args.save_results_csv,
                           device=args.device)
    return 0


if __name__ == '__main__':
    sys.exit(main())
