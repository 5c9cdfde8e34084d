"""End-to-end demo on the PyTorch port: simulate -> ingest -> train ->
sweep -> stream.

examples/full_pipeline.py's five steps, with its flags and seeds, through
``telluride_decoding_torch`` on a synthetic two-speaker subject in a
working directory (no downloads needed):

  1. simulate a TRF subject: EEG = speech envelope through random
     impulse responses, two speakers, attention switches;
  2. ingest trials to TFRecords through BrainExperiment;
  3. train a linear decoder + LDA stage with the decoding driver;
  4. cross-validate a lambda grid with the sweep engine (each file
     lag-stacked by the lag-stack kernel on the card);
  5. decide attention window by window with the state-space decoder (one
     launch of its window-update kernel for all window sizes).

    python examples/full_pipeline_torch.py [workdir] [--device cuda|cpu]

The device is ``cuda`` unless ``--device cpu`` is given; without a card
``cuda`` raises. ``main()`` takes the sizes as keyword arguments, so a
test or a smoke run can size the subject; the defaults are
examples/full_pipeline.py's.
"""

import argparse
import os
import sys
import tempfile

import numpy as np

try:
    import telluride_decoding_torch  # noqa: F401
except ModuleNotFoundError:
    # Running from a source checkout without installation.
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

FRAME_RATE = 100.0
NUM_CHANNELS = 8
IR_FRAMES = 25
LAMBDAS = np.logspace(-6, 1, 8)


def simulate_subject(rng, num_trials=4, frames=3000, channels=NUM_CHANNELS,
                     ir_frames=IR_FRAMES):
    """Per-trial two-speaker data with a mid-trial attention switch
    (examples/full_pipeline.py's, with the widths as arguments)."""
    t = np.arange(ir_frames) / FRAME_RATE
    irs = (np.random.RandomState(7).randn(channels, ir_frames) *
           (30 * t * np.exp(-30 * t))).astype(np.float32)

    def speech(n):
        raw = np.abs(rng.randn(n // 10 + 2))
        idx = np.linspace(0, raw.shape[0] - 1.001, n)
        low = idx.astype(int)
        frac = idx - low
        return ((1 - frac) * raw[low] +
                frac * raw[low + 1]).astype(np.float32)

    trials = []
    for k in range(num_trials):
        s1 = speech(frames)
        s2 = speech(frames)
        labels = np.zeros((frames, 1), np.float32)
        if k == num_trials - 1:          # Test trial: switch halfway.
            labels[frames // 2:] = 1.0
        attended = np.where(labels[:, 0] == 0, s1, s2)
        eeg = np.stack(
            [np.convolve(attended, irs[c], 'full')[:frames]
             for c in range(channels)], axis=1).astype(np.float32)
        eeg += 0.1 * rng.randn(*eeg.shape).astype(np.float32)
        trials.append((s1, s2, labels, eeg))
    return trials


def write_records(trials, records_dir):
    """Step 2: the trials through BrainExperiment to TFRecords; returns
    the files written."""
    from telluride_decoding_torch.io import (BrainExperiment,
                                             MemoryBrainDataFile)
    trial_dict = {}
    for k, (s1, s2, labels, eeg) in enumerate(trials):
        name = ('test_%02d' if k == len(trials) - 1 else
                'train_%02d') % k
        trial_dict[name] = [
            {'loudness': s1[:, None], 'loudness2': s2[:, None],
             'attend': labels},
            MemoryBrainDataFile({'eeg_data': eeg}, sr=FRAME_RATE)]
    exp = BrainExperiment(trial_dict, frame_rate=FRAME_RATE)
    exp.load_all_data()
    for trial in exp.iterate_trials():
        trial.assemble_brain_data('eeg_data')
    return exp.write_all_data(records_dir)


def decoding_flags(workdir, ir_frames=IR_FRAMES):
    """Step 3's flags: a linear decoder over ir_frames lags, lambda 1e-3,
    trained on the train trials and tested on the test trial."""
    from telluride_decoding_torch.cli import decoding
    return decoding.DecodingOptions().set_from_dict(dict(
        tfexample_dir=os.path.join(workdir, 'records'), input_field='eeg',
        output_field='loudness', attended_field='attend',
        frame_rate=FRAME_RATE, pre_context=0,
        post_context=ir_frames - 1,
        dnn_regressor='linear', regularization_lambda=1e-3,
        batch_size=200, shuffle_buffer_size=0,
        train_file_pattern='train', validate_file_pattern='test',
        test_file_pattern='test',
        summary_dir=os.path.join(workdir, 'summary'),
        saved_model_dir=os.path.join(workdir, 'model')))


def lambda_sweep(flags, workdir, ir_frames=IR_FRAMES, device='cuda',
                 lambdas=LAMBDAS):
    """Step 4: the jackknife over every trial for each lambda; returns
    {lambda: (mean, std)}, and writes the [lambda, file] grid to
    ``workdir/sweep.csv``."""
    from telluride_decoding_torch.cli import regression
    obj = regression.RegressionLinear(flags, device=device)
    obj.my_flags.post_context = ir_frames - 1
    obj.my_flags.output_field = 'loudness'
    return obj.jackknife_over_regularizations(
        flags, lambdas, summary_base_dir=os.path.join(workdir, 'sweep'),
        results_csv_file=os.path.join(workdir, 'sweep.csv'))


def main(workdir=None, *, channels=NUM_CHANNELS, ir_frames=IR_FRAMES,
         num_trials=4, frames=3000, window_list=(100, 200), device='cuda'):
    """Runs the five steps; returns what they printed and each step's
    seconds (``seconds``, synchronized with the card on ``cuda``)."""
    from telluride_decoding_torch import device as device_policy
    from telluride_decoding_torch.utils import timed_block
    device = device_policy.resolve(device)   # cuda without a card raises.
    sync = None
    if device.type == 'cuda':
        import torch
        sync = torch.cuda.synchronize
    workdir = workdir or tempfile.mkdtemp(prefix='tdt_torch_demo_')
    records_dir = os.path.join(workdir, 'records')
    model_dir = os.path.join(workdir, 'model')
    rng = np.random.RandomState(0)
    seconds = {}

    # -- 1+2: simulate and ingest ------------------------------------------
    with timed_block('simulate', seconds):
        trials = simulate_subject(rng, num_trials, frames, channels,
                                  ir_frames)
    with timed_block('ingest', seconds):
        files = write_records(trials, records_dir)
    print('ingested %d trials -> %s' % (len(files), records_dir))

    # -- 3: train via the decoding driver -----------------------------------
    from telluride_decoding_torch.cli import decoding
    flags = decoding_flags(workdir, ir_frames)
    with timed_block('decoding', seconds, sync=sync):
        _, test_results, dprime = decoding.run_decoding_experiment(
            flags, device=device)
    r = float(test_results['pearson_correlation_first'])
    print('decoder: r=%.3f  dprime=%.2f' % (r, dprime))

    # -- 4: lambda sweep in one program --------------------------------------
    with timed_block('sweep', seconds, sync=sync):
        results = lambda_sweep(flags, workdir, ir_frames, device)
    best = max(results.items(), key=lambda kv: kv[1][0])
    print('sweep: best lambda=%.2g (r=%.3f over %d-file jackknife)' %
          (best[0], best[1][0], len(files)))

    # -- 5: streaming attention decisions -------------------------------------
    from telluride_decoding_torch.cli import infer
    with timed_block('ssd', seconds, sync=sync):
        accuracy = infer.run_reduction_test(
            model_dir, records_dir, ['train'], ['test'],
            reduction='lda', decoder_type='ssd',
            audio_label_1='loudness', audio_label_2='loudness2',
            window_list=list(window_list), device=device)
    print('streaming attention accuracy (ssd): %s' % accuracy)
    print('artifacts in %s' % workdir)
    return dict(workdir=workdir, records=sorted(files), r=r,
                dprime=float(dprime), sweep=results,
                sweep_csv=os.path.join(workdir, 'sweep.csv'),
                best_lambda=float(best[0]), accuracy=accuracy,
                seconds=seconds)


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('workdir', nargs='?', default=None,
                        help='Where to write the records, model and '
                        'summaries (default: a new temporary directory).')
    parser.add_argument('--device', default='cuda', choices=('cuda', 'cpu'),
                        help='cuda (default; raises without a card) or '
                        'cpu.')
    return parser.parse_args(argv)


if __name__ == '__main__':
    args = parse_args()
    main(args.workdir, device=args.device)
