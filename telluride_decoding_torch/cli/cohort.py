"""Whole-cohort jackknife x lambda sweeps in one command (port of
cli/cohort.py).

  python -m telluride_decoding_torch.cli.cohort --cohort_dir D \\
      --input_field eeg --output_field intensity --post_context 36 \\
      --regularization_list 1e-6,1e-4,1e-2,1 --cohort_csv_file C \\
      [--device cpu]

``--cohort_dir`` holds one subdirectory of TFRecords per subject (what
``cli.regression_data`` writes for the multi-subject corpora);
``--subject_dir`` names subjects one by one instead. Every subject's
leave-one-trial-out x lambda grid runs through ``sweep.engine`` on the
card: raw channels go up once a subject and each trial is lag-stacked
there by kernel K2 inside the moments (``TDT_DEVICE_CONTEXT=0`` stacks
on the host). A prefetch thread reads subject k+1's TFRecords while
subject k's grid runs. The driver writes the JAX driver's cohort CSV
(lambda, mean, std over all held-out trials), the per-subject CSVs and
plot, and prints the same summary table.

The flags are the JAX driver's (the decoding and regression flags plus
the cohort's own), parsed by argparse in absl's forms, plus ``--device``
(``cuda`` by default). ``--num_partitions N --partition_index i`` runs
one of N independent processes; they join through part files
(``parallel.multihost``), which either package can read. Under a process
group (TDT_COORDINATOR, TDT_NUM_PROCESSES and TDT_PROCESS_ID, one process
a rank; ``multihost.initialize``), the partitions are the group's ranks:
each rank reads and sweeps only its own subjects on its device
(``cuda:{rank % cards}``), the join is one all_gather
(``multihost.allgather_summary``) and rank 0 writes the cohort CSV. The SGD
families (``fullyconnected``, ``classifier``, ``dcca``) have no
sufficient statistics: every (subject, lambda) cell runs the per-model
jackknife (``cli.regression.jackknife_one_model``), one training run per
held-out trial, with a lambda row trained once and tiled where the model
ignores lambda, and per-subject checkpoints in JAX's file format
(``--sweep_checkpoint_dir``).
"""

from __future__ import annotations

import dataclasses
import logging
import os
import queue
import sys
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

from telluride_decoding_torch import device as device_policy
from telluride_decoding_torch.cli import decoding, regression
from telluride_decoding_torch.data import records
from telluride_decoding_torch.parallel import mesh as mesh_lib
from telluride_decoding_torch.parallel import multihost
from telluride_decoding_torch.sweep import engine
from telluride_decoding_torch.utils import csv_util, profiling

SWEEP_KINDS = ('linear', 'linear_with_bias', 'cca')


def discover_subjects(cohort_dir: Optional[str],
                      subject_dirs: List[str]) -> Dict[str, str]:
    """{subject_name: tfrecord_dir} from either flag."""
    found = {}
    for d in subject_dirs:
        name = os.path.basename(os.path.normpath(d))
        if name in found and found[name] != d:
            # Keeping one of the two would compute the cohort statistics
            # over the wrong population.
            raise ValueError(
                'Two --subject_dir paths share the subject name %r '
                '(%s and %s); rename one directory.' %
                (name, found[name], d))
        found[name] = d
    if cohort_dir:
        for name in sorted(os.listdir(cohort_dir)):
            path = os.path.join(cohort_dir, name)
            if os.path.isdir(path):
                found.setdefault(name, path)
    if not found:
        raise ValueError('No subjects: pass --cohort_dir with per-'
                         'subject subdirectories or --subject_dir.')
    return found


def load_cohort(subjects: Dict[str, str], my_flags, device='cuda'
                ) -> Tuple[Dict[str, Tuple[list, list]],
                           Optional[engine.ContextSpec]]:
    """Loads every subject's per-trial (x, y) arrays.

    Returns ({subject: (xs, ys)}, context). By default the arrays are
    raw streams and ``context`` is the engine ContextSpec of the lag
    expansion on the device; with TDT_DEVICE_CONTEXT=0 they are lag
    stacked on the host and ``context`` is None. ``device`` runs the
    field filters of on-the-fly field specs.
    """
    use_raw = regression.device_context_enabled()
    cohort = {}
    for name, data_dir in subjects.items():
        name, arrays = _load_subject(name, data_dir, my_flags, use_raw,
                                     device)
        cohort[name] = arrays
    return cohort, (cohort_context(my_flags) if use_raw else None)


def _load_subject(name: str, data_dir: str, my_flags, use_raw: bool,
                  device='cuda'):
    """One subject's per-trial (x, y) numpy arrays (raw or host-stacked),
    read through the decoded-file cache without filling it: a cohort
    sweep touches every file once."""
    sub_flags = dataclasses.replace(my_flags, tfexample_dir=data_dir)
    bd = regression.get_brain_data_object(sub_flags, device)
    files = sorted(bd.all_files())
    helper = regression.Regression(sub_flags, device=device)
    if use_raw:
        xs, ys, _ = helper._per_file_raw(bd, files, cache=False)
    else:
        xs, ys = helper._per_file_arrays(bd, files, cache=False)
    logging.info('subject %s: %d trials from %s', name, len(files),
                 data_dir)
    return name, (xs, ys)


def cohort_context(my_flags) -> engine.ContextSpec:
    """The engine ContextSpec the raw loader implies, from flags alone
    (what Regression._per_file_raw derives for every subject)."""
    cca = my_flags.dnn_regressor == 'cca'
    return engine.ContextSpec(
        my_flags.pre_context, my_flags.post_context,
        my_flags.input2_pre_context if cca else 0,
        my_flags.input2_post_context if cca else 0)


def prescan_cohort(subjects: Dict[str, str], my_flags
                   ) -> Optional[Tuple[int, int]]:
    """The cohort's shared (pad_files_to, pad_frames_to) from TFRecord
    record counts alone, without decoding a feature.

    Every example is one frame of every field, so a file's common frame
    count is its record count. The regression and cohort loaders never
    apply input_offset (get_brain_data_object leaves it out, as the
    reference does), so neither does this, and the result equals what
    the eager loader derives: streaming and eager loading reach the
    sweep with the same pads. Returns None, and the caller loads
    eagerly, where counts cannot be trusted: an on-the-fly field spec
    may change stream lengths, and a corrupt file leaves its error to
    the real loader.
    """
    if not subjects:
        return None
    max_files = 0
    max_count = 0
    for data_dir in subjects.values():
        sub_flags = dataclasses.replace(my_flags, tfexample_dir=data_dir)
        bd = regression.get_brain_data_object(sub_flags, 'cpu')
        if (any(s is not None for s in (bd._in1_specs or []))
                or any(s is not None for s in (bd._in2_specs or []))
                or bd._out_spec is not None):
            return None
        files = bd.all_files()
        max_files = max(max_files, len(files))
        for f in files:
            count, error = records.count_tfrecords(f)
            if error:
                return None
            max_count = max(max_count, count)
    if max_files == 0 or max_count <= 0:
        return None
    return max_files, max_count


def iter_cohort(subjects: Dict[str, str], my_flags, prefetch: bool = True):
    """Yields (name, (xs, ys)) in ``subjects`` order, one subject at a
    time.

    A daemon thread reads subject k+1 (TFRecord decode and field
    selection, numpy only; it never touches the card, so field filters,
    if any, run on the CPU here) while the consumer sweeps subject k, so
    the host holds about two subjects instead of the whole cohort. A
    loader exception is raised again in the consumer.
    """
    use_raw = regression.device_context_enabled()
    items = list(subjects.items())
    if not prefetch:
        for name, data_dir in items:
            yield _load_subject(name, data_dir, my_flags, use_raw, 'cpu')
        return
    q: 'queue.Queue' = queue.Queue(maxsize=1)
    # Set when the consumer abandons the generator (a sweep exception,
    # an early close): the worker must not block in q.put holding a
    # subject's arrays for the life of the process.
    stop = threading.Event()

    def _put(payload) -> bool:
        while not stop.is_set():
            try:
                q.put(payload, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for name, data_dir in items:
                if not _put(('item', _load_subject(name, data_dir,
                                                   my_flags, use_raw,
                                                   'cpu'))):
                    return
            _put(('done', None))
        except BaseException as e:   # Raised again by the consumer.
            _put(('error', e))

    threading.Thread(target=worker, daemon=True,
                     name='tdt-cohort-prefetch').start()
    try:
        while True:
            kind, val = q.get()
            if kind == 'done':
                return
            if kind == 'error':
                raise val
            yield val
    finally:
        stop.set()


def general_cohort_results(my_flags, subjects: Dict[str, str],
                           regularization_list,
                           checkpoint_dir: Optional[str] = None,
                           device='cuda') -> Dict[str, engine.SweepResult]:
    """Whole-cohort jackknife of the SGD families (JAX cli/cohort.py:
    286-401): per (subject, lambda), ``regression.jackknife_one_model``
    leaves each of the subject's trials out in turn, a training run per
    trial.

    fullyconnected and classifier models never read the lambda and their
    training is seeded, so their lambda rows are the same numbers: one
    row is trained and tiled (``TDT_GENERAL_LAMBDA_DEDUP=0`` retrains
    every row). Not with mismatch batches, whose stream differs from one
    row to the next, and not for dcca, whose final CCA reads the lambda.

    With ``checkpoint_dir`` each finished subject's grid is published
    atomically as ``general_<subject>.npz`` (corr, lambdas, the trial
    files' basenames, the sweep's parameters), and a rerun restores a
    subject whose checkpoint matches instead of retraining it; one of
    other parameters, lambdas or trial files raises, naming what
    differed.
    """
    if my_flags.dnn_regressor == 'tf':
        raise ValueError(
            "tdt-cohort: --dnn_regressor tf is a flag-parity value "
            "with no buildable model (the reference's "
            "create_brain_model has no 'tf' branch either, reference "
            "decoding.py:279-308); use linear/cca or an SGD family "
            "(fullyconnected/classifier/dcca).")
    lambdas64 = np.asarray(regularization_list, np.float64)
    dedup = (my_flags.dnn_regressor in ('fullyconnected', 'classifier')
             and len(lambdas64) > 1 and not my_flags.mismatch_batch
             and os.environ.get('TDT_GENERAL_LAMBDA_DEDUP', '1').lower()
             not in ('0', 'off', 'false'))
    results = {}
    for name, data_dir in subjects.items():
        sub_flags = dataclasses.replace(my_flags, tfexample_dir=data_dir)
        sub_flags.train_file_pattern = (sub_flags.train_file_pattern
                                        or 'allbut')
        params = _sweep_key_params(sub_flags)
        ckpt = (os.path.join(checkpoint_dir, 'general_%s.npz' % name)
                if checkpoint_dir else None)
        bd = regression.get_brain_data_object(sub_flags, device)
        files = sorted(bd.all_files())
        if not files:
            raise ValueError('subject %s: no TFRecord files under %s'
                             % (name, data_dir))
        if ckpt and os.path.exists(ckpt):
            results[name] = _load_general_checkpoint(ckpt, lambdas64, params,
                                                     files)
            logging.info('subject %s: restored from %s', name, ckpt)
            continue
        corr = np.zeros((len(regularization_list), len(files)))
        train_rows = 1 if dedup else len(regularization_list)
        for i, lamb in enumerate(regularization_list[:train_rows]):
            sub_flags.regularization_lambda = float(lamb)
            sub_flags.validate_file_pattern = files[0]
            sub_flags.test_file_pattern = files[0]
            model = regression.get_brain_model(bd.create_dataset('test'),
                                               sub_flags, device)
            corr[i, :] = regression.jackknife_one_model(bd, model, None,
                                                        sub_flags)
        if dedup:
            corr[1:, :] = corr[0, :]
            logging.info(
                'subject %s: %s ignores regularization_lambda and '
                'training is seeded — trained one row, tiled %d lambda '
                'rows (TDT_GENERAL_LAMBDA_DEDUP=0 to force full '
                'retraining).', name, my_flags.dnn_regressor,
                len(regularization_list))
        results[name] = engine.SweepResult(corr, lambdas64, files)
        if ckpt:
            os.makedirs(checkpoint_dir, exist_ok=True)
            # Ends in .npz so np.savez keeps the name; os.replace
            # publishes it whole, so a killed run leaves no torn
            # checkpoint for the resume to trust.
            tmp = ckpt + '.tmp-%d.npz' % os.getpid()
            np.savez(tmp, corr=corr, lambdas=lambdas64,
                     files=np.asarray([os.path.basename(f) for f in files]),
                     params=np.asarray(params))
            os.replace(tmp, ckpt)
        logging.info('subject %s: general %s jackknife done (%d fits)',
                     name, my_flags.dnn_regressor, corr.size)
    return results


# DecodingOptions fields left out of the checkpoint key: output paths,
# the per-trial selections the jackknife overwrites, the lambda (the
# grid is kept on its own) and the subject's directory (the trial
# basenames pin the data), so a sweep resumed from another host restores.
_SWEEP_KEY_IGNORED = frozenset((
    'regularization_lambda', 'summary_dir', 'saved_model_dir',
    'tensorboard_dir', 'test_file_pattern', 'validate_file_pattern',
    'tfexample_dir', 'debug',
))


def _sweep_key_params(sub_flags) -> List[str]:
    """The 'key=value' strings that identify an SGD sweep's numbers."""
    return [kv for kv in sub_flags.experiment_parameters(delimiter=None)
            if kv.split('=', 1)[0] not in _SWEEP_KEY_IGNORED]


def _load_general_checkpoint(path: str, lambdas: np.ndarray,
                             params: List[str], files: List[str]
                             ) -> engine.SweepResult:
    """One subject's checkpoint of the general sweep (JAX
    cli/cohort.py:423-465), labelled with the subject's current trial
    paths ``files``; raises, naming what differed, for an older format,
    other trial files, another lambda grid or other parameters."""
    remedy = ('— remove the checkpoint or point --sweep_checkpoint_dir '
              'elsewhere.')
    with np.load(path, allow_pickle=False) as z:
        stored_params = [str(p) for p in np.atleast_1d(z['params'])]
        stored_lambdas = np.asarray(z['lambdas'], np.float64)
        stored_files = [str(f) for f in np.atleast_1d(z['files'])]
        if z['params'].ndim == 0 or any(os.sep in f for f in stored_files):
            raise ValueError(
                'checkpoint %s was written by an older checkpoint '
                'format (absolute trial paths / joined parameter '
                'string) and cannot be safely matched %s' % (path, remedy))
        basenames = [os.path.basename(f) for f in files]
        if stored_files != basenames:
            raise ValueError(
                'checkpoint %s was written over different trial files '
                '(stored %s vs present %s) %s'
                % (path, stored_files, basenames, remedy))
        if not np.array_equal(stored_lambdas, lambdas):
            raise ValueError(
                'checkpoint %s was written by a different sweep: '
                'lambda grid %s vs requested %s %s'
                % (path, stored_lambdas.tolist(), lambdas.tolist(), remedy))
        if stored_params != params:
            diff = sorted(set(stored_params) ^ set(params))
            raise ValueError(
                'checkpoint %s was written by a different sweep; '
                'mismatched parameters: %s %s'
                % (path, ', '.join(diff), remedy))
        return engine.SweepResult(np.asarray(z['corr']), lambdas,
                                  list(files))


def write_cohort_csv(path: str, lambdas, mean, std):
    os.makedirs(os.path.dirname(path) or '.', exist_ok=True)
    with open(path, 'w') as f:
        f.write('lambda,mean,std\n')
        for lamb, m, s in zip(lambdas, mean, std):
            f.write('%g,%g,%g\n' % (lamb, m, s))


def _plot_cohort(path: str, title: str, regularization_list, mean, std):
    from telluride_decoding_torch.utils import plot_util
    os.makedirs(os.path.dirname(path) or '.', exist_ok=True)
    plot_util.plot_mean_std(title,
                            np.asarray(regularization_list, np.float64),
                            mean, std, png_file_name=path)


def _sweep_cohort(my_flags, subjects: Dict[str, str], regularization_list,
                  subject_parallel: bool, streaming: Optional[bool],
                  device, mesh) -> Dict[str, engine.SweepResult]:
    """The sweep engine's grids of a cohort of a sweep family."""
    if streaming is None:
        streaming = os.environ.get('TDT_STREAMING_COHORT', '1').lower() \
            not in ('0', 'off', 'false')
    model = 'cca' if my_flags.dnn_regressor == 'cca' else 'ridge'
    common = dict(model=model, dims=my_flags.cca_dimensions,
                  subject_parallel=subject_parallel, device=device,
                  mesh=mesh)
    to_read = subjects
    if subject_parallel and mesh is not None and mesh.size > 1:
        # Subject j is rank j mod W's: each rank reads its own share.
        names = list(subjects)
        to_read = {name: subjects[name]
                   for name in names[mesh.rank::mesh.size]}
        common['cohort_names'] = names
    pads = prescan_cohort(to_read, my_flags) if streaming else None
    if pads is not None:
        use_raw = regression.device_context_enabled()
        return engine.multi_subject_sweep(
            iter_cohort(to_read, my_flags), regularization_list,
            context=cohort_context(my_flags) if use_raw else None,
            pad_files_to=pads[0], pad_frames_to=pads[1], **common)
    if streaming:
        logging.info('cohort prescan unavailable (field specs or '
                     'unreadable records); loading eagerly.')
    cohort, context = load_cohort(to_read, my_flags, device)
    return engine.multi_subject_sweep(cohort, regularization_list,
                                      context=context, **common)


def run_cohort_sweep(my_flags, subjects: Dict[str, str],
                     regularization_list,
                     subject_parallel: bool = True,
                     cohort_csv_file: Optional[str] = None,
                     cohort_plot_file: Optional[str] = None,
                     results_csv_file: Optional[str] = None,
                     streaming: Optional[bool] = None,
                     checkpoint_dir: Optional[str] = None,
                     device='cuda', mesh=None):
    """The whole cohort's sweep; returns ({subject: SweepResult},
    (mean, std) per lambda).

    The SGD families go through ``general_cohort_results``, resumable
    per subject from ``checkpoint_dir``; the sweep families ignore it, as
    in the JAX package. ``streaming`` (default on;
    ``--nostreaming_cohort`` or env TDT_STREAMING_COHORT=0 turn it off)
    feeds the sweep through the prefetching loader with the prescan's
    pads; results equal eager loading bit for bit. Without a usable
    prescan (field specs, unreadable records) it loads eagerly.
    ``mesh`` (engine.default_mesh('subject') under a process group; a
    collective call, every rank passing the whole cohort) shards the
    subject axis over the ranks with ``subject_parallel``, each rank
    reading only its own subjects, else each subject's file axis; every
    rank returns every subject. Without a mesh the subjects run in
    series on ``device``.
    """
    device = device_policy.resolve(device)
    if my_flags.dnn_regressor not in SWEEP_KINDS:
        # No sufficient statistics: a training run per grid cell.
        results = general_cohort_results(my_flags, subjects,
                                         regularization_list,
                                         checkpoint_dir=checkpoint_dir,
                                         device=device)
    else:
        results = _sweep_cohort(my_flags, subjects, regularization_list,
                                subject_parallel, streaming, device, mesh)
    mean, std = engine.cohort_summary(results)
    if results_csv_file:
        # Per-subject rows in the reference csv_util layout (lambda, then
        # one correlation per held-out trial).
        base, ext = os.path.splitext(results_csv_file)
        for name, res in results.items():
            csv_util.write_results('%s_%s%s' % (base, name, ext or '.csv'),
                                   list(res.lambdas), res.correlations)
    if cohort_csv_file:
        write_cohort_csv(cohort_csv_file,
                         np.asarray(regularization_list, np.float64),
                         mean, std)
    if cohort_plot_file:
        _plot_cohort(cohort_plot_file, 'cohort (%d subjects)' % len(results),
                     regularization_list, mean, std)
    return results, (mean, std)


def run_partitioned_cohort(my_flags, subjects: Dict[str, str],
                           regularization_list,
                           partition_index: int, num_partitions: int,
                           partition_dir: str,
                           subject_parallel: bool = True,
                           cohort_csv_file: Optional[str] = None,
                           cohort_plot_file: Optional[str] = None,
                           results_csv_file: Optional[str] = None,
                           partition_wait_s: float = 1200.0,
                           streaming: Optional[bool] = None,
                           checkpoint_dir: Optional[str] = None,
                           device='cuda'):
    """One partition's share of a multi-process cohort sweep.

    Runs this partition's subjects (round-robin by sorted name, so every
    process derives the same assignment with no coordination) and joins
    every partition's per-lambda sufficient statistics into the cohort
    summary (the single-process mean and std up to the order of float64
    sums): under a process group with one all_gather
    (``multihost.allgather_summary``), else through part files in
    ``partition_dir``, which partition 0 waits for. Returns ({local
    subject: SweepResult}, (mean, std) on partition 0, else None).
    """
    processes = multihost.process_count()
    if 1 < processes != num_partitions:
        # The collective join reduces over the process group; another
        # partition count would leave subject shards nobody computes (or
        # count some twice) while the gather still succeeds.
        raise ValueError(
            'num_partitions=%d but the torch.distributed group has %d '
            'processes; they must match.' % (num_partitions, processes))
    mine = multihost.partition_subjects(subjects, partition_index,
                                        num_partitions)
    if mine:
        results, _ = run_cohort_sweep(
            my_flags, mine, regularization_list,
            subject_parallel=subject_parallel,
            results_csv_file=results_csv_file, streaming=streaming,
            checkpoint_dir=checkpoint_dir, device=device)
    else:
        # More partitions than subjects: this one still joins, with
        # exact-zero statistics.
        results = {}
    if processes > 1:
        mean, std = multihost.allgather_summary(regularization_list,
                                                results)
        if partition_index != 0:
            return results, None
    else:
        multihost.write_part(partition_dir, partition_index,
                             regularization_list, results)
        if partition_index != 0:
            return results, None
        expected = {i: sorted(multihost.partition_subjects(subjects, i,
                                                           num_partitions))
                    for i in range(num_partitions)}
        mean, std, joined = multihost.join_parts(
            partition_dir, num_partitions, lambdas=regularization_list,
            timeout_s=partition_wait_s, expected_shards=expected)
        logging.info('joined %d partitions covering subjects: %s',
                     num_partitions, ', '.join(joined))
    if cohort_csv_file:
        write_cohort_csv(cohort_csv_file,
                         np.asarray(regularization_list, np.float64),
                         mean, std)
    if cohort_plot_file:
        _plot_cohort(cohort_plot_file,
                     'cohort (%d partitions)' % num_partitions,
                     regularization_list, mean, std)
    return results, (mean, std)


# (name, type, default, choices, help): the JAX driver's own flags
# (telluride_decoding_tpu/cli/cohort.py:51-92); --subject_dir repeats.
_FLAGS = [
    ('cohort_dir', str, None, None,
     'Directory with one subdirectory of TFRecord files per subject.'),
    ('cohort_csv_file', str, None, None,
     'Where to write the cohort summary CSV (lambda, mean, std over all '
     'held-out trials).'),
    ('cohort_plot_file', str, None, None,
     'Optional mean+/-std png of the cohort curve.'),
    ('subject_parallel', bool, True, None,
     'Shard the subject axis over the ranks of a process group (serial '
     'in one process).'),
    ('streaming_cohort', bool, True, None,
     'Load subjects through a prefetching streaming loader (about two '
     'subjects on the host; subject k+1 is read while subject k sweeps '
     'on the device). Loads the whole cohort eagerly when the shape '
     'prescan cannot run (on-the-fly field specs).'),
    ('num_partitions', int, 0, None,
     'Split the cohort over this many independent processes (0 = off; '
     'the group size under TDT_COORDINATOR). Each runs the subjects '
     'whose sorted rank %% num_partitions == partition_index; the '
     'partitions join through part files, or with one all_gather under '
     'a process group.'),
    ('partition_index', int, -1, None,
     "This process's shard (0-based; the rank under TDT_COORDINATOR)."),
    ('partition_dir', str, None, None,
     'Shared directory for partition part files (defaults to the '
     'cohort_csv_file directory).'),
    ('partition_wait_s', float, 1200.0, None,
     "How long partition 0 waits for the other partitions' part files "
     'before failing.'),
]


def build_parser():
    parser = regression.build_parser()
    parser.prog = 'python -m telluride_decoding_torch.cli.cohort'
    parser.description = ('Whole-cohort jackknife x regularization sweep '
                          'over per-subject TFRecord directories.')
    decoding.add_flags(parser, _FLAGS)
    parser.add_argument('--subject_dir', action='append', default=[],
                        help='Explicit per-subject TFRecord dirs '
                        '(alternative to --cohort_dir); repeat the flag.')
    # None marks a flag left untouched: the driver gives those meanings
    # of its own (linear; the TDT_STREAMING_COHORT environment knob).
    parser.set_defaults(dnn_regressor=None, streaming_cohort=None)
    return parser


def main(argv: Optional[List[str]] = None) -> int:
    logging.basicConfig(level=logging.INFO)
    args = build_parser().parse_args(argv)
    my_flags = decoding.DecodingOptions().set_flags(args)
    if args.dnn_regressor is None:
        # The decoding driver's default is fullyconnected; a cohort
        # sweep's natural family is deterministic, so an untouched flag
        # means linear, as in the JAX driver.
        my_flags.dnn_regressor = 'linear'
    subjects = discover_subjects(args.cohort_dir, args.subject_dir)
    regularization_list = regression.parse_regularization_values(
        args.regularization_list)
    # Env-driven (TDT_COORDINATOR); a no-op without it.
    multihost.initialize(device=args.device)
    processes = multihost.process_count()
    device = (mesh_lib.rank_device(args.device, multihost.process_index())
              if processes > 1 else args.device)
    on_card = device_policy.resolve(device).type == 'cuda'
    common = dict(subject_parallel=args.subject_parallel,
                  cohort_csv_file=args.cohort_csv_file,
                  cohort_plot_file=args.cohort_plot_file,
                  results_csv_file=args.results_csv_file,
                  streaming=args.streaming_cohort,
                  checkpoint_dir=args.sweep_checkpoint_dir,
                  device=device)
    num_partitions = args.num_partitions
    partition_index = args.partition_index
    if num_partitions <= 0 and processes > 1:
        num_partitions = processes
    if num_partitions > 1:
        if partition_index < 0:
            if processes > 1:
                partition_index = multihost.process_index()
            else:
                raise ValueError(
                    '--num_partitions needs --partition_index (or a '
                    'process group to derive it from).')
        partition_dir = args.partition_dir or os.path.dirname(
            args.cohort_csv_file or '') or '.'
        with profiling.trace(args.trace_dir, cuda=on_card):
            results, summary = run_partitioned_cohort(
                my_flags, subjects, regularization_list,
                partition_index=partition_index,
                num_partitions=num_partitions, partition_dir=partition_dir,
                partition_wait_s=args.partition_wait_s, **common)
        if summary is None:
            print('Partition %d/%d done: %d subjects swept.'
                  % (partition_index, num_partitions, len(results)))
            return 0
        mean, std = summary
        num_named = '%d partitions' % num_partitions
    else:
        with profiling.trace(args.trace_dir, cuda=on_card):
            results, (mean, std) = run_cohort_sweep(
                my_flags, subjects, regularization_list, **common)
        num_named = '%d subjects' % len(results)
    best = int(np.argmax(mean))
    print('Cohort sweep over %s, %d lambdas:' % (num_named, len(mean)))
    for lamb, m, s in zip(regularization_list, mean, std):
        marker = '  <-- best' if float(
            np.asarray(regularization_list)[best]) == float(lamb) else ''
        print('  lambda %10.4g  r = %.4f +/- %.4f%s' %
              (float(lamb), float(m), float(s), marker))
    return 0


def app_main():
    sys.exit(main())


if __name__ == '__main__':
    app_main()
