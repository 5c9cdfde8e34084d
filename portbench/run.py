"""Runs one cell of the benchmark of telluride_decoding_torch once.

  python3 portbench/run.py --workload codelab_cca.serve_wta --seed 7 \\
      --seconds 10 --trace 0

from the root of a checkout. BENCHMARK.json names the cell's
configuration (portbench/configs/<config>.json) and traffic mix
(portbench/traffic/<mix>.json); the mix's ``kind`` names the driver
(portbench/harness/<kind>.py), portbench/limits/<cell>.json the limits
of the numbers that decide ``correct``, and each per-layer metric its
reader (portbench/metrics/<metric>.py). With ``--trace 0`` the result
carries the cell's end-to-end metrics, with ``--trace 1`` its per-layer
metrics read from a torch.profiler trace of the window and the
benchmark's spans.

The last line of standard output is the result, one JSON object; the
last lines of standard error are the numbers compared, each beside its
limit. Without a CUDA card, or with fewer than the cell asks for, or if
JAX or the JAX package was loaded, the run exits non-zero and prints no
result.
"""

import time

PROCESS_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Kernel and compiler caches at fixed paths inside the checkout, so that
# only a checkout's first run builds.
CACHES = {'TRITON_CACHE_DIR': os.path.join(ROOT, 'build', 'triton'),
          'TORCH_EXTENSIONS_DIR': os.path.join(ROOT, 'build',
                                               'torch_extensions')}
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'telluride_decoding_tpu')


def forbidden_modules():
    """Loaded modules whose top-level name, compared whole, is JAX's, its
    libraries' or the JAX package's."""
    return sorted({name.split('.')[0] for name in list(sys.modules)} &
                  set(FORBIDDEN))


def applies(metric: dict, workload: str) -> bool:
    return 'workloads' not in metric or workload in metric['workloads']


def read_metric(name: str, readings: dict):
    """The per-layer metric's reader, portbench/metrics/<name>.py, on the
    run's readings: a number, or None where it finds nothing to read."""
    path = os.path.join(ROOT, 'portbench', 'metrics', name + '.py')
    spec = importlib.util.spec_from_file_location(
        'portbench_metric_' + name.replace('.', '_'), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read(readings)


def cell(bench: dict, workload: str):
    """(cell entry, configuration, traffic mix, limits) of a workload."""
    from portbench.harness import common
    entry = next((w for w in bench['workloads'] if w['name'] == workload),
                 None)
    if entry is None:
        raise SystemExit('unknown workload %r' % workload)
    config = next(c for c in bench['configs'] if c['name'] == entry['config'])
    with open(os.path.join(ROOT, config['file'])) as f:
        cfg = json.load(f)
    mix = common.load_json('traffic', entry['traffic'] + '.json')
    limits = common.load_json('limits', workload + '.json')
    return entry, cfg, mix, limits


def execute(bench: dict, workload: str, seed: int, seconds: float,
            traced: bool, device, process_start: float, cfg=None,
            mix=None, limits=None):
    """Runs the cell on ``device``; returns (result without ``device``,
    outcome). ``cfg``, ``mix`` and ``limits`` replace the cell's own (the
    tests run cells at small sizes on the CPU)."""
    entry, cell_cfg, cell_mix, cell_limits = cell(bench, workload)
    cfg, mix = cfg or cell_cfg, mix or cell_mix
    limits = limits or cell_limits
    kind = importlib.import_module('portbench.harness.' + mix['kind'])
    outcome = kind.run(cfg, mix, limits, seed, seconds, traced, device,
                       process_start)
    metrics = {}
    if traced:
        for metric in bench['per_layer']:
            if applies(metric, workload):
                value = read_metric(metric['name'], outcome.readings)
                if value is not None:
                    metrics[metric['name']] = {'value': value,
                                               'unit': metric['unit']}
    else:
        for metric in bench['end_to_end']:
            if applies(metric, workload):
                metrics[metric['name']] = {
                    'value': outcome.end_to_end[metric['name']],
                    'unit': metric['unit']}
    result = {'correct': all(c.ok for c in outcome.checks),
              'attempted': outcome.attempted, 'failed': outcome.failed,
              'metrics': metrics}
    return result, outcome


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--workload', required=True)
    parser.add_argument('--seed', type=int, required=True)
    parser.add_argument('--seconds', type=float, required=True)
    parser.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    for key, path in CACHES.items():
        os.environ[key] = path
    # One process with few threads: the serving loop and the engine's
    # host work are single-threaded, and idle pools only add noise.
    for key in ('OMP_NUM_THREADS', 'MKL_NUM_THREADS', 'OPENBLAS_NUM_THREADS'):
        os.environ[key] = '1'
    sys.path.insert(0, ROOT)
    with open(os.path.join(ROOT, 'BENCHMARK.json')) as f:
        bench = json.load(f)
    entry = next((w for w in bench['workloads']
                  if w['name'] == args.workload), None)
    if entry is None:
        print('unknown workload %r' % args.workload, file=sys.stderr)
        return 2
    import torch
    if (not torch.cuda.is_available() or
            torch.cuda.device_count() < entry['chips']):
        print('this cell needs %d CUDA device(s); found %s'
              % (entry['chips'], torch.cuda.device_count()
                 if torch.cuda.is_available() else 'none'), file=sys.stderr)
        return 2
    device = torch.device('cuda', 0)
    torch.zeros(1, device=device)      # The CUDA context, as its own stage.
    context_s = time.perf_counter() - PROCESS_START
    result, outcome = execute(bench, args.workload, args.seed, args.seconds,
                              bool(args.trace), device, PROCESS_START)
    device_info = {'platform': 'gpu',
                   'kind': torch.cuda.get_device_name(0),
                   'count': entry['chips'],
                   'memory_peak_bytes': outcome.memory_peak_bytes}
    if outcome.trace is not None:
        device_info['busy_s'] = outcome.trace['busy_s']
        device_info['window_s'] = outcome.trace['window_s']
    result['device'] = device_info
    if outcome.trace is not None:
        result['breakdown'] = {key: outcome.trace[key]
                               for key in ('device_ops', 'idle_gaps')}
    # A number that is not finite fails its check; JSON has no NaN.
    result['checks'] = {c.name: {'value': c.value if math.isfinite(c.value)
                                 else None, 'limit': c.limit}
                        for c in outcome.checks}
    found = forbidden_modules()
    if found:
        print('loaded in this process, and refused: %s' % ', '.join(found),
              file=sys.stderr)
        return 3
    print('set-up, seconds from the start: torch and CUDA context %.2f, %s'
          % (context_s, ', '.join(
              '%s %.2f' % kv
              for kv in outcome.readings['setup_stages_s'].items())),
          file=sys.stderr)
    print('reference: %.2f s after the window'
          % outcome.readings.get('reference_s', float('nan')),
          file=sys.stderr)
    for c in outcome.checks:
        print('check %s: %r (limit %r) %s' % (c.name, c.value, c.limit,
                                             'ok' if c.ok else 'FAILED'),
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == '__main__':
    sys.exit(main())
