"""The control of a cell: the plain reference put in the program's place
and computed one precision below the configuration's (float32 with TF32
products, against the configuration's float32 with TF32 off), held to
the float64 reference by the cell's own numbers. A sound limit lets the
program pass and this control fail.

  python3 portbench/control.py --workload codelab_cca.serve_wta \\
      --seeds 11,12,13 --frames 770000

runs on a card at the cell's own size (serving: ``--frames`` as many
frames scored as a run of the cell scores) and prints one JSON line a
seed: the numbers, their limits and whether the control passed.
Benchmark runs do not run it.
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def serve_control(cfg, mix, limits, seed, frames, device):
    from portbench.harness import gen, serve
    from portbench.reference import ssd as ref_ssd
    weights = gen.decoder_weights(cfg, seed, device)
    session = gen.serve_session(cfg, mix, seed, device)
    ref1, ref2 = serve.reference_means(session, weights, cfg, mix, frames,
                                       device)
    c1, c2 = serve.reference_means(session, weights, cfg, mix, frames,
                                   device, precision='tf32')
    if mix['decision'] == 'ssd':
        decisions = ref_ssd.sequence(c1, c2, min(mix['ssd_start_windows'],
                                                 len(c1)))
    else:
        decisions = (c1 > c2)[:, None].astype(float)
    return serve.compare(mix, limits, ref1, ref2, c1, c2, decisions)


def sweep_control(cfg, mix, limits, seed, device):
    from portbench.harness import gen, sweep
    from portbench.reference import sweep as ref_sweep
    subjects = [gen.sweep_subject(cfg, mix, seed, s, device)
                for s in range(mix['subjects'])]
    want = sweep.reference_grids(subjects, mix, device)
    got = sweep.reference_grids(subjects, mix, device, precision='tf32')
    xs, ys, lags = subjects[0]
    return sweep.compare(
        list(enumerate(got)), want,
        ref_sweep.file_moments(xs[0], ys[0], mix['frames'], lags, device,
                               precision='tf32'),
        ref_sweep.file_moments(xs[0], ys[0], mix['frames'], lags, device))


def control(workload, seed, frames, device, cfg=None, mix=None,
            limits=None):
    """(numbers, limits) of the control of ``workload`` on one seed."""
    from portbench import run
    with open(os.path.join(ROOT, 'BENCHMARK.json')) as f:
        bench = json.load(f)
    _, cell_cfg, cell_mix, cell_limits = run.cell(bench, workload)
    cfg, mix = cfg or cell_cfg, mix or cell_mix
    limits = limits or cell_limits
    if mix['kind'] == 'serve':
        values = serve_control(cfg, mix, limits, seed, frames, device)
    else:
        values = sweep_control(cfg, mix, limits, seed, device)
    return values, limits


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--workload', required=True)
    parser.add_argument('--seeds', required=True)
    parser.add_argument('--frames', type=int, default=0)
    args = parser.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available():
        print('the control runs on a CUDA card', file=sys.stderr)
        return 2
    device = torch.device('cuda', 0)
    for seed in (int(s) for s in args.seeds.split(',')):
        values, limits = control(args.workload, seed, args.frames, device)
        print(json.dumps({'workload': args.workload, 'seed': seed,
                          'values': values,
                          'limits': {k: limits[k] for k in values},
                          'passed': all(values[k] <= limits[k]
                                        for k in values)}))
        sys.stdout.flush()
    return 0


if __name__ == '__main__':
    sys.exit(main())
