"""The control of VLAAI's serving cell: the plain reference
(reference/vlaai.py) put in the program's place and computed one
precision below the configuration's (float32 with every product in
TF32, every convolution's included), held to the float64 reference by
the cell's own numbers. A sound limit lets the program pass and this
control fail.

  python3 portbench/control_vlaai.py --workload kuleuven_vlaai.serve_wta \\
      --seeds 11,12,13 --frames 5000000

runs on a card at the cell's own size (``--frames``: as many frames
scored as a run of the cell scores) and prints one JSON line a seed: the
numbers, their limits and whether the control passed. Benchmark runs do
not run it.
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def control(workload, seed, frames, device, cfg=None, mix=None,
            limits=None):
    """(numbers, limits) of the control of ``workload`` on one seed."""
    from portbench import run
    from portbench.harness import serve_vlaai
    with open(os.path.join(ROOT, 'BENCHMARK.json')) as f:
        bench = json.load(f)
    _, cell_cfg, cell_mix, cell_limits = run.cell(bench, workload)
    cfg, mix = cfg or cell_cfg, mix or cell_mix
    limits = limits or cell_limits
    return serve_vlaai.control(cfg, mix, limits, seed, frames,
                               device), limits


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--workload', required=True)
    parser.add_argument('--seeds', required=True)
    parser.add_argument('--frames', type=int, required=True)
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
