"""Runs chip_smoke.py's phase 3 (K1) and phase 11 (the attention path,
after phase 4, whose model and stream it serves) of several checkouts
on one card, one process each, in the order given, and prints their
timing lines and a JSON summary.

Give the same checkouts twice in mirrored order (parent, change, change,
parent) to tell a change from drift between runs:

  python3 tools/phase_ab.py build/parent . . build/parent

Each checkout builds its own kernels unless its ``build/`` already holds
the library for the same sources.
"""

import json
import re
import subprocess
import sys

SCRIPT = '''
import torch, chip_smoke as c
from telluride_decoding_torch.device import cuda_device
device = cuda_device(0)
smi, _ = c.phase_device(torch)
c.phase_decode(torch, device)
c.phase_slice(torch, device, smi)
c.phase_attention(torch, device, smi)
'''
LINES = {
    'k1_serving_ms': (r'^phase 3 fused_cca_decode float32 pair codelab_32: '
                      r'call ([0-9.]+) ms'),
    'k1_serving_device_ms': (r'^phase 3 fused_cca_decode float32 pair '
                             r'codelab_32: .* on the device ([0-9.]+) ms'),
    'k1_serving_plain_ms': (r'^phase 3 fused_cca_decode float32 pair '
                            r'codelab_32: .* plain ([0-9.]+) ms'),
    'phase11_s': r'^phase 11: ([0-9.]+) s in all',
    'ssd_window_device_ms': (r'^phase 11 ssd_update .* on the device '
                             r'([0-9.]+) ms'),
    'lda_wta_s': r'^phase 11 infer lda \+ wta on the card: ([0-9.]+) s',
}


def run(checkout):
    proc = subprocess.run([sys.executable, '-c', SCRIPT], cwd=checkout,
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    lines = proc.stdout.splitlines()
    picked = {'checkout': checkout, 'rc': proc.returncode}
    for key, pattern in LINES.items():
        for line in lines:
            found = re.search(pattern, line)
            if found:
                picked[key] = float(found.group(1))
                print(line)
                break
    if proc.returncode:
        print('\n'.join(lines[-30:]))
    return picked


def main(checkouts):
    results = [run(checkout) for checkout in checkouts]
    print(json.dumps(results))
    return max(r['rc'] for r in results)


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
