"""Converts a reference TensorFlow SavedModel directory to the native
format (port of telluride_decoding_tpu/cli/migrate_saved_model.py).

The reference's trained artifact is a Keras SavedModel (reference
decoding.py:571-576). This tool reads it without TensorFlow
(io/tf_checkpoint.py: snappy, SSTable and TensorBundle parsed here),
builds the model on ``--device`` (default cuda; cpu on request) and
writes model.json + weights.npz, keeping the embedded telluride
metadata; a decoder_model.json beside the source is copied through
unchanged.

Usage:
  python -m telluride_decoding_torch.cli.migrate_saved_model \\
      [--device cuda|cpu] SRC_DIR DST_DIR
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
from typing import List, Tuple


def pop_device(argv: List[str]) -> Tuple[str, List[str]]:
    """(the ``--device`` value, default cuda; the other arguments)."""
    parser = argparse.ArgumentParser(add_help=False, allow_abbrev=False)
    parser.add_argument('--device', default='cuda')
    args, rest = parser.parse_known_args(argv)
    return args.device, rest


def migrate(src_dir: str, dst_dir: str, device='cuda') -> None:
    from telluride_decoding_torch.models.migrate import (
        load_reference_saved_model)
    model = load_reference_saved_model(src_dir, device=device)
    model.save(dst_dir)
    decoder_json = os.path.join(src_dir, 'decoder_model.json')
    if os.path.exists(decoder_json):
        shutil.copyfile(decoder_json,
                        os.path.join(dst_dir, 'decoder_model.json'))
    print('Migrated %s -> %s' % (src_dir, dst_dir))


def app_main(argv=None):
    device, argv = pop_device(
        list(argv if argv is not None else sys.argv[1:]))
    if len(argv) != 2:
        raise SystemExit(
            'usage: migrate_saved_model SRC_SAVED_MODEL_DIR DST_DIR')
    src, dst = argv
    if not os.path.exists(os.path.join(src, 'saved_model.pb')):
        raise SystemExit('%s does not look like a SavedModel directory '
                         '(no saved_model.pb).' % src)
    migrate(src, dst, device)


if __name__ == '__main__':
    app_main()
