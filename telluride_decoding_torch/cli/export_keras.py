"""Exports a native trained model for TensorFlow/Keras consumers (port of
telluride_decoding_tpu/cli/export_keras.py).

The inverse of migrate_saved_model: takes a native model directory
(model.json + weights.npz, as ``cli.decoding --saved_model_dir`` writes
it), loads it on ``--device`` (default cuda; cpu on request) and writes
what the reference's world loads with stock TensorFlow calls (reference
decoding.py:571-576):

  * ``DST.h5`` (the default): a Keras HDF5 model that
    ``tf.keras.models.load_model`` loads with no custom objects
    (io/keras_h5.py), and its ``.telluride.json`` sidecar. Needs h5py.
  * with ``--saved-model``: a SavedModel directory (saved_model.pb +
    keras_metadata.pb + variables/, io/saved_model_pb.py) that the same
    ``tf.keras.models.load_model`` call loads.
  * with ``--variables``: a ``variables/`` TensorBundle checkpoint
    (io/tf_checkpoint.write_tensor_bundle) in the positional layout of a
    freshly built reference model, with the telluride metadata.

Linear and CCA models export. A decoder_model.json beside the source is
copied through unchanged (reference infer_decoder.py:124).

Usage:
  python -m telluride_decoding_torch.cli.export_keras SRC_DIR DST.h5
  python -m telluride_decoding_torch.cli.export_keras --saved-model SRC DST_DIR
  python -m telluride_decoding_torch.cli.export_keras --variables SRC DST
  (each with [--device cuda|cpu])
"""

from __future__ import annotations

import os
import shutil
import sys

from telluride_decoding_torch.cli.migrate_saved_model import pop_device


def export(src_dir: str, dst: str, variables: bool = False,
           saved_model: bool = False, device='cuda') -> None:
    from telluride_decoding_torch.models.brain_model import load_model
    model = load_model(src_dir, device)
    decoder_json = os.path.join(src_dir, 'decoder_model.json')
    if saved_model:
        from telluride_decoding_torch.io.saved_model_pb import (
            export_saved_model)
        export_saved_model(model, dst)
        print('Wrote SavedModel directory to %s' % dst)
        if os.path.exists(decoder_json):
            shutil.copyfile(decoder_json,
                            os.path.join(dst, 'decoder_model.json'))
            print('Copied decoder parameters into %s' % dst)
        return
    if variables:
        from telluride_decoding_torch.io.keras_h5 import (
            export_saved_model_variables)
        export_saved_model_variables(model,
                                     os.path.join(dst, 'variables'))
        print('Wrote TensorBundle checkpoint to %s/variables' % dst)
        if os.path.exists(decoder_json):
            shutil.copyfile(decoder_json,
                            os.path.join(dst, 'decoder_model.json'))
        return
    from telluride_decoding_torch.io.keras_h5 import export_keras_h5
    export_keras_h5(model, dst)
    print('Wrote Keras H5 model to %s' % dst)
    if os.path.exists(decoder_json):
        sidecar = os.path.splitext(dst)[0] + '.decoder_model.json'
        shutil.copyfile(decoder_json, sidecar)
        print('Copied decoder parameters to %s' % sidecar)


def app_main(argv=None):
    device, argv = pop_device(
        list(argv if argv is not None else sys.argv[1:]))
    variables = '--variables' in argv
    if variables:
        argv.remove('--variables')
    saved_model = '--saved-model' in argv
    if saved_model:
        argv.remove('--saved-model')
    if len(argv) != 2 or (variables and saved_model):
        raise SystemExit(
            'usage: export_keras [--saved-model | --variables] '
            'SRC_MODEL_DIR DST\n'
            '  DST is a .h5 path (default) or a directory '
            '(--saved-model / --variables).')
    src, dst = argv
    if not os.path.exists(os.path.join(src, 'model.json')):
        raise SystemExit('%s does not look like a native model '
                         'directory (no model.json).' % src)
    if variables:
        os.makedirs(dst, exist_ok=True)
    export(src, dst, variables=variables, saved_model=saved_model,
           device=device)


if __name__ == '__main__':
    app_main()
