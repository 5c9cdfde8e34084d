"""Ahead-of-time (AOT) serving artifacts (port of decode/aot.py).

The JAX package exports a decoder's fused two-stream program as
serialized StableHLO (jax.export). The port exports the same program,
``infer_decoder.PairProgram`` (the model's weights, the correlation
statistics and the LDA as constants), with ``torch.export`` and one
dynamic frame axis shared by the five inputs, so one artifact serves any
chunk length, one frame included. For a CCA or deep CCA model with the
LDA reduction the program holds kernel K1 as one node, the op
``tdt::fused_cca_decode_f32`` (ops/decode_kernel.py), which launches the
hand-written kernel on the card and runs its plain version on the CPU.
Loading needs no model classes and no retracing; it needs the op
registered, which importing this module does.

Artifacts are a directory, as in the JAX package:
  aot_manifest.json   widths, reduction, platforms, experiment params
  infer_pair.pt2      torch.export.save of the two-stream program
  decoder_model.json  the standard wire-format decoder parameters

An artifact of the JAX package (``infer_pair.shlo``) holds a StableHLO
program, which PyTorch cannot run: ExportedDecoder refuses it and names
the tool that re-exports its model directory. ``cli/serve.py`` serves
either a model directory or a port artifact.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from telluride_decoding_torch import device as device_policy
from telluride_decoding_torch.decode.infer_decoder import (PairProgram,
                                                           PendingPair)
from telluride_decoding_torch.models.brain_model import BrainModel
# Registers tdt::fused_cca_decode_f32, which loading a program needs.
from telluride_decoding_torch.ops import decode_kernel  # noqa: F401

MANIFEST_NAME = 'aot_manifest.json'
_PROGRAM_NAME = 'infer_pair.pt2'
_JAX_PROGRAM_NAME = 'infer_pair.shlo'
_FORMAT_VERSION = 1
PLATFORMS = ('cuda', 'cpu')
# Frames of the sample the program is traced on: two or more, since
# torch.export specialises a dimension of size 0 or 1.
_TRACE_FRAMES = 8


def is_aot_artifact(path: str) -> bool:
    """True when ``path`` is an exported AOT artifact directory."""
    return os.path.isfile(os.path.join(path, MANIFEST_NAME))


def jax_artifact_refusal(artifact_dir: str) -> str:
    """Why a JAX package artifact does not serve here, and what to do."""
    return ('%s is an AOT artifact of the JAX package: its program %s is '
            'StableHLO, which PyTorch cannot run. Re-export the model '
            'directory it came from with python -m '
            'telluride_decoding_torch.cli.export_aot MODEL_DIR ARTIFACT_DIR.'
            % (artifact_dir, _JAX_PROGRAM_NAME))


def export_decoder(decoder, artifact_dir: str, *,
                   platforms: Optional[Sequence[str]] = None,
                   input_widths: Optional[Tuple[int, int]] = None,
                   output_width: Optional[int] = None) -> Dict:
    """Exports a trained Decoder as an AOT serving artifact.

    Args:
      decoder: a decode.infer_decoder.Decoder whose decoding model is a
        port BrainModel with its parameters; its correlation statistics
        and any LDA parameters must already be set (train or
        restore_parameters): they become constants of the program.
      artifact_dir: output directory (created).
      platforms: the devices the artifact may serve on, of 'cuda' and
        'cpu'; defaults to both. The program is traced on the decoder's
        device and moved to the serving device when loaded.
      input_widths / output_width: per-frame feature widths of
        (input_1, input_2) and the model output. Defaults come from the
        decoder's embedded telluride metadata (model_inputs /
        model_output); required explicitly when the decoder was built
        in-process without add_metadata.

    Returns:
      The manifest dict.
    """
    model = decoder.decoding_model
    if not (isinstance(model, BrainModel) and model.params is not None):
        raise ValueError(
            'export_decoder needs a BrainModel decoding model (a '
            'torch.nn.Module with its parameters); a plain python '
            'callable cannot be serialized.')
    program = PairProgram(decoder)
    if getattr(decoder, '_count', 0) == 0:
        # The statistics become constants of the program, which cannot
        # be trained after the fact: the reset-state scalars (mean 0,
        # power 1) would freeze meaningless normalization into every
        # non-LDA reduction.
        raise ValueError(
            'export_decoder: the decoder has no correlation '
            'statistics (count == 0); train the decoder or '
            'restore_parameters first - the exported artifact bakes '
            'these statistics in permanently.')
    if input_widths is None:
        inputs = decoder.model_inputs
        if not inputs or 'input_1' not in inputs or 'input_2' not in inputs:
            raise ValueError(
                'Decoder has no embedded input metadata; pass '
                'input_widths=(w1, w2) explicitly.')
        input_widths = (int(inputs['input_1'][-1]),
                        int(inputs['input_2'][-1]))
    if output_width is None:
        if not decoder.model_output:
            raise ValueError(
                'Decoder has no embedded output metadata; pass '
                'output_width explicitly.')
        output_width = int(decoder.model_output[-1])
    if isinstance(platforms, str):
        # tuple('cpu') would iterate characters into ('c','p','u').
        platforms = (platforms,)
    platforms = tuple(platforms or PLATFORMS)
    unknown = [p for p in platforms if p not in PLATFORMS]
    if unknown:
        raise ValueError('export_decoder: the port\'s program runs on %s, '
                         'not %s.' % (' or '.join(PLATFORMS),
                                      ', '.join(unknown)))
    w1, w2 = int(input_widths[0]), int(input_widths[1])

    widths = (w1, w2, w2, int(output_width), int(output_width))
    sample = tuple(torch.zeros((_TRACE_FRAMES, w), dtype=torch.float32,
                               device=decoder.device) for w in widths)
    # One frame count shared by every stream: chunk length is a
    # serve-time choice.
    frames = torch.export.Dim('frames', min=1)
    with torch.no_grad():
        exported = torch.export.export(
            program.eval(), sample, strict=False,
            dynamic_shapes=tuple({0: frames} for _ in widths))

    os.makedirs(artifact_dir, exist_ok=True)
    torch.export.save(exported, os.path.join(artifact_dir, _PROGRAM_NAME))
    decoder.save_parameters(os.path.join(artifact_dir,
                                         'decoder_model.json'))
    manifest = {
        'format_version': _FORMAT_VERSION,
        'program': _PROGRAM_NAME,
        'reduction': decoder._reduction,
        'input_1_width': w1,
        'input_2_width': w2,
        'output_width': int(output_width),
        'platforms': list(platforms),
        'model_params': decoder.decoding_model_params,
        'model_inputs': decoder.model_inputs,
        'model_output': decoder.model_output,
    }
    with open(os.path.join(artifact_dir, MANIFEST_NAME), 'w') as f:
        json.dump(manifest, f, indent=2)
    return manifest


class ExportedDecoder:
    """Serves an exported artifact with the Decoder serving interface.

    Provides what the serving path consumes (cli/serve.py):
    ``infer_pair`` / ``infer_pair_async`` / ``infer_one``, ``device`` and
    the ``decoding_model_params`` metadata. Scoring state (correlation
    statistics, LDA) is inside the program; there is nothing to train or
    restore. ``device`` (default cuda) must be of a platform the artifact
    was exported for; CUDA without a card raises.
    """

    def __init__(self, artifact_dir: str, device='cuda'):
        manifest_path = os.path.join(artifact_dir, MANIFEST_NAME)
        with open(manifest_path) as f:
            self._manifest = json.load(f)
        version = self._manifest.get('format_version')
        if version != _FORMAT_VERSION:
            raise ValueError('Unsupported AOT artifact version %r in %s '
                             '(this build reads version %d).'
                             % (version, manifest_path, _FORMAT_VERSION))
        program = self._manifest.get('program', _PROGRAM_NAME)
        if program == _JAX_PROGRAM_NAME:
            raise ValueError(jax_artifact_refusal(artifact_dir))
        device = torch.device(device)
        platforms = self._manifest.get('platforms', [])
        if device.type not in platforms:
            raise ValueError('AOT artifact %s was exported for %s; it does '
                             'not serve on %s.'
                             % (artifact_dir, ','.join(platforms),
                                device.type))
        self._device = device_policy.resolve(device)
        from torch.export.passes import move_to_device_pass
        exported = move_to_device_pass(
            torch.export.load(os.path.join(artifact_dir, program)),
            self._device)
        self._program = exported.module()

    @property
    def manifest(self) -> Dict:
        return self._manifest

    @property
    def reduction(self) -> str:
        return self._manifest['reduction']

    @property
    def device(self) -> torch.device:
        return self._device

    @property
    def decoding_model_params(self) -> Dict:
        return self._manifest.get('model_params', {})

    @property
    def model_inputs(self) -> Dict:
        return self._manifest.get('model_inputs', {})

    @property
    def model_output(self) -> list:
        return self._manifest.get('model_output', [])

    def _scores(self, *streams) -> Tuple[torch.Tensor, torch.Tensor]:
        with torch.no_grad():
            return self._program(*(
                device_policy.as_tensor(v, self._device,
                                        torch.float32).contiguous()
                for v in streams))

    def infer_pair(self, input_1, input_2a, input_2b, output_a,
                   output_b) -> Tuple[np.ndarray, np.ndarray]:
        sa, sb = self._scores(input_1, input_2a, input_2b, output_a,
                              output_b)
        return sa.cpu().numpy(), sb.cpu().numpy()

    def infer_pair_async(self, input_1, input_2a, input_2b, output_a,
                         output_b):
        """infer_pair without waiting for the scores, as
        Decoder.infer_pair_async: on the card a PendingPair (the copies
        back issued without blocking), on the CPU the two arrays."""
        scores = self._scores(input_1, input_2a, input_2b, output_a,
                              output_b)
        if self._device.type != 'cuda':
            return tuple(s.numpy() for s in scores)
        return PendingPair(scores)

    def infer_one(self, input_dict, output) -> np.ndarray:
        """Single-stream scoring through the pair program (the second
        lane re-scores the same stream)."""
        sa, _ = self.infer_pair(input_dict['input_1'],
                                input_dict['input_2'],
                                input_dict['input_2'], output, output)
        return sa


def load_exported_decoder(artifact_dir: str,
                          device='cuda') -> ExportedDecoder:
    """Loads an AOT artifact directory for serving on ``device``."""
    return ExportedDecoder(artifact_dir, device)
