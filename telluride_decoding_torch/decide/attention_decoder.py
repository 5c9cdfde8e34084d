"""Attention decision rules (port of decide/attention_decoder.py:30-51,
406-419): winner-take-all and the hysteresis stepper. Host code on two
window scores; the state-space decoder is not ported yet."""

from __future__ import annotations

from typing import Tuple, Union

import numpy as np


class AttentionDecoder:
    """Winner-take-all: instantaneous comparison, no hysteresis."""

    def attention(self, r1, r2) -> Tuple[Union[float, bool], float, float]:
        return bool(np.mean(r1) > np.mean(r2)), 0, 0

    def tune(self, r1, r2):
        del r1, r2


class StepAttentionDecoder(AttentionDecoder):
    """Hysteresis stepper: state in [0.1, 0.9], +/-0.1 per window."""

    def __init__(self):
        self.state = 0.5

    def attention(self, r1, r2):
        if np.mean(r1) > np.mean(r2):
            self.state = min(0.9, self.state + 0.1)
        else:
            self.state = max(0.1, self.state - 0.1)
        return self.state > 0.5, 0, 0


def create_attention_decoder(type_name: str) -> AttentionDecoder:
    """'wta' or 'stepped' ('step'); 'ssd' is not ported yet."""
    if type_name == 'wta':
        return AttentionDecoder()
    if type_name in ('stepped', 'step'):
        return StepAttentionDecoder()
    if type_name == 'ssd':
        raise ValueError('The state-space attention decoder (ssd) is not '
                         'ported to telluride_decoding_torch yet.')
    raise ValueError('Unknown type (%s) requested from '
                     'create_attention_decoder' % type_name)
