"""Attention decision rules: WTA, stepped, state-space (port of
telluride_decoding_tpu/decide)."""

from telluride_decoding_torch.decide.attention_decoder import (
    AttentionDecoder,
    StateSpaceAttentionDecoder,
    StepAttentionDecoder,
    create_attention_decoder,
)
