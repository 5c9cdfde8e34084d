"""Tensor operations and the wrappers of the hand-written kernels (port of
telluride_decoding_tpu/ops)."""

from telluride_decoding_torch.ops.pearson import (
    pearson_correlation,
    pearson_correlation_first,
    pearson_correlation_second,
    pearson_loss,
    correlation_matrix,
)
from telluride_decoding_torch.ops.fused_frontend import (
    fused_envelope_lagstack,
    fused_envelope_lagstack_reference,
)
from telluride_decoding_torch.ops.covariance import (
    MomentStats,
    moments_from_arrays,
    blocked_moments,
)
from telluride_decoding_torch.ops.lagstack import (
    lag_stack,
    lag_stack_np,
    lag_stack_reference,
    stacked_width,
)
