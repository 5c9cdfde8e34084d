"""Deterministic solvers: ridge, CCA and LDA (port of
telluride_decoding_tpu/solvers)."""

from telluride_decoding_torch.solvers.ridge import (
    RidgeSolution,
    solve_ridge_from_moments,
    calculate_linear_regressor_parameters,
)
from telluride_decoding_torch.solvers.cca import (
    CcaSolution,
    solve_cca_from_moments,
    calculate_cca_parameters,
    cca_loss,
)
from telluride_decoding_torch.solvers.lda import (
    LinearDiscriminantAnalysis,
    ScaledLinearDiscriminantAnalysis,
    LdaParams,
)
