"""Brain models: linear, CCA, DNN, classifier and deep CCA (port of
telluride_decoding_tpu/models)."""

from telluride_decoding_torch.models.brain_model import (
    BrainModel,
    BrainModelClassifier,
    BrainModelDNN,
    BrainModelLinearRegression,
    load_model,
    register_model,
)
from telluride_decoding_torch.models.cca import (
    BrainModelCCA,
    BrainModelDCCA,
)
from telluride_decoding_torch.models.migrate import (
    load_reference_saved_model,
)
