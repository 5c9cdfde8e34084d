"""Correlation decoding, reductions and separation metrics (port of
telluride_decoding_tpu/decode)."""

from telluride_decoding_torch.decode.metrics import (
    calculate_dprime,
    average_data,
)
from telluride_decoding_torch.decode.result_store import (
    NumpyStore,
    TwoResultStore,
    WindowedDataStore,
)
from telluride_decoding_torch.decode.infer_decoder import (
    CCADecoder,
    CorrelationParamsTuple,
    Decoder,
    LinearRegressionDecoder,
    ModelParamsTuple,
    NumpyEncoder,
    create_decoder,
)
