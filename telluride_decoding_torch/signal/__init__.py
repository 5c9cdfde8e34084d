"""Signal preprocessing: IIR filters, resampling, audio features (port of
telluride_decoding_tpu/signal)."""

from telluride_decoding_torch.signal.filters import (
    butter_sos,
    sosfilt,
    sosfilt_zi,
    streaming_state_init,
)
from telluride_decoding_torch.signal.preprocess import (
    AudioFeatures,
    Preprocessor,
)
from telluride_decoding_torch.signal.audio_stores import (
    AudioIntensityStore,
    AudioLoudnessMick,
)
