"""Raw-format ingest: EDF, BrainVision, WAV, in-memory recordings (port
of telluride_decoding_tpu/io)."""

from telluride_decoding_torch.io.ingest import (
    BrainDataFile,
    BrainExperiment,
    BrainSignal,
    BrainTrial,
    EdfBrainDataFile,
    LocalCopy,
    MemoryBrainDataFile,
    convert_data_to_tfrecords,
    count_tfrecords,
    discover_feature_shapes,
    find_mean_std,
    find_temporal_offset_via_linear_regression,
    find_temporal_offset_via_mode_histogram,
    normalize_data,
    parse_edf_file,
    read_tfrecords,
    remove_close_times,
    transform_tfrecords,
)
from telluride_decoding_torch.io.brainvision import (
    BvBrainDataFile,
    parse_bv_header,
    parse_bv_keywords,
    read_bv_file,
)
from telluride_decoding_torch.io.edf import read_edf, write_edf
