"""Dataset assembly and TFRecord I/O (port of
telluride_decoding_tpu/data)."""

from telluride_decoding_torch.data.records import (
    FeatureSpec,
    count_tfrecords,
    convert_data_to_tfrecords,
    discover_feature_shapes,
    encode_example,
    iter_tfrecords,
    parse_example,
    read_tfrecords,
    write_tfrecords,
)
from telluride_decoding_torch.data.brain_data import (
    BrainData,
    BrainDataset,
    TestBrainData,
    TFExampleData,
    create_brain_dataset,
)
