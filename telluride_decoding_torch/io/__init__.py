"""Raw-format ingest: WAV and in-memory recordings to TFRecords."""
