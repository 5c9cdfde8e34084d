"""The benchmark of telluride_decoding_torch on one NVIDIA H100: see run.py."""
