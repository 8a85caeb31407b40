"""ingest_norm: uint8 NHWC -> normalized NCHW, as a CUDA kernel."""
