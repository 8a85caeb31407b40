"""PyTorch / CUDA port of the ``repro`` data-loading stack, for one NVIDIA H100.

``repro`` (JAX/Pallas) stays the reference; this package imports nothing of it
and nothing of JAX.  Its first slice is the paper's own experiment: ResNet-18
trained on synthetic ImageNet streamed from simulated S3 through the
concurrent loader, with the ``ingest_norm`` epilogue as a hand-written CUDA
kernel.  Every entry point takes an explicit ``device`` that defaults to
``"cuda"``; the tests ask for ``"cpu"``.
"""
