"""Serving: prefill/decode programs and the continuous-batching engine, and
the multi-tenant read path (single-flight coalescing, tenant fairness, SLO
hedging) over the store stack, as the reference's ``repro/serve``.
:mod:`repro_torch.serve.readpath` imports no ``torch``; the engine does."""
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.readpath import ReadPath

__all__ = ["ReadPath", "Request", "ServeEngine"]
