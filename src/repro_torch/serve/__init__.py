"""Serving: prefill/decode programs and the continuous-batching engine
(the reference's ``repro/serve``; its multi-tenant read path is not
ported yet)."""
from repro_torch.serve.engine import Request, ServeEngine

__all__ = ["Request", "ServeEngine"]
