"""The port's Mamba-1 mixer on the card against the same calls on the CPU
(``tests/test_torch_ssm.py`` holds it to the JAX reference).  Imports no
JAX, so it runs on a machine with the card and without JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_ssm_card.py

Tolerance: fp32 with TF32 off, outputs and cache leaves within 1e-4 (the
devices differ only in the order of fp32 sums; ``tests/test_torch_prefill.py``'s
card-free tolerance for the same leaves)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from repro_torch.config import get_arch  # noqa: E402
from repro_torch.convert import from_jax, to_jax  # noqa: E402
from repro_torch.models import ssm  # noqa: E402

TOL = 1e-4


@pytest.mark.cuda
def test_apply_mamba_on_the_card_matches_the_cpu():
    """At the jamba smoke widths with S above ``SCAN_CHUNK``: without a
    cache, and a prefill into a cache then 2 decode steps."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_arch("jamba-v0.1-52b", smoke=True), dtype="float32")
    np_p = to_jax(ssm.init_mamba(torch.Generator().manual_seed(0), cfg))
    rng = np.random.default_rng(5)
    xs = [rng.standard_normal((2, n, cfg.d_model)).astype(np.float32)
          for n in (ssm.SCAN_CHUNK + 9, 1, 1)]
    outs = {}
    for dev in ("cpu", "cuda"):
        p = from_jax(np_p, dev)
        y, _ = ssm.apply_mamba(p, torch.from_numpy(xs[0]).to(dev), cfg)
        got = [y.cpu()]
        cache = ssm.init_mamba_cache(cfg, 2, dev)
        for x in xs:
            y, cache = ssm.apply_mamba(p, torch.from_numpy(x).to(dev), cfg, cache=cache)
            got += [y.cpu(), cache["conv"].cpu(), cache["ssm"].cpu()]
        outs[dev] = got
    for a, b in zip(outs["cpu"], outs["cuda"]):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=0, atol=TOL)
