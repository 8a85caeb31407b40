"""The port's parameter counting (``repro_torch.models.counting``) against the
JAX reference's (``repro.models.counting``): ``count_params`` and
``count_active_params`` equal, integer for integer, for every registered
arch at its full and its smoke config, ``model_flops`` too, and the twin
of ``tests/test_archs_smoke.py::test_param_counts_sane``.  Counting draws
no number: the two largest full configs are counted in a fresh process
whose peak resident memory stays under 2 GiB (nemotron-4-340b alone would
be 1.36 TB of fp32)."""
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
from repro.config import get_arch as jax_get_arch  # noqa: E402
from repro.models import counting as jcounting  # noqa: E402
from repro_torch.config import get_arch, list_archs  # noqa: E402
from repro_torch.models import counting  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCHS = list_archs()


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", ARCHS)
def test_counts_equal_the_reference(arch, smoke):
    cfg, jcfg = get_arch(arch, smoke=smoke), jax_get_arch(arch, smoke=smoke)
    assert counting.count_params(cfg) == jcounting.count_params(jcfg)
    assert counting.count_active_params(cfg) == jcounting.count_active_params(jcfg)
    for kind in ("train", "infer"):
        assert counting.model_flops(cfg, 4096, kind) == jcounting.model_flops(jcfg, 4096, kind)


def test_param_counts_sane():
    """Twin of the reference's test of the same name, on the port's counts."""
    n = counting.count_params(get_arch("granite-8b"))
    assert 7.0e9 < n < 9.5e9, n  # ~8B-class
    moe = get_arch("qwen2-moe-a2.7b")
    assert counting.count_active_params(moe) < counting.count_params(moe)
    n340 = counting.count_params(get_arch("nemotron-4-340b"))
    assert 3.0e11 < n340 < 3.9e11, n340  # ~340B
    nj = counting.count_params(get_arch("jamba-v0.1-52b"))
    assert 4.0e10 < nj < 6.5e10, nj  # ~52B
    nr = counting.count_params(get_arch("rwkv6-7b"))
    assert 5.5e9 < nr < 9.0e9, nr  # ~7B
    nw = counting.count_params(get_arch("whisper-large-v3"))
    assert 1.2e9 < nw < 2.2e9, nw  # ~1.5B


def test_whisper_and_internvl_counts():
    """whisper-large-v3: 32 encoder layers of 19.67 M, 32 decoder layers of
    26.22 M, embedding and LM head of 66.39 M each; internvl2-26b's
    patch projection is 3200 x 6144."""
    w = get_arch("whisper-large-v3")
    d, f = w.d_model, w.d_ff
    attn, ln = 4 * d * d, 2 * d
    enc, dec = attn + d * f * 2 + 2 * ln, 2 * attn + d * f * 2 + 3 * ln
    assert counting.count_params(w) == 32 * enc + 32 * dec + 2 * w.vocab_size * d + 2 * ln
    assert counting.count_params(w) == 1_601_198_080
    v = get_arch("internvl2-26b")
    from dataclasses import replace

    assert counting.count_params(v) - counting.count_params(replace(v, frontend_dim=0)) \
        == 3200 * 6144


_COUNT_LARGEST = r"""
import resource, sys
sys.path.insert(0, sys.argv[1])
from repro_torch.config import get_arch
from repro_torch.models.counting import count_params
total = sum(count_params(get_arch(a)) for a in ("nemotron-4-340b", "jamba-v0.1-52b"))
print(total, resource.getrusage(resource.RUSAGE_SELF).ru_maxrss)
"""


def test_counting_allocates_no_parameter():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _COUNT_LARGEST, str(ROOT / "src")],
                         capture_output=True, text=True, env=env, timeout=300, check=True)
    total, maxrss_kib = map(int, out.stdout.split())
    assert total == 341_029_195_776 + 51_570_315_264  # 1.57 TB of fp32
    assert maxrss_kib < 2 * 1024 * 1024, maxrss_kib
