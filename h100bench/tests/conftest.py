import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
for p in (HERE, HERE.parent, HERE.parent.parent / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


@pytest.fixture(scope="session")
def smoke_root(tmp_path_factory):
    import smoke

    return smoke.make_root(tmp_path_factory.mktemp("checkout"),
                           extra_cells=[("smoke-decoder", "smoke-memory")])
