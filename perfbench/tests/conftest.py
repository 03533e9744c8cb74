"""The benchmark's own tests: run from the repository root with
``python3 -m pytest perfbench/tests`` (the repository's ``tests/`` suite does
not collect them). Tests marked ``cuda`` run only where a card is present."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture
def card():
    """Skip unless a CUDA card is present (decided here, never at import)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
