import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture
def card():
    """Skips unless a CUDA card is visible (decided here, never at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def tiny(cell, envs=16, steps=3):
    """Shrink a cell to a CPU-sized run of the same entries: returns the
    program's config overrides."""
    cell.config["num_envs"] = envs
    if cell.traffic["loop"] == "train":
        cell.config["num_steps_per_env"] = steps
        return [f"algo.config.num_steps_per_env={steps}"]
    return []
