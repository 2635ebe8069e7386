import pytest
import torch


@pytest.fixture
def cuda():
    """The card, or a skip: the tests marked ``cuda`` run on an H100."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run pytest -m cuda portbench/tests on the card")
    return torch.device("cuda", 0)
