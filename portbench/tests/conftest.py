import pytest
import torch


@pytest.fixture(autouse=True, scope="session")
def _few_threads():
    """The tiny runs are many small ops: one thread a test worker keeps
    several workers from crowding the cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)
