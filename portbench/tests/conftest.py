"""The benchmark's own tests. Those marked ``card`` need an NVIDIA card and
skip without one; the look is made inside the ``card`` fixture, never while
a module is imported.

    python3 -m pytest portbench/tests -q             # the CPU tests; card tests skip
    python3 -m pytest portbench/tests -q -m card     # on the card
"""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card; skips without one")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the card")
    return torch.device("cuda", 0)


@pytest.fixture(autouse=True, scope="session")
def few_threads():
    """Tiny CPU runs in several test workers at once: a few threads each,
    where torch's default of one a core would have them wait on each other."""
    torch.set_num_threads(2)
