"""The benchmark's own tests (run them as ``python -m pytest
benchmark/tests -q`` from the checkout's root). Tests that need the
card carry the ``chip`` marker and skip without one, deciding inside the
test."""

import torch


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs an NVIDIA card; skips on a machine without")
    torch.set_num_threads(min(4, torch.get_num_threads()))
