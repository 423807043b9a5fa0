"""The port's test modules run torch on one intra-op thread.

The smoke models' ops are a few thousand elements: one thread runs them
fastest, and six test workers' thread pools otherwise thrash.  A module
takes the fixture by importing it (``from _torch_threads import
one_thread``); an imported autouse fixture applies to that module, and
the setting is restored for the worker's next file.
"""
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
