"""The benchmark's CPU tests run many tiny tensor ops (the port's plain
loops at small shapes): one intra-op thread each, so that several test
workers on one host do not oversubscribe its cores."""
import pytest
import torch


@pytest.fixture(autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)
