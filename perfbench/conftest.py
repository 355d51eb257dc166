"""Fixtures of the benchmark's tests: the ``cuda`` marker, a card check made
inside a fixture, and the cells shrunk to CPU size."""
import pytest

from perfbench import bench


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU with sm_90 (H100); skips elsewhere")


@pytest.fixture(autouse=True)
def one_thread():
    """One CPU thread per test: the suite runs several workers at once, and
    PyTorch's thread pools in each would contend for the cores."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is no sm_90 card."""
    import torch

    if not torch.cuda.is_available() or torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs an NVIDIA H100 (sm_90)")
    return torch.device("cuda")


TINY_MODEL = {"channels": 8, "hidden": 16, "chain_tune": "heuristic"}


@pytest.fixture
def tiny(monkeypatch):
    """Every cell at a size a CPU test holds: 8 channels, molecules of 5-8
    atoms, small buckets and batches; the limits are the cells' own."""
    base_config, base_traffic = bench.config, bench.traffic

    def config(name):
        c = base_config(name)
        c["model"] = dict(c["model"], **TINY_MODEL)
        return c

    def traffic(name):
        t = base_traffic(name)
        if t["kind"] == "serve":
            small = len(t["buckets"]) > 1
            t.update(atoms=[5, 8] if small else [6, 6], clients=8,
                     buckets=[[6, 2], [8, 2]] if small else [[8, 4]])
        else:
            t.update(atoms=6, batch=2, dataset=8)
        return t

    monkeypatch.setattr(bench, "config", config)
    monkeypatch.setattr(bench, "traffic", traffic)
    return bench.manifest()
