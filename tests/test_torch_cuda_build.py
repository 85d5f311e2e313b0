"""The port's one launch path and launch counter (`core/cuda_build.py`), on the CPU.

Every hand-written kernel is registered once, under the key its dispatch
spans count it by, with its source and its device functions; its wrapper
launches it through `cuda_build.launch`, which passes the current stream of
the data's device last, raises naming the kernel on a CUDA error and
otherwise counts the launch under that key.  Here a stand-in takes the place
of a ctypes entry, and the device context and the stream are stubbed (a CPU
build of PyTorch has neither)."""

import contextlib
import glob
import importlib
import inspect
import os
import re
import types

import pytest
import torch

from fhe_sorting_tpu_torch.core import cuda_build

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(cuda_build.__file__))),
                     "csrc")
# the keys the dispatch spans carry, which the benchmark's launch metrics read
KEYS = ["k1", "k2", "k3", "k4"]
STREAM = 7
GLOBAL = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\s*\(")


@pytest.fixture
def stub_cuda(monkeypatch):
    """`torch.cuda.device` as a no-op and every current stream as STREAM."""
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: types.SimpleNamespace(cuda_stream=STREAM))


class _Entry:
    """A stand-in ctypes entry: records its arguments and returns `rc`."""

    def __init__(self, rc: int):
        self.__name__ = "stand_in"
        self.rc, self.calls = rc, []

    def __call__(self, *args):
        self.calls.append(args)
        return self.rc


def _only(key, n):
    return {k: n if k == key else 0 for k in KEYS}


@pytest.mark.parametrize("key", KEYS)
def test_failed_launch_raises_naming_the_kernel_and_counts_nothing(stub_cuda, key):
    before = cuda_build.counts()
    entry = _Entry(719)
    with pytest.raises(RuntimeError, match=rf"^{key.upper()} \({cuda_build.KERNELS[key].source}\)"
                                           rf": stand_in launch failed: CUDA error 719$"):
        cuda_build.launch(key, entry, 1, 2, device=torch.device("cpu"))
    assert entry.calls == [(1, 2, STREAM)]
    assert cuda_build.since(before) == _only(key, 0)


@pytest.mark.parametrize("key", KEYS)
def test_launch_counts_only_its_own_kernel(stub_cuda, key):
    before = cuda_build.counts()
    entry = _Entry(0)
    cuda_build.launch(key, entry, 3, device=torch.device("cpu"))
    cuda_build.launch(key, entry, 4, 5, device=torch.device("cpu"))
    assert entry.calls == [(3, STREAM), (4, 5, STREAM)]       # the stream comes last
    assert cuda_build.since(before) == _only(key, 2)


def test_reset_and_advance_a_replays_launches():
    cuda_build.reset()
    assert cuda_build.counts() == _only("k1", 0)
    cuda_build.advance({"k2": 3, "k4": 1})                      # a replay
    assert cuda_build.counts() == {"k1": 0, "k2": 3, "k3": 0, "k4": 1}
    cuda_build.advance({"k2": 3, "k4": 1}, -1)                  # its capture taken back
    assert cuda_build.counts() == _only("k1", 0)


def test_registry_and_csrc_correspond_one_to_one():
    sources = sorted(os.path.basename(p)[:-3] for p in glob.glob(os.path.join(_CSRC, "*.cu")))
    assert sorted(k.source for k in cuda_build.KERNELS.values()) == sources
    assert list(cuda_build.KERNELS) == KEYS


@pytest.mark.parametrize("key", KEYS)
def test_registry_entry_names_its_device_functions_and_wrapper(key):
    """Its functions are exactly its source's `__global__` ones, and its
    wrapper launches through `cuda_build.launch` under its key and keeps no
    counter of its own."""
    kernel = cuda_build.KERNELS[key]
    with open(os.path.join(_CSRC, f"{kernel.source}.cu")) as f:
        assert GLOBAL.findall(f.read()) == list(kernel.functions)
    wrapper = importlib.import_module(f"fhe_sorting_tpu_torch.core.{kernel.source}")
    assert not hasattr(wrapper, "launches")
    assert re.search(rf'cuda_build\.launch\(\s*"{key}",', inspect.getsource(wrapper))
