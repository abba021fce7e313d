"""The port stands alone: importing ``sparkucx_tpu_torch`` and every submodule
loads neither JAX nor the JAX package, and no entry point silently falls back
to the CPU when CUDA is missing."""

import subprocess
import sys
import textwrap

import pytest
import torch

from sparkucx_tpu_torch.ops.columnar import ColumnarSpec, build_columnar_shuffle
from sparkucx_tpu_torch.ops.sort import SortSpec, build_distributed_sort, run_distributed_sort
from sparkucx_tpu_torch.shuffle.manager import TpuShuffleManager
from sparkucx_tpu_torch.transport.tpu import TpuShuffleCluster
from sparkucx_tpu_torch.utils.devices import resolve_devices

_PROBE = textwrap.dedent(
    """
    import importlib, pkgutil, sys
    import sparkucx_tpu_torch
    for mod in pkgutil.walk_packages(sparkucx_tpu_torch.__path__, "sparkucx_tpu_torch."):
        importlib.import_module(mod.name)
    bad = sorted(
        k for k in sys.modules
        if k in ("jax", "sparkucx_tpu") or k.startswith(("jax.", "sparkucx_tpu."))
    )
    print("LOADED", bad)
    """
)


def test_package_imports_without_jax():
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], capture_output=True, text=True, timeout=300, check=True
    )
    assert "LOADED []" in out.stdout, out.stdout + out.stderr


@pytest.mark.parametrize("entry", [TpuShuffleCluster, TpuShuffleManager])
def test_entry_points_default_to_cuda(entry, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        entry(num_executors=2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        entry(devices=["cpu", "cuda"])


def test_explicit_cpu_devices():
    cluster = TpuShuffleCluster(devices=["cpu"] * 3)
    assert cluster.num_executors == 3
    assert all(t.device == torch.device("cpu") for t in cluster.transports)
    with pytest.raises(ValueError, match="num_executors"):
        resolve_devices(["cpu"], 2)


def test_sort_entry_points_default_to_cuda(monkeypatch):
    import numpy as np

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_distributed_sort(None, SortSpec(1, 8, 8, impl="radix"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_distributed_sort(None, SortSpec(4, 8, 8), np.zeros(4, np.uint32), np.zeros((4, 24), np.int32))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_columnar_shuffle(None, ColumnarSpec(2, 8, 8, 1))
