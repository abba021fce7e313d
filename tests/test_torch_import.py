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


def test_upload_on_the_cpu_shares_the_array():
    import numpy as np

    from sparkucx_tpu_torch.utils.devices import upload

    a = np.arange(12, dtype=np.int64).reshape(3, 4)
    t = upload(a, torch.device("cpu"))
    assert t.device.type == "cpu" and np.array_equal(t.numpy(), a)
    a[0, 0] = 99
    assert int(t[0, 0]) == 99
    assert np.array_equal(upload(a[:, ::2], torch.device("cpu")).numpy(), a[:, ::2])


def test_sort_entry_points_default_to_cuda(monkeypatch):
    import numpy as np

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_distributed_sort(None, SortSpec(1, 8, 8, impl="radix"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_distributed_sort(None, SortSpec(4, 8, 8), np.zeros(4, np.uint32), np.zeros((4, 24), np.int32))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_columnar_shuffle(None, ColumnarSpec(2, 8, 8, 1))


_GROUP_BY_MODULES = (
    "sparkucx_tpu_torch.ops.compress",
    "sparkucx_tpu_torch.ops.combine",
    "sparkucx_tpu_torch.ops.ici_exchange",
    "sparkucx_tpu_torch.ops.ring_kernels",
    "sparkucx_tpu_torch.ops.relational",
)


@pytest.mark.parametrize("module", _GROUP_BY_MODULES)
def test_group_by_modules_import_without_jax(module):
    probe = f"import importlib, sys; importlib.import_module({module!r}); " + (
        "print('LOADED', sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'sparkucx_tpu')))"
    )
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True, text=True, timeout=300, check=True)
    assert "LOADED []" in out.stdout, out.stdout + out.stderr


def test_group_by_entry_points_default_to_cuda(monkeypatch):
    import numpy as np

    from sparkucx_tpu_torch.ops.combine import CombineSpec
    from sparkucx_tpu_torch.ops.exchange import ExchangeSpec
    from sparkucx_tpu_torch.ops.ici_exchange import build_combine_exchange, build_ici_exchange
    from sparkucx_tpu_torch.ops.relational import AggregateSpec, build_grouped_aggregate, run_grouped_aggregate

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = AggregateSpec(2, 8, 8, ("sum",), partial=True, combine="dense", combine_groups=8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_grouped_aggregate(None, spec)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_grouped_aggregate(None, spec, np.zeros(4, np.uint32), np.zeros((4, 1), np.int32))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_ici_exchange(None, ExchangeSpec(2, 8, 8, 4))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_combine_exchange(None, ExchangeSpec(2, 8, 8, 3), CombineSpec(8, ("sum",)))


_PLAN_ENGINE_MODULES = (
    "sparkucx_tpu_torch.ops.skew",
    "sparkucx_tpu_torch.ops.planner",
    "sparkucx_tpu_torch.transport.pipeline",
    "sparkucx_tpu_torch.transport.executor",
    "sparkucx_tpu_torch.utils.stats",
    "sparkucx_tpu_torch.perf.benchmark",
    "sparkucx_tpu_torch.utils.pagecodec",
)


@pytest.mark.parametrize("module", _PLAN_ENGINE_MODULES)
def test_plan_engine_modules_import_without_jax(module):
    probe = f"import importlib, sys; importlib.import_module({module!r}); " + (
        "print('LOADED', sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'sparkucx_tpu')))"
    )
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True, text=True, timeout=300, check=True)
    assert "LOADED []" in out.stdout, out.stdout + out.stderr


def test_fused_send_side_and_benchmark_default_to_cuda(monkeypatch):
    from sparkucx_tpu_torch.ops.exchange import ExchangeSpec
    from sparkucx_tpu_torch.ops.ici_exchange import build_fused_ici_exchange
    from sparkucx_tpu_torch.perf.benchmark import measure_ici

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_fused_ici_exchange(None, ExchangeSpec(2, 8, 8, 4), 2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        measure_ici((2,), 8, 4)


_BENCHMARK_RUN = textwrap.dedent(
    """
    import sys
    from sparkucx_tpu_torch.perf.benchmark import main
    for argv in (
        "superstep -s 8k -i 1 -o 1 --executors 2", "gather -n 3 -s 4k -i 1 -o 1", "write -n 2 -s 4k -i 1",
        "pipeline --executors 2 -n 2 -s 8k --depths 1,2 -i 1", "skew --executors 2 -s 8k -i 1",
        "adaptive --executors 2 -s 4k -i 1", "sort -n 256 -i 1 -o 1 --executors 2",
        "sort -n 256 -i 1 --executors 2 --batches 2", "columnar -n 256 -s 16 -i 1 -o 1 --executors 2",
        "groupby -n 256 -i 1 -o 1 --executors 2 --keys 8 --partial", "join -n 256 -i 1 -o 1 --executors 2",
        "combine --executors 2 -s 2k --keys 4 -i 1",
    ):
        assert main(argv.split() + ["--device", "cpu"]) == 0, argv
    print("LOADED", sorted(k for k in sys.modules if k.split(".")[0] in ("jax", "sparkucx_tpu")))
    """
)


def test_benchmark_modes_run_without_jax():
    """Every ported benchmark mode, run end to end on the CPU, loads neither
    JAX nor the JAX package (their measurement cores import lazily)."""
    out = subprocess.run(
        [sys.executable, "-c", _BENCHMARK_RUN], capture_output=True, text=True, timeout=300, check=True
    )
    assert "LOADED []" in out.stdout, out.stdout + out.stderr
