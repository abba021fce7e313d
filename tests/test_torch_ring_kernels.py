"""K3's wrapper (sparkucx_tpu_torch/ops/ring_kernels.py ``ring_exchange_grid``):
its window-table cache, its receiver groups, and its grid on CPU tensors (the
plain version) against the JAX package's Pallas ring kernel under the
interpreter (``_axis_grid`` with ``lowering='interpret'`` inside shard_map on
the virtual CPU mesh of tests/conftest.py).  Grids compare bit for bit:
tolerance 0."""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from sparkucx_tpu.ops import exchange as jax_exchange
from sparkucx_tpu.ops import ici_exchange as jax_ici
from sparkucx_tpu.ops._compat import shard_map
from sparkucx_tpu_torch.ops import ici_exchange as torch_ici
from sparkucx_tpu_torch.ops import ring_kernels


def _jax_grid(n, slot, chunks, data):
    """Every device's sender-major grid from the JAX package's ring kernel."""
    mesh = jax_exchange.make_mesh(n)
    ax = jax_exchange.ExchangeSpec(num_executors=n, send_rows=n * slot, recv_rows=n * slot, lane=1).axis_name
    sched = jax_ici.ring_schedule(n, chunks)

    def body(flat):
        return jax_ici._axis_grid(ax, n, slot, sched, flat, jax.lax.axis_index(ax), "interpret")

    fn = jax.jit(shard_map(body, mesh=mesh, in_specs=P(ax, None), out_specs=P(ax, None), check_vma=False))
    return np.asarray(fn(jax.device_put(data, NamedSharding(mesh, P(ax, None)))))


@pytest.mark.parametrize("n,chunks,lane", [(2, 1, 9), (4, 2, 32), (8, 4, 3)])
def test_cpu_grid_matches_the_jax_ring_kernel(n, chunks, lane):
    slot = 8
    rng = np.random.default_rng(n * 100 + lane)
    data = rng.integers(-(2**31), 2**31 - 1, size=(n * n * slot, lane), dtype=np.int64).astype(np.int32)
    steps = torch_ici.ring_schedule(n, chunks).raw_steps()
    before = ring_kernels.ring_exchange_grid.launches
    got = ring_kernels.ring_exchange_grid(n, slot, slot // chunks, steps, torch.from_numpy(data))
    assert ring_kernels.ring_exchange_grid.launches == before  # CPU: the plain version
    assert got.numpy().tobytes() == _jax_grid(n, slot, chunks, data).tobytes()


def test_window_table_cache_returns_one_table_per_schedule():
    steps = torch_ici.ring_schedule(4, 2).raw_steps()
    a = ring_kernels.window_table(4, 16, 8, steps, "cpu")
    again = ring_kernels.window_table(4, 16, 8, [list(step) for step in steps], torch.device("cpu"))
    assert again is a  # the same schedule, however it is spelled, hits the cache
    other = ring_kernels.window_table(4, 16, 4, torch_ici.ring_schedule(4, 4).raw_steps(), "cpu")
    assert other is not a
    table = ring_kernels.ring_windows(4, 16, 8, steps)
    assert a.num_windows == table.shape[0] and a.total_rows == int(table[:, 4].sum())
    flat = a.tensor.numpy()
    np.testing.assert_array_equal(flat[: table.size].reshape(-1, 5), table)
    np.testing.assert_array_equal(flat[table.size :], np.concatenate([[0], np.cumsum(table[:, 4])]))


def test_window_table_cache_is_bounded_and_checks_schedules():
    first = ring_kernels.window_table(2, 3, 3, torch_ici.ring_schedule(2, 1).raw_steps(), "cpu")
    for slot in range(100, 100 + ring_kernels.WINDOW_CACHE_SIZE):
        ring_kernels.window_table(2, slot, slot, torch_ici.ring_schedule(2, 1).raw_steps(), "cpu")
    assert len(ring_kernels._window_tables) <= ring_kernels.WINDOW_CACHE_SIZE
    assert ring_kernels.window_table(2, 3, 3, torch_ici.ring_schedule(2, 1).raw_steps(), "cpu") is not first
    with pytest.raises(ValueError, match="schedule item"):
        ring_kernels.window_table(2, 4, 4, (((1, 1, 1),),), "cpu")


@pytest.mark.parametrize("n", [1, 64, 65, 130])
def test_receiver_groups_cover_the_window_table(n):
    """K3 and K4's global tier launch once per group of at most
    MAX_EXECUTORS receivers, at an offset into the window table: the groups
    partition the receivers and the table, and every window of a group
    belongs to one of its receivers."""
    steps = torch_ici.ring_schedule(n, 1).raw_steps() if n > 1 else ()  # n = 1: the own slot alone
    table = ring_kernels.ring_windows(n, 2, 2, steps)
    per = table.shape[0] // n
    groups = ring_kernels.receiver_groups(n, table.shape[0])
    size = ring_kernels.MAX_EXECUTORS
    assert [(g.first, g.receivers) for g in groups] == [(j, min(size, n - j)) for j in range(0, n, size)]
    assert sum(g.windows for g in groups) == table.shape[0]
    for g in groups:
        assert g.first_window == g.first * per and g.windows == g.receivers * per
        receivers = table[g.first_window : g.first_window + g.windows, 0]
        assert receivers.min() == g.first and receivers.max() == g.first + g.receivers - 1


def test_executor_count_has_no_limit():
    """Past MAX_EXECUTORS executors K3 and both K4 tiers get past every check
    to the device one (the card runs them in receiver groups), and the plain
    versions run."""
    from sparkucx_tpu_torch.ops.combine import CombineSpec

    n = ring_kernels.MAX_EXECUTORS + 1
    steps = torch_ici.ring_schedule(n, 1).raw_steps()
    data = torch.empty((n * n, 4), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="runs on cuda or cpu tensors"):
        ring_kernels.ring_exchange_grid(n, 1, 1, steps, data)
    cpu = torch.arange(n * n * 2, dtype=torch.int32).view(n * n, 2)
    grid = ring_kernels.ring_exchange_grid(n, 1, 1, steps, cpu)
    assert torch.equal(grid, cpu.view(n, n, 1, 2).transpose(0, 1).reshape(-1, 2))
    wide = CombineSpec(1 << 14, ("sum",), np.int32)  # 128 KB of accumulator: the global tier
    narrow = CombineSpec(8, ("sum",), np.int32)
    assert ring_kernels.ring_combine_tier(wide) == "global" and ring_kernels.ring_combine_tier(narrow) == "shared"
    for cspec in (wide, narrow):
        meta = torch.empty((n * n, cspec.row_width), dtype=torch.int32, device="meta")
        with pytest.raises(ValueError, match="runs on cuda or cpu tensors"):
            ring_kernels.ring_combine_grid(n, 1, 1, steps, cspec, meta)
    rows = torch.zeros((n * n, wide.row_width), dtype=torch.int32)
    rows[:, 0] = torch.arange(n * n) % 7  # one row a region: key, value 1, count 1
    rows[:, 1:] = 1
    grid, vals, counts = ring_kernels.ring_combine_grid(n, 1, 1, steps, wide, rows)
    assert torch.equal(grid, rows.view(n, n, 1, -1).transpose(0, 1).reshape(-1, wide.row_width))
    assert int(counts.sum()) == n * n and int(vals.sum()) == n * n


def test_executor_limit_matches_the_kernel_source():
    import re
    from pathlib import Path

    src = (Path(ring_kernels.__file__).parent.parent / "csrc" / "ring_exchange.cu").read_text()
    assert int(re.search(r"constexpr int kMaxExecs = (\d+);", src).group(1)) == ring_kernels.MAX_EXECUTORS
