"""The port's ``ici`` benchmark mode (sparkucx_tpu_torch/perf/benchmark.py)
on the CPU: ``measure_ici`` with ``device="cpu"`` (stock, pallas and the
fused send side held bit-identical inside it), its schedule geometry against
the JAX mode's on the 8-device CPU mesh, and the CLI."""

import pytest
import torch

from sparkucx_tpu.perf.benchmark import measure_ici as jax_measure_ici
from sparkucx_tpu_torch.perf import benchmark
from sparkucx_tpu_torch.utils.stats import StatsAggregator


def test_measure_ici_on_cpu_matches_jax_geometry():
    stats = StatsAggregator()
    rows = []
    ours = benchmark.measure_ici(
        (2, 4, 8), 32, 8, iterations=1, stats=stats, device="cpu",
        report=lambda impl, n, it, dt, tot: rows.append((impl, n, tot)),
    )
    theirs = jax_measure_ici((2, 4, 8), 32, 8, iterations=1)
    assert ours["device"] == "cpu" and ours["slot_rows"] == theirs["slot_rows"] == 32
    assert ours["chunks_per_dest"] == theirs["chunks_per_dest"]
    assert sorted(ours["per_n"]) == sorted(theirs["per_n"]) == [2, 4, 8]
    for n, p in ours["per_n"].items():
        assert p["bit_identical"]
        assert (p["supersteps"], p["chunks"]) == (theirs["per_n"][n]["supersteps"], theirs["per_n"][n]["chunks"])
        assert p["pallas_per_link_gbps"] == pytest.approx(p["pallas_gbps"] / (2 * n))
    assert ours["fused"]["executors"] == 8 and ours["fused"]["bit_identical"]
    assert ours["fused"]["k5_launches"] == 0  # CPU tensors run K5's plain version
    assert rows == [(impl, n, 4 * n * (n - 1) * 32 * 32) for n in (2, 4, 8) for impl in ("stock", "pallas")]
    assert stats.counters("ici_n8")["supersteps"] == ours["per_n"][8]["supersteps"]


def test_cli_ici_on_cpu(capsys):
    assert benchmark.main(["ici", "-s", "8k", "-i", "1", "--executors", "3", "--chunks", "2", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "n=3: stock" in out and "fused send side (n=3)" in out and "ici_n3" in out


def test_cli_other_modes_name_the_roadmap_item(capsys):
    assert benchmark.main(["superstep"]) == 2
    assert "ROADMAP queue A item 11" in capsys.readouterr().err


def test_cli_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        benchmark.main(["ici", "-s", "8k", "-i", "1"])
