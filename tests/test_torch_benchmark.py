"""The port's benchmark cores (sparkucx_tpu_torch/perf/benchmark.py) on the
CPU against the JAX package's on its 8-device CPU mesh: every key that
describes the work (staged rows, wire bytes, padding fractions, bytes moved,
expected output counts, plan fields, drain bytes, launch counts) equal, the
timings each package's own.  ``ici``: ``measure_ici`` with ``device="cpu"``
(stock, pallas and the fused send side held bit-identical inside it), its
schedule geometry against the JAX mode's.  Then the CLI's refusals."""

import numpy as np
import pytest
import torch

from sparkucx_tpu.perf import benchmark as jax_bench
from sparkucx_tpu_torch.perf import benchmark
from sparkucx_tpu_torch.utils.stats import StatsAggregator


def test_measure_ici_on_cpu_matches_jax_geometry():
    stats = StatsAggregator()
    rows = []
    ours = benchmark.measure_ici(
        (2, 4, 8), 32, 8, iterations=1, stats=stats, device="cpu",
        report=lambda impl, n, it, dt, tot: rows.append((impl, n, tot)),
    )
    theirs = jax_bench.measure_ici((2, 4, 8), 32, 8, iterations=1)
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


@pytest.mark.parametrize("n, rows, alpha", [(8, 2200, 1.2), (4, 10240, 1.8), (5, 512, 0.0), (1, 7, 1.2)])
def test_zipf_size_matrix_equals_jax(n, rows, alpha):
    ours = benchmark.zipf_size_matrix(n, rows, alpha)
    theirs = jax_bench.zipf_size_matrix(n, rows, alpha)
    assert ours.dtype == theirs.dtype and np.array_equal(ours, theirs)


def test_staged_rows_reduction_on_zipf_skew():
    """``test_skew.py``'s acceptance geometry on the port's matrix: the quota
    plan stages strictly fewer rows than the single-shot pow2 bucket."""
    from sparkucx_tpu_torch.ops.skew import plan_exchange, quota_slot_rows

    n = 8
    sizes = benchmark.zipf_size_matrix(n, 2200, 1.2)
    assert int(sizes.max()) == 2200
    slot = quota_slot_rows(int(sizes.max()), 0)
    plan = plan_exchange([int(sizes.max())], slot, quota_slot_rows(slot, int(np.ceil(sizes.mean()))))
    assert plan.staged_rows(n) < n * n * slot
    assert plan.chunks_per_round[0] * plan.slot_rows >= int(sizes.max())


@pytest.mark.parametrize("rows, alpha, quota", [(80, 1.2, 0), (40, 1.8, 16), (64, 0.0, 0)])
def test_measure_skew_matches_jax(rows, alpha, quota):
    lines = []
    ours = benchmark.measure_skew(4, rows, 1, zipf_alpha=alpha, quota_rows=quota, device="cpu",
                                  report=lambda plan, it, dt, tot: lines.append((plan, tot)))
    theirs = jax_bench.measure_skew(4, rows, 1, zipf_alpha=alpha, quota_rows=quota)
    for key in ("executors", "zipf_alpha", "max_peer_rows", "quota_slot", "subrounds", "used_rows", "bit_identical"):
        assert ours[key] == theirs[key], key
    for plan in ("max", "quota"):
        for key in ("staged_rows", "wire_bytes", "padding_fraction"):
            assert ours[plan][key] == pytest.approx(theirs[plan][key], rel=0), (plan, key)
    assert lines == [("max", ours["used_rows"] * 512), ("quota", ours["used_rows"] * 512)]


def test_measure_adaptive_matches_jax_plans():
    ours = benchmark.measure_adaptive(4, 512, 1, device="cpu")
    theirs = jax_bench.measure_adaptive(4, 512, 1)
    from sparkucx_tpu.ops.skew import plan_exchange as jax_plan_exchange

    assert len(ours["cells"]) == len(theirs["cells"]) == 8
    for a, b in zip(ours["cells"], theirs["cells"]):
        assert (a["alpha"], a["entropy"], a["fault"]) == (b["alpha"], b["entropy"], b["fault"])
        assert a["adaptive_choice"] == b["adaptive_choice"]
        assert sorted(a["static_gbps"]) == sorted(b["static_gbps"])
        assert a["bit_identical"] and b["bit_identical"]
        # every schedule the cell ran stages what the JAX plan stages
        hot = 512 if a["alpha"] == 0.0 else 640
        sizes = jax_bench.zipf_size_matrix(4, hot, a["alpha"])
        slot = max(1, 1 << (int(sizes.max()) - 1).bit_length())
        for q, staged in a["staged_rows"].items():
            assert staged == jax_plan_exchange([int(sizes.max())], slot, q).staged_rows(4), q
    assert sorted(ours["aggregate_static_gbps"]) == sorted(theirs["aggregate_static_gbps"])
    assert (ours["executors"], ours["max_peer_rows"]) == (theirs["executors"], theirs["max_peer_rows"])


def test_measure_pipeline_moves_what_jax_moves():
    ours, theirs = [], []
    r = benchmark.measure_pipeline(4, 64 << 10, 3, 1, depths=(1, 2), device="cpu",
                                   report=lambda d, it, dt, tot: ours.append((d, it, tot)))
    jax_bench.measure_pipeline(4, 64 << 10, 3, 1, depths=(1, 2), report=lambda d, it, dt, tot: theirs.append((d, it, tot)))
    assert ours == theirs and sorted(r) == [1, 2]


def test_measure_gather_moves_what_jax_moves():
    ours, theirs = [], []
    benchmark.measure_gather(5, 3000, 2, 3, device="cpu", report=lambda it, dt, tot, impl: ours.append((it, tot, impl)))
    jax_bench.measure_gather(5, 3000, 2, 3, report=lambda it, dt, tot, impl: theirs.append((it, tot)))
    assert [o[:2] for o in ours] == theirs
    assert {o[2] for o in ours} == {"dma"}


def test_measure_write_reports_both_impls():
    """Twin of ``test_device_staging.py::test_measure_write_reports_both_impls``."""
    lines = []
    res = benchmark.measure_write(2, 4096, iterations=1, device="cpu",
                                  report=lambda impl, it, dt, tot: lines.append((impl, it, tot)))
    assert set(res) == {"host", "device"} == set(jax_bench.measure_write(2, 4096, iterations=1))
    assert all(v > 0 for v in res.values())
    assert lines == [("host", 0, 2 * 4096), ("device", 0, 2 * 4096)]


@pytest.mark.parametrize("partial", [False, True])
def test_measure_groupby_wire_rows_match_jax(partial):
    ours, theirs = [], []
    benchmark.measure_groupby(4, 3000, 1, outstanding=1, num_keys=50, partial=partial, wire_rows=ours, device="cpu")
    jax_bench.measure_groupby(4, 3000, 1, outstanding=1, num_keys=50, partial=partial, wire_rows=theirs)
    assert ours == theirs and len(ours) == 1


def _recording_join(module, counts):
    """``module.build_hash_join`` wrapped to record each join's emitted rows."""
    build = module.build_hash_join

    def recording(devices, spec):
        fn = build(devices, spec)

        def join(*args):
            out = fn(*args)
            counts.append(int(np.asarray(out[3].cpu() if isinstance(out[3], torch.Tensor) else out[3]).sum()))
            return out

        join.spec = fn.spec
        return join

    return recording


@pytest.mark.parametrize("join_type", ["inner", "left_outer", "left_semi", "left_anti", "right_outer", "full_outer"])
def test_measure_join_counts_match_jax(monkeypatch, join_type):
    import sparkucx_tpu.ops.relational as jax_relational
    import sparkucx_tpu_torch.ops.relational as relational

    ours, theirs = [], []
    monkeypatch.setattr(relational, "build_hash_join", _recording_join(relational, ours))
    monkeypatch.setattr(jax_relational, "build_hash_join", _recording_join(jax_relational, theirs))
    benchmark.measure_join(4, 600, 0, 1, outstanding=1, join_type=join_type, device="cpu")
    jax_bench.measure_join(4, 600, 0, 1, outstanding=1, join_type=join_type)
    assert ours == theirs and len(ours) == 2 and ours[0] > 0


@pytest.mark.parametrize("groups", [8, 300])
def test_measure_combine_matches_jax(groups):
    lines = []
    ours = benchmark.measure_combine(4, 16, groups, iterations=1, device="cpu",
                                     report=lambda impl, it, dt, tot: lines.append((impl, tot)))
    theirs = jax_bench.measure_combine(4, 16, groups, iterations=1)
    for key in ("executors", "slot_rows", "groups", "lane", "supersteps", "chunks", "bit_identical",
                "drain", "launches", "reference_launches", "reference_dispatches"):
        assert ours[key] == theirs[key], key
    assert ours["lowering"] == "dma"
    assert lines == [("fused", 4 * 4 * 3 * 16 * ours["lane"] * 4), ("unfused", 4 * 4 * 3 * 16 * ours["lane"] * 4)]


# -- the CLI's refusals -------------------------------------------------------------


def test_cli_ici_on_cpu(capsys):
    assert benchmark.main(["ici", "-s", "8k", "-i", "1", "--executors", "3", "--chunks", "2", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "n=3: stock" in out and "fused send side (n=3)" in out and "ici_n3" in out


@pytest.mark.parametrize("mode, item", sorted((m, i) for m, (i, _) in benchmark.UNPORTED.items()))
def test_cli_other_modes_name_the_roadmap_item(capsys, mode, item):
    assert benchmark.main([mode, "--device", "cpu"]) == 2
    err = capsys.readouterr().err
    assert f"ROADMAP queue A item {item} " in err and "item 9" in err


def test_unported_modes_are_exactly_the_rest():
    ported = {"superstep", "pipeline", "gather", "write", "skew", "adaptive", "sort", "columnar", "groupby",
              "join", "combine", "ici", "server", "client", "wire"}
    assert set(benchmark.UNPORTED) == set(benchmark.MODES) - ported
    assert len(benchmark.UNPORTED) == 8
    # the compress mode's end-to-end leg runs through the reader's
    # credit-pipelined fetch (item 5); its codec legs' wire and its
    # quantized leg's core, measure_quantized_ici, are ported
    assert benchmark.UNPORTED["compress"][0] == 5


def test_cli_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        benchmark.main(["ici", "-s", "8k", "-i", "1"])
