"""The port's benchmark CLI (``python -m sparkucx_tpu_torch.perf.benchmark``)
on the CPU: twins of ``tests/test_perf_cli.py`` for every ported mode, each
mode's printed lines held word for word against the JAX mode's on the same
arguments (numbers, lowering names and verdicts aside), the flags against the
JAX parser, and the refusals: the routes not ported name their ROADMAP item,
and no mode runs without a card unless ``--device cpu`` is given."""

import re

import pytest
import torch

from sparkucx_tpu.perf import benchmark as jax_bench
from sparkucx_tpu_torch.perf import benchmark

CPU = ["--device", "cpu"]


def _run(capsys, argv):
    assert benchmark.main(argv + CPU) == 0
    return capsys.readouterr().out


def _words(text: str):
    """The lines with every number, lowering name and verdict blanked."""
    out = []
    for line in text.strip().splitlines():
        line = re.sub(r"\[impl=[^\]]*\]", "[impl]", line)
        line = re.sub(r"\[(dma|xla|interpret|dense|ragged)\]", "[lowering]", line)
        line = re.sub(r"(oracle|best static) (single|q\d+)/(off|rle)", r"\1 <arm>", line)  # the fastest arm
        line = re.sub(r"[+-]?\d+(\.\d+)?", "#", line)
        out.append(re.sub(r"\b(True|False)\b", "bool", line))
    return out


@pytest.mark.parametrize("argv", [
    ["client", "-a", "h:1", "-f", "f", "-n", "2", "-s", "1k", "-i", "3", "-o", "4", "-r", "5", "-t", "6"],
    ["superstep"],
    ["sort", "--executors", "4", "--slices", "2", "--impl", "host,device", "--keys", "9", "--build-rows", "7",
     "--partial", "--join-type", "full_outer", "--sort-impl", "radix", "--batches", "3", "--depths", "1,2",
     "--streams", "2", "--chunk-bytes", "1m", "--zipf-alpha", "1.5", "--quota", "64", "--chunks", "4", "--apps", "3"],
])
def test_cli_flags_match_reference(argv):
    """Every flag of the JAX parser, same names and defaults, plus --device."""
    ours = vars(benchmark._parse_args(argv))
    assert ours.pop("device") == "cuda"
    assert ours == vars(jax_bench._parse_args(argv))
    assert vars(benchmark._parse_args(argv + CPU))["device"] == "cpu"


@pytest.mark.parametrize("argv", [
    ["superstep", "-s", "64k", "-i", "2", "-o", "2", "--executors", "4"],
    ["gather", "-n", "6", "-s", "64k", "-i", "2", "-o", "2"],
    ["write", "-n", "4", "-s", "4k", "-i", "1"],
    ["pipeline", "--executors", "4", "-n", "3", "-s", "64k", "--depths", "1,2", "-i", "1"],
    ["skew", "--executors", "4", "-s", "40k", "-i", "1"],
    ["adaptive", "--executors", "4", "-s", "256k", "-i", "1"],
    ["sort", "-n", "4096", "-i", "2", "--executors", "4"],
    ["sort", "-n", "8192", "-i", "1", "--executors", "2", "--batches", "4"],
    ["columnar", "-n", "4096", "-s", "128", "-i", "2", "-o", "2", "--executors", "4"],
    ["groupby", "-n", "4096", "-i", "2", "-o", "2", "--executors", "4", "--keys", "64"],
    ["groupby", "-n", "4096", "-i", "1", "-o", "2", "--executors", "4", "--keys", "64", "--partial"],
    ["join", "-n", "4096", "-i", "2", "-o", "2", "--executors", "4"],
    ["join", "-n", "4096", "-i", "1", "-o", "2", "--executors", "4", "--join-type", "full_outer"],
    ["combine", "--executors", "4", "-s", "8k", "--keys", "8", "-i", "1"],
], ids=lambda argv: "-".join(a.lstrip("-") for a in argv[:1] + argv[-2:]))
def test_mode_prints_the_jax_modes_lines(capsys, argv):
    ours = _run(capsys, argv)
    jax_bench.main(argv)
    theirs = capsys.readouterr().out
    assert _words(ours) == _words(theirs)


def test_superstep_mode(capsys):
    out = _run(capsys, ["superstep", "-s", "64k", "-i", "2", "-o", "2", "--executors", "4"])
    assert "impl=shared" in out  # executors sharing one device exchange through K1
    assert out.count("GB/s") == 2


def test_superstep_hierarchical_mode_names_item_4():
    with pytest.raises(NotImplementedError, match="ROADMAP queue A item 4"):
        benchmark.main(["superstep", "-s", "64k", "-i", "1", "-o", "2", "--executors", "8", "--slices", "2"] + CPU)


def test_gather_mode(capsys):
    out = _run(capsys, ["gather", "-n", "6", "-s", "64k", "-i", "2", "-o", "2"])
    assert "impl=dma" in out and out.count("GB/s") == 2


@pytest.mark.parametrize("impl", ["dma", "tiled", "auto", "xla"])
def test_gather_mode_impl_flag(capsys, impl):
    """The JAX lowering names reach the one route (K1); ``xla`` only on the CPU."""
    assert benchmark._parse_args(["gather", "--impl", impl]).impl == impl
    out = _run(capsys, ["gather", "-n", "3", "-s", "4k", "-i", "1", "-o", "1", "--impl", impl])
    assert "impl=dma" in out


def test_gather_impl_names_on_the_card():
    for impl in ("auto", "dma", "tiled", None):
        assert benchmark.resolve_gather_impl(impl, "cuda") == "dma"
    for impl in ("xla", "interpret"):
        with pytest.raises(ValueError, match="on the card"):
            benchmark.resolve_gather_impl(impl, "cuda")
    with pytest.raises(ValueError, match="unknown gather impl"):
        benchmark.resolve_gather_impl("ragged", "cpu")


def test_write_mode(capsys):
    out = _run(capsys, ["write", "-n", "4", "-s", "4k", "-i", "2", "--impl", "host,device"])
    assert out.count("via host path") == 2 and out.count("via device path") == 2
    assert "write device:" in out and "x vs host" in out


def test_pipeline_mode(capsys):
    out = _run(capsys, ["pipeline", "--executors", "2", "-n", "2", "-s", "32k", "--depths", "1,3", "-i", "1"])
    assert "pipeline depth 3:" in out and "x vs serial" in out


def test_skew_mode(capsys):
    out = _run(capsys, ["skew", "--executors", "4", "-s", "40k", "-i", "1", "--quota", "16"])
    assert "quota slot 16 rows" in out and "outputs bit-identical" in out


def test_adaptive_mode(capsys):
    out = _run(capsys, ["adaptive", "--executors", "2", "-s", "4k", "-i", "1"])
    assert out.count("cell alpha=") == 8 and "outputs bit-identical" in out


def test_sort_mode(capsys):
    out = _run(capsys, ["sort", "-n", "4096", "-i", "2", "--executors", "4"])
    assert "rows/s" in out and out.count("iter") == 2 and "impl=shared" in out


@pytest.mark.parametrize("impl", ["radix", "single", "auto", "dense"])
def test_sort_mode_one_executor(capsys, impl):
    out = _run(capsys, ["sort", "-n", "3000", "-i", "1", "-o", "2", "--sort-impl", impl])
    assert f"impl={'single' if impl in ('auto', 'dense') else impl}" in out


def test_sort_external_mode(capsys):
    out = _run(capsys, ["sort", "-n", "8192", "-i", "1", "--executors", "2", "--batches", "4"])
    assert "external-sorted" in out and "4 device batches" in out


def test_sort_routes_not_ported_name_item_4():
    with pytest.raises(NotImplementedError, match="ROADMAP queue A item 4"):
        benchmark.main(["sort", "-n", "64", "-i", "1", "--executors", "2", "--sort-impl", "ragged"] + CPU)
    with pytest.raises(ValueError, match="portable lowering"):
        benchmark.resolve_sort_impl("dense", "cuda")
    with pytest.raises(SystemExit):
        benchmark.main(["sort", "-n", "64", "--executors", "2", "--sort-impl", "radix"] + CPU)


def test_columnar_mode(capsys):
    out = _run(capsys, ["columnar", "-n", "4096", "-s", "128", "-i", "2", "-o", "2", "--executors", "4"])
    assert "impl=shared" in out and out.count("GB/s") == 2


def test_groupby_mode(capsys):
    out = _run(capsys, ["groupby", "-n", "4096", "-i", "2", "-o", "2", "--executors", "4", "--keys", "64"])
    assert "rows/s" in out and out.count("iter") == 2


def test_groupby_partial_mode(capsys):
    out = _run(capsys, ["groupby", "-n", "4096", "-i", "1", "-o", "1", "--executors", "4", "--keys", "64", "--partial"])
    assert "256 rows on the wire for 4096 input rows (16x reduction)" in out


@pytest.mark.parametrize("join_type", ["inner", "left_outer", "left_semi", "left_anti", "right_outer", "full_outer"])
def test_join_mode(capsys, join_type):
    out = _run(capsys, ["join", "-n", "4096", "-i", "2", "-o", "2", "--executors", "4", "--join-type", join_type])
    assert "rows/s" in out and out.count("iter") == 2


def test_combine_mode(capsys):
    out = _run(capsys, ["combine", "--executors", "3", "-s", "8k", "--keys", "5", "-i", "1"])
    assert "n=3: fused" in out and "bit-identical" in out and "accumulator (O(groups))" in out


@pytest.mark.parametrize("argv", [
    ["superstep"], ["pipeline"], ["gather"], ["write"], ["skew"], ["adaptive"], ["sort"],
    ["sort", "--batches", "2"], ["columnar"], ["groupby"], ["join"], ["combine"],
], ids=lambda argv: "-".join(argv))
def test_every_mode_needs_the_card_unless_told(monkeypatch, argv):
    """No mode falls back to the CPU when it finds no card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        benchmark.main(argv + ["-n", "64", "-s", "4k", "-i", "1"])
