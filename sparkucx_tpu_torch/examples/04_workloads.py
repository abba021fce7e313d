"""The reference's gate workloads — GROUP BY, hash join, SparkTC — on the device.

Port of ``examples/04_workloads.py``.  The reference validates itself by
running stock Spark examples over its transport (GroupByTest and SparkTC,
buildlib/test.sh:163-179); its BASELINE adds TPC-H-style joins.  Here the
same logical plans run as device operators over four executors sharing the
device: hash-partition exchange + segment reduction (GROUP BY; K1 a
receiver, or K4 once where the conf fuses the combine), exchange of both
sides + sort-merge match (join; K1 2n), and an iterated join/union/distinct
step (transitive closure; K1 a receiver).  Every result is checked against
a numpy oracle.

Run: python sparkucx_tpu_torch/examples/04_workloads.py [--device cpu|cuda]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import numpy as np

from sparkucx_tpu_torch.config import TpuShuffleConf
from sparkucx_tpu_torch.ops.relational import (
    AggregateSpec,
    oracle_aggregate,
    run_grouped_aggregate,
    run_hash_join,
)
from sparkucx_tpu_torch.ops.tc import TcSpec, oracle_tc, run_transitive_closure


def groupby(devices, n: int) -> None:
    # GroupByTest's shape: random keys from a small keyspace, grouped; the
    # gate's pass criterion is the distinct-key count (test.sh:163-167).
    # Map-side partial aggregation (Spark's HashAggregateExec(partial)) is
    # taken from the conf toggle, on by default — each shard exchanges at
    # most one partial row per local distinct key instead of every raw row.
    total, num_keys = 20_000, 100
    conf = TpuShuffleConf()
    rng = np.random.default_rng(5)
    keys = rng.integers(0, num_keys, size=total).astype(np.uint32)
    values = rng.integers(0, 1000, size=(total, 2)).astype(np.int32)
    spec = AggregateSpec.from_conf(
        conf,
        num_executors=n, capacity=-(-total // n), recv_capacity=4 * -(-total // n),
        aggs=("sum", "max"),
    )
    partial = spec.partial
    gk, gv, gc = run_grouped_aggregate(devices, spec, keys, values)
    wk, wv, wc = oracle_aggregate(keys, values, spec.aggs)
    assert np.array_equal(gk, wk) and np.array_equal(gv, wv) and np.array_equal(gc, wc)
    print(
        f"OK: GROUP BY over {total} rows -> {len(gk)} groups, oracle-exact "
        f"(partial aggregation {'on' if partial else 'off'}, combine {spec.combine!r})"
    )


def join(devices, n: int) -> None:
    # PK-FK inner join (TPC-H's plan shape): unique dimension keys, fact rows
    # referencing them.  run_hash_join plans receive/output capacities from
    # the real placement hash and raises precise diagnostics on divergence —
    # use it instead of hand-sizing JoinSpec buffers.
    nb, np_rows = 1_000 * n, 4_000 * n
    rng = np.random.default_rng(6)
    bkeys = rng.permutation(nb).astype(np.uint32)
    pkeys = bkeys[rng.integers(0, nb, size=np_rows)]
    bvals = rng.integers(0, 100, size=(nb, 1)).astype(np.int32)
    # probe values derive from the key so the output check can verify the
    # probe side per-row (equal-key fact rows are otherwise interchangeable)
    pvals = (pkeys.astype(np.int64) * 3 + 1).astype(np.int32)[:, None]
    jk, jb, jp = run_hash_join(devices, bkeys, bvals, pkeys, pvals)
    assert len(jk) == np_rows, f"PK-FK join must match every fact row ({len(jk)} != {np_rows})"
    # value alignment: every emitted (key, build, probe) triple must carry the
    # build table's value for that key AND the key-derived probe value
    build_of = dict(zip(bkeys.tolist(), bvals[:, 0].tolist()))
    for k, b, p in zip(jk.tolist(), jb[:, 0].tolist(), jp[:, 0].tolist()):
        assert build_of[k] == b
        assert p == k * 3 + 1
    print(f"OK: PK-FK join matched {len(jk)} fact rows, values aligned both sides")


def transitive_closure(devices, n: int) -> None:
    # SparkTC: random sparse digraph, closure by iterated join until fixpoint.
    rng = np.random.default_rng(8)
    edges = rng.integers(0, 60, size=(150, 2)).astype(np.uint32)
    want = oracle_tc(edges)
    cap = max(4096 // n, 512)
    spec = TcSpec(
        num_executors=n, edge_capacity=cap, tc_capacity=cap, join_capacity=4 * cap
    )
    pairs, rounds = run_transitive_closure(devices, spec, edges)
    assert np.array_equal(pairs, want)  # driver returns ascending-unique
    print(f"OK: transitive closure {len(want)} pairs in {rounds} rounds")


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default="cuda", choices=("cpu", "cuda"), help="where the executors run")
    args = parser.parse_args(argv)
    n = 4
    devices = [args.device] * n
    groupby(devices, n)
    join(devices, n)
    transitive_closure(devices, n)


if __name__ == "__main__":
    main()
