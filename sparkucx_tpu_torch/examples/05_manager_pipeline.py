"""The ShuffleManager SPI pipeline — what a host engine (Spark) drives.

Port of ``examples/05_manager_pipeline.py``.  The reference plugs into Spark
as a `ShuffleManager`: map tasks get a writer (sequential partition
streams), reduce tasks get a reader (windowed fetch + deserialize ->
aggregate -> sort).  This walkthrough drives the same SPI as a
word-count-style GroupByTest job would: partition records by key hash,
write through the writer, ONE exchange, then read each partition back
aggregated and key-ordered — checked against a host-side oracle.  The
reader's combine and sort spill to disk past ``reduceMemoryBudget``.

Run: python sparkucx_tpu_torch/examples/05_manager_pipeline.py [--device cpu|cuda]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import numpy as np

from sparkucx_tpu_torch.config import TpuShuffleConf
from sparkucx_tpu_torch.shuffle.manager import TpuShuffleManager
from sparkucx_tpu_torch.shuffle.reader import serialize_records


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default="cuda", choices=("cpu", "cuda"), help="where the executors run")
    args = parser.parse_args(argv)
    n = 2
    manager = TpuShuffleManager(
        TpuShuffleConf(num_executors=n, staging_capacity_per_executor=1 << 20),
        devices=[args.device] * n,
    )
    M, R, SID = 4, 6, 0
    manager.register_shuffle(SID, num_mappers=M, num_reducers=R)

    # Map side: each map task hash-partitions its (word, count) records and
    # writes them through the sequential-partition SPI writer.
    rng = np.random.default_rng(13)
    oracle = {}
    for m in range(M):
        records = [
            (f"word-{int(rng.integers(0, 40))}", int(rng.integers(1, 100)))
            for _ in range(300)
        ]
        for k, v in records:
            oracle[k] = oracle.get(k, 0) + v
        writer = manager.get_writer(SID, m)
        by_part = {}
        for k, v in records:
            by_part.setdefault(hash(k) % R, []).append((k, v))
        for r in sorted(by_part):
            with writer.get_partition_writer(r).open_stream() as stream:
                stream.write(serialize_records(by_part[r]))
        writer.commit_all_partitions()

    # All maps committed -> one exchange moves every block to its reducer.
    assert manager.exchange_ready(SID)
    manager.run_exchange(SID)
    print("OK: all maps committed, exchange complete")

    # Reduce side: each partition read back with combine + key ordering (the
    # deserialize -> aggregate -> sort pipeline the reference reader runs).
    got = {}
    records_read = 0
    for r in range(R):
        reader = manager.get_reader(
            SID, r, r + 1, aggregator=lambda a, b: a + b, key_ordering=True
        )
        out = list(reader.read())
        keys = [k for k, _ in out]
        assert keys == sorted(keys), "key_ordering must sort within the partition"
        for k, v in out:
            assert hash(k) % R == r, "record landed in the wrong partition"
            got[k] = v
        records_read += reader.metrics.records_read  # the Spark metric surface
    assert got == oracle, "aggregated counts diverged from the oracle"
    print(
        f"OK: {len(got)} words aggregated across {R} partitions, oracle-exact "
        f"({records_read} records through the read metrics)"
    )

    manager.unregister_shuffle(SID)
    manager.stop()


if __name__ == "__main__":
    main()
