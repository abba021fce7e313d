"""TeraSort on the device: the whole job, not just the shuffle transport.

Port of ``examples/03_terasort.py``.  The reference accelerates only the
block-fetch layer under Spark's sortByKey; here sampling, range
partitioning, the exchange and both local sorts run on the device over four
executors sharing it (ops/sort.py; ``impl='auto'`` resolves to the sample
sort, whose exchange is K1 once a receiver).  The host driver handles the
one data-dependent decision — splitter-skew overflow — by re-running with
doubled receive headroom.

Run: python sparkucx_tpu_torch/examples/03_terasort.py [--device cpu|cuda]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import numpy as np

from sparkucx_tpu_torch.ops.sort import SortSpec, oracle_sort, run_distributed_sort


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default="cuda", choices=("cpu", "cuda"), help="where the executors run")
    args = parser.parse_args(argv)
    n = 4
    total = 40_000  # 100 B rows: uint32 key + 24 int32 payload lanes
    rng = np.random.default_rng(3)
    keys = rng.integers(0, 1 << 32, size=total, dtype=np.uint32)
    payload = rng.integers(-(2**31), 2**31, size=(total, 24), dtype=np.int32)

    spec = SortSpec(
        num_executors=n,
        capacity=-(-total // n),
        recv_capacity=2 * -(-total // n),  # headroom over the balanced share
        width=24,
    )
    out_keys, out_payload = run_distributed_sort([args.device] * n, spec, keys, payload)

    want_keys, want_payload = oracle_sort(keys, payload)
    assert np.array_equal(out_keys, want_keys)
    assert np.array_equal(out_payload, want_payload)  # stable: payloads row-exact
    print(f"OK: {total} rows sorted across {n} executors (impl={spec.resolve_impl().impl!r}), "
          "row-exact vs the oracle")


if __name__ == "__main__":
    main()
