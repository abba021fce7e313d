"""Out-of-core TeraSort: sorting a dataset larger than one device batch.

Port of ``examples/06_external_sort.py``.  ``run_external_sort`` chains
full-capacity device sorts — one built sort reused across batches — and
merges the sorted runs on the host, moving only (key, index) pairs through
the merge levels and placing each run's payload once.  Four executors share
the device; ``impl='auto'`` resolves to the sample sort (K1 once a
receiver).

Run: python sparkucx_tpu_torch/examples/06_external_sort.py [--device cpu|cuda]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import numpy as np

from sparkucx_tpu_torch.ops.sort import SortSpec, oracle_sort, run_external_sort


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default="cuda", choices=("cpu", "cuda"), help="where the executors run")
    args = parser.parse_args(argv)
    n = 4
    cap = 2_000                      # per-executor device capacity per batch
    total = 6 * n * cap + 123        # ~6 device batches, ragged tail
    rng = np.random.default_rng(17)
    keys = rng.integers(0, 1 << 32, size=total, dtype=np.uint32)
    payload = rng.integers(-(2**31), 2**31, size=(total, 24), dtype=np.int32)

    spec = SortSpec(
        num_executors=n, capacity=cap,
        recv_capacity=cap if n == 1 else 2 * cap, width=24,
    )
    out_keys, out_payload = run_external_sort([args.device] * n, spec, keys, payload)

    want_keys, want_payload = oracle_sort(keys, payload)
    assert np.array_equal(out_keys, want_keys)
    assert np.array_equal(out_payload, want_payload)  # stable across batch merges
    batches = -(-total // (n * cap))
    print(
        f"OK: {total} rows sorted through {batches} device batches of "
        f"{n * cap} rows (impl={spec.resolve_impl().impl!r}) + host merge, row-exact vs the oracle"
    )


if __name__ == "__main__":
    main()
