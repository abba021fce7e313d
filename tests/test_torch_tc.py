"""The port's transitive closure (sparkucx_tpu_torch/ops/tc.py) against the JAX
package's (sparkucx_tpu/ops/tc.py on the virtual CPU mesh of
tests/conftest.py): every case of tests/test_tc.py through both drivers,
one step's whole output buffers, and the pair hash and the DISTINCT on keys
>= 2**31 and the 0xFFFFFFFF padding.

Tolerance: none; vertex ids, counts and overflow reports are integers and
equal bit for bit (closures in order, each step's buffers whole)."""

import functools
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from sparkucx_tpu.ops import exchange as jax_exchange
from sparkucx_tpu.ops import tc as jtc
from sparkucx_tpu_torch.ops import tc as ttc

N_EXEC = 4
KEY_MAX = 0xFFFFFFFF


@functools.lru_cache(maxsize=None)
def _mesh(n):
    return jax_exchange.make_mesh(n)


def _kw(n=N_EXEC, edge_cap=256, tc_cap=2048, join_cap=4096, **kw):
    return dict(num_executors=n, edge_capacity=edge_cap, tc_capacity=tc_cap, join_capacity=join_cap, **kw)


def _both(edges, n=N_EXEC, max_rounds=64, **kw):
    """Both drivers' results, or the exception type each raised."""
    out = []
    for run in (
        lambda: jtc.run_transitive_closure(_mesh(n), jtc.TcSpec(impl="dense", **_kw(n, **kw)), edges, max_rounds),
        lambda: ttc.run_transitive_closure(["cpu"] * n, ttc.TcSpec(**_kw(n, **kw)), edges, max_rounds),
    ):
        try:
            out.append(run())
        except (RuntimeError, ValueError) as e:
            out.append((type(e), str(e).split(" (")[0]))
    return out


def _chain(k):
    return np.array([(i, i + 1) for i in range(k)], np.uint32)


_GRAPHS = {
    "chain": (_chain(9), {}),
    "cycle": (np.array([(0, 1), (1, 2), (2, 3), (3, 0)], np.uint32), {}),
    "random_seed0": (np.random.default_rng(0).integers(0, 24, size=(60, 2), dtype=np.uint32), {}),
    "random_seed1": (np.random.default_rng(1).integers(0, 24, size=(60, 2), dtype=np.uint32), {}),
    "already_closed": (np.array([(0, 1), (0, 2), (1, 2)], np.uint32), {}),
    "duplicates_self_loops": (np.array([(0, 1), (0, 1), (1, 1), (1, 2)], np.uint32), {}),
    "keys_past_2_31": ((np.random.default_rng(2).integers(0, 24, size=(60, 2)) * 97 + 2**31).astype(np.uint32), {}),
    "capacity_overflow": (_chain(11), dict(tc_cap=4, join_cap=8)),
    "non_convergence": (_chain(19), dict(max_rounds=5)),
    "vertex_id_guard": (np.array([(0, KEY_MAX)], np.uint32), {}),
    "edge_recv_overflow": (_chain(40), dict(edge_cap=16, edge_recv_capacity=4)),
}


@pytest.mark.parametrize("graph", list(_GRAPHS))
def test_run_transitive_closure_matches_jax(graph):
    edges, kw = _GRAPHS[graph]
    j, t = _both(edges, **kw)
    if isinstance(j[0], type):
        assert t == j, (t, j)  # the same exception and message
        assert graph in ("capacity_overflow", "non_convergence", "vertex_id_guard", "edge_recv_overflow")
        return
    assert np.array_equal(t[0], j[0]) and t[0].dtype == j[0].dtype == np.uint32
    assert t[1] == j[1], "rounds"
    assert np.array_equal(t[0], ttc.oracle_tc(edges))
    if graph == "chain":
        assert len(t[0]) == 45
    if graph == "already_closed":
        assert t[1] == 1


@pytest.mark.parametrize("n", [1, 2, 8])
def test_executor_counts_match_jax(n):
    edges = np.random.default_rng(n).integers(0, 30, size=(70, 2), dtype=np.uint32)
    j, t = _both(edges, n=n)
    assert np.array_equal(t[0], j[0]) and t[1] == j[1]


def test_one_step_whole_buffers_match_jax():
    """The prep and two steps of both packages: every output whole, padding
    and overflow reports included."""
    n = N_EXEC
    kw = _kw(edge_cap=32, tc_cap=128, join_cap=256)
    edges = np.unique(np.random.default_rng(5).integers(0, 20, size=(50, 2), dtype=np.uint32), axis=0)
    mesh = _mesh(n)
    ks = NamedSharding(mesh, P("ex"))
    jspec, tspec = jtc.TcSpec(impl="dense", **kw), ttc.TcSpec(**kw)

    def deal(cap):
        a = np.full(n * cap, KEY_MAX, np.uint32)
        b = np.full(n * cap, KEY_MAX, np.uint32)
        num = np.zeros(n, np.int32)
        for s in range(n):
            mine = edges[s::n]
            a[s * cap : s * cap + len(mine)], b[s * cap : s * cap + len(mine)] = mine[:, 0], mine[:, 1]
            num[s] = len(mine)
        return a, b, num

    ea, eb, en = deal(32)
    jprep = jtc.build_tc_prep(mesh, jspec)(*(jax.device_put(x, ks) for x in (ea, eb, en)))
    tprep = ttc.build_tc_prep(["cpu"] * n, tspec)(torch.from_numpy(ea.astype(np.int64)),
                                                   torch.from_numpy(eb.astype(np.int64)), en)
    assert np.array_equal(tprep[0].numpy(), np.asarray(jprep[0]).astype(np.int64)), "sorted keys"
    assert np.array_equal(tprep[1].numpy(), np.asarray(jprep[1]).astype(np.int64)), "sorted dsts"
    assert np.array_equal(tprep[2], np.asarray(jprep[2])) and np.array_equal(tprep[3], np.asarray(jprep[3]))

    ta, tb, tn = deal(128)
    jstate = tuple(jax.device_put(x, ks) for x in (ta, tb, tn))
    tstate = (torch.from_numpy(ta.astype(np.int64)), torch.from_numpy(tb.astype(np.int64)), tn)
    jstep = jtc.build_tc_step(mesh, jspec)
    tstep = ttc.build_tc_step(["cpu"] * n, tspec)
    for _ in range(2):
        jo = [np.asarray(o) for o in jstep(*jstate, *jprep[:3])]
        to = tstep(*tstate, *tprep[:3])
        for k, name in enumerate(("tc_a", "tc_b", "tc_num", "global_count", "overflow")):
            assert np.array_equal(to[k].numpy(), jo[k].astype(to[k].numpy().dtype).reshape(to[k].shape)), name
        jstate = tuple(jax.device_put(x, ks) for x in jo[:3])
        tstate = to[:3]


def test_pair_mix_matches_jax_past_2_31():
    rng = np.random.default_rng(7)
    a = rng.integers(0, 2**32, size=4096, dtype=np.uint64).astype(np.uint32)
    b = rng.integers(0, 2**32, size=4096, dtype=np.uint64).astype(np.uint32)
    a[:3] = (KEY_MAX, KEY_MAX, 2**31)
    b[:3] = (KEY_MAX, 0, KEY_MAX)
    want = np.asarray(jtc._pair_mix(jnp.asarray(a), jnp.asarray(b)))
    got = ttc._pair_mix(torch.from_numpy(a.astype(np.int64)), torch.from_numpy(b.astype(np.int64)))
    assert got.dtype == torch.int64 and np.array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("n", [1, 3])
def test_lex_dedup_matches_jax_past_2_31(n):
    """Keys >= 2**31 and valid 0xFFFFFFFF pairs beside the padding, with
    duplicates, a scattered validity, and out_rows below the distinct count
    on one executor (the count reports the truth; the rest is dropped)."""
    rng = np.random.default_rng(11 + n)
    rows, out_rows = 64, 24
    pool = np.array([0, 1, 2**31 - 1, 2**31, 2**32 - 2, KEY_MAX], np.uint64)
    a = pool[rng.integers(0, len(pool), n * rows)].astype(np.uint32)
    b = pool[rng.integers(0, len(pool), n * rows)].astype(np.uint32)
    valid = rng.random(n * rows) < 0.8
    ta, tb, tcount = ttc._lex_dedup(n, torch.from_numpy(a.astype(np.int64)), torch.from_numpy(b.astype(np.int64)),
                                     torch.from_numpy(valid), out_rows)
    for s in range(n):
        sl = slice(s * rows, (s + 1) * rows)
        ja, jb, jc = jtc._lex_dedup(jnp.asarray(a[sl]), jnp.asarray(b[sl]), jnp.asarray(valid[sl]), out_rows)
        out = slice(s * out_rows, (s + 1) * out_rows)
        assert np.array_equal(ta[out].numpy(), np.asarray(ja).astype(np.int64))
        assert np.array_equal(tb[out].numpy(), np.asarray(jb).astype(np.int64))
        assert int(tcount[s]) == int(jc)


def test_spec_and_entry_points(monkeypatch):
    with pytest.raises(NotImplementedError):
        ttc.TcSpec(**_kw(impl="ragged")).validate()
    with pytest.raises(ValueError, match="impl"):
        ttc.TcSpec(**_kw(impl="dense")).validate()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (ttc.build_tc_prep, ttc.build_tc_step):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            build(None, ttc.TcSpec(**_kw()))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttc.run_transitive_closure(None, ttc.TcSpec(**_kw()), _chain(3))


def test_tc_module_imports_without_jax():
    probe = "import sys, sparkucx_tpu_torch.ops.tc; " + (
        "print('LOADED', sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'sparkucx_tpu')))"
    )
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True, text=True, timeout=300, check=True)
    assert "LOADED []" in out.stdout, out.stdout + out.stderr
