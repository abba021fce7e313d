"""Kernel-against-plain checks for the card: the Hopper block gather and block
scatter (sparkucx_tpu_torch/csrc/block_copy.cu) and the radix pass
(csrc/radix_sort.cu) against their plain PyTorch versions on CUDA tensors,
bit-exact.  Marked ``cuda``; each test skips unless
a CUDA device is present (``python -m pytest tests/test_torch_cuda.py`` on the
machine with the card).  No JAX here."""

import numpy as np
import pytest
import torch

from sparkucx_tpu_torch.ops.block_kernels import (
    block_gather,
    block_gather_ref,
    block_scatter,
    block_scatter_ref,
    plan_tensors,
)
from sparkucx_tpu_torch.ops.radix import TILE_ROWS, radix_pass, radix_pass_ref, radix_sort_rows
from sparkucx_tpu_torch.ops.sort import SortSpec, build_distributed_sort

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _plan(seed, num_blocks, src_rows, max_rows):
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, max_rows, size=num_blocks).astype(np.int32)
    counts[rng.random(num_blocks) < 0.2] = 0
    starts = np.array([rng.integers(0, src_rows - c + 1) for c in counts], dtype=np.int32)
    return starts, counts, (np.cumsum(counts) - counts).astype(np.int32)


@pytest.mark.parametrize("lane", [128, 33])
@pytest.mark.parametrize("seed", [0, 1])
def test_gather_matches_plain(cuda, lane, seed):
    src = torch.randint(0, 1 << 30, (4096, lane), dtype=torch.int32, device=cuda)
    starts, counts, outs = _plan(seed, 300, 4096, 40)
    total = int(counts.sum())
    # count=0 pads pointing at the packed end are no-ops
    starts, counts, outs = (np.concatenate([a, [0, 0]]).astype(np.int32) for a in (starts, counts, outs))
    outs[-2:] = total
    s, c, o = plan_tensors(starts, counts, outs, cuda)
    before = block_gather.launches
    got = block_gather(s, c, o, src, total)
    torch.cuda.synchronize()
    assert block_gather.launches == before + 1
    assert torch.equal(got[:total], block_gather_ref(s, c, o, src, total)[:total])


@pytest.mark.parametrize("lane", [128, 33])
def test_scatter_matches_plain(cuda, lane):
    dst = torch.randint(0, 1 << 30, (4096, lane), dtype=torch.int32, device=cuda)
    counts = np.full(200, 7, dtype=np.int32)
    counts[::5] = 0
    starts = (np.arange(200) * 20).astype(np.int32)
    outs = (np.cumsum(counts) - counts).astype(np.int32)
    src = torch.randint(0, 1 << 30, (int(counts.sum()), lane), dtype=torch.int32, device=cuda)
    s, c, o = plan_tensors(starts, counts, outs, cuda)
    expected = block_scatter_ref(s, c, o, src, dst.clone())
    before = block_scatter.launches
    got = block_scatter(s, c, o, src, dst)
    torch.cuda.synchronize()
    assert got.data_ptr() == dst.data_ptr()
    assert block_scatter.launches == before + 1
    assert torch.equal(got, expected)


def test_rows_outside_the_source_are_not_copied(cuda):
    """The kernel's memory guard: a block running past the source's end copies
    its in-range rows and touches nothing outside the buffers."""
    src = torch.randint(0, 1 << 30, (100, 128), dtype=torch.int32, device=cuda)
    s, c, o = plan_tensors([90], [20], [0], cuda)
    got = block_gather(s, c, o, src, 20)
    torch.cuda.synchronize()
    assert torch.equal(got[:10], src[90:])


def _radix_rows(device, n, width, seed, sign_bit=True):
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    rows = torch.randint(-(2**31), 2**31 - 1, (n, width), dtype=torch.int32, generator=gen, device=device)
    if sign_bit and n:
        rows[::3, 0] = -1  # key 0xFFFFFFFF
        rows[1::5, 0] |= -(2**31)  # keys >= 2**31
    return rows


# N = 1 and 2; one whole tile; one row past it; a partial last tile that also
# ends inside a 256-row chunk; many tiles
@pytest.mark.parametrize("n,width", [(1, 1), (2, 2), (TILE_ROWS, 3), (TILE_ROWS + 1, 25),
                                     (3 * TILE_ROWS + 1001, 25), (100_003, 25)])
@pytest.mark.parametrize("shift", [0, 8, 24])
def test_radix_pass_matches_plain(cuda, n, width, shift):
    rows = _radix_rows(cuda, n, width, seed=n + shift)
    before = radix_pass.launches
    got = radix_pass(rows, shift)
    torch.cuda.synchronize()
    assert radix_pass.launches == before + 1
    assert torch.equal(got, radix_pass_ref(rows, shift))


def test_radix_sort_matches_library_sort(cuda):
    """Sign-bit keys and a partial last tile, float32 rows through their bits."""
    rows = _radix_rows(cuda, 300_001, 25, seed=7).view(torch.float32)
    got = radix_sort_rows(rows)
    keys = rows[:, 0].view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    want = rows.index_select(0, torch.sort(keys, stable=True).indices)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_radix_distributed_sort_on_the_card(cuda):
    n = 50_000
    gen = torch.Generator(device=cuda)
    gen.manual_seed(3)
    keys = torch.randint(0, 2**32, (n,), dtype=torch.int64, generator=gen, device=cuda)
    keys[::4] = 2**32 - 1
    payload = torch.randint(-(2**31), 2**31 - 1, (n, 24), dtype=torch.int32, generator=gen, device=cuda)
    fn = build_distributed_sort(["cuda"], SortSpec(1, n, n, impl="radix"))
    ko, po, counts = fn(keys, payload, [n - 7])
    masked = keys.clone()
    masked[n - 7 :] = 2**32 - 1
    want_k, order = torch.sort(masked, stable=True)
    want_p = payload.index_select(0, order)
    want_p[n - 7 :] = 0
    torch.cuda.synchronize()
    assert counts.tolist() == [n - 7]
    assert torch.equal(ko, want_k) and torch.equal(po, want_p)
