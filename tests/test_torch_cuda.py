"""Kernel-against-plain checks for the card: the Hopper block gather and block
scatter (sparkucx_tpu_torch/csrc/block_copy.cu) against their plain PyTorch
versions on CUDA tensors, bit-exact.  Marked ``cuda``; each test skips unless
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
