"""The port's staged store (sparkucx_tpu_torch/store/hbm_store.py) against the
JAX package's ``HbmBlockStore`` fed the same writes.

Host staging (``MapWriter.write_partition``) and device staging
(``write_partition_device``, placed by the block scatter at seal) must give
byte-identical sealed payloads, size rows and ``MapperInfo.pack()`` blobs on
both sides — one round or several (region overflow rolls the round over, into
the ``np.memmap`` disk tier when ``spill_to_disk``).  Exact comparison."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparkucx_tpu.config import TpuShuffleConf as JaxConf
from sparkucx_tpu.core.operation import TransportError as JaxTransportError
from sparkucx_tpu.store.hbm_store import HbmBlockStore as JaxStore
from sparkucx_tpu_torch.config import TpuShuffleConf
from sparkucx_tpu_torch.core.operation import TransportError
from sparkucx_tpu_torch.store.hbm_store import HbmBlockStore, default_peer_ranges

ALIGN = 128
LANE = ALIGN // 4
M, R, PEERS = 5, 6, 2


def _rows(payload: bytes) -> np.ndarray:
    """Bytes -> (rows, lane) int32, zero-padded tail: the device write unit."""
    buf = np.zeros(-(-len(payload) // ALIGN) * ALIGN, dtype=np.uint8)
    buf[: len(payload)] = np.frombuffer(payload, dtype=np.uint8)
    return buf.view(np.int32).reshape(-1, LANE)


def _payloads(seed):
    rng = np.random.default_rng(seed)
    return {
        (m, r): rng.integers(0, 256, size=int(rng.integers(0, 700)), dtype=np.uint8).tobytes()
        for m in range(M)
        for r in range(R)
    }


def _conf(cls, device, cap, spill, tmp_path):
    return cls(
        staging_capacity_per_executor=cap,
        block_alignment=ALIGN,
        device_staging=device,
        spill_to_disk=spill,
        spill_dir=str(tmp_path),
    )


def _write(store, payloads, device, as_rows):
    store.create_shuffle(0, M, R, peer_ranges=default_peer_ranges(R, PEERS))
    blobs = []
    for m in range(M):
        w = store.map_writer(0, m)
        for r in range(R):
            data = payloads[(m, r)]
            if device:
                w.write_partition_device(r, as_rows(_rows(data)), length=len(data))
            else:
                w.write_partition(r, data)
        blobs.append(w.commit().pack())
    return blobs


@pytest.mark.parametrize("spill", [True, False])
@pytest.mark.parametrize("cap", [64 << 10, 4 << 10], ids=["one_round", "rollover"])
@pytest.mark.parametrize("device", [False, True], ids=["host", "device"])
def test_sealed_rounds_match_jax(device, cap, spill, tmp_path):
    payloads = _payloads(seed=5)
    theirs = JaxStore(_conf(JaxConf, device, cap, spill, tmp_path / "jax"))
    ours = HbmBlockStore(_conf(TpuShuffleConf, device, cap, spill, tmp_path / "torch"), device="cpu")
    their_blobs = _write(theirs, payloads, device, jnp.asarray)
    our_blobs = _write(ours, payloads, device, torch.from_numpy)
    assert our_blobs == their_blobs
    if cap < (64 << 10):
        assert ours.num_rounds(0) > 1  # the small capacity really rolled over
    assert ours.host_staging_allocated(0) is (not device)

    # pre-seal reads serve staging, rollover snapshots or device blocks
    for (m, r), data in payloads.items():
        assert ours.read_block(0, m, r) == data
    their_sealed = theirs.seal(0)
    our_sealed = ours.seal(0)
    assert len(our_sealed) == len(their_sealed) == ours.num_rounds(0)
    for (tp, ts), (jp, js) in zip(our_sealed, their_sealed):
        assert isinstance(tp, torch.Tensor) and tp.dtype == torch.int32
        assert np.array_equal(tp.numpy(), np.asarray(jp))
        assert np.array_equal(ts, js) and ts.dtype == js.dtype
    for (m, r), data in payloads.items():
        assert ours.read_block(0, m, r) == data
        assert ours.block_length(0, m, r) == len(data)
    ours.close()
    theirs.close()


@pytest.mark.parametrize("first_device", [False, True])
def test_mixing_host_and_device_writes_raises_like_jax(first_device, tmp_path):
    errors = []
    for cls, store_cls, err_cls, as_rows in (
        (JaxConf, JaxStore, JaxTransportError, jnp.asarray),
        (TpuShuffleConf, HbmBlockStore, TransportError, torch.from_numpy),
    ):
        store = store_cls(_conf(cls, True, 64 << 10, False, tmp_path))
        store.create_shuffle(0, 2, 2)
        first, second = store.map_writer(0, 0), store.map_writer(0, 1)
        if first_device:
            first.write_partition_device(0, as_rows(_rows(b"x" * 200)))
            with pytest.raises(err_cls) as info:
                second.write_partition(0, b"y" * 10)
        else:
            first.write_partition(0, b"y" * 10)
            with pytest.raises(err_cls) as info:
                second.write_partition_device(0, as_rows(_rows(b"x" * 200)))
        errors.append(str(info.value))
    assert errors[0] == errors[1]


def test_device_write_validates_rows(tmp_path):
    store = HbmBlockStore(_conf(TpuShuffleConf, True, 64 << 10, False, tmp_path), device="cpu")
    store.create_shuffle(0, 1, 2)
    w = store.map_writer(0, 0)
    with pytest.raises(TransportError, match="int32 tensor"):
        w.write_partition_device(0, torch.zeros((2, LANE + 1), dtype=torch.int32))
    with pytest.raises(TransportError, match="int32 tensor"):
        w.write_partition_device(0, np.zeros((2, LANE), dtype=np.int32))
    with pytest.raises(TransportError, match="inconsistent"):
        w.write_partition_device(0, torch.zeros((2, LANE), dtype=torch.int32), length=ALIGN)
    with pytest.raises(TransportError, match="increasing"):
        w.write_partition_device(1, torch.zeros((1, LANE), dtype=torch.int32))
        w.write_partition_device(0, torch.zeros((1, LANE), dtype=torch.int32))


def test_retry_attempt_keeps_first_commit(tmp_path):
    store = HbmBlockStore(_conf(TpuShuffleConf, False, 64 << 10, False, tmp_path), device="cpu")
    store.create_shuffle(0, 1, 2)
    w = store.map_writer(0, 0)
    w.write_partition(1, b"first")
    first = w.commit()
    retry = store.map_writer(0, 0)
    assert retry.is_retry_discard
    retry.write_partition(1, b"second attempt")
    assert retry.commit() == first
    assert store.read_block(0, 0, 1) == b"first"


def test_spill_files_are_removed_with_the_shuffle(tmp_path):
    store = HbmBlockStore(_conf(TpuShuffleConf, False, 4 << 10, True, tmp_path), device="cpu")
    _write(store, _payloads(seed=8), False, None)
    assert store.num_rounds(0) > 1
    assert any(tmp_path.rglob("*.bin"))
    store.remove_shuffle(0)
    assert not any(tmp_path.rglob("*.bin"))
    store.close()
    assert not any(tmp_path.iterdir())
