"""The port's page codecs (sparkucx_tpu_torch/utils/pagecodec.py) and wire
compression policy (ops/compress.py ``CompressSpec``/``encode_chunk``) held
against the JAX package's on the same seeded pages: every encoding equal byte
for byte, every decode equal, every malformed payload refused by both with
the same message.  Twins of ``tests/test_compress.py``
``TestPageCodecRoundtrip``, ``TestCodecAdversarial`` and ``TestEncodeChunk``."""

import struct

import numpy as np
import pytest

from sparkucx_tpu.ops import compress as jax_compress
from sparkucx_tpu.utils import pagecodec as jax_codec
from sparkucx_tpu_torch.config import TpuShuffleConf
from sparkucx_tpu_torch.ops.compress import CompressSpec, encode_chunk
from sparkucx_tpu_torch.utils import pagecodec
from sparkucx_tpu_torch.utils.pagecodec import (
    CODEC_DELTA,
    CODEC_DICT,
    CODEC_RAW,
    CODEC_RLE,
    CodecError,
    decode_page,
    encode_page,
)

_ALL_CODECS = (CODEC_DICT, CODEC_RLE, CODEC_DELTA)


def _pages():
    """The case matrix of ``test_compress.py``: every shape the codecs are
    tuned for, the ones they must decline (noise), word tails and degenerate
    sizes, from the same seed."""
    rng = np.random.default_rng(7)
    nwords = 4096
    alpha = np.unique(rng.integers(0, 2**32, size=97, dtype=np.uint64).astype("<u4"))
    wide = np.unique(rng.integers(0, 2**31, size=600, dtype=np.uint64).astype("<u4"))
    huge = np.unique(rng.integers(0, 2**31, size=3000, dtype=np.uint64).astype("<u4"))
    near = (np.uint32(2**31) + np.cumsum(rng.integers(-100, 100, size=nwords), dtype=np.int64).astype(np.uint32))
    wrap = ((np.arange(nwords, dtype=np.uint64) * 3 + 2**32 - 100) % 2**32).astype("<u4")
    zeros = bytes(4 * nwords)
    return {
        "dict_small": alpha[rng.integers(0, alpha.size, nwords)].tobytes(),
        "dict_wide_hash": wide[rng.integers(0, wide.size, 4 * nwords)].tobytes(),
        "dict_u16_search": huge[rng.integers(0, huge.size, 16 * nwords)].tobytes(),
        "clustered": np.repeat(alpha[:64], nwords // 64).astype("<u4").tobytes(),
        "zeros": zeros,
        "sorted": np.sort(rng.integers(0, 2**28, size=nwords, dtype=np.uint64).astype("<u4")).tobytes(),
        "near_seq": near.astype("<u4").tobytes(),
        "wrap_delta": wrap.tobytes(),
        "noise": rng.integers(0, 256, size=4 * nwords, dtype=np.uint8).tobytes(),
        "tail1": zeros + b"\x01",
        "tail2": zeros + b"\x01\x02",
        "tail3": zeros + b"\x01\x02\x03",
        "one_word": b"\xde\xad\xbe\xef",
        "tail_only": b"\x01\x02\x03",
    }


def _same_encoding(codec_id, page):
    """Both packages' encodings of ``page``, equal; the port's round-trips."""
    ours, theirs = encode_page(codec_id, page), jax_codec.encode_page(codec_id, page)
    assert ours == theirs
    if ours is not None:
        assert len(ours) < len(page)
        out = bytearray(len(page))
        decode_page(codec_id, ours, out)
        assert bytes(out) == page
    return ours


def _same_decode(codec_id, payload, size):
    """Both packages decode ``payload`` into ``size`` bytes alike: the same
    bytes, or both refuse it with the same message."""
    results = []
    for decode, error in ((decode_page, CodecError), (jax_codec.decode_page, jax_codec.CodecError)):
        out = bytearray(size)
        try:
            decode(codec_id, payload, out)
            results.append(("ok", bytes(out)))
        except error as e:
            results.append(("error", str(e)))
    assert results[0] == results[1]
    return results[0]


def test_wire_ids_match_the_jax_package():
    assert (CODEC_RAW, CODEC_DICT, CODEC_RLE, CODEC_DELTA) == (
        jax_codec.CODEC_RAW, jax_codec.CODEC_DICT, jax_codec.CODEC_RLE, jax_codec.CODEC_DELTA)
    assert pagecodec.WIRE_CODECS == jax_codec.WIRE_CODECS
    assert pagecodec.CODEC_NAMES == jax_codec.CODEC_NAMES


class TestPageCodecRoundtrip:
    @pytest.mark.parametrize("codec_id", _ALL_CODECS)
    @pytest.mark.parametrize("name", sorted(_pages()))
    def test_case_matrix_encodes_as_the_jax_package(self, codec_id, name):
        _same_encoding(codec_id, _pages()[name])

    def test_expected_pages_actually_compress(self):
        pages = _pages()
        assert len(_same_encoding(CODEC_DICT, pages["dict_small"])) < len(pages["dict_small"]) // 3
        assert _same_encoding(CODEC_DICT, pages["dict_wide_hash"]) is not None
        assert _same_encoding(CODEC_DICT, pages["dict_u16_search"]) is not None
        assert len(_same_encoding(CODEC_RLE, pages["clustered"])) < len(pages["clustered"]) // 20
        assert len(_same_encoding(CODEC_RLE, pages["zeros"])) < 32
        assert _same_encoding(CODEC_DELTA, pages["sorted"]) is not None
        assert len(_same_encoding(CODEC_DELTA, pages["near_seq"])) < len(pages["near_seq"]) // 3
        assert _same_encoding(CODEC_DELTA, pages["wrap_delta"]) is not None

    @pytest.mark.parametrize("codec_id", _ALL_CODECS)
    def test_noise_and_degenerates_fall_back(self, codec_id):
        pages = _pages()
        for name in ("noise", "one_word", "tail_only"):
            assert _same_encoding(codec_id, pages[name]) is None, name
        assert _same_encoding(codec_id, b"") is None

    @pytest.mark.parametrize("codec_id", _ALL_CODECS)
    def test_random_fuzz_encodes_as_the_jax_package(self, codec_id, rng):
        for _ in range(30):
            n = int(rng.integers(0, 2000))
            kind = rng.integers(0, 3)
            if kind == 0:  # low-cardinality words + tail
                page = rng.integers(0, 9, size=(n + 3) // 4, dtype=np.uint64).astype("<u4").tobytes()[:n]
            elif kind == 1:  # runs
                page = (b"\x07\x00\x00\x00" * ((n + 3) // 4))[:n]
            else:  # raw noise
                page = rng.integers(0, 256, size=n, dtype=np.uint8).tobytes()
            _same_encoding(codec_id, page)

    def test_raw_codec_copies_exactly(self):
        page = b"raw-page-payload" * 9
        assert _same_decode(CODEC_RAW, page, len(page)) == ("ok", page)
        assert encode_page(CODEC_RAW, page) is None


class TestCodecAdversarial:
    @pytest.mark.parametrize("codec_id", _ALL_CODECS)
    def test_mutations_decode_as_the_jax_package(self, codec_id, rng):
        pages = _pages()
        source = {CODEC_DICT: pages["dict_small"], CODEC_RLE: pages["clustered"],
                  CODEC_DELTA: pages["near_seq"]}[codec_id]
        enc = encode_page(codec_id, source)
        for bad in (enc[: len(enc) // 2], enc[:-1], enc + b"\x00", enc + enc, b""):
            assert _same_decode(codec_id, bad, len(source))[0] == "error"
        for _ in range(60):
            buf = bytearray(enc)
            for _ in range(int(rng.integers(1, 4))):
                buf[int(rng.integers(0, len(buf)))] ^= int(rng.integers(1, 256))
            _same_decode(codec_id, bytes(buf), len(source))

    @pytest.mark.parametrize("codec_id, payload, size, match", [
        (CODEC_RLE, struct.pack("<I", 2) + np.array([1, 1], "<u4").tobytes() + np.array([7, 9], "<u4").tobytes(),
         12, "expand"),
        (CODEC_RLE, struct.pack("<I", 2**30), 64, "payload"),
        (CODEC_DICT, struct.pack("<IIB", 1, 1, 1) + struct.pack("<I", 42) + b"\x05", 4, "range"),
        (CODEC_DICT, struct.pack("<IIB", 1, 1, 3) + struct.pack("<I", 42) + b"\x00", 4, "width"),
        (CODEC_DICT, struct.pack("<IIB", 1, 0, 1) + b"\x00", 4, "dictionary"),
        (CODEC_DICT, struct.pack("<IIB", 9, 1, 1) + struct.pack("<I", 42) + b"\x00" * 9, 4, "claims"),
        (CODEC_DELTA, struct.pack("<IIB", 2, 0, 0) + b"\x00" * 8, 8, "width"),
        (CODEC_DELTA, struct.pack("<IIB", 2, 0, 4) + b"\x00" * 8, 8, "width"),
        (CODEC_DELTA, struct.pack("<IIB", 2, 0, 255) + b"\x00" * 8, 8, "width"),
        (CODEC_DELTA, struct.pack("<IIB", 0, 0, 1), 8, "zero"),
        (CODEC_DELTA, struct.pack("<IIB", 4, 0, 2) + b"\x00" * 3, 16, "payload"),
        (CODEC_RAW, b"abc", 4, "raw"),
        (99, b"abc", 3, "unknown"),
    ])
    def test_malformed_pages_refused_as_the_jax_package(self, codec_id, payload, size, match):
        with pytest.raises(CodecError, match=match):
            decode_page(codec_id, payload, bytearray(size))
        assert _same_decode(codec_id, payload, size)[0] == "error"

    def test_unknown_encoder_and_error_type(self):
        with pytest.raises(ValueError, match="unknown"):
            encode_page(99, b"abcd")
        assert issubclass(CodecError, ValueError)


class TestEncodeChunk:
    def test_off_spec_never_encodes(self):
        assert encode_chunk(CompressSpec(), bytes(1 << 16)) == (CODEC_RAW, None)

    @pytest.mark.parametrize("codec", ["dict", "rle", "delta"])
    @pytest.mark.parametrize("size", [0, 4095, 4096, 8193])
    def test_chunks_encode_as_the_jax_package(self, codec, size):
        page = np.repeat(np.arange(size // 64 + 1, dtype="<u4"), 16).tobytes()[:size]
        ours = encode_chunk(CompressSpec(codec=codec), page)
        assert ours == jax_compress.encode_chunk(jax_compress.CompressSpec(codec=codec), page)
        assert ours[0] == (CODEC_RAW if ours[1] is None else pagecodec.WIRE_CODECS[codec])

    def test_min_chunk_gate(self):
        spec = CompressSpec(codec="rle", min_chunk_bytes=4096)
        assert encode_chunk(spec, bytes(4095)) == (CODEC_RAW, None)
        cid, enc = encode_chunk(spec, bytes(4096))
        assert cid == CODEC_RLE and enc is not None and len(enc) < 4096

    def test_incompressible_falls_back_raw(self):
        noise = np.random.default_rng(3).integers(0, 256, 8192, np.uint8).tobytes()
        assert encode_chunk(CompressSpec(codec="dict", min_chunk_bytes=0), noise) == (CODEC_RAW, None)

    def test_from_conf_and_validation(self):
        spec = CompressSpec.from_conf(TpuShuffleConf(wire_compress_codec="delta", compress_min_chunk_bytes=1024))
        assert spec.codec == "delta" and spec.min_chunk_bytes == 1024
        assert spec.enabled and spec.codec_id == CODEC_DELTA
        assert not CompressSpec().enabled
        with pytest.raises(ValueError, match="codec"):
            CompressSpec(codec="zstd").validate()
        with pytest.raises(ValueError, match="min_chunk_bytes"):
            CompressSpec(codec="rle", min_chunk_bytes=-1).validate()
        with pytest.raises(ValueError, match="wire_compress_codec"):
            TpuShuffleConf(wire_compress_codec="zstd").validate()
