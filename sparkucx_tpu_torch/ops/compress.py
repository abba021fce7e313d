"""Payload reduction for the data plane: lossless page codecs (tier a) and
lossy block quantization of float exchange payloads (tier b).

Port of ``sparkucx_tpu/ops/compress.py``.

**Tier (a)** (``CompressSpec``, ``encode_chunk``) is the wire compression
policy, host code over the page codecs of ``utils/pagecodec.py``: which codec,
and the min-page gate under which a page ships raw.  Lossless always; the
encoded bytes equal the JAX package's.

**Tier (b)** (``QuantizeSpec``, ``_block_scales``, ``quantize_rows``,
``dequantize_rows``) runs as torch ops.  Aggregate-tolerant float payloads (the GROUP BY's partial
rows, ops/relational.py) travel as int8 with one float32 scale per
``block_size`` values.  ``int8`` uses a linear scale (|err| <= amax/254),
``blockfloat`` a power-of-two shared exponent (|err| <= amax/127, scales
exact).  Keys and counts are never quantized.

Quantized row layout, bit for bit the JAX package's: for a float row of
width ``w`` and block size ``B`` (a multiple of 4), ``wq = ceil(w/B)*B``
padded values pack 4 int8 per int32 word (byte k of word i is value
``4*i + k``, little end first) — ``wq//4`` words — followed by ``nb = wq//B``
per-block float32 scales whose bits are the int32 words.  The packing is a
view of the int8 values as int32 words, so it holds on little-endian hosts
and devices (x86, Arm, every CUDA card).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from sparkucx_tpu_torch.utils.pagecodec import CODEC_RAW, WIRE_CODECS, encode_page

QUANTIZE_MODES = ("off", "int8", "blockfloat")


# ----------------------------------------------------------------------------
# Tier (a): lossless wire compression policy
# ----------------------------------------------------------------------------


@dataclass(frozen=True)
class CompressSpec:
    """Static description of the wire compression policy (tier a).

    ``codec``: 'off' | 'dict' | 'rle' | 'delta' (conf ``compress.codec``).
    ``min_chunk_bytes``: pages smaller than this ship raw without attempting
    an encode — below a few KiB the header + call overhead beats any shrink.
    """

    codec: str = "off"
    min_chunk_bytes: int = 4096

    @classmethod
    def from_conf(cls, conf) -> "CompressSpec":
        spec = cls(codec=conf.wire_compress_codec, min_chunk_bytes=conf.compress_min_chunk_bytes)
        spec.validate()
        return spec

    def validate(self) -> None:
        if self.codec != "off" and self.codec not in WIRE_CODECS:
            raise ValueError(f"unknown compress codec {self.codec!r}")
        if self.min_chunk_bytes < 0:
            raise ValueError("min_chunk_bytes must be >= 0")

    @property
    def enabled(self) -> bool:
        return self.codec != "off"

    @property
    def codec_id(self) -> int:
        return WIRE_CODECS[self.codec] if self.enabled else CODEC_RAW


def encode_chunk(spec: CompressSpec, data) -> Tuple[int, Optional[bytes]]:
    """Encode one wire page under ``spec``.

    Returns ``(codec_id, encoded)``; ``encoded is None`` means "ship the raw
    slice" (codec off, page under the min-size gate, or encoding didn't
    shrink it) and the returned codec id is :data:`CODEC_RAW`."""
    if not spec.enabled or len(data) < spec.min_chunk_bytes:
        return CODEC_RAW, None
    encoded = encode_page(spec.codec_id, data)
    if encoded is None:
        return CODEC_RAW, None
    return spec.codec_id, encoded


# ----------------------------------------------------------------------------
# Tier (b): lossy block quantization
# ----------------------------------------------------------------------------


@dataclass(frozen=True)
class QuantizeSpec:
    """Static description of the lossy quantization policy (tier b).

    ``mode``: 'off' | 'int8' | 'blockfloat' (conf ``quantize.mode``).
    ``block_size``: values per scale block along the row; multiple of 4
    (int8x4-in-int32 packing granularity)."""

    mode: str = "off"
    block_size: int = 128

    @classmethod
    def from_conf(cls, conf) -> "QuantizeSpec":
        spec = cls(mode=conf.quantize_mode, block_size=conf.quantize_block_size)
        spec.validate()
        return spec

    def validate(self) -> None:
        if self.mode not in QUANTIZE_MODES:
            raise ValueError(f"unknown quantize mode {self.mode!r}")
        if self.block_size <= 0 or self.block_size % 4:
            raise ValueError("quantize block_size must be a positive multiple of 4")

    @property
    def enabled(self) -> bool:
        return self.mode != "off"

    def padded_width(self, w: int) -> int:
        """Float width padded up to a whole number of blocks."""
        return -(-w // self.block_size) * self.block_size

    def num_blocks(self, w: int) -> int:
        return self.padded_width(w) // self.block_size

    def quantized_width(self, w: int) -> int:
        """int32 lanes of the quantized payload: packed int8 words + scales."""
        return self.padded_width(w) // 4 + self.num_blocks(w)

    def error_bound(self, amax: float) -> float:
        """Per-element absolute error bound for a block whose max |value| is
        ``amax``."""
        if self.mode == "int8":
            return amax / 254.0  # scale = amax/127, round error <= scale/2
        if self.mode == "blockfloat":
            return amax / 127.0  # scale <= 2*amax/127 (pow2 ceil), err <= scale/2
        return 0.0


#: float32 1/127: inside a jit, XLA folds the JAX package's ``amax / 127``
#: into a product with this reciprocal, and the JAX package quantizes only
#: inside jitted builders; the scales here round as they do there
_RECIPROCAL_127 = 1.0 / 127.0


def _block_scales(spec: QuantizeSpec, amax: torch.Tensor) -> torch.Tensor:
    """float32 scale per block from its max |value| (1.0 for an all-zero
    block): ``amax * float32(1/127)``, rounded as the JAX package's jitted
    code rounds ``amax / 127``."""
    one = torch.ones((), dtype=torch.float32, device=amax.device)
    r = torch.tensor(_RECIPROCAL_127, dtype=torch.float32, device=amax.device)
    s = torch.where(amax > 0, amax * r, one)
    if spec.mode == "int8":
        return s
    # blockfloat: power-of-two shared exponent — no mantissa error in the scale
    return torch.where(amax > 0, torch.exp2(torch.ceil(torch.log2(s))), one)


def quantize_rows(spec: QuantizeSpec, x: torch.Tensor) -> torch.Tensor:
    """Quantize float32 rows ``(rows, w)`` -> int32 ``(rows, quantized_width(w))``.

    Row-independent (each row carries its own block scales), so quantized
    rows survive any permutation the exchange applies before
    :func:`dequantize_rows` runs on the receive side."""
    spec.validate()
    if not spec.enabled:
        raise ValueError("quantize_rows called with mode='off'")
    rows, w = x.shape
    wq = spec.padded_width(w)
    nb = spec.num_blocks(w)
    xp = x.to(torch.float32)
    if wq != w:
        xp = torch.nn.functional.pad(xp, (0, wq - w))
    blocks = xp.reshape(rows, nb, spec.block_size)
    lo, hi = torch.aminmax(blocks, dim=2)  # max |value| a block, in one read
    scale = _block_scales(spec, torch.maximum(hi, -lo))
    q = (blocks / scale[:, :, None]).round_().clamp_(-127, 127).to(torch.int8)
    # byte k of word i is value 4*i + k: the int8 row read as little-endian words
    packed = q.reshape(rows, wq).view(torch.int32)
    return torch.cat([packed, scale.contiguous().view(torch.int32)], dim=1)


def dequantize_rows(spec: QuantizeSpec, payload: torch.Tensor, w: int) -> torch.Tensor:
    """Inverse of :func:`quantize_rows`: int32 ``(rows, quantized_width(w))``
    -> float32 ``(rows, w)``, each value ``q * scale`` rounded once in float32.
    Zero-filled payload rows dequantize to zero rows."""
    spec.validate()
    if not spec.enabled:
        raise ValueError("dequantize_rows called with mode='off'")
    rows, qw = payload.shape
    wq = spec.padded_width(w)
    nb = spec.num_blocks(w)
    if qw != wq // 4 + nb:
        raise ValueError(f"payload width {qw} != quantized_width({w}) = {wq // 4 + nb}")
    q = payload[:, : wq // 4].to(torch.int32).contiguous().view(torch.int8)  # the words' bytes, value order
    scale = payload[:, wq // 4 :].contiguous().view(torch.float32)
    x = q.reshape(rows, nb, spec.block_size).to(torch.float32) * scale[:, :, None]
    return x.reshape(rows, wq)[:, :w]
