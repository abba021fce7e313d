"""Lossy block quantization of float exchange payloads (tier b).

Port of the quantize half of ``sparkucx_tpu/ops/compress.py``
(``QuantizeSpec``, ``_block_scales``, ``quantize_rows``, ``dequantize_rows``)
as torch ops.  Aggregate-tolerant float payloads (the GROUP BY's partial
rows, ops/relational.py) travel as int8 with one float32 scale per
``block_size`` values.  ``int8`` uses a linear scale (|err| <= amax/254),
``blockfloat`` a power-of-two shared exponent (|err| <= amax/127, scales
exact).  Keys and counts are never quantized.

Quantized row layout, bit for bit the JAX package's: for a float row of
width ``w`` and block size ``B`` (a multiple of 4), ``wq = ceil(w/B)*B``
padded values pack 4 int8 per int32 word (byte k of word i is value
``4*i + k``, little end first) — ``wq//4`` words — followed by ``nb = wq//B``
per-block float32 scales whose bits are the int32 words.

The lossless page codecs of tier (a) (``CompressSpec``, ``encode_chunk``) need
``utils/pagecodec.py`` and are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

QUANTIZE_MODES = ("off", "int8", "blockfloat")


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


def _block_scales(spec: QuantizeSpec, amax: torch.Tensor) -> torch.Tensor:
    """float32 scale per block from its max |value| (1.0 for an all-zero block)."""
    one = torch.ones((), dtype=torch.float32, device=amax.device)
    s = torch.where(amax > 0, amax / 127.0, one)
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
    xp = torch.nn.functional.pad(x.to(torch.float32), (0, wq - w))
    blocks = xp.reshape(rows, nb, spec.block_size)
    scale = _block_scales(spec, blocks.abs().amax(dim=2))
    q = torch.clamp(torch.round(blocks / scale[:, :, None]), -127, 127).to(torch.int32)
    qb = (q.reshape(rows, wq // 4, 4) & 0xFF).to(torch.int64)
    packed = (qb[..., 0] | (qb[..., 1] << 8) | (qb[..., 2] << 16) | (qb[..., 3] << 24))
    packed = (packed - ((packed >> 31) << 32)).to(torch.int32)  # the word's two's-complement value
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
    packed = payload[:, : wq // 4].to(torch.int32)
    scale = payload[:, wq // 4 :].contiguous().view(torch.float32)
    shifts = torch.tensor([0, 8, 16, 24], dtype=torch.int32, device=payload.device)
    b = (packed[..., None] >> shifts) & 0xFF
    b = torch.where(b >= 128, b - 256, b)  # sign-extend int8
    q = b.reshape(rows, nb, spec.block_size).to(torch.float32)
    x = q * scale[:, :, None]
    return x.reshape(rows, wq)[:, :w]
