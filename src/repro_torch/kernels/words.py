"""Bit operations on packed 32-bit lane words, shared by the multi-source
modules.

Torch has no shifts on uint32 and no popcount, so packed words are
``torch.int32`` tensors holding uint32 bit patterns (as in
:mod:`repro_torch.kernels.ref`).  ``>>`` on int32 is arithmetic: every
shift here is masked, or runs in int64 on the zero-extended word, so that
bit 31 never leaks into the result.
"""
from __future__ import annotations

import torch

_WORD = 0xFFFFFFFF


def _shifts(device, dtype=torch.int32) -> torch.Tensor:
    return torch.arange(32, dtype=dtype, device=device)


def popcount32(words: torch.Tensor) -> torch.Tensor:
    """Set bits of each int32 bit-pattern word (SWAR), as int32.

    The counterpart of ``lax.population_count`` on uint32 words."""
    x = words.to(torch.int64) & _WORD
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (((x * 0x01010101) & _WORD) >> 24).to(torch.int32)


def unpack_words(words: torch.Tensor, dtype=torch.uint8) -> torch.Tensor:
    """(..., kw) int32 words -> (..., kw*32) 0/1 lanes; lane 32w+l is bit l
    of word w."""
    # masked: exact; in place, so the int32 lanes exist once
    bits = (words[..., None] >> _shifts(words.device)).bitwise_and_(1)
    return bits.to(dtype).reshape(*words.shape[:-1], words.shape[-1] * 32)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(..., kw, 32) bool/0-1 lanes -> (..., kw) int32 bit-pattern words."""
    words = (bits.to(torch.int64) << _shifts(bits.device, torch.int64)).sum(-1)
    # [0, 2**32) -> the int32 with the same 32 bits
    return (words - ((words >> 31) << 32)).to(torch.int32)
