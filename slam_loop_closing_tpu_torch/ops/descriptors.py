"""Binary-descriptor layouts and conversions.

Port of :mod:`slam_loop_closing_tpu.ops.descriptors`. 256-bit ORB
descriptors come in two layouts:

* **packed**: ``[..., 8]`` 32-bit words (bit i of word w = bit 32*w+i), the
  input of the XOR+popcount band kernel. Stored as ``torch.int32``: the bit
  patterns are those of the JAX package's uint32 words (``.view(np.uint32)``
  on the host gives them back).
* **signed**: ``[..., 256]`` int8 of +-1, invalid rows all zero.
"""

from __future__ import annotations

import torch

BITS = 256
WORDS = BITS // 32


def bits_to_packed(bits: torch.Tensor) -> torch.Tensor:
    """[..., 256] {0,1} -> [..., 8] int32 words (uint32 bit patterns)."""
    b = bits.to(torch.int64).reshape(*bits.shape[:-1], WORDS, 32)
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    s = torch.sum(b << shifts, dim=-1)
    # wrap [0, 2^32) into int32's range with the same bit pattern
    return (s - ((s >> 31) << 32)).to(torch.int32)


def packed_to_bits(packed: torch.Tensor) -> torch.Tensor:
    """[..., 8] int32 words -> [..., 256] {0,1} uint8."""
    shifts = torch.arange(32, dtype=torch.int32, device=packed.device)
    b = (packed[..., :, None] >> shifts) & 1
    return b.reshape(*packed.shape[:-1], BITS).to(torch.uint8)


def bits_to_signed(bits: torch.Tensor) -> torch.Tensor:
    """[..., 256] {0,1} -> [..., 256] int8 of +-1 (1 -> +1, 0 -> -1)."""
    return (bits.to(torch.int8) * 2 - 1).to(torch.int8)


def signed_to_packed(signed: torch.Tensor) -> torch.Tensor:
    return bits_to_packed((signed > 0).to(torch.uint8))


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Popcount of 32-bit words (SWAR in int64, so no sign-bit wrap)."""
    x = x.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def hamming_packed(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The XOR+popcount oracle: ``a`` [M, 8], ``b`` [N, 8] packed words ->
    [M, N] int32 Hamming distances."""
    x = a[:, None, :] ^ b[None, :, :]
    return torch.sum(popcount32(x), dim=-1).to(torch.int32)
