"""The yardstick of the kernels: the bytes an operation needs, from shapes.

An erasure-code kernel is bound by memory: it reads each input chunk once
and writes each output chunk once, whatever it reads again inside.  These
counts come from the codec's chunk size and the chunks an operation reads
and writes alone, so they read the same work whatever kernel, fusion or
renaming a later change brings.
"""

from __future__ import annotations

#: published peaks: card name prefix -> HBM bytes/s (NVIDIA's H100 SXM data
#: sheet, at its 700 W power limit)
PEAK_BYTES_PER_S = {"NVIDIA H100": 3.35e12}


def kernel_bytes(chunks_read: int, chunks_written: int,
                 chunk_size: int) -> int:
    """Bytes an operation's kernels need: each input chunk read once, each
    output chunk written once."""
    return (chunks_read + chunks_written) * chunk_size


def peak_bytes_per_s(device_name: str):
    """The card's published HBM bandwidth, or None for a card not listed."""
    for prefix, peak in PEAK_BYTES_PER_S.items():
        if device_name.startswith(prefix):
            return peak
    return None
