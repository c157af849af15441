"""ROM image utilities: the immutable trunk as a content-addressed
artifact (port of ``repro.core.rom``).

The ROM contents are fixed at tape-out (init / freeze time) and never
checkpointed: a checkpoint stores the SRAM state plus the ROM
fingerprint, and restore refuses a fingerprint other than the booted
image's.

The fingerprint is the JAX package's, byte for byte, so one tree gives
the same hex in both packages: leaves sorted by their keystr name
(``bridge.flatten``), each hashed as name, numpy dtype name, the shape as
a tuple's ``str`` (``(2, 3)``, not ``torch.Size([2, 3])``) and the raw
little-endian bytes — a bfloat16 leaf by its 2-byte bits.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from repro_torch import bridge
from repro_torch.core import rebranch


def dtype_name(dtype) -> str:
    """numpy's name for a torch dtype (``torch.float32`` -> ``float32``);
    a name passes through."""
    return str(dtype).removeprefix("torch.")


def host_bytes(t: torch.Tensor) -> np.ndarray:
    """A tensor's elements as a host numpy array of the same width; a
    bfloat16 tensor as its raw bits (int16), which numpy cannot name."""
    t = t.detach().contiguous()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.cpu().numpy()


def rom_fingerprint(params) -> str:
    """SHA-256 over every ROM leaf, in sorted keystr order."""
    _, frozen = rebranch.partition(params)
    h = hashlib.sha256()
    for name, leaf in sorted(bridge.flatten(frozen).items()):
        h.update(name.encode())
        h.update(dtype_name(leaf.dtype).encode())
        h.update(str(tuple(leaf.shape)).encode())
        h.update(host_bytes(leaf).reshape(-1).view(np.uint8))   # no copy
    return h.hexdigest()


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size()
               for t in bridge.flatten(tree).values())


def rom_bytes(params) -> int:
    """Total ROM image size in bytes (what would be mask-programmed)."""
    return _nbytes(rebranch.partition(params)[1])


def sram_bytes(params) -> int:
    """Total SRAM (trainable, swappable) state in bytes."""
    return _nbytes(rebranch.partition(params)[0])
