"""The port's one device resolver.

Every entry point that places tensors (model init, serving) resolves its
device here.  The default is the CUDA card; without one this RAISES rather
than quietly running on the CPU — a caller that wants the CPU (the parity
tests) says ``device="cpu"``.

It also pins float32 to full precision on the card: cuDNN convolutions
default to TF32 on Hopper, which keeps ~3 decimal digits and would break
every float32 check on the plain 1x1 ``pred`` conv and the unfused branch
convs of ``models.cnn.apply_conv``.
"""

from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """``None`` -> the CUDA card (raises without one); else ``device``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions on the CPU")
        return torch.device("cuda")
    return torch.device(device)
