"""TrunkEngine: the execution contract every CiM backend implements (port
of ``repro.engine.base``).

An engine owns the frozen-trunk primitives (matmul, conv) plus a
capability record the registry gates on.  It receives the layer's
``CiMConfig`` and the frozen int8 ROM image and returns float outputs;
its backward is the straight-through estimator (no dW).  The conv entry
point takes a :class:`ConvEpilogue` so the per-channel affine (bias, BN)
and the activation can ride the trunk pass.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class EngineCapabilities:
    """What a backend can do.  ``fidelity_modes`` is gated at resolve
    time (``None``: the engine ignores ``cfg.mode``); ``epilogue`` is read
    by the conv layers; ``fused_ops`` lists the primitives with a fused
    trunk+branch path ('matmul'/'conv').  ``grads``/``devices`` are
    advisory.  ``tune``: the engine's kernels take their launch plans from
    the ``repro_torch.tune`` table; ``deploy.compile_model`` refuses
    ``tune=True`` on an engine without it."""
    fidelity_modes: tuple | None = ("ideal", "per_subarray", "bitserial")
    grads: bool = True
    devices: tuple = ("cpu", "cuda")
    epilogue: bool = False
    sharded_ops: tuple = ()
    tune: bool = False
    fused_ops: tuple = ()


@dataclasses.dataclass(frozen=True)
class ConvEpilogue:
    """Per-output-channel affine + activation after a trunk conv:
    ``y = act(conv(x, w) * scale + bias)``; inference BN folds into it."""
    scale: Any = None
    bias: Any = None
    act: str | None = None          # None | 'relu' | 'leaky_relu'
    leaky_slope: float = 0.1

    def without_act(self) -> "ConvEpilogue":
        return dataclasses.replace(self, act=None)


def activate(y, epilogue: ConvEpilogue | None):
    if epilogue is None or epilogue.act is None:
        return y
    if epilogue.act == "relu":
        return F.relu(y)
    if epilogue.act == "leaky_relu":
        return F.leaky_relu(y, epilogue.leaky_slope)
    raise ValueError(f"unknown epilogue activation: {epilogue.act!r}")


def finish(y, epilogue: ConvEpilogue | None):
    """scale -> bias -> activation tail of an epilogue, applied to the
    trunk output (on the output, not folded into ``w_scale``, so BN
    parameters stay differentiable)."""
    if epilogue is None:
        return y
    if epilogue.scale is not None:
        y = y * epilogue.scale.to(y.dtype)
    if epilogue.bias is not None:
        y = y + epilogue.bias.to(y.dtype)
    return activate(y, epilogue)


class TrunkEngine:
    """Base class of CiM trunk backends; subclasses set ``name`` and
    ``capabilities`` and implement ``matmul``/``conv``."""

    name: str = "abstract"
    capabilities: EngineCapabilities = EngineCapabilities()

    def matmul(self, cfg, x, w_q, w_scale):
        """y = dequant(CiM(quant(x), w_q)); [..., K] x [K, N] -> [..., N]."""
        raise NotImplementedError

    def conv(self, cfg, x, w_q, w_scale, *, stride=1, padding="SAME",
             epilogue: ConvEpilogue | None = None):
        """NHWC/HWIO frozen-trunk conv with an optional epilogue."""
        raise NotImplementedError

    def matmul_partial(self, cfg, x_q, w_q):
        """The CiM dot of int8 rows ``x_q`` [M, k], quantised at their
        whole row's scale, against ROM rows ``w_q`` [k, N] holding whole
        k-blocks, f32 [M, N] before any scale: what a rank of a
        row-parallel site adds into the rank-order sum."""
        raise NotImplementedError(
            f"engine {self.name!r} has no row-parallel partial matmul")

    def fused_matmul(self, cfg, x, w_q, w_scale, c, core, u):
        """Fused trunk+branch ReBranch matmul ('matmul' in fused_ops)."""
        raise NotImplementedError(
            f"engine {self.name!r} has no fused matmul path")

    def fused_partial(self, cfg, x, w_q, c):
        """The fused kernel's (trunk, sketch) of x [M, k] holding whole
        k-blocks, before the epilogue ('matmul' in fused_ops): a rank's
        part of a row-parallel site."""
        raise NotImplementedError(
            f"engine {self.name!r} has no fused matmul path")

    def fused_conv(self, cfg, x, w_q, w_scale, c, core, u, *, stride=1,
                   padding="SAME", epilogue: ConvEpilogue | None = None):
        """Fused trunk+branch ReBranch conv on one patch matrix; the
        epilogue applies after the branch add ('conv' in fused_ops)."""
        raise NotImplementedError(
            f"engine {self.name!r} has no fused conv path")

    def check(self, spec) -> None:
        """Raise if ``spec`` asks for a fidelity mode this engine lacks."""
        caps = self.capabilities
        mode = spec.cim.mode
        if caps.fidelity_modes is not None and mode not in caps.fidelity_modes:
            raise ValueError(
                f"engine {self.name!r} does not support CiM fidelity mode "
                f"{mode!r} (supported: {list(caps.fidelity_modes)}); pick "
                f"another mode or another engine")

    def __repr__(self):
        return f"<TrunkEngine {self.name!r} caps={self.capabilities}>"
