"""The 'pallas_sharded' TrunkEngine: halo-exchange conv over a mesh (port
of ``repro.engine.sharded``).

Conv is the native sharded op: NHWC activations shard over H on the mesh
axis the ``"cnn_h"`` logical rule names (``"data"`` by default), each rank
fetches only the kernel's halo rows from its neighbours (point-to-point on
the axis's process group) and runs kernel 1 on its slab, bit-identical to
the unsharded 'pallas' engine on its rows (``kernels/halo_conv.py``).

Capabilities: ``sharded_ops=("conv",)``; matmul delegates to 'pallas' (LM
trunks shard tensor-parallel, where a spatial halo buys nothing).  Conv
delegates to 'pallas' when no mesh is bound or the ``"cnn_h"`` axis has
size 1.  When the halo would span more than one neighbour (H too small for
the mesh) the layer is gathered on every rank, run whole through kernel 1
and re-split: correct, not sharded; it warns once per geometry and adds
one to :data:`fallbacks` (under a ``launch.cost`` record, a dry run's
rank, it adds one to the record's ``fallbacks`` and warns nothing).
``grads=True``: the sharded trunk's backward is the STE on each rank's
extended slab, and the halo exchange's adjoint returns the halo rows'
gradient to their owners (a gathered layer's gather sums its gradient
back), so branch training runs on the H layout.
There are no ``fused_ops``: training takes the trunk + branch route.
"""

from __future__ import annotations

import warnings

from repro_torch.distributed import sharding as shd
from repro_torch.engine import base
from repro_torch.engine.registry import get, register
from repro_torch.kernels import halo_conv
from repro_torch.kernels import ops as kops
from repro_torch.launch import cost

# trunk convs run gathered (halo does not fit) since the count was last
# set to 0
fallbacks = 0

# (H, kh, stride, padding, n_shards) combos already warned about
_warned_fallbacks: set = set()


class ShardedPallasEngine(base.TrunkEngine):
    """Halo-exchange H-sharded kernel-1 conv; matmul delegates to
    'pallas'."""

    name = "pallas_sharded"
    capabilities = base.EngineCapabilities(
        fidelity_modes=("ideal", "per_subarray", "bitserial"),
        grads=True, devices=("cpu", "cuda"), epilogue=True,
        sharded_ops=("conv",), tune=True)

    def matmul(self, cfg, x, w_q, w_scale):
        return get("pallas").matmul(cfg, x, w_q, w_scale)

    def matmul_partial(self, cfg, x_q, w_q):
        return get("pallas").matmul_partial(cfg, x_q, w_q)

    def conv(self, cfg, x, w_q, w_scale, *, stride=1, padding="SAME",
             epilogue=None):
        global fallbacks
        at = shd.h_axis()
        if at is None:
            return get("pallas").conv(cfg, x, w_q, w_scale, stride=stride,
                                      padding=padding, epilogue=epilogue)
        mesh, axis = at
        kh, kw = w_q.shape[0], w_q.shape[1]
        h, fits = halo_conv.halo_h(x, kh, kw, stride, padding, mesh, axis)
        if fits:
            y = halo_conv.sharded_trunk_conv(cfg, stride, padding, mesh, axis,
                                             x, w_q, w_scale, h=h)
            return base.finish(y, epilogue)
        n = mesh.shape[axis]
        key = (h, kh, stride, padding, n)
        rec = cost.recording()
        if rec is not None:
            rec["fallbacks"] += cost.times()
        elif key not in _warned_fallbacks:
            _warned_fallbacks.add(key)
            warnings.warn(
                f"pallas_sharded: halo for H={h} kh={kh} stride={stride} "
                f"{padding} does not fit a {n}-way '{axis}' mesh axis (it "
                f"would span more than one neighbour shard); falling back "
                f"to the unsharded 'pallas' conv for this layer (gathered "
                f"on every rank and re-split)", stacklevel=3)
        if rec is None:
            fallbacks += 1
        y = halo_conv.gathered(
            lambda xf: kops.trunk_conv(cfg, stride, padding, xf, w_q,
                                       w_scale), x, mesh, axis, h)
        return base.finish(y, epilogue)

register("pallas_sharded", ShardedPallasEngine())
