"""Rank functions of the spawned gloo worlds of ``test_torch_sharding.py``
and ``test_torch_halo_conv.py``, and the inputs both sides share.

The ranks import no JAX: they rebuild the same numpy inputs from seeds,
run the port on the CPU (plain kernel versions) over 4 ranks, and return
numpy outputs; the test process holds them to the JAX package.  Every
rank returns the whole output of a sharded call (its slabs gathered over
H), so the tests also see that all ranks agree.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

CNNS = ("vgg8", "resnet18", "darknet19", "tiny_yolo")
MESH_SHAPES = ((4, 1), (2, 2), (1, 4))     # the data axis: n = 4, 2, 1
SWEEP = [(k, s, h) for k in (1, 3) for s in (1, 2) for h in (16, 9)]
ADC_CASES = [(mode, h) for mode in ("per_subarray", "bitserial")
             for h in (8, 9)]
ADC_C_IN = 12            # 3x3 x 12 = 108 rows: one subarray (XLA compiles
                         # the JAX bitserial block slowly)
FUSED_CASES = [(16, 1), (9, 2)]            # (H, stride) of the fused route


def cnn_size(name: str) -> int:
    """32 px, Tiny-YOLO 64 (its six pools leave no pixel of 32)."""
    return 64 if name == "tiny_yolo" else 32


def with_cores(params, rng):
    """Every zero ReBranch core replaced by seeded N(0, 0.05) values."""
    if isinstance(params, dict):
        out = {k: with_cores(v, rng) for k, v in params.items()}
        if "core" in out.get("sram", {}):
            core = out["sram"]["core"]
            out["sram"] = dict(out["sram"], core=(
                rng.normal(size=core.shape) * 0.05).astype(np.float32))
        return out
    if isinstance(params, list):
        return [with_cores(v, rng) for v in params]
    return params


def cnn_case(name: str):
    """(numpy params with live cores, NHWC images [2, S, S, 3])."""
    from repro_torch import bridge, deploy
    from repro_torch.models import cnn
    size = cnn_size(name)
    cfg = cnn.CNNConfig(name=name, input_size=size)
    params = bridge.to_numpy(deploy.compile_model(cfg).init(3, device="cpu"))
    rng = np.random.default_rng(len(name))
    x = rng.normal(size=(2, size, size, 3)).astype(np.float32)
    return with_cores(params, rng), x


def conv_case(seed: int, k: int, c_in: int, c_out: int, h: int, w: int = 8,
              n: int = 2):
    """(x, w_q int8, w_scale, C, core, U) as numpy, from ``seed``."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, h, w, c_in)).astype(np.float32)
    w_q = rng.integers(-127, 128, (k, k, c_in, c_out)).astype(np.int8)
    w_scale = rng.uniform(1e-3, 1e-2, (1, 1, 1, c_out)).astype(np.float32)
    c_c, c_u = max(1, c_in // 4), max(1, c_out // 4)
    c = (rng.normal(size=(1, 1, c_in, c_c)) / np.sqrt(c_in)).astype(np.float32)
    core = (rng.normal(size=(k, k, c_c, c_u)) * 0.1).astype(np.float32)
    u = (rng.normal(size=(1, 1, c_u, c_out)) / np.sqrt(c_u)).astype(np.float32)
    return x, w_q, w_scale, c, core, u


def geometry_cases():
    """Every distinct trunk-conv geometry of DarkNet-19 and ResNet-18 at
    32 px as (c_in, c_out, k, h, stride), channels capped at 64 (the
    contract is channel-independent; the time is not)."""
    from repro_torch.models import cnn
    geoms = set()
    for name in ("darknet19", "resnet18"):
        for _, k, c_in, c_out, in_hw, _, st in cnn._conv_sites(
                cnn.CNNConfig(name=name, input_size=32)):
            geoms.add((min(c_in, 64), min(c_out, 64), k, in_hw, st))
    return sorted(geoms)


def _meshes():
    from repro_torch.launch import mesh as mesh_lib
    return {s: mesh_lib.make_mesh(s, backend="gloo") for s in MESH_SHAPES}


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _sharded_conv(mesh, cfg, x, w_q, w_scale, stride):
    """The 'pallas_sharded' engine's conv of ``x`` (whole, on every rank)
    under ``mesh``, gathered back to whole."""
    from repro_torch import engine
    from repro_torch.distributed import sharding as shd
    with shd.use_mesh(mesh):
        y = engine.get("pallas_sharded").conv(
            cfg, shd.shard(x, "cnn_batch", "cnn_h"), w_q, w_scale,
            stride=stride)
        return shd.gather_h(y)


def halo_world(rank: int, world: int) -> dict:
    """The reference's sweep, the fidelity modes, the fused route, the
    plain sharded conv, every DarkNet-19/ResNet-18 trunk geometry and the
    sharded trunk's backward, on meshes (4, 1), (2, 2) and (1, 4)."""
    from repro_torch import engine
    from repro_torch.core import cim
    from repro_torch.core.rebranch import conv_nhwc
    from repro_torch.distributed import sharding as shd
    from repro_torch.kernels import halo_conv
    from repro_torch.kernels import rebranch_conv as rc
    meshes = _meshes()
    ideal = cim.CiMConfig(mode="ideal")
    pallas = engine.get("pallas")
    out = {"sweep": {}, "adc": {}, "fused": {}, "plain": {}, "geoms": {}}
    for shape, mesh in meshes.items():
        for k, s, h in SWEEP:
            x, w_q, w_scale = _t(*conv_case(k * 10 + h, k, 20, 12, h)[:3])
            out["sweep"][shape, k, s, h] = _sharded_conv(
                mesh, ideal, x, w_q, w_scale, s).numpy()
        for mode, h in ADC_CASES:
            cfg = cim.CiMConfig(mode=mode)
            x, w_q, w_scale = _t(*conv_case(h, 3, ADC_C_IN, 12, h,
                                            n=1)[:3])
            got = _sharded_conv(mesh, cfg, x, w_q, w_scale, 1)
            want = pallas.conv(cfg, x, w_q, w_scale)
            out["adc"][shape, mode, h] = (got.numpy(), want.numpy())
        for h, s in FUSED_CASES:
            args = _t(*conv_case(h + s, 3, 20, 12, h))
            with shd.use_mesh(mesh):
                got = shd.gather_h(halo_conv.sharded_rebranch_conv(
                    shd.shard(args[0], "cnn_batch", "cnn_h"), *args[1:],
                    stride=s))
            want = rc.rebranch_conv(*args, stride=s)
            out["fused"][shape, h, s] = (got.numpy(), want.numpy())
        for k, s, h in SWEEP:
            x, w_q, w_scale = _t(*conv_case(k + h, k, 20, 12, h)[:3])
            w = w_q.float() * w_scale
            with shd.use_mesh(mesh):
                got = shd.gather_h(halo_conv.sharded_conv_nhwc(
                    shd.shard(x, "cnn_batch", "cnn_h"), w, s))
            out["plain"][shape, k, s, h] = (got.numpy(),
                                            conv_nhwc(x, w, s).numpy())
    mesh = meshes[4, 1]
    for i, (ci, co, k, h, s) in enumerate(geometry_cases()):
        x, w_q, w_scale = _t(*conv_case(1000 + i, k, ci, co, h, w=h,
                                        n=1)[:3])
        got = _sharded_conv(mesh, ideal, x, w_q, w_scale, s)
        want = pallas.conv(ideal, x, w_q, w_scale, stride=s)
        out["geoms"][ci, co, k, h, s] = bool(torch.equal(got, want))
    x, w_q, w_scale = _t(*conv_case(7, 3, 20, 12, 16)[:3])
    with shd.use_mesh(mesh):
        xl = shd.shard(x, "cnn_batch", "cnn_h").requires_grad_()
        y = halo_conv.sharded_trunk_conv(ideal, 1, "SAME", mesh, "data", xl,
                                         w_q, w_scale)
        try:
            y.sum().backward()
            out["backward"] = None
        except NotImplementedError as e:
            out["backward"] = str(e)
        try:                    # a plain conv under autograd: no adjoint
            halo_conv.sharded_conv_nhwc(xl, w_q.float() * w_scale)
            out["exchange_grad"] = None
        except NotImplementedError as e:
            out["exchange_grad"] = str(e)
    out["traffic"] = dict(shd.bytes_sent)
    return out


def sharding_world(rank: int, world: int) -> dict:
    """The meshes' constructors, and ``compile_model(mesh=)`` forwards of
    the four CNNs on meshes (4, 1), (2, 2) and (1, 4), each with the
    engine's fallback count and warnings (DarkNet-19 twice on each mesh: the
    second forward must not warn again)."""
    import torch.distributed as dist
    from repro_torch import bridge, deploy
    from repro_torch.engine import sharded as sharded_engine
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import cnn
    out = {}
    for what, make in (("production", lambda: mesh_lib.make_production_mesh(
            backend="gloo")), ("serve8", lambda: mesh_lib.make_cnn_serve_mesh(
            8, backend="gloo"))):
        try:
            make()
            out[what] = None
        except ValueError as e:
            out[what] = str(e)
    local = mesh_lib.make_local_mesh(backend="gloo")
    serve = mesh_lib.make_cnn_serve_mesh(4, backend="gloo")
    meshes = _meshes()
    out["meshes"] = {
        name: (m.shape, m.size, {a: m.coordinate(a) for a in m.axis_names},
               {a: m.group(a)._get_backend(torch.device("cpu")).options
                ._timeout.total_seconds() for a in m.axis_names})
        for name, m in [("local", local), ("serve4", serve),
                        *meshes.items()]}
    out["rank"] = dist.get_rank()
    out["forward"] = {}
    for name in ("darknet19", *[c for c in CNNS if c != "darknet19"]):
        params, x = cnn_case(name)
        params = bridge.to_torch(params, "cpu")
        cfg = cnn.CNNConfig(name=name, input_size=cnn_size(name),
                            fuse_bn_act=True)
        for shape, mesh in meshes.items():
            model = deploy.compile_model(cfg, engine="pallas_sharded",
                                         mesh=mesh)
            for run in range(2 if name == "darknet19" else 1):
                sharded_engine.fallbacks = 0
                with warnings.catch_warnings(record=True) as caught, \
                        torch.no_grad():
                    warnings.simplefilter("always")
                    y = model.forward(params, torch.from_numpy(x))
                msgs = [str(w.message) for w in caught
                        if "falling back" in str(w.message)]
                out["forward"][name, shape, run] = (
                    y.numpy(), sharded_engine.fallbacks, msgs, repr(model))
    return out

