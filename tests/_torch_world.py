"""Rank functions of the spawned gloo worlds of ``test_torch_sharding.py``,
``test_torch_halo_conv.py``, ``test_torch_dist_train.py``,
``test_torch_tp.py``, ``test_torch_tp_train.py``,
``test_torch_dryrun.py``, ``test_torch_moe_tp.py`` and
``test_torch_moe_tp_train.py``, and the inputs both sides share.

The ranks import no JAX: they rebuild the same numpy inputs from seeds,
run the port on the CPU (plain kernel versions) over 4 ranks, and return
numpy outputs; the test process holds them to the JAX package.  Every
rank returns the whole output of a sharded call (its slabs gathered over
H), so the tests also see that all ranks agree.
"""

from __future__ import annotations

import dataclasses
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


def with_biases(params, rng):
    """Every zero linear bias replaced by seeded N(0, 0.1) values."""
    if isinstance(params, dict):
        out = {k: with_biases(v, rng) for k, v in params.items()}
        if "b" in out.get("sram", {}):
            b = out["sram"]["b"]
            out["sram"] = dict(out["sram"], b=(
                rng.normal(size=b.shape) * 0.1).astype(b.dtype))
        return out
    if isinstance(params, list):
        return [with_biases(v, rng) for v in params]
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
    # the trunk's STE backward and a plain conv's, through the exchange's
    # adjoint, against the unsharded ones
    from repro_torch.core.rebranch import trunk_conv_ste_bwd
    x, w_q, w_scale = _t(*conv_case(7, 3, 20, 12, 16)[:3])
    w = w_q.float() * w_scale
    with shd.use_mesh(mesh):
        xl = shd.shard(x, "cnn_batch", "cnn_h").requires_grad_()
        y = halo_conv.sharded_trunk_conv(ideal, 1, "SAME", mesh, "data", xl,
                                         w_q, w_scale)
        y.sum().backward()
        out["backward"] = (shd.gather_h(xl.grad).numpy(), trunk_conv_ste_bwd(
            1, "SAME", x.shape, w_q, w_scale, torch.ones(y.shape[0], 16, 8,
                                                         12)).numpy())
        xl = shd.shard(x, "cnn_batch", "cnn_h").requires_grad_()
        halo_conv.sharded_conv_nhwc(xl, w).sum().backward()
        xw = x.clone().requires_grad_()
        conv_nhwc(xw, w).sum().backward()
        out["exchange_grad"] = (shd.gather_h(xl.grad).numpy(),
                                xw.grad.numpy())
    out["traffic"] = dict(shd.bytes_sent)
    return out


def sharding_world(rank: int, world: int) -> dict:
    """The meshes' constructors, and ``compile_model(mesh=)`` forwards of
    the four CNNs on meshes (4, 1), (2, 2) and (1, 4), each with the
    engine's fallback count, warnings and the bytes the rank sent
    (DarkNet-19 twice on each mesh: the second forward must not warn
    again)."""
    import torch.distributed as dist
    from repro_torch import bridge, deploy
    from repro_torch.distributed import sharding as shd
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
    out["forward"], out["traffic"] = {}, {}
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
                shd.reset_traffic()
                with warnings.catch_warnings(record=True) as caught, \
                        torch.no_grad():
                    warnings.simplefilter("always")
                    y = model.forward(params, torch.from_numpy(x))
                out["traffic"][name, shape, run] = dict(shd.bytes_sent)
                msgs = [str(w.message) for w in caught
                        if "falling back" in str(w.message)]
                out["forward"][name, shape, run] = (
                    y.numpy(), sharded_engine.fallbacks, msgs, repr(model))
    return out



# ---------------------------------------------------------------------------
# test_torch_dist_train.py: branch training over a mesh
# ---------------------------------------------------------------------------

STE_MESHES = ((2, 2), (4, 1))              # (data, model); H over data
# the reference's sweep, and maps whose halo does not fit 2 or 4 ways
# (the engine gathers them)
STE_CASES = SWEEP + [(3, 1, 1), (3, 1, 3), (3, 2, 1)]
TRAIN_MESH = ((2, 2, 1), ("pod", "data", "model"))
# (model, every conv dense): VGG-8's head follows a gather; five of
# DarkNet-19's trunk convs at 32 px are gathered over 2
TRAIN_CASES = [("vgg8", True), ("vgg8", False), ("darknet19", False)]
TRAIN_BATCH = 3                            # over pod 2: blocks of 2 and 1
LM_BATCH, LM_SEQ = 8, 16                   # over data 4: 2 rows a rank
COMPRESS_SHAPE = (8, 64)
RESTORE_MESH = (2, 2)                      # (data, model): blocks over model


def ste_case(k: int, s: int, h: int):
    """(x, w_q, w_scale, g): a conv of ``conv_case`` and a seeded
    cotangent of its SAME output."""
    x, w_q, w_scale = conv_case(5000 + 10 * k + h + s, k, 20, 12, h)[:3]
    oh, ow = -(-h // s), -(-x.shape[2] // s)
    g = np.random.default_rng(k + h + s).normal(
        size=(x.shape[0], oh, ow, 12)).astype(np.float32)
    return x, w_q, w_scale, g


def train_cnn_case(name: str, dense: bool = False):
    """(numpy params, images [3, S, S, 3], a seeded target of the head's
    output shape): the ReBranch model with live cores, or ``dense`` (every
    conv a trainable SRAM conv)."""
    if dense:
        from repro_torch import bridge, deploy
        params = bridge.to_numpy(deploy.compile_model(
            _cnn_cfg(name, True)).init(3, device="cpu"))
    else:
        params, _ = cnn_case(name)
    cfg = _cnn_cfg(name)
    size = cfg.input_size
    rng = np.random.default_rng(40 + len(name))
    x = rng.normal(size=(TRAIN_BATCH, size, size, 3)).astype(np.float32)
    head = ((cfg.num_classes,) if name == "vgg8" else
            (size // 32, size // 32, cfg.head_anchors, 5 + cfg.head_classes))
    y = rng.normal(size=(TRAIN_BATCH, *head)).astype(np.float32)
    return params, x, y


def _tree(params):
    from repro_torch import bridge
    return bridge.to_torch(params, "cpu")


def regression_loss(model):
    """Mean squared error of ``model.forward`` against ``batch["y"]``."""
    return lambda p, b: ((model.forward(p, b["x"]) - b["y"]) ** 2).mean()


def compress_grads():
    """Each of the 4 ranks' N(0, 1e-3) gradient of COMPRESS_SHAPE."""
    return [(np.random.default_rng(60 + r).normal(size=COMPRESS_SHAPE)
             * 1e-3).astype(np.float32) for r in range(4)]


def _digest(tree) -> dict:
    import hashlib

    from repro_torch import bridge
    return {k: hashlib.sha256(v.detach().contiguous().numpy().tobytes())
            .hexdigest() for k, v in bridge.flatten(tree).items()}


def _numpy(tree) -> dict:
    from repro_torch import bridge
    return {k: v.detach().numpy().copy()
            for k, v in bridge.flatten(tree).items()}


def train_world(rank: int, world: int, lm_path: str, ckpt_dir: str,
                cli_dir: str) -> dict:
    """The sharded STE, the sharded CNN step, the data-parallel LM step
    (plain and compressed), the int8 all-reduce, elastic restore and the
    train CLI inside the world.  The LM parameters come from ``lm_path``
    (``torch.save`` of the tree: a numpy tree in the spawn arguments costs
    the ranks seconds to start)."""
    import torch.distributed as dist
    from repro_torch import configs, deploy, engine, optim
    from repro_torch.checkpoint import manager as ckpt
    from repro_torch.core import cim, rebranch
    from repro_torch.data import synthetic
    from repro_torch.distributed import sharding as shd
    from repro_torch.engine import sharded as sharded_engine
    from repro_torch.kernels import halo_conv
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import steps
    from repro_torch.launch import train as train_cli
    warnings.simplefilter("ignore")       # the engine's fallback warnings
    from repro_torch.optim import compress
    out = {"rank": rank}
    ideal = cim.CiMConfig(mode="ideal")

    # the sharded trunk's STE dx and the plain sharded conv's dx and dw
    out["ste"] = {}
    for shape in STE_MESHES:
        mesh = mesh_lib.make_mesh(shape, backend="gloo")
        for k, s, h in STE_CASES:
            x, w_q, w_scale, g = _t(*ste_case(k, s, h))
            with shd.use_mesh(mesh):
                gl = shd.shard(g, "cnn_batch", "cnn_h")
                xl = shd.shard(x, "cnn_batch", "cnn_h").requires_grad_()
                y = engine.get("pallas_sharded").conv(ideal, xl, w_q,
                                                      w_scale, stride=s)
                dx, = torch.autograd.grad(y, xl, gl)
                trunk_dx = shd.gather_h(dx)
                xl = shd.shard(x, "cnn_batch", "cnn_h").requires_grad_()
                w = (w_q.float() * w_scale).requires_grad_()
                y = halo_conv.sharded_conv_nhwc(xl, w, s)
                # a rank with no output rows gives w no gradient
                dx, dw = torch.autograd.grad(y, (xl, w), gl,
                                             allow_unused=True)
                dw = torch.zeros_like(w) if dw is None else dw.contiguous()
                dist.all_reduce(dw, group=mesh.group("data"))
                out["ste"][shape, k, s, h] = (
                    trunk_dx.numpy(), shd.gather_h(dx).numpy(), dw.numpy())

    # one CNN branch step on (pod 2, data 2, model 1), with the branches
    # (STE through the trunk) and dense (every conv trainable, no
    # quantiser)
    mesh = mesh_lib.make_mesh(*TRAIN_MESH, backend="gloo")
    out["cnn"] = {}
    for name, dense in TRAIN_CASES:
        params, x, y = train_cnn_case(name, dense)
        model = deploy.compile_model(_cnn_cfg(name, dense),
                                     engine="pallas_sharded", mesh=mesh)
        trainable, frozen = rebranch.partition(_tree(params))
        opt = optim.init(trainable)
        step = steps.BranchStep(regression_loss(model),
                                optim.AdamWConfig(lr=1e-3))
        batch = {"x": torch.from_numpy(x), "y": torch.from_numpy(y)}
        sharded_engine.fallbacks = 0
        shd.reset_traffic()
        with shd.use_mesh(mesh):
            loss, grads = step.grads(trainable, frozen, batch)
        fallbacks = sharded_engine.fallbacks
        new_t, new_opt, _ = optim.update(grads, opt, trainable,
                                         step.opt_cfg)
        out["cnn"][name, dense] = {
            "loss": float(loss), "fallbacks": fallbacks,
            "grads": _numpy(grads) if rank == 0 else None,
            "digests": (_digest(grads), _digest(new_t), _digest(new_opt)),
            "traffic": dict(shd.bytes_sent)}

    # the data-parallel LM step over (4, 1), plain and compressed
    cfg = configs.get_smoke("gemma_2b")
    mesh = mesh_lib.make_mesh((4, 1), backend="gloo")
    model = deploy.compile_model(cfg, engine="pallas")
    params = torch.load(lm_path)
    trainable, frozen = rebranch.partition(params)
    opt = optim.init(trainable)
    dcfg = synthetic.DataConfig(seed=0, vocab_size=cfg.vocab_size,
                                seq_len=LM_SEQ, global_batch=LM_BATCH)
    whole = synthetic.markov_batch(dcfg, 0, device="cpu")
    batch = steps.local_batch(cfg, mesh, whole, LM_BATCH)
    out["lm"] = {"rows": batch["tokens"][:, 0].tolist()}
    with shd.use_mesh(mesh):
        for compressed in (False, True):
            step = steps.make_train_step(cfg, optim.AdamWConfig(lr=1e-3),
                                         loss_chunks=2, model=model,
                                         compress=compressed,
                                         global_batch=LM_BATCH)
            compress.wire_bytes.clear()
            loss, grads = step.grads(trainable, frozen, batch)
            wire = dict(compress.wire_bytes)
            new_t, new_opt, metrics = step(trainable, frozen, opt, batch)
            out["lm"][compressed] = {
                "loss": float(loss), "step_loss": float(metrics["loss"]),
                "grads": _numpy(grads) if rank == 0 else None,
                "digests": (_digest(grads), _digest(new_t),
                            _digest(new_opt)),
                "wire": wire}

    # the int8 all-reduce of one tensor
    g = torch.from_numpy(compress_grads()[rank])
    red, err = compress.all_reduce_int8(g, torch.zeros_like(g), mesh, "data")
    out["compress"] = (red.numpy(), err.numpy())

    # elastic restore of a single-process save onto (data 2, model 2)
    mesh = mesh_lib.make_mesh(RESTORE_MESH, backend="gloo")
    t_sh, _, o_sh, _ = steps.model_state_shardings(cfg, mesh, model)
    tmpl_t, _ = rebranch.partition(params)
    at, t, o, _ = ckpt.restore(ckpt_dir, tmpl_t, optim.init(tmpl_t), params,
                               shardings=(t_sh, o_sh), device="cpu")
    from repro_torch import bridge
    out["restore"] = {
        "step": at, "t": _numpy(t), "o": _numpy(o),
        "bounds": {k: shd.block_bounds(tuple(v.shape), sh)
                   for k, v, sh in [
                       (k, v, bridge.flatten(t_sh)[k])
                       for k, v in bridge.flatten(tmpl_t).items()]},
        "coord": {a: mesh.coordinate(a) for a in mesh.axis_names}}

    # the train CLI inside the world: --compress, rank 0's checkpoints,
    # --resume on every rank
    args = ["--arch", "gemma_2b", "--smoke", "--steps", "2", "--batch", "4",
            "--seq", "16", "--warmup", "1", "--ckpt-dir", cli_dir,
            "--ckpt-every", "1", "--log-every", "1", "--compress"]
    first = train_cli.main(args, device="cpu")
    args[4] = "3"
    more = train_cli.main(args + ["--resume"], device="cpu")
    out["cli"] = (first, more, ckpt.latest_steps(cli_dir))
    return out


def _cnn_cfg(name: str, dense: bool = False):
    from repro_torch.core.rebranch import ReBranchSpec
    from repro_torch.models import cnn
    cfg = cnn.CNNConfig(name=name, input_size=cnn_size(name))
    if dense:
        cfg = dataclasses.replace(cfg, rebranch=ReBranchSpec(enabled=False))
    return cfg


# ---------------------------------------------------------------------------
# test_torch_tp.py: LM tensor-parallel serving
# ---------------------------------------------------------------------------

TP_MESHES = ((1, 4), (2, 2))               # (data, model)
TP_POD_MESH = (2, 2, 1)                    # (pod, data, model)
# Yi's smoke config (kv 2: head-split over model 2, sequence-split over
# 4), Gemma's (kv 1), and Yi's with d_ff 1536: its down projection's three
# k-blocks deal 1, 1, 1, 0 over model 4 and 2, 1 over model 2, and its
# even split (384, 768 a rank) cuts a block
TP_EVEN = ("yi_34b", "gemma_2b", "yi_34b_ff1536")
# uneven heads, on (1, 4): Gemma's with 3 heads (1, 1, 1, 0 a rank: a rank
# without heads, MQA's one group read by three ranks), Yi's with 6 heads
# over 2 kv heads (2, 2, 2, 0; rep 3: groups split between ranks), the
# same at max_len 30 (neither the kv heads nor 30 divide 4: a whole cache
# on every rank), and Qwen1.5's with 6 heads and its seeded q/k/v biases
# (each rank's q bias cut on its whole heads, 2, 2, 2, 0)
TP_UNEVEN = ("gemma_2b_h3", "yi_34b_h6", "yi_34b_h6_len30", "qwen15_32b_h6")
TP_CONFIGS = TP_EVEN + TP_UNEVEN
# (config, mesh shape): the even configs on both meshes, the uneven ones on
# (1, 4), Yi's and Gemma's smoke configs on (pod 2, data 2, model 1), a
# batch over pod x data
TP_CASES = ([(n, s) for n in TP_EVEN for s in TP_MESHES]
            + [(n, (1, 4)) for n in TP_UNEVEN]
            + [(n, TP_POD_MESH) for n in ("yi_34b", "gemma_2b")])
TP_ENGINES = ("int8_native", "pallas", "pallas_fused")
TP_BATCH, TP_PROMPT, TP_MAX_LEN, TP_STEPS = 8, 8, 32, 4
# (config, site, d_in, d_out) held site by site, in layer 0
TP_ROW_SITES = (("yi_34b_ff1536", "down"), ("yi_34b", "o"),
                ("gemma_2b", "down"), ("gemma_2b", "o"),
                ("yi_34b_h6", "o"), ("gemma_2b_h3", "o"))
TP_COL_SITES = (("yi_34b_ff1536", "gate"), ("yi_34b", "q"),
                ("gemma_2b", "k"), ("yi_34b_h6", "q"), ("gemma_2b_h3", "q"),
                ("qwen15_32b_h6", "q"))


def tp_shapes(name: str) -> list:
    """The mesh shapes config ``name`` runs on."""
    return [s for n, s in TP_CASES if n == name]


def tp_max_len(name: str) -> int:
    return 30 if name.endswith("_len30") else TP_MAX_LEN


def tp_config(name: str):
    from repro_torch import configs
    name = name.removesuffix("_len30")
    if name == "yi_34b_ff1536":
        return dataclasses.replace(configs.get_smoke("yi_34b"), d_ff=1536)
    if name == "yi_34b_h6":
        return dataclasses.replace(configs.get_smoke("yi_34b"), num_heads=6,
                                   num_kv_heads=2, head_dim=8)
    if name == "gemma_2b_h3":
        return dataclasses.replace(configs.get_smoke("gemma_2b"),
                                   num_heads=3, head_dim=32)
    if name == "qwen15_32b_h6":
        return dataclasses.replace(configs.get_smoke("qwen15_32b"),
                                   num_heads=6, num_kv_heads=6, head_dim=8)
    return configs.get_smoke(name)


def tp_mesh(shape, backend: str):
    """A (data, model) mesh, or (pod, data, model) for three sizes."""
    from repro_torch.launch import mesh as mesh_lib
    if len(shape) == 3:
        return mesh_lib.make_mesh(shape, ("pod", "data", "model"),
                                  backend=backend)
    return mesh_lib.make_lm_mesh(*shape, backend=backend)


def tp_port_tree(name: str) -> dict:
    """The port's init of ``name`` with seeded non-zero cores and biases,
    as numpy (the same in every process)."""
    from repro_torch import bridge, deploy
    tree = bridge.to_numpy(deploy.compile_model(tp_config(name)).init(
        seed=0, device="cpu"))
    return with_biases(with_cores(tree, np.random.default_rng(1)),
                       np.random.default_rng(2))


def tp_prompts(vocab: int, batch: int = TP_BATCH) -> np.ndarray:
    return np.random.default_rng(7).integers(
        0, vocab, (batch, TP_PROMPT)).astype(np.int32)


def tp_site(cfg, params, site: str):
    """(layer-0 params of ``site``, d_in, d_out, module key)."""
    block = "mlp" if site in ("gate", "up", "down") else "attn"
    d, ff = cfg.d_model, cfg.d_ff
    hd, kvd = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
    dims = {"q": (d, hd), "k": (d, kvd), "v": (d, kvd), "o": (hd, d),
            "gate": (d, ff), "up": (d, ff), "down": (ff, d)}[site]
    leaf = {k: {kk: vv[0] for kk, vv in v.items()}
            for k, v in params["layers"][block][site].items()}
    return leaf, dims[0], dims[1]


def tp_steps(cfg, whole, mesh, engine: str, max_len: int = TP_MAX_LEN,
             batch: int = TP_BATCH):
    """(logits, tokens [B, 1 + TP_STEPS]) of the prefill step and
    TP_STEPS greedy serve steps on the prompts, over ``mesh`` (None: the
    unsharded steps), and (model, local params, cache); the sharding
    counters hold the last serve step's bytes."""
    from repro_torch import deploy
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import steps
    prompts = torch.from_numpy(tp_prompts(cfg.vocab_size, batch))
    model = deploy.compile_model(cfg, engine=engine, mesh=mesh)
    params = model.shard_params(whole)
    logits, cache = steps.make_prefill_step(
        cfg, batch, max_len, model=model, device="cpu")(
            params, {"tokens": prompts})
    serve = steps.make_serve_step(cfg, model=model)
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    toks = [tok]
    for i in range(TP_STEPS):
        if i == TP_STEPS - 1:
            shd.reset_traffic()       # the last step's bytes (tp_world)
        tok, cache = serve(params, {"tokens": tok}, cache)
        toks.append(tok)
    return (logits.numpy(), torch.cat(toks, 1).numpy()), (model, params,
                                                          cache)


def _tp_batch_invariance(cfg, model, params, cache, max_len) -> dict:
    """Two decode steps of the batch-8 cache against the same steps of a
    small batch made of its first local row on every rank (batch 1 on a
    single data rank; over data 2, rows 0 and 4: each data rank's first;
    over pod 2 x data 2, rows 0, 2, 4 and 6): that row's logits,
    bitwise."""
    import copy
    import math

    from repro_torch.distributed import sharding as shd
    n_data = math.prod(model.mesh.shape.get(a, 1) for a in ("pod", "data"))
    small = 1 if n_data == 1 else n_data
    rows = [shd.h_layout(TP_BATCH, n_data)[d][0] for d in range(n_data)]
    big = copy.deepcopy(cache)
    sm = model.init_cache(small, max_len, device="cpu")
    for leaf in ("k", "v"):
        sm["layers"][leaf].copy_(big["layers"][leaf][:, :1])
    sm["layers"]["length"].copy_(big["layers"]["length"][:, rows])
    tok = torch.from_numpy(tp_prompts(cfg.vocab_size)[:, :1])
    lo, hi = shd.batch_block(TP_BATCH, model.mesh)
    got = []
    for _ in range(2):
        lb, big = model.decode_step(params, tok[lo:hi], big)
        ls, sm = model.decode_step(params, tok[lo:lo + 1], sm)
        got.append((lb[:1].numpy(), ls.numpy()))
    return {"pairs": got}


def _tp_row_site(cfg, whole, mesh, site: str, engine: str) -> dict:
    """A row-parallel site: the reduced trunk against the rank-order sum
    of the plain version over ``k_layout``'s ranges (bitwise), the output
    against the unsharded site's, and the relayout traffic."""
    from repro_torch import deploy
    from repro_torch.core import cim, quant, rebranch
    from repro_torch.distributed import sharding as shd
    from repro_torch.kernels import cim_matmul as cm
    from repro_torch.kernels import rebranch_matmul as rm
    model = deploy.compile_model(cfg, engine=engine, mesh=mesh)
    spec = dataclasses.replace(cfg.rebranch, trunk_impl=engine)
    p_all, d_in, d_out = tp_site(cfg, whole, site)
    p_loc, _, _ = tp_site(cfg, model.shard_params(whole), site)
    x = torch.from_numpy(np.random.default_rng(d_in + len(site)).normal(
        size=(3, 5, d_in)).astype(np.float32))
    r = mesh.coordinate("model")
    with shd.use_mesh(mesh):
        tp = shd.linear_tp(site, d_in, d_out, 128, head_dim=cfg.head_dim)
        lo, hi = tp.x_layout[r]
        shd.reset_traffic()
        parts = rebranch.row_parallel_parts(p_loc, x[..., lo:hi], spec, tp)
        traffic = dict(shd.bytes_sent)
        reduced = shd.rank_sum(shd.gather_parts(parts["trunk"], mesh,
                                                "model", "reduce"))
        y = rebranch.apply_linear(p_loc, x[..., lo:hi], spec, tp=tp)
    y_whole = rebranch.apply_linear(p_all, x, spec)
    x2 = x.reshape(-1, d_in)
    w, c = p_all["rom"]["w_q"], p_all["rom"]["C"]
    x_q = quant.quantize_activations(x2)[0]
    want = []
    for k0, k1 in tp.k_ranges:
        if k1 == k0:
            want.append(torch.zeros((x2.shape[0], d_out)))
        elif engine == "pallas_fused":
            want.append(rm.rebranch_matmul_plain(x2[:, k0:k1], w[k0:k1],
                                                 c[k0:k1], spec.cim)[0])
        elif engine == "pallas":
            want.append(cm.cim_matmul_plain(x_q[:, k0:k1], w[k0:k1],
                                            spec.cim))
        else:
            want.append(cim.cim_matmul_model(x_q[:, k0:k1], w[k0:k1],
                                             spec.cim))
    return {"equal": torch.equal(reduced, shd.rank_sum(want)),
            "k_ranges": tp.k_ranges, "even": tp.x_layout,
            "y": y.numpy(), "y_whole": y_whole.numpy(),
            "relayout": traffic.get("relayout", 0),
            "empty": tp.k_ranges[r][0] == tp.k_ranges[r][1]}


def _tp_col_site(cfg, whole, mesh, site: str, engine: str) -> dict:
    """A column-parallel site: its trunk (branch off) bitwise the
    unsharded site's columns, its output with the branch within
    tolerance."""
    from repro_torch import deploy
    from repro_torch.core import rebranch
    from repro_torch.distributed import sharding as shd
    model = deploy.compile_model(cfg, engine=engine, mesh=mesh)
    spec = dataclasses.replace(cfg.rebranch, trunk_impl=engine)
    bare = dataclasses.replace(spec, branch_enabled=False)
    p_all, d_in, d_out = tp_site(cfg, whole, site)
    p_loc, _, _ = tp_site(cfg, model.shard_params(whole), site)
    x = torch.from_numpy(np.random.default_rng(d_out).normal(
        size=(3, 5, d_in)).astype(np.float32))
    with shd.use_mesh(mesh):
        tp = shd.linear_tp(site, d_in, d_out, 128, head_dim=cfg.head_dim)
        lo, hi = tp.cols
        trunk = rebranch.apply_linear(p_loc, x, bare, tp=tp)
        y = rebranch.apply_linear(p_loc, x, spec, tp=tp)
    out = {"trunk_equal": torch.equal(
        trunk, rebranch.apply_linear(p_all, x, bare)[..., lo:hi]),
        "y": y.numpy(),
        "y_whole": rebranch.apply_linear(p_all, x, spec)[..., lo:hi].numpy(),
        "cols": (lo, hi)}
    if engine == "pallas_fused" and hi > lo:   # kernel 3 on the columns
        from repro_torch.kernels import rebranch_matmul as rm
        x2, c = x.reshape(-1, d_in), p_all["rom"]["C"]
        out["trunk_equal"] &= torch.equal(
            rm.rebranch_trunk_sketch(x2, p_loc["rom"]["w_q"], c)[0],
            rm.rebranch_trunk_sketch(x2, p_all["rom"]["w_q"], c)[0][:, lo:hi])
    return out


def _tp_vocab(cfg, whole, mesh) -> dict:
    """The vocab-parallel lookup (bitwise) and the distributed argmax with
    ties across the ranks' vocab blocks (``torch.argmax``'s rule)."""
    from repro_torch import deploy
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import layers
    model = deploy.compile_model(cfg, mesh=mesh)
    local = model.shard_params(whole)
    ids = torch.from_numpy(tp_prompts(cfg.vocab_size))
    v, n = cfg.vocab_size, mesh.shape["model"]
    r = mesh.coordinate("model")
    logits = torch.zeros((4, 3, v))
    blk = v // n
    logits[0, :, [1, (blk + 1) % v]] = 5.0        # a tie across two ranks
    logits[1, :, [blk * (n - 1) + 2]] = 7.0       # the last rank's
    logits[2, :, [3, (3 + blk) % v]] = -1.0       # ties below zeros
    logits[3] = torch.from_numpy(np.random.default_rng(3).normal(
        size=(3, v)).astype(np.float32))
    with shd.use_mesh(mesh):
        emb = layers.apply_embedding(local["embed"], ids, cfg)
        arg = shd.vocab_argmax(logits[..., r * blk:(r + 1) * blk], v)
    return {"embed_equal": torch.equal(
        emb, layers.apply_embedding(whole["embed"], ids, cfg)),
        "argmax_equal": torch.equal(arg, torch.argmax(logits, dim=-1))}


def _tp_head(cfg, whole, mesh) -> dict:
    """The vocab-parallel readout (the tied table's rows, or Yi's
    column-parallel ``lm_head``): its whole logits and this rank's vocab
    block against the unsharded head's."""
    from repro_torch import deploy
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import transformer
    model = deploy.compile_model(cfg, engine="pallas", mesh=mesh)
    local = model.shard_params(whole)
    x = torch.from_numpy(np.random.default_rng(11).normal(
        size=(3, 2, cfg.d_model)).astype(np.float32))
    n, r = mesh.shape["model"], mesh.coordinate("model")
    with shd.use_mesh(mesh):
        got = transformer.apply_head(local, x, cfg)
        block = transformer.apply_head(local, x, cfg, whole_logits=False)
    want = transformer.apply_head(whole, x, cfg)
    lo, hi = shd.h_layout(cfg.vocab_size, n)[r]
    return {"logits": got.numpy(), "want": want.numpy(),
            "block_equal": torch.equal(block, got[..., lo:hi])}


def tp_world(rank: int, world: int, path: str) -> dict:
    """Every case of :data:`TP_CASES` under the three engines (the plain
    kernel versions): the sharded steps and the bytes of their last serve
    step, batch 8 against a small batch, the site checks over a model
    axis.  The configs the port initialises run first; the
    JAX-initialised trees are read from ``path`` once the test process
    has written it."""
    import os
    import time

    from repro_torch import bridge
    from repro_torch.distributed import sharding as shd
    warnings.simplefilter("ignore")
    meshes = {s: tp_mesh(s, "gloo") for s in dict.fromkeys(
        s for _, s in TP_CASES)}
    trees = {name: bridge.to_torch(tp_port_tree(name), "cpu")
             for name in TP_CONFIGS if name not in ("yi_34b", "gemma_2b")}
    out = {"steps": {}, "batch": {}, "row": {}, "col": {}, "vocab": {},
           "head": {}, "traffic": {}}
    for name in (*trees, "yi_34b", "gemma_2b"):
        while name not in trees:
            if os.path.exists(path):
                trees.update(torch.load(path))
            else:
                time.sleep(0.05)
        cfg, whole, max_len = tp_config(name), trees[name], tp_max_len(name)
        for shape in tp_shapes(name):
            mesh = meshes[shape]
            for engine in TP_ENGINES:
                res, (model, params, cache) = tp_steps(cfg, whole, mesh,
                                                       engine, max_len)
                out["steps"][name, shape, engine] = res
                out["traffic"][name, shape, engine] = dict(shd.bytes_sent)
                if engine == "pallas":
                    out["batch"][name, shape] = _tp_batch_invariance(
                        cfg, model, params, cache, max_len)
            out["vocab"][name, shape] = _tp_vocab(cfg, whole, mesh)
            out["head"][name, shape] = _tp_head(cfg, whole, mesh)
            if mesh.shape["model"] == 1:
                continue
            for engine in TP_ENGINES:
                for site in [s for n, s in TP_ROW_SITES if n == name]:
                    out["row"][name, site, shape, engine] = _tp_row_site(
                        cfg, whole, mesh, site, engine)
                for site in [s for n, s in TP_COL_SITES if n == name]:
                    out["col"][name, site, shape, engine] = _tp_col_site(
                        cfg, whole, mesh, site, engine)
    return out


# ---------------------------------------------------------------------------
# test_torch_tp_train.py and test_torch_dryrun.py: LM training over a
# model axis
# ---------------------------------------------------------------------------

# (config, mesh shape, sequence length): Gemma's smoke config on (1, 4)
# and (2, 2) and with a batch over (pod 2, data 2, model 1); 3 heads (a
# rank without heads), Yi's 6 heads over 2 kv heads (GQA groups split
# between ranks), Yi's d_ff 1536 (a down projection with an empty rank);
# Qwen1.5's 6 heads with biases at 15 tokens, which the model axis does
# not divide (no seq_sp: the residual stream whole on every rank)
TP_TRAIN_CASES = (("gemma_2b", (1, 4), 16), ("gemma_2b", (2, 2), 16),
                  ("gemma_2b_h3", (1, 4), 16), ("yi_34b_h6", (1, 4), 16),
                  ("yi_34b_ff1536", (1, 4), 16), ("gemma_2b", TP_POD_MESH, 16),
                  ("qwen15_32b_h6", (1, 4), 15))
TP_TRAIN_BATCH, TP_TRAIN_STEPS, TP_TRAIN_LR, TP_TRAIN_CHUNKS = 8, 2, 1e-3, 2
TP_TRAIN_COMPRESS = ("gemma_2b", (2, 2), 16)
TP_BYTES_CASE = ("gemma_2b", (1, 4), 16)   # the dry run's bytes held to it


def tp_train_batch(cfg, seq: int):
    from repro_torch.data import synthetic
    dcfg = synthetic.DataConfig(seed=0, vocab_size=cfg.vocab_size,
                                seq_len=seq, global_batch=TP_TRAIN_BATCH)
    return synthetic.markov_batch(dcfg, 0, device="cpu")


def tp_train_run(cfg, whole, mesh, seq: int, compress: bool = False,
                 steps_n: int = TP_TRAIN_STEPS) -> dict:
    """``steps_n`` train steps of ``cfg`` from the whole tree ``whole``
    (None mesh: one process on the whole batch), 'pallas' engine: each
    step's loss and grad_norm, the first step's gradients (as the step
    reduced them) and updated parameters, and on a mesh each leaf's block
    bounds and the leaves held in blocks."""
    from repro_torch import bridge, deploy, optim
    from repro_torch.core import rebranch
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import steps
    model = deploy.compile_model(cfg, engine="pallas", mesh=mesh)
    params = model.shard_params(whole)
    t, f = rebranch.partition(params)
    opt = optim.init(t)
    batch = tp_train_batch(cfg, seq)
    if mesh is not None:
        batch = steps.local_batch(cfg, mesh, batch, TP_TRAIN_BATCH)
    step = steps.make_train_step(cfg, optim.AdamWConfig(lr=TP_TRAIN_LR),
                                 loss_chunks=TP_TRAIN_CHUNKS, model=model,
                                 compress=compress,
                                 global_batch=TP_TRAIN_BATCH)
    _, grads = step.grads(t, f, batch)           # the first step's
    out = {"grads": {k: v.numpy().copy() for k, v in
                     bridge.flatten(grads).items()},
           "loss": [], "grad_norm": []}
    step.err = None               # the compressed step starts at zero error
    for i in range(steps_n):
        t, opt, m = step(t, f, opt, batch)
        out["loss"].append(float(m["loss"]))
        out["grad_norm"].append(float(m["grad_norm"]))
        if i == 0:                # the first update
            out["updated"] = {k: v.numpy().copy() for k, v in
                              bridge.flatten(t).items()}
    if mesh is not None:
        sh = bridge.flatten(shd.param_shardings(whole, mesh))
        rows = cfg.rebranch.cim.rows_per_subarray
        out["bounds"] = {k: shd.param_bounds(k, tuple(v.shape), sh[k], rows,
                                             cfg.head_dim)
                         for k, v in bridge.flatten(
                             rebranch.partition(whole)[0]).items()}
        out["split"] = sorted(step.split_leaves(mesh))
    return out


def tp_train_world(rank: int, world: int) -> dict:
    """Every case of :data:`TP_TRAIN_CASES` over 4 gloo ranks, and one
    compressed step (:data:`TP_TRAIN_COMPRESS`)."""
    from repro_torch import bridge
    warnings.simplefilter("ignore")
    meshes = {s: tp_mesh(s, "gloo") for s in dict.fromkeys(
        s for _, s, _ in TP_TRAIN_CASES)}
    out = {"rank": rank}
    for name, shape, seq in TP_TRAIN_CASES:
        whole = bridge.to_torch(tp_port_tree(name), "cpu")
        out[name, shape, seq] = tp_train_run(tp_config(name), whole,
                                             meshes[shape], seq)
    name, shape, seq = TP_TRAIN_COMPRESS
    out["compress"] = tp_train_run(
        tp_config(name), bridge.to_torch(tp_port_tree(name), "cpu"),
        meshes[shape], seq, compress=True, steps_n=1)
    return out


def tp_bytes_world(rank: int, world: int) -> dict:
    """The bytes this rank sends, by kind, over one train step of
    :data:`TP_BYTES_CASE` (the dry run's step: default AdamW and loss
    chunks, 'pallas')."""
    from repro_torch import bridge, deploy, optim
    from repro_torch.core import rebranch
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import steps
    from repro_torch.optim import compress
    name, shape, seq = TP_BYTES_CASE
    cfg, mesh = tp_config(name), tp_mesh(shape, "gloo")
    model = deploy.compile_model(cfg, engine="pallas", mesh=mesh)
    t, f = rebranch.partition(model.shard_params(bridge.to_torch(
        tp_port_tree(name), "cpu")))
    batch = steps.local_batch(cfg, mesh, tp_train_batch(cfg, seq),
                              TP_TRAIN_BATCH)
    step = steps.make_train_step(cfg, model=model)
    shd.reset_traffic()
    compress.wire_bytes.clear()
    with shd.use_mesh(mesh):
        step(t, f, optim.init(t), batch)
    return {"bytes_sent": dict(shd.bytes_sent),
            "wire_bytes": dict(compress.wire_bytes)}


# ---------------------------------------------------------------------------
# test_torch_moe_tp.py: the moe family served over a mesh
# ---------------------------------------------------------------------------

# (config, mesh): Granite-MoE's smoke config (E 8) on (1, 4) and (2, 2):
# whole experts a rank (the "expert" layout; over (2, 2) the decode
# group of 8 tokens spans both data ranks); Qwen2-MoE's (E 6, ff 64) on
# (1, 4): each expert's ff columns ("expert_mlp", the down core cut on
# d_c) and the shared experts' MLP (ff 128); the same with ff 66, which
# neither E nor ff divide ("whole")
MOE_TP_CASES = (("granite_moe_3b", (1, 4)), ("granite_moe_3b", (2, 2)),
                ("qwen2_moe_a2_7b", (1, 4)), ("qwen2_moe_ff66", (1, 4)))
MOE_TP_LAYOUTS = {"granite_moe_3b": "expert", "qwen2_moe_a2_7b": "expert_mlp",
                  "qwen2_moe_ff66": "whole"}
# the routing groups' cases: Granite's smoke config at capacity 4 with a
# router skewed onto expert 0 (mesh, rows).  6 rows over (2, 2): prefill
# group 0 (tokens 0-31) spans data rank 0's rows 0-2 and rank 1's row 3,
# group 1 is rank 1's with the 16 pad tokens; a decode step's group is
# the 6 tokens of both ranks.  8 rows over (4, 1): prefill group 0 spans
# ranks 0 and 1, group 1 ranks 2 and 3; a decode step's group of 8 spans
# all four (ranks 1 and 2 hold its middle)
MOE_SKEW = "granite_moe_skew"
MOE_SKEW_CASES = (((2, 2), 6), ((4, 1), 8))
# the expert_mlp down trunks held bitwise, ff over model 4: the smoke
# config's and Qwen2-MoE's 1408 (352 rows a rank; the row sums pass
# 2**24, so the partials cross as int32)
MOE_TRUNK_FF = (64, 1408)


def moe_tp_config(name: str):
    from repro_torch import configs
    if name == "qwen2_moe_ff66":
        return dataclasses.replace(configs.get_smoke("qwen2_moe_a2_7b"),
                                   moe_d_ff=66)
    if name == "granite_moe_skew":
        return dataclasses.replace(configs.get_smoke("granite_moe_3b"),
                                   moe_capacity_factor=0.25)
    return configs.get_smoke(name)


def moe_tp_tree(name: str) -> dict:
    """The port's init of ``name`` with seeded non-zero cores (and biases),
    as numpy; the skewed config's embedding holds code 127 in column 0
    of every row and its routers weigh that column at 4 on expert 0, so
    every token's first choice is expert 0."""
    from repro_torch import bridge, deploy
    tree = bridge.to_numpy(deploy.compile_model(moe_tp_config(name)).init(
        seed=0, device="cpu"))
    tree = with_biases(with_cores(tree, np.random.default_rng(1)),
                       np.random.default_rng(2))
    if name == "granite_moe_skew":
        tree["embed"]["rom"]["table_q"][:, 0] = 127
        tree["layers"]["moe"]["router"]["sram"]["w"][:, 0, 0] = 4.0
    return tree


class DropCount:
    """Count the (token, expert) choices each ``moe.route`` call drops,
    over the positions the rank routes (its tokens and pads)."""

    def __init__(self):
        self.per_call = []

    def __enter__(self):
        from repro_torch.models import moe
        self.real = real = moe.route

        def route(params, xg, cfg, groups=None):
            out = real(params, xg, cfg, groups)
            own = None if groups is None else groups.own(xg.device)
            dropped = ~out[3] if own is None else ~out[3] & own[..., None]
            self.per_call.append(int(dropped.sum()))
            return out
        moe.route = route
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe
        moe.route = self.real


class SumCheck:
    """Record every rank-order sum of the moe block (``sharding.sum_parts``
    and ``sum_chunk`` of the ``expert`` kinds) and hold each to a plain
    :func:`rank_sum` of the ranks' gathered parts (bitwise)."""

    def __init__(self, mesh):
        self.mesh, self.calls = mesh, []

    def __enter__(self):
        from repro_torch.distributed import sharding as shd
        self.real = parts, chunk = shd.sum_parts, shd.sum_chunk

        def sum_parts(g, mesh, axis, kind):
            out = parts(g, mesh, axis, kind)
            if kind.startswith("expert"):
                self.calls.append((g.clone(), None, out))
            return out

        def sum_chunk(g, dim, layout, mesh, axis, kind):
            out = chunk(g, dim, layout, mesh, axis, kind)
            self.calls.append((g.clone(), (dim, layout), out))
            return out
        shd.sum_parts, shd.sum_chunk = sum_parts, sum_chunk
        return self

    def __exit__(self, *exc):
        from repro_torch.distributed import sharding as shd
        shd.sum_parts, shd.sum_chunk = self.real

    def equal(self) -> tuple[int, bool]:
        """(sums held, every one bitwise the rank-order sum)."""
        from repro_torch.distributed import sharding as shd
        ok = True
        r = self.mesh.coordinate("model")
        for g, cut, out in self.calls:
            want = shd.rank_sum(shd.gather_parts(g, self.mesh, "model",
                                                 "check"))
            if cut is not None:
                dim, layout = cut
                lo, hi = layout[r]
                want = want.narrow(dim, lo, hi - lo)
            ok &= torch.equal(want, out)
        return len(self.calls), ok


def moe_down_trunk(ff: int, mesh, whole=None) -> dict:
    """A down stack row-parallel on ff over the model axis
    (``moe.row_parallel_trunk``, the rank's ff rows of w_q and columns of
    x): the int32 sums and the row scales against the unsharded
    ``int8_bmm`` of x quantised whole (bitwise).  ``whole``: layer 0's
    down w_q [E, ff, d] of a tree, else +-127-heavy codes whose row sums
    pass 2**24."""
    from repro_torch.core import quant
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import moe
    rng = np.random.default_rng(ff)
    if whole is None:
        w_q = torch.from_numpy(rng.choice(np.array(
            [127, 125, 123, 121], np.int8), size=(2, ff, 24)))
        x = torch.from_numpy(np.where(
            rng.random((2, 5, ff)) < 0.9, 3.0,
            np.clip(rng.normal(size=(2, 5, ff)), -2.9, 2.9))
            .astype(np.float32))
    else:
        w_q = whole
        x = torch.from_numpy(rng.normal(size=(w_q.shape[0], 5, ff))
                             .astype(np.float32))
    lo, hi = shd.h_layout(ff, mesh.shape["model"])[mesh.coordinate("model")]
    trunk, sx = moe.row_parallel_trunk(x[..., lo:hi].contiguous(),
                                       w_q[:, lo:hi], mesh, "model")
    x_q, sx_whole = quant.quantize_activations(x)
    want = moe.int8_bmm(x_q, w_q)
    return {"equal": torch.equal(trunk.float(), want)
            and torch.equal(sx, sx_whole),
            "past_f32": float(want.abs().max()) > 2 ** 24,
            "dtype": str(trunk.dtype)}


def moe_tp_run(name: str, whole, mesh, engine: str,
               batch: int = TP_BATCH) -> dict:
    """The steps of :func:`tp_steps` over ``mesh`` (None: unsharded) with
    the choices the routing drops per call counted, the bytes of the last
    serve step, and (over a mesh, ``pallas_fused``) the block's rank-order
    sums held over a prefill and a decode step."""
    import copy

    from repro_torch.distributed import sharding as shd
    cfg = moe_tp_config(name)
    with DropCount() as drops:
        res, (model, params, cache) = tp_steps(cfg, whole, mesh, engine,
                                               batch=batch)
    out = {"steps": res, "bytes": dict(shd.bytes_sent),
           "drops": drops.per_call}
    with shd.use_mesh(mesh):
        out["layout"] = shd.expert_layout(cfg.num_experts,
                                          cfg.moe_d_ff or cfg.d_ff)
    if engine == "pallas_fused" and mesh is not None:
        prompts = torch.from_numpy(tp_prompts(cfg.vocab_size, batch))
        lo, hi = shd.batch_block(batch, mesh)
        with SumCheck(mesh) as sums:
            fresh = model.init_cache(batch, TP_MAX_LEN, device="cpu")
            model.prefill(params, {"tokens": prompts[lo:hi]}, fresh)
            model.decode_step(params, prompts[lo:hi, :1],
                              copy.deepcopy(cache))
        out["sums"] = sums.equal()
    return out


def moe_tp_world(rank: int, world: int) -> dict:
    """Every case of :data:`MOE_TP_CASES` under the three engines, the
    routing groups' cases (:data:`MOE_SKEW_CASES`), and the expert_mlp
    down trunks of :data:`MOE_TRUNK_FF`."""
    from repro_torch import bridge
    warnings.simplefilter("ignore")
    shapes = dict.fromkeys([s for _, s in MOE_TP_CASES]
                           + [s for s, _ in MOE_SKEW_CASES])
    meshes = {s: tp_mesh(s, "gloo") for s in shapes}
    out = {"runs": {}, "trunk": {}}
    for name, shape in MOE_TP_CASES:
        whole = bridge.to_torch(moe_tp_tree(name), "cpu")
        for engine in TP_ENGINES:
            out["runs"][name, shape, engine] = moe_tp_run(
                name, whole, meshes[shape], engine)
        if MOE_TP_LAYOUTS[name] == "expert_mlp":
            w_q = whole["layers"]["moe"]["experts"]["down"]["rom"]["w_q"][0]
            out["trunk"][name] = moe_down_trunk(w_q.shape[1], meshes[shape],
                                                w_q)
    for ff in MOE_TRUNK_FF:
        out["trunk"][ff] = moe_down_trunk(ff, meshes[(1, 4)])
    skew = bridge.to_torch(moe_tp_tree(MOE_SKEW), "cpu")
    out["skew"] = {shape: moe_tp_run(MOE_SKEW, skew, meshes[shape],
                                     "pallas_fused", batch=batch)
                   for shape, batch in MOE_SKEW_CASES}
    return out


# ---------------------------------------------------------------------------
# test_torch_moe_tp_train.py: the moe family trained over a mesh, and a
# data rank without rows
# ---------------------------------------------------------------------------

# (config, mesh, sequence length): Granite-MoE's smoke config (E 8, whole
# experts a rank) on (1, 4) and on (2, 2), where 8 rows of 12 tokens make
# 3 routing groups of 32 and data rank 0's tokens 0-47 cut group 1;
# Qwen2-MoE's (E 6, ff 64: each expert's ff columns, its shared experts'
# MLP); the same with ff 66 (every expert whole on every rank).  At 16
# tokens the residual stream takes seq_sp over model 4 (each rank its
# chunk); at 15 it stays whole (Megatron's f into the expert layouts)
MOE_TRAIN_CASES = (("granite_moe_3b", (1, 4), 16),
                   ("granite_moe_3b", (2, 2), 12),
                   ("qwen2_moe_a2_7b", (1, 4), 16),
                   ("qwen2_moe_ff66", (1, 4), 16),
                   ("granite_moe_3b", (1, 4), 15),
                   ("qwen2_moe_a2_7b", (1, 4), 15))
MOE_TRAIN_BATCH, MOE_TRAIN_STEPS, MOE_TRAIN_LR = 8, 2, 1e-3
# a data rank without rows: 6 rows over data 4 go 2, 2, 2, 0 and 5 rows
# 2, 2, 1, 0 (GSPMD's uneven layout, ``sharding.batch_block``)
EMPTY_MESH = (4, 1)
EMPTY_SERVE = (("gemma_2b", 6), ("granite_moe_3b", 6))
EMPTY_TRAIN = (6, 5)


def moe_train_batch(cfg, seq: int, rows: int = MOE_TRAIN_BATCH):
    from repro_torch.data import synthetic
    dcfg = synthetic.DataConfig(seed=0, vocab_size=cfg.vocab_size,
                                seq_len=seq, global_batch=rows)
    return synthetic.markov_batch(dcfg, 0, device="cpu")


def _bounds(cfg, whole, mesh) -> dict:
    """Each trainable leaf's block bounds on this rank."""
    from repro_torch import bridge
    from repro_torch.core import rebranch
    from repro_torch.distributed import sharding as shd
    sh = bridge.flatten(shd.param_shardings(whole, mesh))
    experts = ((cfg.num_experts, cfg.moe_d_ff or cfg.d_ff)
               if cfg.family == "moe" else None)
    return {k: shd.param_bounds(k, tuple(v.shape), sh[k],
                                cfg.rebranch.cim.rows_per_subarray,
                                cfg.head_dim, experts)
            for k, v in bridge.flatten(rebranch.partition(whole)[0]).items()}


def moe_train_run(cfg, whole, mesh, seq: int, rows: int = MOE_TRAIN_BATCH,
                  steps_n: int = MOE_TRAIN_STEPS, remat_off: bool = True
                  ) -> dict:
    """``steps_n`` 'pallas' train steps of ``cfg`` (default loss chunks,
    the dry run's) on ``rows`` sequences from the whole tree ``whole``
    (None mesh: one process on the whole batch): each step's loss, the
    first step's gradients, update and bytes sent by kind (its grads and
    update, as one call sends), and with ``remat_off`` the first
    gradients again with remat off; on a mesh the leaves' bounds and the
    leaves held in blocks."""
    from repro_torch import bridge, deploy, optim
    from repro_torch.core import rebranch
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import steps
    model = deploy.compile_model(cfg, engine="pallas", mesh=mesh)
    t, f = rebranch.partition(model.shard_params(whole))
    opt = optim.init(t)
    batch = moe_train_batch(cfg, seq, rows)
    if mesh is not None:
        batch = steps.local_batch(cfg, mesh, batch, rows)
    step = steps.make_train_step(cfg, optim.AdamWConfig(lr=MOE_TRAIN_LR),
                                 model=model, global_batch=rows)
    shd.reset_traffic()
    loss, grads = step.grads(t, f, batch)
    t, opt, m = step.update(t, opt, loss, grads)
    out = {"bytes": dict(shd.bytes_sent), "loss": [float(m["loss"])],
           "grad_norm": float(m["grad_norm"]),
           "grads": {k: v.numpy().copy()
                     for k, v in bridge.flatten(grads).items()},
           "updated": {k: v.numpy().copy()
                       for k, v in bridge.flatten(t).items()}}
    for _ in range(steps_n - 1):
        t, opt, m = step(t, f, opt, batch)
        out["loss"].append(float(m["loss"]))
    if remat_off:
        off = dataclasses.replace(cfg, remat=False)
        t0, _ = rebranch.partition(model.shard_params(whole))
        l_off, g_off = steps.make_train_step(
            off, optim.AdamWConfig(lr=MOE_TRAIN_LR),
            model=deploy.compile_model(off, engine="pallas", mesh=mesh),
            global_batch=rows).grads(t0, f, batch)
        out["remat_equal"] = bool(torch.equal(l_off, loss)) and all(
            torch.equal(g, grads_k) for g, grads_k in zip(
                bridge.flatten(g_off).values(),
                bridge.flatten(grads).values()))
    if mesh is not None:
        out["bounds"] = _bounds(cfg, whole, mesh)
        out["split"] = sorted(step.split_leaves(mesh))
        with shd.use_mesh(mesh):
            out["layout"] = shd.expert_layout(cfg.num_experts,
                                              cfg.moe_d_ff or cfg.d_ff)
    return out


def empty_train_run(rows: int, mesh) -> dict:
    """One 'pallas' train step's loss and gradients of Gemma-2B's smoke
    config on ``rows`` sequences of 16 (None mesh: one process)."""
    from repro_torch import bridge, deploy, optim
    from repro_torch.core import rebranch
    from repro_torch.launch import steps
    cfg = tp_config("gemma_2b")
    model = deploy.compile_model(cfg, engine="pallas", mesh=mesh)
    whole = bridge.to_torch(tp_port_tree("gemma_2b"), "cpu")
    t, f = rebranch.partition(model.shard_params(whole))
    batch = moe_train_batch(cfg, 16, rows)
    if mesh is not None:
        batch = steps.local_batch(cfg, mesh, batch, rows)
    loss, grads = steps.make_train_step(
        cfg, optim.AdamWConfig(lr=MOE_TRAIN_LR), model=model,
        global_batch=rows).grads(t, f, batch)
    return {"rows": int(batch["tokens"].shape[0]), "loss": float(loss),
            "grads": {k: v.numpy().copy()
                      for k, v in bridge.flatten(grads).items()}}


def empty_serve_run(name: str, rows: int, mesh) -> tuple:
    """(logits, tokens) of :func:`tp_steps` ('pallas') on ``rows``
    prompts of config ``name`` (dense or moe), over ``mesh`` or (None)
    in one process."""
    from repro_torch import bridge
    if name == "gemma_2b":
        cfg, tree = tp_config(name), tp_port_tree(name)
    else:
        cfg, tree = moe_tp_config(name), moe_tp_tree(name)
    return tp_steps(cfg, bridge.to_torch(tree, "cpu"), mesh, "pallas",
                    batch=rows)[0]


def moe_train_world(rank: int, world: int) -> dict:
    """Every case of :data:`MOE_TRAIN_CASES` over 4 gloo ranks, then a
    data rank without rows (:data:`EMPTY_MESH`): the serving steps of
    :data:`EMPTY_SERVE` and a dense train step on each of
    :data:`EMPTY_TRAIN` rows."""
    from repro_torch import bridge
    warnings.simplefilter("ignore")
    shapes = dict.fromkeys([s for _, s, _ in MOE_TRAIN_CASES]
                           + [EMPTY_MESH])
    meshes = {s: tp_mesh(s, "gloo") for s in shapes}
    out = {"rank": rank, "runs": {}, "serve": {}, "train": {}}
    for name, shape, seq in MOE_TRAIN_CASES:
        whole = bridge.to_torch(moe_tp_tree(name), "cpu")
        out["runs"][name, shape, seq] = moe_train_run(
            moe_tp_config(name), whole, meshes[shape], seq)
    mesh = meshes[EMPTY_MESH]
    for name, rows in EMPTY_SERVE:
        out["serve"][name, rows] = empty_serve_run(name, rows, mesh)
    for rows in EMPTY_TRAIN:
        out["train"][rows] = empty_train_run(rows, mesh)
    return out
