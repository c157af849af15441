"""The paper's own models: VGG-8, ResNet-18, DarkNet-19, Tiny-YOLO (port
of ``repro.models.cnn``).

ReBranchConv (paper Fig. 7-8): frozen int8 trunk conv (ROM) in parallel
with  1x1 compress -> KxK trainable core -> 1x1 decompress  (branch).
NHWC activations and HWIO weights, as in the JAX package, so converted
parameters line up key for key.  The trunk resolves ``spec.trunk_impl``
through the ``repro_torch.engine`` registry; per-site overrides come in
through ``cfg.rebranch_overrides`` (see ``config.spec_for``).  With
``cfg.fuse_bn_act`` the inference BN affine + activation fold into the
trunk conv's engine epilogue.

Initialisation draws from an explicit ``torch.Generator`` on the CPU and
moves the tree to the target device, so a seed gives the same parameters
on every device.

Under a mesh (``distributed.sharding.use_mesh``, bound by
``deploy.compile_model(mesh=)``) activations are this rank's slab of the H
layout (of its block of the batch, where the mesh has a ``pod`` axis;
``deploy`` gathers the batch after the head).  The rows move only where
GSPMD moved them for the reference: the trunk conv in its engine
('pallas_sharded'), the branch's KxK core and SRAM convs in
``halo_conv.sharded_conv_nhwc``, a pool whose 2x2 windows straddle a
cut, and the heads (VGG-8's flatten, ResNet-18's mean, the YOLO
predictor's output), which gather H so that every rank returns the whole
output.  Every move is differentiable, so the branches train on the
layout.  Without a mesh every line runs as on one device.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch import bridge
from repro_torch import engine as engine_lib
from repro_torch.core import quant
from repro_torch.core.rebranch import ReBranchSpec, conv_nhwc
from repro_torch.distributed import sharding as shd
from repro_torch.engine import base as engine_base
from repro_torch.kernels.halo_conv import sharded_conv_nhwc
from repro_torch.models.config import spec_for


def _randn(gen, *shape):
    return torch.randn(shape, generator=gen, dtype=torch.float32)


def _pool(x):
    """2x2 VALID max pool (NHWC).  Under a mesh, each rank first fetches
    the input rows of its output rows' windows (the reference's
    ``shard(x, "cnn_batch", "cnn_h")`` after its pool): rows move only
    where a window straddles a cut."""
    at = shd.h_axis()
    if at is not None:
        mesh, axis = at
        h, n = shd.global_h(x, mesh, axis), mesh.shape[axis]
        want = [(2 * a, 2 * b) for a, b in shd.h_layout(h // 2, n)]
        x = shd.move_rows(x, shd.h_layout(h, n), want, mesh, axis,
                          "relayout")
    n, h, w, c = x.shape
    x = x[:, :h // 2 * 2, :w // 2 * 2]
    return x.reshape(n, h // 2, 2, w // 2, 2, c).amax(dim=(2, 4))


# ---------------------------------------------------------------------------
# ReBranch convolution
# ---------------------------------------------------------------------------

def init_conv(gen, k: int, c_in: int, c_out: int, spec: ReBranchSpec,
              *, w_init=None):
    if w_init is None:
        w_init = _randn(gen, k, k, c_in, c_out) * math.sqrt(2.0 / (k * k * c_in))
    if not spec.enabled:
        return {"sram": {"w": w_init}}
    w_q, scale = quant.quantize_weights(w_init, axis=(0, 1, 2))
    p = {"rom": {"w_q": w_q, "w_scale": scale}, "sram": {}}
    if spec.branch_enabled:
        c_c = max(1, c_in // spec.d_ratio)
        c_u = max(1, c_out // spec.u_ratio)
        p["rom"]["C"] = _randn(gen, 1, 1, c_in, c_c) / math.sqrt(c_in)
        p["rom"]["U"] = _randn(gen, 1, 1, c_u, c_out) / math.sqrt(c_u)
        p["sram"]["core"] = torch.zeros((k, k, c_c, c_u))
    return p


def apply_conv(params, x, spec: ReBranchSpec, stride: int = 1,
               epilogue: engine_base.ConvEpilogue | None = None):
    """One ReBranch conv through the resolved TrunkEngine.

    With a live branch the activation is deferred until after the branch
    add, so act(BN(trunk + branch)) holds on every route.
    """
    if not spec.enabled:
        return engine_base.finish(
            sharded_conv_nhwc(x, params["sram"]["w"], stride), epilogue)
    rom = params["rom"]
    eng = engine_lib.resolve(spec)          # strict + capability-gated
    if "conv" not in eng.capabilities.sharded_ops and shd.h_axis():
        raise ValueError(f"engine {eng.name!r} does not run a conv on the "
                         f"H layout of a mesh; deploy on 'pallas_sharded'")
    has_branch = spec.branch_enabled and "core" in params["sram"]
    fuse = epilogue is not None and eng.capabilities.epilogue
    if has_branch and "conv" in eng.capabilities.fused_ops:
        y = eng.fused_conv(spec.cim, x, rom["w_q"], rom["w_scale"],
                           rom["C"], params["sram"]["core"], rom["U"],
                           stride=stride, padding="SAME",
                           epilogue=epilogue if fuse else None)
        return y if fuse else engine_base.finish(y, epilogue)
    trunk_ep = (epilogue.without_act() if has_branch else epilogue) \
        if fuse else None
    y = eng.conv(spec.cim, x, rom["w_q"], rom["w_scale"],
                 stride=stride, padding="SAME", epilogue=trunk_ep)
    if has_branch:
        t = conv_nhwc(x, rom["C"].to(x.dtype), 1)
        t = sharded_conv_nhwc(t, params["sram"]["core"].to(x.dtype), stride)
        b = conv_nhwc(t, rom["U"].to(x.dtype), 1)
        if fuse:
            if epilogue.scale is not None:
                b = b * epilogue.scale.to(b.dtype)
            return engine_base.activate(y + b, epilogue)
        return engine_base.finish(y + b, epilogue)
    return y if fuse or epilogue is None else engine_base.finish(y, epilogue)


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------

def _bn_init(c):
    return {"sram": {"scale": torch.ones(c), "bias": torch.zeros(c),
                     "mean": torch.zeros(c), "var": torch.ones(c)}}


def bn_epilogue(bn_params, act: str | None = None) -> engine_base.ConvEpilogue:
    """Inference BN (frozen statistics) plus an optional activation, as a
    fusable conv epilogue — the one home of the BN affine."""
    s = bn_params["sram"]
    inv = torch.rsqrt(s["var"] + 1e-5) * s["scale"]
    return engine_base.ConvEpilogue(scale=inv, bias=s["bias"] - s["mean"] * inv,
                                    act=act)


def _bn_apply(p, x):
    return engine_base.finish(x, bn_epilogue(p))


def _leaky(x):
    return F.leaky_relu(x, 0.1)


@dataclasses.dataclass(frozen=True)
class CNNConfig:
    name: str
    num_classes: int = 100
    input_size: int = 32
    rebranch: ReBranchSpec = dataclasses.field(default_factory=ReBranchSpec)
    head_anchors: int = 5            # YOLO heads
    head_classes: int = 20           # VOC
    # per-layer mapping overrides ((site, ReBranchSpec), ...)
    rebranch_overrides: tuple = ()
    # fold BN + activation into the trunk conv's engine epilogue
    fuse_bn_act: bool = False


# ---------------------------------------------------------------------------
# VGG-8
# ---------------------------------------------------------------------------

VGG8_CHANNELS = (64, 64, 128, 128, 256, 256)   # conv layers, pool every 2


def init_vgg8(gen, cfg: CNNConfig):
    convs, bns = [], []
    c_in = 3
    for i, c in enumerate(VGG8_CHANNELS):
        convs.append(init_conv(gen, 3, c_in, c, spec_for(cfg, f"convs.{i}")))
        bns.append(_bn_init(c))
        c_in = c
    fc = {"sram": {
        "w": _randn(gen, c_in * (cfg.input_size // 8) ** 2,
                    cfg.num_classes) * 0.01,
        "b": torch.zeros(cfg.num_classes)}}
    return {"convs": convs, "bns": bns, "fc": fc}


def apply_vgg8(params, x, cfg: CNNConfig):
    for i, (conv, bn) in enumerate(zip(params["convs"], params["bns"])):
        spec = spec_for(cfg, f"convs.{i}")
        if cfg.fuse_bn_act:
            x = apply_conv(conv, x, spec, epilogue=bn_epilogue(bn, "relu"))
        else:
            x = F.relu(_bn_apply(bn, apply_conv(conv, x, spec)))
        if i % 2 == 1:
            x = _pool(x)
    x = shd.gather_h(x).flatten(1)
    return x @ params["fc"]["sram"]["w"] + params["fc"]["sram"]["b"]


# ---------------------------------------------------------------------------
# ResNet-18 (CIFAR variant)
# ---------------------------------------------------------------------------

RESNET18_STAGES = ((64, 2, 1), (128, 2, 2), (256, 2, 2), (512, 2, 2))


def init_resnet18(gen, cfg: CNNConfig):
    params = {"stem": init_conv(gen, 3, 3, 64, spec_for(cfg, "stem")),
              "stem_bn": _bn_init(64), "stages": []}
    c_in = 64
    for si, (c_out, blocks, stride) in enumerate(RESNET18_STAGES):
        stage = []
        for b in range(blocks):
            st = stride if b == 0 else 1
            site = f"stages.{si}.{b}"
            blk = {
                "conv1": init_conv(gen, 3, c_in, c_out,
                                   spec_for(cfg, f"{site}.conv1")),
                "bn1": _bn_init(c_out),
                "conv2": init_conv(gen, 3, c_out, c_out,
                                   spec_for(cfg, f"{site}.conv2")),
                "bn2": _bn_init(c_out),
            }
            if st != 1 or c_in != c_out:
                blk["proj"] = init_conv(gen, 1, c_in, c_out,
                                        spec_for(cfg, f"{site}.proj"))
                blk["proj_bn"] = _bn_init(c_out)
            stage.append(blk)
            c_in = c_out
        params["stages"].append(stage)
    params["fc"] = {"sram": {"w": _randn(gen, 512, cfg.num_classes) * 0.01,
                             "b": torch.zeros(cfg.num_classes)}}
    return params


def apply_resnet18(params, x, cfg: CNNConfig):
    def conv_bn(conv_p, bn_p, xx, spec, st=1, act=None):
        # fuse_bn_act: the BN affine always folds into the conv epilogue;
        # the activation only where it follows the conv (bn2 / proj_bn
        # feed the residual add, so their act stays outside)
        if cfg.fuse_bn_act:
            return apply_conv(conv_p, xx, spec, st,
                              epilogue=bn_epilogue(bn_p, act))
        y = _bn_apply(bn_p, apply_conv(conv_p, xx, spec, st))
        return F.relu(y) if act == "relu" else y

    x = conv_bn(params["stem"], params["stem_bn"], x,
                spec_for(cfg, "stem"), act="relu")
    for si, (stage, (_, _, stride)) in enumerate(
            zip(params["stages"], RESNET18_STAGES)):
        for b, blk in enumerate(stage):
            st = stride if b == 0 else 1
            site = f"stages.{si}.{b}"
            h = conv_bn(blk["conv1"], blk["bn1"], x,
                        spec_for(cfg, f"{site}.conv1"), st, act="relu")
            h = conv_bn(blk["conv2"], blk["bn2"], h,
                        spec_for(cfg, f"{site}.conv2"))
            sc = x
            if "proj" in blk:
                sc = conv_bn(blk["proj"], blk["proj_bn"], x,
                             spec_for(cfg, f"{site}.proj"), st)
            x = F.relu(h + sc)
    x = shd.gather_h(x).mean(dim=(1, 2))
    return x @ params["fc"]["sram"]["w"] + params["fc"]["sram"]["b"]


# ---------------------------------------------------------------------------
# DarkNet-19 backbone + YOLO head (the paper's headline model), Tiny-YOLO
# ---------------------------------------------------------------------------

# (channels, kernel) per layer; 'M' = maxpool — DarkNet-19 (YOLOv2 backbone)
DARKNET19 = [
    (32, 3), "M", (64, 3), "M",
    (128, 3), (64, 1), (128, 3), "M",
    (256, 3), (128, 1), (256, 3), "M",
    (512, 3), (256, 1), (512, 3), (256, 1), (512, 3), "M",
    (1024, 3), (512, 1), (1024, 3), (512, 1), (1024, 3),
]

TINY_YOLO = [
    (16, 3), "M", (32, 3), "M", (64, 3), "M", (128, 3), "M",
    (256, 3), "M", (512, 3), "M", (1024, 3),
]


def _darknet_layout(name: str):
    if name == "darknet19":
        return DARKNET19, [(1024, 3), (1024, 3)]
    return TINY_YOLO, [(512, 3)]


def _init_darknet(gen, cfg: CNNConfig):
    plan, head_convs = _darknet_layout(cfg.name)
    convs, bns = [], []
    c_in = 3
    for item in plan:
        if item == "M":
            continue                      # pools carry no params
        c, k = item
        convs.append(init_conv(gen, k, c_in, c,
                               spec_for(cfg, f"convs.{len(convs)}")))
        bns.append(_bn_init(c))
        c_in = c
    head = []
    for hi, (c, k) in enumerate(head_convs):
        head.append({"conv": init_conv(gen, k, c_in, c,
                                       spec_for(cfg, f"head.{hi}")),
                     "bn": _bn_init(c)})
        c_in = c
    n_out = cfg.head_anchors * (5 + cfg.head_classes)
    # the 1x1 predictor is always a plain trainable conv (no site)
    pred = init_conv(gen, 1, c_in, n_out,
                     dataclasses.replace(cfg.rebranch, enabled=False))
    return {"convs": convs, "bns": bns, "head": head, "pred": pred}


def apply_darknet(params, x, cfg: CNNConfig):
    plan, _ = _darknet_layout(cfg.name)

    def conv_bn_leaky(conv_p, bn_p, xx, spec):
        if cfg.fuse_bn_act:
            return apply_conv(conv_p, xx, spec,
                              epilogue=bn_epilogue(bn_p, "leaky_relu"))
        return _leaky(_bn_apply(bn_p, apply_conv(conv_p, xx, spec)))

    i = 0
    for item in plan:
        if item == "M":
            x = _pool(x)
        else:
            x = conv_bn_leaky(params["convs"][i], params["bns"][i], x,
                              spec_for(cfg, f"convs.{i}"))
            i += 1
    for hi, blk in enumerate(params["head"]):
        x = conv_bn_leaky(blk["conv"], blk["bn"], x,
                          spec_for(cfg, f"head.{hi}"))
    x = apply_conv(params["pred"], x,
                   dataclasses.replace(cfg.rebranch, enabled=False))
    x = shd.gather_h(x)
    b, h, w, _ = x.shape
    return x.reshape(b, h, w, cfg.head_anchors, 5 + cfg.head_classes)


MODEL_REGISTRY = {
    "vgg8": (init_vgg8, apply_vgg8),
    "resnet18": (init_resnet18, apply_resnet18),
    "darknet19": (_init_darknet, apply_darknet),
    "tiny_yolo": (_init_darknet, apply_darknet),
}


def _conv_sites(cfg: CNNConfig) -> list | None:
    """:func:`conv_site_shapes` with each conv's input resolution:
    ``(site, k, c_in, c_out, in_hw, out_hw, stride)``."""
    if cfg.name == "vgg8":
        out, c_in, hw = [], 3, cfg.input_size
        for i, c in enumerate(VGG8_CHANNELS):
            out.append((f"convs.{i}", 3, c_in, c, hw, hw, 1))
            c_in = c
            if i % 2 == 1:
                hw //= 2
        return out
    if cfg.name == "resnet18":
        hw = cfg.input_size
        out, c_in = [("stem", 3, 3, 64, hw, hw, 1)], 64
        for si, (c_out, blocks, stride) in enumerate(RESNET18_STAGES):
            for b in range(blocks):
                st = stride if b == 0 else 1
                hw_out = -(-hw // st)               # SAME stride st
                site = f"stages.{si}.{b}"
                out.append((f"{site}.conv1", 3, c_in, c_out, hw, hw_out, st))
                out.append((f"{site}.conv2", 3, c_out, c_out, hw_out, hw_out,
                            1))
                if st != 1 or c_in != c_out:        # same rule as init
                    out.append((f"{site}.proj", 1, c_in, c_out, hw, hw_out,
                                st))
                c_in, hw = c_out, hw_out
        return out
    if cfg.name in ("darknet19", "tiny_yolo"):
        plan, head = _darknet_layout(cfg.name)
        out, c_in, hw, ci = [], 3, cfg.input_size, 0
        for item in plan:
            if item == "M":
                hw //= 2
                continue
            c, k = item
            out.append((f"convs.{ci}", k, c_in, c, hw, hw, 1))
            c_in = c
            ci += 1
        for hi, (c, k) in enumerate(head):
            out.append((f"head.{hi}", k, c_in, c, hw, hw, 1))
            c_in = c
        return out
    return None


def conv_site_shapes(cfg: CNNConfig) -> list | None:
    """Every conv site of this config, in forward order, as
    ``(site, k, c_in, c_out, out_hw, stride)``; None for names outside
    MODEL_REGISTRY.  (The 1x1 'pred' conv never freezes into ROM and has
    no site.)"""
    sites = _conv_sites(cfg)
    return None if sites is None else [
        (site, k, c_in, c_out, out_hw, st)
        for site, k, c_in, c_out, _, out_hw, st in sites]


def override_sites(cfg: CNNConfig) -> set | None:
    """The site-name set of :func:`conv_site_shapes` (None when unknown)."""
    shapes = conv_site_shapes(cfg)
    return None if shapes is None else {s[0] for s in shapes}


# ---------------------------------------------------------------------------
# tape-out and the cost model's counts
# ---------------------------------------------------------------------------

def conv_trainable_frac(spec: ReBranchSpec) -> float:
    return 1.0 / (spec.d_ratio * spec.u_ratio)


def freeze_to_rom(params, gen: torch.Generator, spec: ReBranchSpec):
    """Tape-out of a pretrained all-trainable CNN: every plain 4-D conv
    (``{'sram': {'w': [k, k, c_in, c_out]}}``) becomes a ReBranch conv
    (int8 ROM trunk, fixed C/U, zero trainable core).  Dense heads (2-D
    ``w``) and BN stay SRAM.

    C and U are drawn from ``gen`` (on the CPU) conv by conv in tree
    order, and every frozen conv lands on its ``w``'s device, so one seed
    gives the same tree on the CPU and on the card.  The trunk is the JAX
    package's bit for bit; C and U are not (other generators).
    """
    def walk(node):
        if isinstance(node, dict):
            if set(node) == {"sram"} and "w" in node["sram"]:
                w = node["sram"]["w"]
                if w.dim() != 4:
                    return node              # dense head: stays SRAM
                p = init_conv(gen, w.shape[0], w.shape[2], w.shape[3], spec,
                              w_init=w)
                return bridge.tree_map(p, lambda t: t.to(w.device))
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        return node

    return walk(params)


def traced_ops(cfg: CNNConfig) -> list:
    """The convolutions and dot products one image's forward runs, as
    ``(output elements, MACs)`` in forward order — the ops the JAX
    package's ``count_macs_and_params`` finds in its jaxpr (every
    ``conv_general_dilated`` and ``dot_general``), from shapes.

    Per site that the reference lowering (``int8_native``, ``ideal``)
    traces: a ROM trunk is one int8 dot over the patches; a live branch
    three convs (1x1 compress at the input resolution, the k x k core at
    the site's stride, 1x1 decompress); an SRAM site one plain conv.
    Then the head: the 1x1 ``pred`` conv (YOLO) or the dense classifier.
    """
    ops, sites = [], _conv_sites(cfg)
    for site, k, c_in, c_out, in_hw, out_hw, _ in sites:
        spec = spec_for(cfg, site)
        n_out = out_hw * out_hw * c_out
        ops.append((n_out, n_out * k * k * c_in))    # trunk, or plain conv
        if spec.enabled and spec.branch_enabled:
            c_c = max(1, c_in // spec.d_ratio)
            c_u = max(1, c_out // spec.u_ratio)
            ops.append((in_hw * in_hw * c_c, in_hw * in_hw * c_c * c_in))
            ops.append((out_hw * out_hw * c_u,
                        out_hw * out_hw * c_u * k * k * c_c))
            ops.append((n_out, n_out * c_u))
    c_last, last_hw = sites[-1][3], sites[-1][5]
    if cfg.name in ("darknet19", "tiny_yolo"):
        n_pred = last_hw * last_hw * cfg.head_anchors * (5 + cfg.head_classes)
        ops.append((n_pred, n_pred * c_last))
    elif cfg.name == "vgg8":
        k_fc = c_last * (cfg.input_size // 8) ** 2
        ops.append((cfg.num_classes, cfg.num_classes * k_fc))
    else:                                            # resnet18: global pool
        ops.append((cfg.num_classes, cfg.num_classes * c_last))
    return ops


def count_macs_and_params(init_fn, apply_fn, cfg: CNNConfig):
    """Static (parameter count, MACs per image) for the energy model.

    Parameters are counted on ``init_fn``'s tree built with no memory
    (``bridge.abstract``); MACs from :func:`traced_ops`, which walks the
    sites by shape instead of tracing ``apply_fn`` (a trace of the port
    would count its own lowering: im2col, fused routes).  Both equal the
    JAX package's counts for its four paper models.
    """
    del apply_fn                  # the MACs come from shapes, not a trace
    tree = bridge.abstract(init_fn, torch.Generator(), cfg)
    n_params = sum(t.numel() for t in bridge.flatten(tree).values())
    return n_params, sum(macs for _, macs in traced_ops(cfg))
