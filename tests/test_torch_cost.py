"""``repro_torch.launch.cost`` (the step cost counter) against the JAX
package's ``repro.launch.hlo_cost`` and against itself across devices, on
the CPU.

Held:
  * ``tests/test_hlo_cost.py``'s five programs (a matmul, an int8 dot, a
    scan of 7, a nested scan of 5 x 3, a 3x3 SAME conv): the port's count
    of the same program in torch (loops for the scans, ``torch._int_mm``
    for the int8 dot) has exactly ``analyse_text``'s FLOPs;
  * each kernel wrapper in all three CiM modes: the same FLOPs, bytes and
    launches on the CPU (its plain version, whose ops count nothing) and
    on ``meta`` (no plain version, no launch);
  * a smoke dense decode step and a small CNN forward: the same record on
    the CPU and on ``meta``, the kernels' trunk FLOPs 2 x rows x the MACs
    of the ROM sites (``plan.site_tree``);
  * the smoke dense serve step under ``dequant`` against ``analyse_text``
    of the reference's compiled step: FLOPs exactly equal when the rows
    fill the port's 16-row buckets (the reference's scan over the layers
    counts each layer once per trip, as the port's loop runs them); with
    fewer rows the port also counts the zero rows it pads the bucketed
    ops with (``core.rows``), so its count lies between the reference's
    at those rows and at a whole bucket.  HBM bytes are not compared:
    the port's are op-granular, the reference's fusion-granular.
"""

import jax
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F

from repro import configs as jconfigs
from repro import deploy as jdeploy
from repro.launch import hlo_cost
from repro.launch import steps as jsteps
from repro_torch import bridge, configs, deploy, plan
from repro_torch.core import cim
from repro_torch.kernels import cim_matmul as cm
from repro_torch.kernels import rebranch_conv as rc
from repro_torch.kernels import rebranch_matmul as rm
from repro_torch.launch import cost
from repro_torch.launch import steps
from repro_torch.models import cnn

MODES = ("ideal", "per_subarray", "bitserial")


def _jax_flops(fn, *args) -> float:
    return hlo_cost.analyse_text(
        jax.jit(fn).lower(*args).compile().as_text())["flops"]


def _scan(x, w, n):
    for _ in range(n):
        x = x @ w
    return x


def _nested(x, w):
    for _ in range(5):
        x = _scan(x, w, 3)
    return x


def _jax_nested(x, w):
    def outer(c, _):
        return jax.lax.scan(lambda ci, _: (ci @ w, None), c, None,
                            length=3)[0], None
    return jax.lax.scan(outer, x, None, length=5)[0]


# (JAX program and inputs, the port's program and inputs)
PROGRAMS = {
    "matmul": ((lambda a, b: a @ b, jnp.zeros((128, 64)), jnp.zeros((64, 32))),
               (lambda a, b: a @ b, torch.zeros(128, 64), torch.zeros(64, 32))),
    "int8_dot": ((lambda a, b: jax.lax.dot_general(
        a, b, (((1,), (0,)), ((), ())), preferred_element_type=jnp.int32),
        jnp.zeros((64, 32), jnp.int8), jnp.zeros((32, 16), jnp.int8)),
        (torch._int_mm, torch.zeros(64, 32, dtype=torch.int8),
         torch.zeros(32, 16, dtype=torch.int8))),
    "scan": ((lambda x, w: jax.lax.scan(lambda c, _: (c @ w, None), x, None,
                                        length=7)[0],
              jnp.zeros((32, 32)), jnp.zeros((32, 32))),
             (lambda x, w: _scan(x, w, 7), torch.zeros(32, 32),
              torch.zeros(32, 32))),
    "nested_scan": ((_jax_nested, jnp.zeros((16, 16)), jnp.zeros((16, 16))),
                    (_nested, torch.zeros(16, 16), torch.zeros(16, 16))),
    "conv": ((lambda x, k: jax.lax.conv_general_dilated(
        x, k, (1, 1), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC")),
        jnp.zeros((1, 8, 8, 4)), jnp.zeros((3, 3, 4, 8))),
        (lambda x, k: F.conv2d(x, k, padding=1), torch.zeros(1, 4, 8, 8),
         torch.zeros(8, 4, 3, 3))),
}


@pytest.mark.parametrize("name", PROGRAMS)
def test_flops_equal_the_references_on_its_programs(name):
    (jfn, *jargs), (tfn, *targs) = PROGRAMS[name]
    got = cost.analyse(tfn, *targs)
    assert got["flops"] == _jax_flops(jfn, *jargs)
    assert got["flops"] == cost.analyse(
        tfn, *[a.to("meta") for a in targs])["flops"]


def test_views_count_nothing_and_in_place_ops_count_their_write_once():
    x = torch.zeros(4, 8)
    with cost.count() as rec:
        x.view(32).t()
        x.narrow(0, 1, 2).transpose(0, 1)
        x.add_(1.0)                        # writes x: 128 bytes once
        x[1:2].copy_(torch.ones(1, 8))     # 32 read + 32 written (+ ones)
    assert rec["by_op"]["aten.add_"]["bytes"] == 128
    assert rec["by_op"]["aten.copy_"]["bytes"] == 64
    assert set(rec["by_op"]) == {"aten.add_", "aten.ones", "aten.copy_"}


# ---------------------------------------------------------------------------
# the kernel wrappers
# ---------------------------------------------------------------------------

def _kernel_calls(cfg):
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 9, 7, 20, generator=g)
    w4 = torch.randint(-127, 128, (3, 3, 20, 12), generator=g,
                       dtype=torch.int8)
    xm = torch.randn(5, 300, generator=g).to(torch.bfloat16)
    w2 = torch.randint(-127, 128, (300, 24), generator=g, dtype=torch.int8)
    c = torch.randn(300, 10, generator=g)
    xq = torch.randint(-127, 128, (5, 300), generator=g, dtype=torch.int8)
    return {
        "trunk_conv": (rc.trunk_conv_dot, (x, w4, 2, "SAME", cfg),
                       2 * (2 * 5 * 4) * 180 * 12),
        "rebranch_matmul": (rm.rebranch_trunk_sketch, (xm, w2, c, cfg),
                            2 * 5 * 300 * 24),
        "cim_matmul": (cm.cim_matmul, (xq, w2, cfg), 2 * 5 * 300 * 24),
    }


def _on(device, args):
    return tuple(a.to(device) if isinstance(a, torch.Tensor) else a
                 for a in args)


@pytest.mark.parametrize("mode", MODES)
def test_each_kernel_counts_its_geometry_on_the_cpu_and_on_meta(mode):
    cfg = cim.CiMConfig(mode=mode)
    for name, (fn, args, trunk) in _kernel_calls(cfg).items():
        with cost.count() as on_cpu:
            want = fn(*args)
        with cost.count() as on_meta:
            got = fn(*_on("meta", args))
        assert on_cpu.summary() == on_meta.summary(), name
        assert on_cpu["kernels"] == on_meta["kernels"], name
        k = on_cpu["kernels"][name]
        assert (k["launches"], k["trunk_flops"]) == (1, trunk), name
        assert on_cpu["by_op"] == {} == on_meta["by_op"], name
        for w, g in zip(want if isinstance(want, tuple) else (want,),
                        got if isinstance(got, tuple) else (got,)):
            assert (g.device.type, g.shape, g.dtype) == (
                "meta", w.shape, w.dtype)


def test_meta_runs_no_plain_version_and_launches_nothing(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a plain version ran on meta")
    monkeypatch.setattr(rc, "trunk_patch_dot_plain", refuse)
    monkeypatch.setattr(rm, "rebranch_matmul_plain", refuse)
    monkeypatch.setattr(cm, "cim_matmul_plain", refuse)
    before = (rc.launches, rm.launches, cm.launches)
    for mode in MODES:
        for name, (fn, args, _) in _kernel_calls(
                cim.CiMConfig(mode=mode)).items():
            fn(*_on("meta", args))
            with cost.count():
                fn(*_on("meta", args))
    assert (rc.launches, rm.launches, cm.launches) == before


# ---------------------------------------------------------------------------
# whole steps
# ---------------------------------------------------------------------------

def _rom_macs(cfg) -> int:
    return sum(s.total_macs for s in plan.site_tree(cfg)
               if deploy.compile_model(cfg).layer_spec(s.name).enabled)


def _lm_decode(model, params, rows: int, max_len: int, device):
    cache = model.init_cache(rows, max_len, device=device)
    tok = torch.zeros((rows, 1), dtype=torch.int32, device=device)
    with cost.count() as rec:
        model.decode_step(params, tok, cache)
    return rec


def _same(a, b):
    assert a.summary() == b.summary()
    assert a["by_op"] == b["by_op"]
    assert a["kernels"] == b["kernels"]


def test_dense_decode_step_counts_the_same_on_the_cpu_and_on_meta():
    cfg = configs.get_smoke("gemma_2b")
    model = deploy.compile_model(cfg, engine="pallas_fused")
    params = model.init(seed=0, device="cpu")
    on_cpu = _lm_decode(model, params, 8, 32, "cpu")
    on_meta = _lm_decode(model, bridge.abstract(lambda: params), 8, 32,
                         "meta")
    _same(on_cpu, on_meta)
    k = on_cpu["kernels"]["rebranch_matmul"]
    assert k["launches"] == 7 * cfg.num_layers
    assert k["trunk_flops"] == 2 * 8 * _rom_macs(cfg)


def test_cnn_forward_counts_the_same_on_the_cpu_and_on_meta():
    cfg = cnn.CNNConfig(name="darknet19", input_size=32)
    model = deploy.compile_model(cfg, engine="pallas_fused")
    params = model.init(seed=0, device="cpu")
    x = torch.randn(2, 32, 32, 3, generator=torch.Generator().manual_seed(1))
    with cost.count() as on_cpu:
        model.forward(params, x)
    with cost.count() as on_meta:
        model.forward(bridge.abstract(lambda: params), x.to("meta"))
    _same(on_cpu, on_meta)
    k = on_cpu["kernels"]["trunk_conv"]
    assert k["launches"] == len(plan.site_tree(cfg)) == 20
    assert k["trunk_flops"] == 2 * 2 * _rom_macs(cfg)


@pytest.mark.parametrize("rows", [16, 8])
def test_dequant_step_flops_against_the_references_compiled_step(rows):
    max_len = 64
    jcfg = jconfigs.get_smoke("gemma_2b")
    jmodel = jdeploy.compile_model(jcfg, engine="dequant")
    jparams = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))

    def ref(b):
        return _jax_flops(jsteps.make_serve_step(jcfg, jmodel), jparams,
                          {"tokens": jax.ShapeDtypeStruct((b, 1), jnp.int32)},
                          jsteps.cache_specs(jcfg, b, max_len))

    cfg = configs.get_smoke("gemma_2b")
    model = deploy.compile_model(cfg, engine="dequant")
    params = bridge.abstract(lambda: model.init(seed=0, device="cpu"))
    got = cost.analyse(steps.make_serve_step(cfg, model), params,
                       {"tokens": torch.empty((rows, 1), dtype=torch.int32,
                                              device="meta")},
                       model.init_cache(rows, max_len, device="meta"))
    if rows == 16:
        assert got["flops"] == ref(rows)
    else:
        assert ref(rows) < got["flops"] < ref(16)


def test_repeated_counts_a_loop_body_once_per_trip():
    x, w = torch.zeros(8, 8, device="meta"), torch.zeros(8, 8, device="meta")
    with cost.count() as rec:
        with cost.repeated(7):
            x @ w
    assert rec["flops"] == 7 * 2 * 8 ** 3
    assert rec["by_op"]["aten.mm"]["calls"] == 7


@pytest.mark.parametrize("m", [40, 48, 1000])
def test_row_buckets_on_meta_count_what_the_cpu_runs(m):
    from repro_torch.core import rows
    x, w = torch.randn(m, 24), torch.randn(24, 40)

    def run(x, w):
        with cost.count() as rec:
            y = rows.rowwise(lambda a: torch.relu(a @ w), x)
        return rec, y

    on_cpu, y = run(x, w)
    on_meta, y_meta = run(x.to("meta"), w.to("meta"))
    _same(on_cpu, on_meta)
    assert on_cpu["peak_bytes"] == on_meta["peak_bytes"]
    assert (y_meta.shape, y_meta.dtype) == (y.shape, y.dtype)
