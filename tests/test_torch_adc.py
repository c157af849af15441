"""The port at the paper's 5-bit ADC fidelity (``per_subarray`` and
``bitserial`` CiM modes) against the JAX package, on the CPU.

On the CPU every kernel wrapper takes its plain PyTorch version; the CUDA
kernels are held to those plain versions on the card by
``test_torch_gpu.py``.

Tolerances and why:
  * ``cim_block_dot``, the macro math of one block, is held BITWISE to the
    JAX package's eager routine: both run the same ADC chain op by op
    (division by the lsb, ``+ 1e-3``, round half to even, clamp, ``* lsb``,
    one add per term in the same order).
  * The kernels' entry points (``trunk_conv_pallas``,
    ``rebranch_conv_pallas``, ``rebranch_matmul_pallas``,
    ``cim_conv_pallas``) are jitted in the JAX package, and XLA fuses the
    ADC chain (it may turn the division by the constant lsb into a
    reciprocal multiply, and FMA-contract the accumulation): 1e-6 of the
    absmax.  Float branch GEMMs on top: 1e-5 of the absmax, as in
    ``test_torch_kernels.py``.
  * ``core.cim``'s macro model sums each (group, plane) over all
    subarrays before adding it, where the kernels add term by term per
    k-block: up to ~450 roundings at the absmax per k-block in
    bitserial mode, so 1e-5 of the absmax (measured 2.0e-6).
  * Whole DarkNet-19 and Gemma-2B-smoke forwards: each layer on the same
    input at 1e-5 of the absmax, the whole forward loosely: the quantised
    networks are chaotic at the ulp level, and at ADC fidelity an int8
    code that moves can also move a subarray's ADC code by a whole step
    (1/31 of its range).  The JAX package's OWN DarkNet-19 forward at 32
    px in per_subarray mode moved by up to 7.0e-2 of its absmax when its
    input was perturbed by 1e-7 relative (one of four draws; the others
    ~1e-6), and the port's forward differs from it by 7.5e-2: the whole
    forward is held to 0.15.  Gemma-2B-smoke keeps test_torch_lm.py's
    5e-2 of the logits' absmax.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import deploy as jdeploy
from repro.core import cim as jcim
from repro.core import rebranch as jrebranch
from repro.kernels import ops as jops
from repro.kernels.cim_matmul import cim_block_dot as j_cim_block_dot
from repro.kernels.rebranch_conv import (cim_conv_pallas,
                                         rebranch_conv_pallas,
                                         trunk_conv_pallas)
from repro.kernels.rebranch_matmul import rebranch_matmul_pallas
from repro.models import cnn as jcnn
from repro_torch import bridge
from repro_torch import configs as tconfigs
from repro_torch import deploy as tdeploy
from repro_torch.core import cim as tcim
from repro_torch.core import rebranch as trebranch
from repro_torch.kernels import cim_matmul as tcm
from repro_torch.kernels import ops as tops
from repro_torch.kernels import rebranch_conv as trc
from repro_torch.kernels import rebranch_matmul as trm
from repro_torch.models import cnn as tcnn

ADC_MODES = ("per_subarray", "bitserial")
MODEL_REL = 1e-5    # against core.cim's model: another sum order (docstring)
FORWARD_REL = 0.15  # whole DarkNet-19 forward at per_subarray (docstring)
ALL_MODES = ("ideal",) + ADC_MODES


def _cfgs(mode, **fields):
    return (jcim.CiMConfig(mode=mode, **fields),
            tcim.CiMConfig(mode=mode, **fields))


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _close(got, want, rel):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.size > 0
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-30))


def _int8_block(seed, m, k, n):
    """int8 operands whose subarray sums saturate the signed ADC (+-15.5
    codes) in some columns and hold -128 in others."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-128, 128, size=(m, k))
    w = rng.integers(-128, 128, size=(k, n))
    x[0] = 127                      # with w[:, 0] = 127: psum 128*127*127
    w[:, 0] = 127
    x[1] = -128                     # -128 activations: a magnitude of 128
    w[:, 1] = -w[:, 0]              # the opposite rail
    w[::3, 2] = -128                # -128 weights: no magnitude plane
    x[2:, :k // 2] //= 8            # small sums: codes off the rails
    return x.astype(np.int8), w.astype(np.int8)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("mode", ADC_MODES)
def test_cim_block_dot_bitwise_vs_jax_eager(mode, seed):
    jcfg, tcfg = _cfgs(mode)
    x, w = _int8_block(seed, 16, 512, 24)
    want = np.asarray(j_cim_block_dot(jcfg, x, w))
    got = tcm.cim_block_dot(tcfg, *_t(x, w)).numpy()
    np.testing.assert_array_equal(got, want)
    if mode == "per_subarray":      # the rails were reached, both ways
        lsb = np.float32(128 * 127 / 15.5)
        assert got[0, 0] == np.float32(4 * np.float32(15.5 * lsb))
        assert got[0, 1] == -got[0, 0]


# (kernel, C_in, stride, H): R = 27 (one subarray), 180 (two), 576 (a
# full k-block and a ragged one)
CONVS = {"R27": (3, 3, 1, 6), "R180": (3, 20, 2, 7), "R576": (3, 64, 1, 4)}


def _conv_inputs(seed, k, c_in, h, c_out=10):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, h, h + 1, c_in)).astype(np.float32)
    x[0, 0, 0] = 0.0                            # an all-zero patch row
    w = rng.normal(size=(k, k, c_in, c_out)) / np.sqrt(k * k * c_in)
    scale = np.maximum(np.abs(w).max(axis=(0, 1, 2), keepdims=True),
                       1e-8) / 127.0
    w_q = np.clip(np.round(w / scale), -127, 127).astype(np.int8)
    c_c, c_u = max(1, c_in // 4), max(1, c_out // 4)
    c = (rng.normal(size=(1, 1, c_in, c_c)) / np.sqrt(c_in)).astype(np.float32)
    core = (rng.normal(size=(k, k, c_c, c_u)) * 0.1).astype(np.float32)
    u = (rng.normal(size=(1, 1, c_u, c_out)) / np.sqrt(c_u)).astype(np.float32)
    return x, w_q, scale.astype(np.float32), c, core, u


@pytest.mark.parametrize("case", ["R27", "R180"])
def test_trunk_conv_bitserial_vs_pallas(case):
    k, c_in, stride, h = CONVS[case]
    x, w_q, w_scale = _conv_inputs(len(case), k, c_in, h)[:3]
    jcfg, tcfg = _cfgs("bitserial")
    want = np.asarray(trunk_conv_pallas(x, w_q, w_scale, jcfg,
                                        stride=stride))
    got = trc.trunk_conv(*_t(x, w_q, w_scale), tcfg, stride=stride)
    _close(got, want, 1e-6)


# bitserial at R576 is left out: XLA takes ~20 s to compile its block
@pytest.mark.parametrize("mode,case", [("per_subarray", "R27"),
                                       ("per_subarray", "R180"),
                                       ("per_subarray", "R576"),
                                       ("bitserial", "R27"),
                                       ("bitserial", "R180")])
def test_rebranch_conv_vs_pallas(mode, case):
    k, c_in, stride, h = CONVS[case]
    args = _conv_inputs(len(case) + 7, k, c_in, h)
    jcfg, tcfg = _cfgs(mode)
    want = np.asarray(rebranch_conv_pallas(*args, jcfg, stride=stride))
    got = trc.rebranch_conv(*_t(*args), tcfg, stride=stride)
    _close(got, want, 1e-5)


# (mode, M, K, N, Cd): one ragged block; a full block and a ragged one
# (bitserial only at one subarray: XLA compiles its unrolled block slowly)
LINEARS = [("per_subarray", 5, 200, 24, 50), ("per_subarray", 3, 640, 16, 40),
           ("bitserial", 4, 100, 24, 30)]


@pytest.mark.parametrize("mode,m,k,n,cd", LINEARS)
def test_rebranch_matmul_vs_pallas(mode, m, k, n, cd):
    rng = np.random.default_rng(m + k)
    x = rng.normal(size=(m, k)).astype(np.float32)
    x[1] *= 1e3                                 # one row's scale dominates
    w_q = rng.integers(-127, 128, size=(k, n)).astype(np.int8)
    w_scale = rng.uniform(1e-3, 1e-2, size=(1, n)).astype(np.float32)
    c = (rng.normal(size=(k, cd)) / np.sqrt(k)).astype(np.float32)
    core = (rng.normal(size=(cd, 8)) * 0.1).astype(np.float32)
    u = (rng.normal(size=(8, n)) / np.sqrt(8)).astype(np.float32)
    jcfg, tcfg = _cfgs(mode)
    want = np.asarray(rebranch_matmul_pallas(x, w_q, w_scale, c, core, u,
                                             jcfg))
    got = trm.rebranch_matmul(*_t(x, w_q, w_scale, c, core, u), tcfg)
    _close(got, want, 1e-5)
    # the trunk alone, against the JAX 1x1 trunk conv on the same rows
    trunk, _ = trm.rebranch_trunk_sketch(*_t(x, w_q, c), tcfg)
    ones = np.ones((n,), np.float32)
    _close(trunk, trunk_conv_pallas(x[:, None, None, :], w_q[None, None],
                                    ones, jcfg)[:, 0, 0], 1e-6)


# (kernel, C_in, stride, padding): R = 45, 180, 128 and, but for
# bitserial (whose 576-wide grid takes XLA ~20 s), 576
INT8_CONVS = [(3, 5, 1, "SAME"), (3, 20, 2, "SAME"), (1, 128, 1, "VALID")]
R576 = (3, 64, 1, "SAME")


@pytest.mark.parametrize("mode,k,c_in,stride,padding",
                         [(m, *c) for m in ALL_MODES for c in INT8_CONVS]
                         + [("ideal", *R576), ("per_subarray", *R576)])
def test_cim_conv_vs_pallas_and_model(mode, k, c_in, stride, padding):
    """``ops.cim_conv`` against the JAX package's ``cim_conv_pallas`` grid
    (interpret mode) and its ``core.cim.cim_conv_model``.  Its default
    (direct) lowering and ``ops.cim_conv`` are compared only where the
    patch width R is a multiple of 128 or spans more than one k-block:
    for a single ragged k-block in a non-ideal mode, ``_cim_direct`` hands
    the unpadded block to ``cim_block_dot``, whose ``K // 128`` subarrays
    drop the ragged one (R = 45 gives zeros), a fault of the reference
    (ROADMAP Queue 3) that the port does not copy."""
    rng = np.random.default_rng(k * c_in + stride)
    x = rng.integers(-128, 128, size=(2, 7, 6, c_in)).astype(np.int8)
    w = rng.integers(-127, 128, size=(k, k, c_in, 9)).astype(np.int8)
    jcfg, tcfg = _cfgs(mode)
    got = tops.cim_conv(*_t(x, w), tcfg, stride, padding).numpy()
    _close(got, cim_conv_pallas(x, w, jcfg, stride=stride, padding=padding,
                                direct=False, interpret=True), 1e-6)
    _close(got, jcim.cim_conv_model(x, w, jcfg, stride, padding), MODEL_REL)
    r = k * k * c_in
    if mode == "ideal" or r % 128 == 0 or r > 512:
        _close(got, jops.cim_conv(x, w, jcfg, stride, padding), 1e-6)


@pytest.mark.parametrize("fields", [{"rows_per_subarray": 64},
                                    {"adc_bits": 4, "psum_range_frac": 0.5},
                                    {"act_group_bits": 1, "act_bits": 6}])
@pytest.mark.parametrize("mode", ADC_MODES)
def test_cpu_takes_any_cim_config(mode, fields):
    """The plain versions take every CiMConfig the JAX package takes; the
    CUDA kernels refuse the ones they are not built for (tested on the
    card in test_torch_gpu.py)."""
    jcfg, tcfg = _cfgs(mode, **fields)
    rng = np.random.default_rng(5)
    x = rng.normal(size=(6, 100)).astype(np.float32)
    w_q = rng.integers(-127, 128, size=(100, 12)).astype(np.int8)
    x_q = rng.integers(-128, 128, size=(6, 100)).astype(np.int8)
    ones = np.ones((12,), np.float32)
    _close(trc.trunk_conv_dot(*_t(x[:, None, None, :], w_q[None, None]),
                              cfg=tcfg),
           trunk_conv_pallas(x[:, None, None, :], w_q[None, None], ones,
                             jcfg)[:, 0, 0], 1e-6)
    _close(tcm.cim_matmul(*_t(x_q, w_q), tcfg),
           jcim.cim_matmul_model(x_q, w_q, jcfg), MODEL_REL)


# ---------------------------------------------------------------------------
# whole models at ADC fidelity
# ---------------------------------------------------------------------------

def _with_cores(tree, rng):
    """Seeded N(0, 0.05) ReBranch cores, so every branch contributes."""
    if isinstance(tree, dict):
        out = {k: _with_cores(v, rng) for k, v in tree.items()}
        sram = out.get("sram")
        if isinstance(sram, dict) and "core" in sram:
            out["sram"] = dict(sram, core=(
                rng.normal(size=sram["core"].shape) * 0.05).astype(np.float32))
        return out
    if isinstance(tree, list):
        return [_with_cores(v, rng) for v in tree]
    return tree


def _jspec(spec):
    """The JAX package's ReBranchSpec of a port spec."""
    return jrebranch.ReBranchSpec(
        d_ratio=spec.d_ratio, u_ratio=spec.u_ratio, enabled=spec.enabled,
        trunk_impl=spec.trunk_impl,
        cim=jcim.CiMConfig(**dataclasses.asdict(spec.cim)),
        branch_enabled=spec.branch_enabled, trunk_skip=spec.trunk_skip)


ADC_SITES = {"convs": {"cim": "per_subarray"},
             "head": {"cim": "per_subarray"}}


def test_darknet19_per_subarray_forward_vs_jax(monkeypatch):
    """DarkNet-19 at 32 px, batch 2, every conv site in per_subarray mode
    under pallas_fused (the override on the two ancestor addresses reaches
    all 20 sites).  Every conv call the port makes is re-run by the JAX
    package on the same input and held to 1e-5 of its absmax; the whole
    forward to FORWARD_REL of its absmax (see the module docstring)."""
    size = 32
    tm = tdeploy.compile_model(tcnn.CNNConfig(name="darknet19",
                                              input_size=size),
                               engine="pallas_fused",
                               layer_overrides=ADC_SITES)
    jm = jdeploy.compile_model(jcnn.CNNConfig(name="darknet19",
                                              input_size=size),
                               engine="pallas_fused",
                               layer_overrides=ADC_SITES)
    sites = [s[0] for s in tcnn.conv_site_shapes(tm.cfg)]
    assert len(sites) == 20
    for site in sites:
        spec = tm.layer_spec(site)
        assert spec.cim.mode == "per_subarray", site
        assert spec.trunk_impl == "pallas_fused", site
    params = _with_cores(bridge.to_numpy(tm.init(3, device="cpu")),
                         np.random.default_rng(4))
    x = np.random.default_rng(5).normal(size=(2, size, size, 3)).astype(
        np.float32)

    calls = []
    apply_conv = tcnn.apply_conv

    def recording(p, xx, spec, stride=1, epilogue=None):
        y = apply_conv(p, xx, spec, stride, epilogue)
        calls.append((p, xx, spec, stride, epilogue, y))
        return y

    monkeypatch.setattr(tcnn, "apply_conv", recording)
    with torch.no_grad():
        got = tm.forward(bridge.to_torch(params, "cpu"), torch.from_numpy(x))
    monkeypatch.undo()
    assert len(calls) == 21
    n_adc = 0
    for p, xx, spec, stride, ep, y in calls:
        jep = None if ep is None else dataclasses.replace(
            jcnn.engine_base.ConvEpilogue(), scale=ep.scale.numpy(),
            bias=ep.bias.numpy(), act=ep.act, leaky_slope=ep.leaky_slope)
        want = jcnn.apply_conv(bridge.to_numpy(p), xx.numpy(), _jspec(spec),
                               stride, jep)
        _close(y, want, 1e-5)
        n_adc += spec.enabled and spec.cim.mode == "per_subarray"
    assert n_adc == 20
    want = np.asarray(jm.forward(params, x))
    assert np.isfinite(got.numpy()).all()
    _close(got, want, FORWARD_REL)


def test_gemma_smoke_per_subarray_vs_jax(monkeypatch):
    """Gemma-2B smoke with ``{"blocks": {"cim": "per_subarray"}}`` under
    pallas_fused: prefill + one decode step.  Every ReBranch linear is
    re-run by the JAX package on the same input (1e-5 of the absmax), and
    the logits are held to 5e-2 of the absmax, as in test_torch_lm.py."""
    overrides = {"blocks": {"cim": "per_subarray"}}
    jcfg, tcfg = jconfigs.get_smoke("gemma_2b"), tconfigs.get_smoke("gemma_2b")
    jm = jdeploy.compile_model(jcfg, engine="pallas_fused",
                               layer_overrides=overrides)
    tm = tdeploy.compile_model(tcfg, engine="pallas_fused",
                               layer_overrides=overrides)
    for site in ("blocks.attn", "blocks.mlp"):
        assert tm.layer_spec(site).cim.mode == "per_subarray"
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    params = _with_cores(params, np.random.default_rng(1))
    tp = bridge.to_torch(params, "cpu")

    calls = []
    apply_linear = trebranch.apply_linear

    def recording(p, x, spec):
        y = apply_linear(p, x, spec)
        calls.append((bridge.to_numpy(p), x.numpy().copy(), spec, y.numpy()))
        return y

    monkeypatch.setattr(trebranch, "apply_linear", recording)
    tok = np.random.default_rng(9).integers(0, 512, size=(1, 11))
    with torch.no_grad():
        tc = tm.init_cache(1, 32, dtype=torch.float32, device="cpu")
        tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(tok)}, tc)
        nxt = np.array([[int(tl[0, -1].argmax())]])
        tl2, tc = tm.decode_step(tp, torch.from_numpy(nxt), tc)
    monkeypatch.undo()
    assert len(calls) == 2 * 2 * 7          # 2 passes x 2 layers x 7 linears
    for p, x, spec, y in calls:
        assert spec.cim.mode == "per_subarray"
        _close(y, jrebranch.apply_linear(p, x, _jspec(spec)), 1e-5)

    jc = jm.init_cache(1, 32, dtype=jnp.float32)
    jl, jc = jm.prefill(params, {"tokens": tok.astype(np.int32)}, jc)
    jl2, jc = jm.decode_step(params, nxt.astype(np.int32), jc)
    _close(tl, jl, 5e-2)
    _close(tl2, jl2, 5e-2)
    assert int(np.argmax(jl[0, -1])) == nxt[0, 0]
