"""The port's cost model and tape-out against the JAX package, on the CPU.

Everything here is arithmetic on shapes and constants, so every number
must come out EQUAL (tolerance 0): the parameter and MAC counts, the
activation bits, every ``core.energy`` function on the same NetStats, and
the Fig. 12 ``sweep``.  The paper's headline ratios (``tests/
test_energy.py``'s assertions) are then reproduced from the port's own
counts, with that file's tolerances (15% relative).  The tape-out
(``freeze_to_rom``) is held bit for bit on its trunk; C and U are drawn
by other generators in the two packages and are compared by shape only.
"""

import dataclasses
import sys
import os

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from benchmarks import netstats as jnetstats  # noqa: E402
from repro import plan as jplan  # noqa: E402
from repro.configs import paper_models as jpaper  # noqa: E402
from repro.core import energy as jenergy  # noqa: E402
from repro.core import rebranch as jrebranch  # noqa: E402
from repro.core import rom as jrom  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro_torch import bridge, netstats  # noqa: E402
from repro_torch import plan as tplan  # noqa: E402
from repro_torch.configs import paper_models as tpaper  # noqa: E402
from repro_torch.core import energy, rebranch, rom  # noqa: E402
from repro_torch.models import cnn as tcnn  # noqa: E402

MODELS = ("vgg8", "resnet18", "darknet19", "tiny_yolo")
ENERGY_FNS = ("yoloc_energy", "sram_single_energy", "chiplet_energy",
              "yoloc_latency", "sram_single_latency")
SCALAR_FNS = ("yoloc_area", "all_sram_area", "efficiency_ratio",
              "area_ratio")


@pytest.fixture(scope="module")
def stats():
    return netstats.paper_net_stats()


@pytest.fixture(scope="module")
def jstats():
    return jnetstats.paper_net_stats()


# ---------------------------------------------------------------------------
# counts and the cost model, equal to the JAX package's
# ---------------------------------------------------------------------------

def test_paper_models_equal_across_packages():
    assert list(tpaper.PAPER_MODELS) == list(jpaper.PAPER_MODELS)
    for name, tcfg in tpaper.PAPER_MODELS.items():
        jcfg = jpaper.PAPER_MODELS[name]
        for field in ("name", "num_classes", "input_size", "head_anchors",
                      "head_classes"):
            assert getattr(tcfg, field) == getattr(jcfg, field), field


@pytest.mark.parametrize("name", MODELS)
def test_counts_equal_across_packages(name, stats, jstats):
    """count_macs_and_params and _act_bits: the port counts from shapes,
    the JAX package walks its jaxpr; both must give the same integers."""
    tcfg, jcfg = tpaper.PAPER_MODELS[name], jpaper.PAPER_MODELS[name]
    assert tcnn.count_macs_and_params(*tcnn.MODEL_REGISTRY[name], tcfg) == \
        jcnn.count_macs_and_params(*jcnn.MODEL_REGISTRY[name], jcfg)
    init, apply = jcnn.MODEL_REGISTRY[name]
    assert netstats._act_bits(tcfg) == jnetstats._act_bits(init, apply,
                                                           jcfg)
    assert dataclasses.astuple(stats[name]) == \
        dataclasses.astuple(jstats[name])


@pytest.mark.parametrize("name", MODELS)
def test_energy_functions_equal_across_packages(name, jstats):
    """The same NetStats through every energy function: equal floats."""
    ns = jstats[name]
    tns = energy.NetStats(**dataclasses.asdict(ns))
    for cm_kw in ({}, {"dram_pj_per_bit": 12.0, "sram_tops_w": 2.5}):
        jcm = jenergy.CostModel(**cm_kw)
        tcm = energy.CostModel(**cm_kw)
        assert dataclasses.astuple(tcm) == dataclasses.astuple(jcm)
        for fn in ENERGY_FNS:
            assert getattr(energy, fn)(tns, tcm) == \
                getattr(jenergy, fn)(ns, jcm), fn
        for fn in SCALAR_FNS:
            assert getattr(energy, fn)(tns, tcm) == \
                getattr(jenergy, fn)(ns, jcm), fn


@pytest.mark.parametrize("name", MODELS)
@pytest.mark.parametrize("size", (32, 416))
def test_sweep_equal_across_packages(name, size):
    """Every record of the Fig. 12 sweep, point for point (the plans by
    their entries, the priced outputs exactly)."""
    def strip(rec):
        out = {k: v for k, v in rec.items() if k != "plan"}
        out["entries"] = [(a, s.enabled, s.trunk_impl)
                          for a, s in rec["plan"].entries]
        return out

    jcfg = jcnn.CNNConfig(name=name, input_size=size)
    tcfg = tcnn.CNNConfig(name=name, input_size=size)
    for kw in ({}, {"engine": "pallas_fused", "reload_factor": 3.0}):
        want = [strip(r) for r in jplan.sweep(jcfg, 6, **kw)]
        got = [strip(r) for r in tplan.sweep(tcfg, 6, **kw)]
        assert got == want


# ---------------------------------------------------------------------------
# tests/test_energy.py's assertions, from the port's own counts
# ---------------------------------------------------------------------------

class TestPaperClaims:
    def test_model_sizes_match_paper(self, stats):
        assert 40e6 < stats["darknet19"].params < 52e6      # "46 M weights"
        assert 9e6 < stats["tiny_yolo"].params < 16e6       # "11.3 M"

    @pytest.mark.parametrize("name,paper,tol", [
        ("resnet18", 4.8, 0.15), ("tiny_yolo", 10.2, 0.15),
        ("darknet19", 14.8, 0.15),
    ])
    def test_energy_efficiency_ratios(self, stats, name, paper, tol):
        ours = energy.efficiency_ratio(stats[name])
        assert abs(ours - paper) / paper < tol, (name, ours, paper)

    def test_area_ratio_yolo(self, stats):
        ours = energy.area_ratio(stats["darknet19"])
        assert abs(ours - 9.7) / 9.7 < 0.15                 # paper 9.7x

    def test_area_ratio_tiny_yolo_footnote_basis(self, stats):
        ours = (energy.all_sram_area(stats["tiny_yolo"])
                / energy.yoloc_area(stats["darknet19"]))
        assert abs(ours - 2.4) / 2.4 < 0.15                 # paper 2.4x

    def test_chiplet_comparison(self, stats):
        ns = stats["darknet19"]
        ratio = (energy.chiplet_energy(ns)["total"]
                 / energy.yoloc_energy(ns)["total"])
        assert 0.9 < ratio < 1.15                            # paper ~1.02x

    def test_latency_overhead(self, stats):
        lat = energy.yoloc_latency(stats["darknet19"])
        assert abs(lat["overhead_frac"] - 0.08) < 0.02       # paper 8%

    def test_yoloc_has_zero_dram_weight_traffic(self, stats):
        for ns in stats.values():
            assert energy.yoloc_energy(ns)["dram"] == 0.0

    def test_rom_density_premise(self):
        cm = energy.DEFAULT_COST
        assert cm.rom_density_mb_mm2 / cm.sram_density_mb_mm2 == 19.0

    def test_efficiency_monotone_in_reload(self, stats):
        ns = stats["darknet19"]
        lo = dataclasses.replace(ns, reload_factor=1.0)
        hi = dataclasses.replace(ns, reload_factor=8.0)
        assert energy.efficiency_ratio(hi) > energy.efficiency_ratio(lo)

    def test_branch_fraction_effect(self, stats):
        ns = stats["resnet18"]
        fat = dataclasses.replace(ns, branch_fraction=0.25)   # D*U=4
        assert energy.yoloc_area(fat) > energy.yoloc_area(ns)


# ---------------------------------------------------------------------------
# tape-out: freeze_to_rom and the ROM image
# ---------------------------------------------------------------------------

def _dense_cnn(rng):
    """A mini conv tree as pretraining leaves it: plain convs mixed with
    BN and a dense head."""
    def mk(shape):
        return {"sram": {"w": (rng.normal(size=shape)
                               / np.sqrt(np.prod(shape[:-1]))
                               ).astype(np.float32)}}
    return {
        "convs": [mk((3, 3, 3, 16)), mk((1, 1, 16, 16)), mk((3, 3, 16, 8))],
        "bns": [{"sram": {"scale": np.ones(16, np.float32),
                          "bias": np.zeros(16, np.float32)}}],
        "fc": {"sram": {"w": (rng.normal(size=(16, 10)) * 0.01
                              ).astype(np.float32)}},
    }


def _structure(tree):
    return {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
            for k, v in bridge.flatten(tree).items()}


def test_cnn_freeze_to_rom_trunk_equals_reference():
    dense = _dense_cnn(np.random.default_rng(0))
    spec = rebranch.ReBranchSpec()
    got = tcnn.freeze_to_rom(bridge.to_torch(dense, "cpu"),
                             torch.Generator().manual_seed(1), spec)
    want = jax.tree.map(np.asarray, jcnn.freeze_to_rom(
        dense, jax.random.PRNGKey(1), jrebranch.ReBranchSpec()))
    want_t = bridge.to_torch(want, "cpu")
    assert _structure(got) == _structure(want_t)
    for conv, jconv in zip(got["convs"], want_t["convs"]):
        assert torch.equal(conv["rom"]["w_q"], jconv["rom"]["w_q"])
        assert torch.equal(conv["rom"]["w_scale"], jconv["rom"]["w_scale"])
        assert not conv["sram"]["core"].any()
    assert set(got["fc"]) == {"sram"} and set(got["bns"][0]) == {"sram"}
    # one seed, one tree: the same tape-out twice hashes the same
    again = tcnn.freeze_to_rom(bridge.to_torch(dense, "cpu"),
                               torch.Generator().manual_seed(1), spec)
    assert rom.rom_fingerprint(again) == rom.rom_fingerprint(got)


def test_lm_freeze_to_rom_trunk_equals_reference():
    """The reference folds the process-salted ``hash(path)`` into its C/U
    keys, so only the trunk, the structure, the shapes and the zero cores
    are compared."""
    rng = np.random.default_rng(3)
    dense = {"attn": {"q": {"sram": {"w": rng.normal(size=(32, 16)).astype(
                 np.float32) / 6}},
                      "o": {"sram": {"w": rng.normal(size=(16, 32)).astype(
                          np.float32) / 4,
                          "b": rng.normal(size=(32,)).astype(np.float32)}}},
             "mlp": [{"sram": {"w": rng.normal(size=(32, 64)).astype(
                 np.float32) / 6}}],
             "norm": {"sram": {"scale": np.ones(32, np.float32)}}}
    spec = rebranch.ReBranchSpec()
    got = rebranch.freeze_to_rom(bridge.to_torch(dense, "cpu"),
                                 torch.Generator().manual_seed(0), spec)
    want_np = jax.tree.map(np.asarray, jrebranch.freeze_to_rom(
        dense, jax.random.PRNGKey(0), jrebranch.ReBranchSpec()))
    want = bridge.to_torch(want_np, "cpu")
    assert _structure(got) == _structure(want)
    for name, leaf in bridge.flatten(got).items():
        if name.endswith(("['w_q']", "['w_scale']", "['b']", "['scale']")):
            assert torch.equal(leaf, bridge.flatten(want)[name]), name
        if name.endswith("['core']"):
            assert not leaf.any(), name
    assert rebranch.trainable_count(got) == \
        jrebranch.trainable_count(want_np)
    assert rebranch.frozen_count(got) == jrebranch.frozen_count(want_np)


def test_rom_bytes_and_fingerprint_equal_across_packages():
    cfg = jcnn.CNNConfig(name="tiny_yolo", input_size=32)
    init, _ = jcnn.MODEL_REGISTRY["tiny_yolo"]
    jtree = jax.tree.map(np.asarray, init(jax.random.PRNGKey(0), cfg))
    ttree = bridge.to_torch(jtree, "cpu")
    assert rom.rom_fingerprint(ttree) == jrom.rom_fingerprint(jtree)
    assert rom.rom_bytes(ttree) == jrom.rom_bytes(jtree)
    assert rom.sram_bytes(ttree) == jrom.sram_bytes(jtree)
    total = sum(t.numel() * t.element_size()
                for t in bridge.flatten(ttree).values())
    assert rom.rom_bytes(ttree) + rom.sram_bytes(ttree) == total
