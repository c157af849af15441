"""System-level area / energy / latency cost model (paper §4.3, Figs.
12-14), port of ``repro.core.energy``.

Macro constants from Table I (ROM-CiM: 5 Mb/mm^2, 11.5 TOPS/W, 28.8 GOPS
per 128x256 macro; SRAM-CiM 19x less dense at system level); DRAM
energy and bandwidth in the CACTI range; chiplet links from SIMBA
(1.17 pJ/b).  Three systems (Fig. 13): (a) YOLoC, trunk in ROM-CiM and
branch in SRAM-CiM with no DRAM weight traffic; (b) an iso-area
all-SRAM-CiM chip streaming its overflow weights from DRAM; (c) SRAM-CiM
chiplets holding every weight.

The constants marked calibrated were fit by the JAX package inside their
published ranges so the model gives the paper's headline ratios; the
arithmetic here is the reference's, float for float.  Every output is a
28 nm model estimate of the paper's chip, not a measurement of any
device.
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class CostModel:
    # ---- Table I (verbatim) ----
    rom_density_mb_mm2: float = 5.0          # ROM-CiM system density
    rom_tops_w: float = 11.5                 # 8b x 8b MAC efficiency
    macro_gops: float = 28.8                 # per 128x256 macro
    macro_bits: float = 1.2e6                # 1.2 Mb per macro
    sram_density_ratio: float = 19.0         # ROM is 19x denser (system)
    # ---- literature-range constants (calibrated in the JAX package) ----
    sram_tops_w: float = 1.68
    sram_macro_tops_w: float = 8.73
    dram_pj_per_bit: float = 24.2
    dram_gbps: float = 25.6
    link_pj_per_bit: float = 1.17            # SIMBA [25], verbatim
    sram_cache_pj_per_bit: float = 0.08
    chiplet_bits: float = 150e6
    weight_bits: int = 8
    act_bits: int = 8

    @property
    def sram_density_mb_mm2(self) -> float:
        return self.rom_density_mb_mm2 / self.sram_density_ratio

    @property
    def rom_pj_per_mac(self) -> float:
        return 2.0 / self.rom_tops_w        # 1 MAC = 2 OPS

    @property
    def sram_pj_per_mac(self) -> float:
        return 2.0 / self.sram_tops_w


DEFAULT_COST = CostModel()


@dataclasses.dataclass(frozen=True)
class NetStats:
    """Workload description (computed from the model configs: see
    ``repro_torch.netstats``).

    reload_factor / act_spill model the SRAM-CiM baseline's scheduling
    (paper Fig. 13b): when the activation working set exceeds the on-chip
    cache of the iso-area chip (YOLO at 416x416), the layer is processed
    in spatial tiles and weights stream from DRAM once per tile
    (reload_factor ~ 4) and activations spill to DRAM (act_spill).  Nets
    whose working set fits (Tiny-YOLO) reload weights exactly once.
    ``baseline``='all_sram' marks nets the paper compares against their
    full all-SRAM-CiM implementation (classification nets, Fig. 10).
    """
    name: str
    params: int                  # weight count
    macs: int                    # MACs per inference
    act_bits_moved: int          # inter-layer activation bits per inference
    branch_fraction: float = 1.0 / 16.0   # ReBranch D*U=16 default
    reload_factor: float = 1.0   # weight DRAM streams per inference
    act_spill: bool = False      # baseline spills activations to DRAM
    baseline: str = "iso_area"   # 'iso_area' | 'all_sram'


# ---------------------------------------------------------------------------
# areas (mm^2)
# ---------------------------------------------------------------------------

def yoloc_area(net: NetStats, cm: CostModel = DEFAULT_COST) -> float:
    trunk_bits = net.params * cm.weight_bits
    branch_bits = trunk_bits * net.branch_fraction
    return (trunk_bits / 1e6 / cm.rom_density_mb_mm2
            + branch_bits / 1e6 / cm.sram_density_mb_mm2)


def all_sram_area(net: NetStats, cm: CostModel = DEFAULT_COST) -> float:
    return net.params * cm.weight_bits / 1e6 / cm.sram_density_mb_mm2


# ---------------------------------------------------------------------------
# energies (mJ / inference)
# ---------------------------------------------------------------------------

def yoloc_energy(net: NetStats, cm: CostModel = DEFAULT_COST) -> dict:
    """(a) trunk on ROM-CiM, branch on SRAM-CiM, zero DRAM weight traffic."""
    branch_macs = net.macs * net.branch_fraction
    e_mac = (net.macs * cm.rom_pj_per_mac + branch_macs * cm.sram_pj_per_mac)
    e_cache = net.act_bits_moved * cm.sram_cache_pj_per_bit
    return {"mac": e_mac * 1e-9, "dram": 0.0, "link": 0.0,
            "cache": e_cache * 1e-9,
            "total": (e_mac + e_cache) * 1e-9}


def sram_single_energy(net: NetStats, cm: CostModel = DEFAULT_COST) -> dict:
    """(b) the SRAM-CiM comparison chip (paper Fig. 13b).

    'iso_area': chip area = YOLoC's; overflow weights stream from DRAM
    ``reload_factor`` times per inference (spatial tiling when the
    activation working set exceeds the cache), activations optionally
    spill.  'all_sram': the full SRAM-CiM implementation (no DRAM) — the
    paper's baseline for the classification nets.
    """
    w_bits = net.params * cm.weight_bits
    if net.baseline == "all_sram":
        reload_bits = 0.0
    else:
        area = yoloc_area(net, cm)                   # iso-area comparison
        capacity_bits = area * cm.sram_density_mb_mm2 * 1e6
        reload_bits = max(0.0, w_bits - capacity_bits) * net.reload_factor
    e_mac = net.macs * cm.sram_pj_per_mac
    e_dram = reload_bits * cm.dram_pj_per_bit
    if net.act_spill:          # activations round-trip DRAM (write+read)
        e_dram += 2.0 * net.act_bits_moved * cm.dram_pj_per_bit
    e_cache = net.act_bits_moved * cm.sram_cache_pj_per_bit
    return {"mac": e_mac * 1e-9, "dram": e_dram * 1e-9, "link": 0.0,
            "cache": e_cache * 1e-9, "reload_bits": reload_bits,
            "total": (e_mac + e_dram + e_cache) * 1e-9}


def chiplet_energy(net: NetStats, cm: CostModel = DEFAULT_COST) -> dict:
    """(c) SRAM-CiM chiplets holding all weights; features cross the package."""
    w_bits = net.params * cm.weight_bits
    n_chips = max(1, math.ceil(w_bits / cm.chiplet_bits))
    # Features cross chip boundaries proportionally to how the layers are
    # split: each boundary forwards the activation working set once.
    link_bits = net.act_bits_moved * (n_chips - 1) / max(1, n_chips)
    # chiplets hold all weights resident -> macro-level efficiency
    e_mac = net.macs * 2.0 / cm.sram_macro_tops_w
    e_link = link_bits * cm.link_pj_per_bit
    e_cache = net.act_bits_moved * cm.sram_cache_pj_per_bit
    return {"mac": e_mac * 1e-9, "dram": 0.0, "link": e_link * 1e-9,
            "cache": e_cache * 1e-9, "n_chips": n_chips,
            "total": (e_mac + e_link + e_cache) * 1e-9}


# ---------------------------------------------------------------------------
# latency (ms / inference)
# ---------------------------------------------------------------------------

def yoloc_latency(net: NetStats, cm: CostModel = DEFAULT_COST) -> dict:
    """Trunk and branch run in parallel macro pools (Fig. 9); the branch adds
    a small serialisation overhead (paper: +8% on YOLO)."""
    trunk_bits = net.params * cm.weight_bits
    n_macros = max(1, math.ceil(trunk_bits / cm.macro_bits))
    chip_gops = n_macros * cm.macro_gops
    t_trunk = 2.0 * net.macs / (chip_gops * 1e9) * 1e3          # ms
    # Branch macros scale with branch size; point-wise (de)compression is
    # extra serial work on the feature map.
    branch_macs = net.macs * net.branch_fraction
    n_bmacros = max(1, math.ceil(trunk_bits * net.branch_fraction / cm.macro_bits))
    t_branch = 2.0 * branch_macs / (n_bmacros * cm.macro_gops * 1e9) * 1e3
    t_merge = 0.08 * t_trunk         # add/requant pipeline bubbles (paper: 8%)
    total = max(t_trunk, t_branch) + t_merge
    return {"trunk": t_trunk, "branch": t_branch,
            "overhead_frac": total / t_trunk - 1.0, "total": total}


def sram_single_latency(net: NetStats, cm: CostModel = DEFAULT_COST) -> dict:
    area = yoloc_area(net, cm)
    capacity_bits = area * cm.sram_density_mb_mm2 * 1e6
    n_macros = max(1, math.ceil(capacity_bits / cm.macro_bits))
    t_mac = 2.0 * net.macs / (n_macros * cm.macro_gops * 1e9) * 1e3
    reload_bits = max(0.0, net.params * cm.weight_bits - capacity_bits)
    t_dram = reload_bits / 8 / (cm.dram_gbps * 1e9) * 1e3
    return {"mac": t_mac, "dram": t_dram, "total": t_mac + t_dram}


def efficiency_ratio(net: NetStats, cm: CostModel = DEFAULT_COST) -> float:
    """Energy-efficiency improvement of YOLoC over iso-area SRAM-CiM."""
    return sram_single_energy(net, cm)["total"] / yoloc_energy(net, cm)["total"]


def area_ratio(net: NetStats, cm: CostModel = DEFAULT_COST) -> float:
    """Chip-area saving of YOLoC over all-SRAM-CiM (Fig. 12)."""
    return all_sram_area(net, cm) / yoloc_area(net, cm)
