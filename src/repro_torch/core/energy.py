"""Table-I cost constants the placement solver prices with (port of
``repro.core.energy``'s ``CostModel``; the system-level energy and
latency terms wait for the tooling slice)."""

from __future__ import annotations

import dataclasses


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
