"""NetStats for the paper's four models from the port's own counts (port
of the JAX package's ``benchmarks/netstats.py::paper_net_stats``).

Parameters and MACs come from ``models.cnn.count_macs_and_params``, the
inter-layer activation bits from :func:`_act_bits`; both equal the JAX
package's jaxpr walks for the four paper models.  Feed the result to
``core.energy`` for the paper's headline ratios (model estimates of the
28 nm chip, not measurements).
"""

from __future__ import annotations

import functools

from repro_torch.configs.paper_models import PAPER_MODELS
from repro_torch.core.energy import NetStats
from repro_torch.models import cnn


def _act_bits(cfg, act_bits: int = 8) -> int:
    """Inter-layer activation bits per image: every conv and dot output
    of the forward (``cnn.traced_ops``) at ``act_bits`` each."""
    return sum(n_out for n_out, _ in cnn.traced_ops(cfg)) * act_bits


# name: (reload_factor, act_spill, baseline) — see NetStats
SCHEDULE = {
    "vgg8": (1.0, False, "all_sram"),
    "resnet18": (1.0, False, "all_sram"),
    "tiny_yolo": (1.0, False, "iso_area"),
    "darknet19": (3.0, True, "iso_area"),
}


@functools.lru_cache(maxsize=None)
def paper_net_stats() -> dict[str, NetStats]:
    out = {}
    for name, cfg in PAPER_MODELS.items():
        init_fn, apply_fn = cnn.MODEL_REGISTRY[name]
        n_params, macs = cnn.count_macs_and_params(init_fn, apply_fn, cfg)
        rf, spill, base = SCHEDULE[name]
        out[name] = NetStats(
            name=name, params=n_params, macs=macs,
            act_bits_moved=_act_bits(cfg),
            reload_factor=rf, act_spill=spill, baseline=base)
    return out
