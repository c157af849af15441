"""The front door for CNN serving (port of ``repro.serve.server``'s
``CNNServer`` and ``load``; ``LMServer`` waits for the LM slice).

Submitted images run through the resident cell in ``n_slots``-row
chunks; a short chunk is padded with zero images and the pad rows are
sliced off the output.  Inference BN uses frozen statistics and every
trunk row is quantised on its own, so padding never changes a real row.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import bridge
from repro_torch.models import cnn
from repro_torch.serve import registry


class CNNServer:
    """Forward-only serving of one resident CNN cell in fixed-size chunks."""

    def __init__(self, model, params, *, n_slots: int):
        if n_slots < 1:
            raise ValueError(f"need at least one slot, got {n_slots}")
        self.model = model
        self.params = params
        self.n_slots = int(n_slots)
        self.device = next(iter(bridge.flatten(params).values())).device

    def swap_scenario(self, name: str):
        """Scenario hot-swap needs a ScenarioStore, which is not ported
        yet (ROADMAP Queue 1 item 10); no server has one attached."""
        raise ValueError(
            f"no ScenarioStore attached to this server, cannot swap to "
            f"{name!r}; scenario hot-swap is not ported yet (ROADMAP "
            f"Queue 1 item 10)")

    def submit(self, images) -> np.ndarray:
        """images: [B, H, W, C] (numpy or tensor) -> outputs for all B rows."""
        x = torch.as_tensor(np.asarray(images, dtype=np.float32))
        if x.dim() == 3:
            x = x[None]
        outs = []
        for lo in range(0, x.shape[0], self.n_slots):
            chunk = x[lo:lo + self.n_slots].to(self.device)
            real = chunk.shape[0]
            if real < self.n_slots:
                chunk = torch.cat([chunk, chunk.new_zeros(
                    (self.n_slots - real, *chunk.shape[1:]))])
            with torch.no_grad():
                out = self.model.forward(self.params, chunk)
            outs.append(out[:real].cpu().numpy())
        return np.concatenate(outs, 0)


def load(model_id: str, *, params=None, seed: int = 0, n_slots=None,
         device=None) -> CNNServer:
    """Resolve ``model_id`` through the registry (compiled at most once
    per process), initialise params from ``seed`` unless given, and
    return its server.  ``device`` defaults to the CUDA card."""
    model, _plan = registry.compile_entry(model_id)
    if not isinstance(model.cfg, cnn.CNNConfig):
        raise NotImplementedError("LM serving waits for ROADMAP Queue 1 "
                                  "item 14")
    if params is None:
        params = model.init(seed, device=device)
    return CNNServer(model, params, n_slots=n_slots or 8)
