"""Fault-tolerance coordinator logic (port of ``repro.distributed.fault``):
pure functions over a heartbeat table, no process group and no tensor.

Hosts heartbeat to a coordinator; the coordinator finds dead and
straggling hosts, excludes them and emits a re-mesh plan; training
resumes from the last checkpoint on the surviving mesh, each rank
rebuilding its block of every leaf (``checkpoint.manager.restore(
shardings=)``).  The data pipeline is stateless (``data/synthetic.py``),
so shard reassignment is arithmetic.  A cluster agent drives these
functions; the tests drive them directly.
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class FaultConfig:
    heartbeat_timeout_s: float = 60.0     # dead if silent this long
    straggler_factor: float = 2.0         # step_time > factor * median
    min_data_parallel: int = 2            # refuse to shrink below this
    spare_hosts: int = 0                  # hot spares to draw from first


@dataclasses.dataclass(frozen=True)
class HostState:
    host_id: int
    last_heartbeat_s: float
    last_step_time_s: float = 0.0
    is_spare: bool = False


def dead_hosts(hosts: list[HostState], now_s: float,
               cfg: FaultConfig) -> list[int]:
    return [h.host_id for h in hosts
            if now_s - h.last_heartbeat_s > cfg.heartbeat_timeout_s]


def stragglers(hosts: list[HostState], cfg: FaultConfig) -> list[int]:
    """Hosts whose step time exceeds straggler_factor x median."""
    times = sorted(h.last_step_time_s for h in hosts
                   if h.last_step_time_s > 0)
    if len(times) < 3:
        return []
    median = times[len(times) // 2]
    return [h.host_id for h in hosts
            if h.last_step_time_s > cfg.straggler_factor * median]


@dataclasses.dataclass(frozen=True)
class RemeshPlan:
    surviving_hosts: tuple
    new_data_axis: int          # data-parallel degree after re-mesh
    replaced_by_spares: tuple   # (failed, spare) pairs
    action: str                 # 'none' | 'swap_spares' | 'shrink' | 'abort'


def plan_remesh(hosts: list[HostState], failed: list[int],
                data_axis: int, hosts_per_data_row: int,
                cfg: FaultConfig) -> RemeshPlan:
    """Decide how to continue after ``failed`` hosts drop.

    Policy (standard large-pod practice):
      1. swap in hot spares 1:1 if available (no topology change);
      2. otherwise shrink the data axis to the largest power of two that
         the surviving hosts can fill (model axis is never shrunk — the
         weights are sharded over it);
      3. abort if below min_data_parallel.
    """
    failed_set = set(failed)
    spares = [h.host_id for h in hosts
              if h.is_spare and h.host_id not in failed_set]
    alive = [h.host_id for h in hosts
             if not h.is_spare and h.host_id not in failed_set]

    if len(spares) >= len(failed):
        pairs = tuple(zip(sorted(failed), spares))
        return RemeshPlan(tuple(sorted(alive + spares[:len(failed)])),
                          data_axis, pairs, "swap_spares")

    usable_rows = len(alive) // hosts_per_data_row
    new_data = 2 ** int(math.floor(math.log2(max(usable_rows, 1))))
    if new_data < cfg.min_data_parallel:
        return RemeshPlan(tuple(alive), 0, (), "abort")
    kept = tuple(alive[:new_data * hosts_per_data_row])
    return RemeshPlan(kept, new_data, (), "shrink")


def reassign_data_shards(num_shards: int, surviving: list[int]) -> dict:
    """shard -> host map after failure; pure arithmetic (stateless data)."""
    return {s: surviving[s % len(surviving)] for s in range(num_shards)}
