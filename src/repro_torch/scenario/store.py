"""ScenarioStore: N registered scenarios over ONE resident trunk (port of
``repro.scenario.store``).

The store owns the host-side sources — in-memory branch trees, tagged
:class:`~repro_torch.scenario.branch.BranchBundle`\\ s, or branch-only
checkpoints written by ``checkpoint.manager.save_branch`` — and an LRU
cache of copies on the serving device, so hot scenarios swap without a
copy while cold ones stay off the device.

Resolution is strict: unknown scenario names raise with the registered
set, and every source is validated (tree geometry at register time for
in-memory sources, plan fingerprint and geometry at load time for
checkpoints).
"""

from __future__ import annotations

import collections

from repro_torch import bridge
from repro_torch import device as device_lib
from repro_torch.scenario import branch as branch_lib


class ScenarioStore:
    """Named branch sources + an LRU device cache for one deployment.

    model / plan: the resident cell the branches must fit (the branch
        template and the plan fingerprint both derive from them).
    capacity: max device-resident branches.  Eviction is LRU; a swap to
        an evicted scenario reloads it from its host source (the trunk
        never left the device).
    device: where cached branches live (default: the CUDA card).
    """

    def __init__(self, model, plan, *, capacity: int = 4, device=None):
        if capacity < 1:
            raise ValueError(f"need capacity >= 1, got {capacity}")
        self.model = model
        self.plan = plan
        self.plan_fp = branch_lib.plan_fingerprint(plan)
        self.capacity = int(capacity)
        self.device = device_lib.resolve(device)
        self.template = branch_lib.branch_template(model)
        self._sources: dict[str, tuple] = {}   # name -> (kind, payload)
        self._cache: collections.OrderedDict = collections.OrderedDict()
        self.evicted: list[str] = []           # eviction order, oldest first
        self.hits = 0
        self.misses = 0

    # -- registration ----------------------------------------------------
    def register(self, name: str, branch=None, *, bundle=None,
                 ckpt_dir: str | None = None,
                 override: bool = False) -> None:
        """Register one scenario from exactly one source.

        branch: an in-memory branch tree (validated now, and snapshotted
            to the host so later changes to the caller's copy cannot reach
            the store).
        bundle: a BranchBundle, whose plan fingerprint must match.
        ckpt_dir: a directory holding ``save_branch`` output for ``name``;
            fingerprint and geometry are validated at load.
        """
        n_sources = sum(x is not None for x in (branch, bundle, ckpt_dir))
        if n_sources != 1:
            raise ValueError(
                f"scenario {name!r}: pass exactly one of branch=, "
                f"bundle=, ckpt_dir= (got {n_sources})")
        if name in self._sources and not override:
            raise ValueError(
                f"scenario {name!r} already registered; pass "
                f"override=True to replace it")
        if bundle is not None:
            if bundle.model != self.model.cfg.name:
                raise ValueError(
                    f"scenario {name!r}: bundle is for model "
                    f"{bundle.model!r}, this store serves "
                    f"{self.model.cfg.name!r}")
            if bundle.plan_fp != self.plan_fp:
                raise ValueError(
                    f"scenario {name!r}: bundle was extracted under "
                    f"placement plan {bundle.plan_fp} but this "
                    f"deployment runs plan {self.plan_fp}; refusing a "
                    f"branch from a mismatched placement")
            branch = bundle.params
        if branch is not None:
            branch_lib.validate_branch(branch, self.template,
                                       where=f"scenario {name!r}")
            host = bridge.tree_map(
                branch, lambda t: t.detach().to("cpu", copy=True))
            self._sources[name] = ("host", host)
        else:
            self._sources[name] = ("ckpt", ckpt_dir)
        self._cache.pop(name, None)            # stale device copy, if any

    def names(self) -> list[str]:
        """Every registered scenario name, sorted."""
        return sorted(self._sources)

    def cached(self) -> list[str]:
        """Device-resident scenario names, least-recently-used first."""
        return list(self._cache)

    # -- lookup ----------------------------------------------------------
    def get(self, name: str):
        """The device-resident branch tree for ``name`` (LRU-cached).  A
        miss copies the host source (or the checkpoint) to the device."""
        if name in self._cache:
            self._cache.move_to_end(name)
            self.hits += 1
            return self._cache[name]
        try:
            kind, payload = self._sources[name]
        except KeyError:
            raise KeyError(
                f"unknown scenario {name!r}; registered: "
                f"{self.names()}") from None
        self.misses += 1
        if kind == "host":
            branch = bridge.tree_map(
                payload, lambda t: t.to(self.device, copy=True))
        else:
            from repro_torch.checkpoint import manager as ckpt
            branch = ckpt.restore_branch(payload, name, self.template,
                                         plan=self.plan, device=self.device)
        self._cache[name] = branch
        while len(self._cache) > self.capacity:
            old, _ = self._cache.popitem(last=False)
            self.evicted.append(old)
        return branch

    def evict(self, name: str | None = None) -> None:
        """Drop one (or every) device-resident copy; sources stay."""
        if name is None:
            self._cache.clear()
        else:
            self._cache.pop(name, None)

    def __len__(self) -> int:
        return len(self._sources)

    def __contains__(self, name: str) -> bool:
        return name in self._sources

    def __repr__(self):
        return (f"<ScenarioStore {self.model.cfg.name!r} "
                f"scenarios={self.names()} cached={len(self._cache)}/"
                f"{self.capacity} plan={self.plan_fp}>")
