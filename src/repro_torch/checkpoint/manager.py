"""Checkpoint manager: atomic, keep-k, async, ROM-aware (port of
``repro.checkpoint.manager``).

* Only the SRAM (trainable) state, the optimizer state, the step and an
  ``extra`` dict are persisted.  The ROM trunk is immutable: a checkpoint
  stores its fingerprint (``core.rom``), and :func:`restore` refuses a
  ROM image other than the one the process booted with.
* Atomic: write ``<dir>.tmp``, fsync, rename; a crash mid-save never
  corrupts the latest good checkpoint.
* The JAX package's layout: ``step_<8 digits>/{state.npz, meta.json}``
  and ``branch_<scenario>/{state.npz, manifest.json}``, npz keys ``t/``,
  ``o/`` and ``b/`` + each leaf's keystr name (``bridge.flatten``).
  numpy has no bfloat16: a bfloat16 leaf is stored as its raw 2-byte
  bits (dtype ``V2``, as numpy writes the JAX package's bfloat16 arrays)
  and restored by the template's dtype.
* Restored leaves land on ``device`` (default: the CUDA card).
* Elastic restore: ``restore(shardings=(t_shard, o_shard))`` (trees of
  ``sharding.NamedSharding``, e.g. ``launch.steps.model_state_shardings``'
  on another mesh than the one that saved) gives each rank its block of
  every leaf, cut from the whole array in the ``.npz`` as the reference's
  ``device_put`` places it.
* Inside a ``torch.distributed`` world :func:`save` writes from rank 0
  only, synchronously, and every rank waits at a barrier until the
  checkpoint is complete (the reference is single-controller).  Rank 0's
  leaves must be whole: under a data-parallel mesh, the one the train
  step runs on, every rank holds the whole trainable tree.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import bridge
from repro_torch import device as device_lib
from repro_torch.core import rom
from repro_torch.distributed import sharding as shd
from repro_torch.scenario import branch as branch_lib


def _host(leaf) -> np.ndarray:
    """One leaf as the array the JAX package would have written."""
    if not isinstance(leaf, torch.Tensor):
        return np.asarray(leaf)
    arr = rom.host_bytes(leaf)
    return arr.view("V2") if leaf.dtype == torch.bfloat16 else arr


def _arrays(prefix: str, tree) -> dict:
    return {f"{prefix}/{k}": _host(v) for k, v in bridge.flatten(tree).items()}


def _write_atomic(path: str, arrays: dict, meta_name: str, meta: dict):
    """``path``.tmp: the npz and the json, each fsynced; then rename."""
    tmp = path + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    with open(os.path.join(tmp, "state.npz"), "wb") as f:
        np.savez(f, **arrays)
        f.flush()
        os.fsync(f.fileno())
    with open(os.path.join(tmp, meta_name), "w") as f:
        json.dump(meta, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(path):
        shutil.rmtree(path)
    os.rename(tmp, path)


def save(ckpt_dir: str, step: int, trainable, opt_state, params_full,
         *, extra: dict | None = None, keep: int = 3,
         async_: bool = False) -> threading.Thread | None:
    """Persist SRAM state atomically; returns the IO thread if async.

    The host snapshot of the SRAM state is taken on the caller's thread.
    The ROM fingerprint is taken with the write, on the IO thread when
    async: the ROM is immutable, and hashing it is most of a save's cost
    at full width (Gemma-2B's 17.7 GB ROM).

    Inside a world only rank 0 writes, synchronously (``async_`` is not
    taken), and every rank returns after a barrier, so the checkpoint is
    complete on disk wherever ``save`` has returned."""
    if dist.is_available() and dist.is_initialized():
        if dist.get_rank() == 0:
            _save(ckpt_dir, step, trainable, opt_state, params_full, extra,
                  keep, async_=False)
        dist.barrier()
        return None
    return _save(ckpt_dir, step, trainable, opt_state, params_full, extra,
                 keep, async_)


def _save(ckpt_dir, step, trainable, opt_state, params_full, extra, keep,
          async_):
    extra = extra or {}
    arrays = _arrays("t", trainable)
    arrays.update(_arrays("o", opt_state))

    def _write():
        meta = {"step": int(step),
                "rom_fingerprint": rom.rom_fingerprint(params_full),
                "extra": extra}
        _write_atomic(os.path.join(ckpt_dir, f"step_{int(step):08d}"),
                      arrays, "meta.json", meta)
        _gc(ckpt_dir, keep)

    if async_:
        t = threading.Thread(target=_write, daemon=True)
        t.start()
        return t
    _write()
    return None


def _preview(names, n=4) -> str:
    names = sorted(names)
    return (", ".join(names[:n])
            + (f", ... ({len(names) - n} more)" if len(names) > n else ""))


def _check_structure(data, expected: dict, prefix: str, *, what: str):
    """Template names vs stored arrays under ``prefix``: a geometry-style
    error naming both structures, not a KeyError deep in the rebuild."""
    found = {k[len(prefix) + 1:] for k in data.files
             if k.startswith(prefix + "/")}
    missing = set(expected) - found
    unexpected = found - set(expected)
    if missing or unexpected:
        parts = []
        if missing:
            parts.append(f"missing from checkpoint: {_preview(missing)}")
        if unexpected:
            parts.append(f"not in template: {_preview(unexpected)}")
        raise ValueError(
            f"{what}: checkpoint state does not match the template "
            f"({'; '.join(parts)}; template expects {len(expected)} "
            f"arrays, checkpoint holds {len(found)}) — was this "
            f"checkpoint written for a different model config or "
            f"placement plan?")
    for name, leaf in expected.items():
        if not hasattr(leaf, "shape"):
            continue
        got = data[f"{prefix}/{name}"].shape
        if tuple(got) != tuple(leaf.shape):
            raise ValueError(
                f"{what}: array {name} has shape {tuple(got)} in the "
                f"checkpoint but the template expects "
                f"{tuple(leaf.shape)} — geometry changed since save")


def _leaf(arr: np.ndarray, like, device) -> torch.Tensor:
    """A stored array as a tensor of the template leaf's dtype where that
    is bfloat16 (stored as raw bits), else of its stored dtype."""
    if getattr(like, "dtype", None) == torch.bfloat16:
        if arr.dtype.itemsize != 2:
            raise ValueError(
                f"a bfloat16 leaf is stored as {arr.dtype}; expected its "
                f"2-byte bits")
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(arr)).to(device)


def _rebuild(data, template, prefix: str, device, *, what: str,
             shard_tree=None):
    """Template tree + stored arrays -> restored tree (structure-checked);
    with ``shard_tree`` (``NamedSharding`` leaves named as the template's)
    each leaf is this rank's block of the stored array."""
    _check_structure(data, bridge.flatten(template), prefix, what=what)
    shards = bridge.flatten(shard_tree) if shard_tree is not None else {}

    def one(name, like):
        arr = data[f"{prefix}/{name}"]
        if name in shards:
            arr = arr[tuple(slice(lo, hi) for lo, hi in
                            shd.block_bounds(arr.shape, shards[name]))]
        return _leaf(arr, like, device)

    return bridge.map_named(template, one)


def _gc(ckpt_dir: str, keep: int):
    steps = latest_steps(ckpt_dir)
    # keep <= 0 keeps NOTHING (steps[:-0] would slice to [] and keep all)
    drop = steps if keep <= 0 else steps[:-keep]
    for s in drop:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)


_STEP_RE = re.compile(r"^step_(\d+)$")


def latest_steps(ckpt_dir: str) -> list[int]:
    """Step numbers of the completed checkpoints under ``ckpt_dir``, sorted.
    Only exact ``step_<int>`` names count: stray directories
    (``step_broken``, ``step_5_backup``, a ``.tmp``) are skipped."""
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(m.group(1)) for m in map(_STEP_RE.match,
                                                os.listdir(ckpt_dir)) if m)


def restore(ckpt_dir: str, trainable_template, opt_template, params_full,
            *, step: int | None = None, shardings=None, device=None):
    """Load the latest (or given) step; refuses a ROM-fingerprint mismatch.

    ``shardings=(t_shard, o_shard)`` (elastic restore): trees of
    ``sharding.NamedSharding`` mirroring the trainable and opt templates;
    each restored leaf is this rank's block of the saved one on the
    sharding's mesh (a leaf without a sharding comes back whole).

    Returns (step, trainable, opt_state, extra), leaves on ``device``.
    """
    t_shard, o_shard = shardings if shardings is not None else (None, None)
    steps = latest_steps(ckpt_dir)
    if not steps:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    step = step if step is not None else steps[-1]
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    booted = rom.rom_fingerprint(params_full)
    if meta["rom_fingerprint"] != booted:
        raise ValueError(
            "ROM fingerprint mismatch: checkpoint was trained against a "
            f"different ROM image ({meta['rom_fingerprint'][:12]} != "
            f"{booted[:12]}). Refusing to restore.")
    dev = device_lib.resolve(device)
    with np.load(os.path.join(path, "state.npz")) as data:
        trainable = _rebuild(data, trainable_template, "t", dev,
                             what="restore(trainable)", shard_tree=t_shard)
        opt_state = _rebuild(data, opt_template, "o", dev,
                             what="restore(opt_state)", shard_tree=o_shard)
    return meta["step"], trainable, opt_state, meta.get("extra", {})


# ---------------------------------------------------------------------------
# branch-only checkpoints: one scenario's swappable SRAM state
# ---------------------------------------------------------------------------

_SCENARIO_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9._-]*$")


def _branch_path(ckpt_dir: str, scenario: str) -> str:
    if not _SCENARIO_RE.match(scenario):
        raise ValueError(
            f"scenario name {scenario!r} is not filesystem-safe "
            f"(want [A-Za-z0-9][A-Za-z0-9._-]*)")
    return os.path.join(ckpt_dir, f"branch_{scenario}")


def save_branch(ckpt_dir: str, scenario: str, branch, *,
                model_name: str, plan=None,
                extra: dict | None = None) -> None:
    """Persist ONE scenario's branch tree, atomically.  The manifest names
    the placement-plan fingerprint it was trained under, so
    :func:`restore_branch` never implants it onto another placement."""
    path = _branch_path(ckpt_dir, scenario)
    manifest = {"scenario": scenario, "model": model_name,
                "plan_fingerprint": branch_lib.plan_fingerprint(plan),
                "extra": extra or {}}
    _write_atomic(path, _arrays("b", branch), "manifest.json", manifest)


def branch_scenarios(ckpt_dir: str) -> list[str]:
    """Scenario names with a completed branch checkpoint under dir."""
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(n[len("branch_"):] for n in os.listdir(ckpt_dir)
                  if n.startswith("branch_") and not n.endswith(".tmp")
                  and os.path.isfile(os.path.join(ckpt_dir, n,
                                                  "manifest.json")))


def restore_branch(ckpt_dir: str, scenario: str, template, *,
                   plan=None, model_name: str | None = None, device=None):
    """Load one scenario's branch onto ``device``; refuses a
    plan-fingerprint or model mismatch.  ``template``: the branch tree
    skeleton (tensors or meta tensors, trunk positions None) the stored
    state must match, with the geometry-style errors of :func:`restore`.
    """
    path = _branch_path(ckpt_dir, scenario)
    if not os.path.isdir(path):
        raise FileNotFoundError(
            f"no branch checkpoint for scenario {scenario!r} under "
            f"{ckpt_dir} (have: {branch_scenarios(ckpt_dir)})")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    want_fp = branch_lib.plan_fingerprint(plan)
    if manifest["plan_fingerprint"] != want_fp:
        raise ValueError(
            f"restore_branch({scenario!r}): branch was saved under "
            f"placement plan {manifest['plan_fingerprint']} but this "
            f"deployment runs plan {want_fp}; refusing to restore a "
            f"branch onto a mismatched placement")
    if model_name is not None and manifest["model"] != model_name:
        raise ValueError(
            f"restore_branch({scenario!r}): branch was saved for model "
            f"{manifest['model']!r}, not {model_name!r}")
    dev = device_lib.resolve(device)
    with np.load(os.path.join(path, "state.npz")) as data:
        return _rebuild(data, template, "b", dev,
                        what=f"restore_branch({scenario!r})")
