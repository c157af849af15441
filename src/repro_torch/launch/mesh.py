"""Meshes over ``torch.distributed`` (port of ``repro.launch.mesh``).

A JAX mesh names the devices of one process; here every mesh position is
a process (a rank), and an axis of the mesh is a process group.  The
port's :class:`Mesh` keeps the reference's surface (``axis_names``, a
``shape`` dict, ``size``), so ported code reads as the reference does,
and adds what a rank needs: its coordinate on an axis and that axis's
process group.  It is built over
``torch.distributed.device_mesh.init_device_mesh``.  :class:`AbstractMesh`
has the same surface and no process group: the sharding rules resolve on
it at any size (16x16 on one CPU), as on ``jax.sharding.AbstractMesh``.

The backend is always the caller's choice, never picked here: ``"nccl"``
where each rank owns a card, ``"gloo"`` otherwise (several ranks on one
card, or the CPU).  Every process group has a timeout of
:data:`TIMEOUT`, so a collective that one rank skips fails the others
within a minute instead of hanging them.

:func:`init_dry_world` makes this process one rank of a world of any size
on PyTorch's fake backend (``FakeProcessGroup``: every collective returns
at once and moves nothing), so one process can build the production mesh
of 256 or 512 ranks and run a step as any of its ranks on the ``meta``
device (``launch/dryrun.py``).  ``backend="fake"`` is taken only inside
such a world; :data:`BACKENDS` stays what a real run may choose.

:func:`spawn` starts a local world of ranks (the port's counterpart of the
reference's forced host devices): spawned processes, a ``file://``
rendezvous in a fresh directory, a deadline after which every rank is
killed and the run fails.
"""

from __future__ import annotations

import datetime
import math
import multiprocessing
import os
import pickle
import tempfile
import time

import torch
import torch.distributed as dist

TIMEOUT = datetime.timedelta(seconds=60)
AXES = ("data", "model")
BACKENDS = ("gloo", "nccl")
FAKE = "fake"


class AbstractMesh:
    """Axis names and sizes only: what the sharding rules read."""

    def __init__(self, shape, axis_names=AXES):
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {tuple(shape)} does not match "
                             f"axis names {tuple(axis_names)}")
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in shape)))
        self.size = math.prod(self.shape.values())

    def __repr__(self):
        dims = "x".join(str(self.shape[a]) for a in self.axis_names)
        return f"<{type(self).__name__} {dims} {self.axis_names}>"


class Mesh(AbstractMesh):
    """A mesh of ranks: ``device_mesh`` (a torch ``DeviceMesh``) holds one
    process group per axis."""

    def __init__(self, device_mesh, backend: str):
        super().__init__(tuple(device_mesh.shape), device_mesh.mesh_dim_names)
        self.device_mesh = device_mesh
        self.backend = backend

    def coordinate(self, axis: str) -> int:
        """This rank's index along ``axis``."""
        return self.device_mesh.get_local_rank(axis)

    def group(self, axis: str):
        """The process group of this rank's line along ``axis`` (group rank
        == coordinate, checked when the mesh is made)."""
        return self.device_mesh.get_group(axis)


def _check_backend(backend: str):
    if backend == FAKE and dist.is_initialized() and dist.get_backend() == FAKE:
        return
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS} (the caller "
                         f"chooses: 'nccl' where each rank owns a card, "
                         f"'gloo' otherwise; 'fake' only in a world of "
                         f"init_dry_world), got {backend!r}")


def init_world(backend: str, *, rank: int, world_size: int,
               init_method: str, timeout: datetime.timedelta = TIMEOUT):
    """Join the default process group (``init_method`` e.g.
    ``file:///tmp/x/init`` or ``tcp://localhost:29500``)."""
    _check_backend(backend)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size, timeout=timeout)


def init_dry_world(rank: int, world_size: int):
    """Make this process rank ``rank`` of a world of ``world_size`` ranks on
    the fake backend: no process is started and no byte moves (a
    collective returns its buffers untouched), so the ranks' steps run on
    ``meta`` tensors and only the shapes and the exchange counters
    (``sharding.bytes_sent``, ``compress.wire_bytes``) mean anything.
    Raises if a process group is already initialised; end the world with
    ``torch.distributed.destroy_process_group()``."""
    from torch._C._distributed_c10d import FakeProcessGroup
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised; "
                           "destroy it before starting a dry world")

    def create(common, options):
        return FakeProcessGroup._create_internal(common.group_rank,
                                                 common.group_size, options)
    # registered for each world: PyTorch's own registration of the fake
    # backend (made when some of its modules load) lacks "meta", by whose
    # device the point-to-point ops pick their backend
    dist.Backend.register_backend(FAKE, create, extended_api=True,
                                  devices=["cpu", "cuda", "meta"])
    dist.init_process_group(FAKE, rank=rank, world_size=world_size,
                            store=dist.HashStore())


def _options(backend: str):
    """Process-group options carrying :data:`TIMEOUT` (``init_device_mesh``
    gives its groups the default half hour otherwise)."""
    opts = (dist.ProcessGroupGloo._Options() if backend == "gloo"
            else dist.ProcessGroupNCCL.Options())
    opts._timeout = TIMEOUT
    return opts


def make_mesh(shape, axis_names=AXES, *, backend: str) -> Mesh:
    """A :class:`Mesh` of ``shape`` over the whole (initialised) world, its
    axis groups on ``backend``.  Every rank calls it, in the same order."""
    _check_backend(backend)
    if not dist.is_initialized():
        raise RuntimeError("no process group: call launch.mesh.init_world "
                           "on every rank first")
    size = math.prod(shape)
    if size != dist.get_world_size():
        raise ValueError(f"a {'x'.join(map(str, shape))} mesh needs {size} "
                         f"ranks; the world has {dist.get_world_size()}")
    from torch.distributed.device_mesh import init_device_mesh
    device_mesh = init_device_mesh(
        "cuda" if backend == "nccl" else "cpu", tuple(shape),
        mesh_dim_names=tuple(axis_names),
        backend_override={a: backend if backend == FAKE
                          else (backend, _options(backend))
                          for a in axis_names})
    mesh = Mesh(device_mesh, backend)
    for a in mesh.axis_names:
        group = mesh.group(a)
        if dist.get_group_rank(group, dist.get_rank()) != mesh.coordinate(a):
            raise RuntimeError(f"axis {a!r}: group rank != mesh coordinate")
    return mesh


def make_production_mesh(*, backend: str, multi_pod: bool = False) -> Mesh:
    """16x16 = 256 ranks per pod; 2 pods = 512 ranks multi-pod.  Raises
    unless the world has exactly that many ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else AXES
    return make_mesh(shape, axes, backend=backend)


def make_local_mesh(*, backend: str) -> Mesh:
    """Every rank of the world on the data axis."""
    return make_mesh((dist.get_world_size(), 1), backend=backend)


def make_cnn_serve_mesh(n_data: int = 8, *, backend: str) -> Mesh:
    """CNN serving mesh for the halo-exchange sharded conv engine: spatial
    H shards over ``data`` (rule ``"cnn_h"``), ``model`` kept 1 (trunk
    weights live whole in ROM macros).  The world must have ``n_data``
    ranks."""
    return make_mesh((n_data, 1), backend=backend)


def make_lm_mesh(n_data: int, n_model: int, *, backend: str) -> Mesh:
    """LM serving mesh ``(data, model)``: the batch over ``data`` (rule
    ``"batch"``), heads, MLP columns, vocab and k-blocks over ``model``;
    each data coordinate has its own ``model`` group (``Mesh.group``).
    The world must have ``n_data * n_model`` ranks."""
    return make_mesh((n_data, n_model), backend=backend)


# ---------------------------------------------------------------------------
# a local world of spawned ranks
# ---------------------------------------------------------------------------

def _rank_main(fn, rank: int, world_size: int, backend: str, root: str,
               threads: int, args: tuple):
    torch.set_num_threads(threads)
    init_world(backend, rank=rank, world_size=world_size,
               init_method=f"file://{os.path.join(root, 'init')}")
    try:
        result = fn(rank, world_size, *args)
        # no rank tears its group down while another still connects
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(root, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


def spawn(fn, world_size: int, *, backend: str, args: tuple = (),
          deadline_s: float = 300.0, threads: int = 1) -> list:
    """Run ``fn(rank, world_size, *args)`` in ``world_size`` spawned
    processes joined in one process group on ``backend``; returns each
    rank's result in rank order.

    ``fn`` must be importable by name (spawned processes import it).  If
    any rank exits with an error, or the deadline passes first, every
    rank still running is killed and this raises: no rank's failure is
    swallowed and a hang costs at most ``deadline_s``.
    """
    _check_backend(backend)
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as root:
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, r, world_size, backend, root, threads,
                                   args))
                 for r in range(world_size)]
        for p in procs:
            p.start()
        end = time.monotonic() + deadline_s
        failed = None
        try:
            while any(p.is_alive() for p in procs):
                codes = [p.exitcode for p in procs]
                if any(c not in (None, 0) for c in codes):
                    failed = f"rank exit codes {codes}"
                    break
                if time.monotonic() > end:
                    failed = f"deadline of {deadline_s:.0f} s passed"
                    break
                time.sleep(0.02)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
            for p in procs:
                p.join(10)
        codes = [p.exitcode for p in procs]
        if failed or any(c != 0 for c in codes):
            raise RuntimeError(f"spawned world of {world_size} ranks failed: "
                               f"{failed or ''} (exit codes {codes})")
        results = []
        for r in range(world_size):
            with open(os.path.join(root, f"rank{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results
