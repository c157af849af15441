"""``repro_torch.launch.dryrun`` (each cell's step run per rank on the
``meta`` device over a fake world) against the JAX package's
``repro.launch.dryrun`` and against the layouts it cuts, on the CPU.

Held:
  * ``run_fig12(fast=True)``: the records equal the reference's, field
    for field, for DarkNet-19, ResNet-18 and Tiny-YOLO.  The reference
    runs in one subprocess that prints JSON: importing
    ``repro.launch.dryrun`` sets ``XLA_FLAGS`` to 512 host devices, which
    would reach every later JAX test of this worker;
  * smoke LM cells (Gemma-2B's and Yi-34B's smoke configs and the
    uneven-head variants of ``_torch_world.tp_config``, decode and
    prefill) on fake worlds of (data 1, model 4), (2, 2) and (pod 2,
    data 2, model 2): every rank's ``argument_bytes_per_dev`` is the sum
    of the blocks the layouts give it (``sharding.param_bounds``,
    ``cache_spec``), and its peak covers it;
  * a smoke ``cnn_serve`` cell: every rank of 8 runs the 20 trunk convs,
    the halo crosses as collective-permute bytes;
  * ``main`` on a cell that waits for ROADMAP item 5(d) prints ``not
    ported`` with its sub-slice and returns 0, and runs the dense
    ``decode_32k`` cells that waited for sub-slice (i) (uneven heads, a
    batch over pod x data) and the moe cells that waited for (iii),
    serving and ``train_4k``; the fake backend only inside a dry
    world.

A fixture ends any fake world a test leaves behind.  The per-rank bytes
against a real world's are held where the worlds run:
``test_torch_tp.py`` (LM) and ``test_torch_sharding.py`` (CNN).
"""

import json
import math
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
import torch.distributed as dist

import _torch_world as world
from repro_torch import bridge, configs, deploy
from repro_torch.distributed import sharding as shd
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def no_world_left():
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def test_fig12_records_equal_the_references():
    code = textwrap.dedent("""
        import json
        from repro.launch import dryrun
        print(json.dumps({n: dryrun.run_fig12(n, fast=True)
                          for n in dryrun.FIG12_MODELS}))
    """)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    want = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(want) == list(dryrun.FIG12_MODELS)
    for name, recs in want.items():
        got = json.loads(json.dumps(dryrun.run_fig12(name, fast=True)))
        assert got == recs, name


def _expected_arguments(cfg, mesh, kind, seq, gbatch, engine) -> int:
    """The bytes of the rank's blocks: parameters by ``param_bounds``, the
    cache by ``cache_spec``, the inputs whole (every rank gets the
    batch)."""
    model = deploy.compile_model(cfg, engine=engine)
    whole = bridge.abstract(lambda: model.init(seed=0, device="cpu"))
    shardings = bridge.flatten(shd.param_shardings(whole, mesh))
    rows = cfg.rebranch.cim.rows_per_subarray

    def size(leaf, bounds):
        n = 1
        for lo, hi in bounds:
            n *= hi - lo
        return n * leaf.element_size()

    total = sum(size(leaf, shd.param_bounds(path, leaf.shape,
                                            shardings[path], rows,
                                            cfg.head_dim))
                for path, leaf in bridge.flatten(whole).items())
    total += sum(t.numel() * t.element_size() for t in
                 steps.input_specs(cfg, seq, gbatch, kind).values())
    if kind == "decode":
        cache = model.init_cache(gbatch, seq, device="meta")
        total += sum(size(leaf, shd.block_bounds(
            leaf.shape, shd.NamedSharding(mesh, shd.cache_spec(p, leaf,
                                                               mesh))))
            for p, leaf in bridge.flatten(cache).items())
    return total


SHAPES = [(1, 4), (2, 2), (2, 2, 2)]
BLOCK_CASES = [
    pytest.param(name, shape, kind, id=f"{name}-shape{SHAPES.index(shape)}"
                                       f"-{kind}")
    for name, shapes in (("gemma_2b", SHAPES), ("yi_34b", SHAPES[:2]),
                         ("gemma_2b_h3", SHAPES[:2]), ("yi_34b_h6", SHAPES),
                         ("qwen15_32b_h6", SHAPES[:1]))
    for shape in shapes for kind in ("decode_32k", "prefill_32k")]


@pytest.mark.parametrize("name,shape,kind", BLOCK_CASES)
def test_each_rank_holds_the_blocks_its_layouts_give_it(name, shape, kind):
    """(2, 2, 2) is (pod, data, model): the batch over pod x data, with
    the heads over model 2."""
    cfg = world.tp_config(name)
    seq, gbatch = 32, 8
    with dryrun.dry_world(math.prod(shape)):
        mesh = world.tp_mesh(shape, mesh_lib.FAKE)
        ranks = [dict(zip(mesh.axis_names, np.unravel_index(r, shape)))
                 for r in range(mesh.size)]
        rec = dryrun.lower_cell(cfg.name.removesuffix("_smoke"), kind,
                                mesh, cfg=cfg, ranks=ranks,
                                engine="pallas_fused", seq=seq,
                                gbatch=gbatch)
        for coords, r in zip(ranks, rec["ranks"]):
            view = dryrun.RankMesh(mesh, coords)
            assert r["rank"] == view.rank
            assert r["argument_bytes_per_dev"] == _expected_arguments(
                cfg, view, configs.SHAPES[kind][2], seq, gbatch,
                "pallas_fused")
            assert r["peak_bytes_per_dev"] > r["argument_bytes_per_dev"]
            assert r["flops"] > 0 and r["collective_bytes"] > 0
    assert rec["mesh"] == "x".join(map(str, shape))
    assert rec["devices"] == math.prod(shape)
    assert rec["peak_bytes_per_dev"] == max(
        r["peak_bytes_per_dev"] for r in rec["ranks"])
    assert rec["peak_bytes_per_dev"] == (
        rec["argument_bytes_per_dev"] + rec["output_bytes_per_dev"]
        + rec["temp_bytes_per_dev"])


def test_smoke_cnn_serve_cell_runs_every_rank():
    with dryrun.dry_world(8):
        mesh = mesh_lib.make_cnn_serve_mesh(8, backend=mesh_lib.FAKE)
        rec = dryrun.lower_cnn_cell("darknet19", mesh, size=32, gbatch=2)
    assert len(rec["ranks"]) == 8
    assert rec["kernels"]["trunk_conv"]["launches"] == 20
    assert rec["collectives"]["collective-permute"] > 0
    assert rec["collectives"]["all-gather"] > 0
    assert (rec["shape"], rec["mesh"], rec["global_batch"]) == (
        "cnn_serve", "8x1", 2)


def test_main_reports_a_cell_that_waits_for_5d_as_not_ported(capsys):
    assert dryrun.main(["--arch", "falcon_mamba_7b", "--shape",
                        "decode_32k", "--single-pod"]) == 0
    out = capsys.readouterr().out
    assert "[not ported: 5(d)(iv)] falcon_mamba_7b x decode_32k" in out
    assert "0 records ok, 1 cells not ported, 0 failed" in out
    assert not dist.is_initialized()


def test_main_runs_the_moe_serving_cells(capsys):
    """Granite-MoE-3B and Qwen2-MoE-A2.7B: the ``prefill_32k`` and
    ``decode_32k`` cells on both meshes run (the first and last model
    rank; E 40 and 60 over model 16: the expert_mlp layout), each rank's
    bytes by kind in its record.  The family waits for no sub-slice of
    its own: its ``train_4k`` cells run since (iii)(b)
    (:func:`test_main_runs_the_dense_train_cells` runs Granite-MoE's)."""
    recs = {}
    for arch in ("granite_moe_3b", "qwen2_moe_a2_7b"):
        for shape in ("prefill_32k", "decode_32k"):
            with dryrun.dry_world(256):
                mesh = mesh_lib.make_production_mesh(backend=mesh_lib.FAKE)
                recs[arch, shape] = dryrun.lower_cell(arch, shape, mesh,
                                                      fast=True)
    for (arch, shape), rec in recs.items():
        assert len(rec["ranks"]) == 2
        for r in rec["ranks"]:
            assert r["bytes_sent"]["expert"] > 0, (arch, shape)
            # decode: 128 rows over 16 data ranks, one group of 128 tokens
            assert ("routing" in r["bytes_sent"]) == (shape == "decode_32k")
    assert dryrun.sub_slice("qwen2_moe_a2_7b") == "5(d)(i)"   # none of its own
    assert not dist.is_initialized()


def test_main_runs_the_dense_cells_of_uneven_heads_and_pod_batches(capsys):
    """Yi-34B (56 heads), Qwen1.5-32B (40) and Gemma-2B (8) over a 16-way
    model axis, DeepSeek-67B's batch over pod x data: each ``decode_32k``
    cell on both meshes runs (its first and last model rank), none waits
    for sub-slice (i)."""
    for arch in ("yi_34b", "qwen15_32b", "gemma_2b", "deepseek_67b"):
        assert dryrun.main(["--arch", arch, "--shape", "decode_32k",
                            "--fast"]) == 0
    out = capsys.readouterr().out
    for arch in ("yi_34b", "qwen15_32b", "gemma_2b", "deepseek_67b"):
        for mesh in ("single_pod", "multi_pod"):
            assert f"[ok] {arch} x decode_32k x {mesh}:" in out
    assert "[not ported" not in out and "[FAIL]" not in out
    assert not dist.is_initialized()


def test_the_fake_backend_only_inside_a_dry_world():
    with pytest.raises(ValueError, match="fake"):
        mesh_lib.init_world("fake", rank=0, world_size=1,
                            init_method="tcp://localhost:1")
    with dryrun.dry_world(2):
        with pytest.raises(RuntimeError, match="already initialised"):
            mesh_lib.init_dry_world(0, 2)
        mesh = mesh_lib.make_mesh((2, 1), backend=mesh_lib.FAKE)
        assert dist.get_backend(mesh.group("data")) == mesh_lib.FAKE
        x = torch.empty(3, device="meta")
        assert shd.gather_parts(x, mesh, "data", "reduce")[0].is_meta


def test_a_train_step_sends_what_a_gloo_world_sends():
    """One train step of ``_torch_world.TP_BYTES_CASE`` (Gemma-2B's smoke
    config on (data 1, model 4)): each rank of a fake world sends the
    bytes, kind by kind (the exchanges' adjoints and the gradients'
    reductions included), that the same rank of a gloo world sent."""
    sent = mesh_lib.spawn(world.tp_bytes_world, 4, backend="gloo",
                          deadline_s=240)
    name, shape, seq = world.TP_BYTES_CASE
    with dryrun.dry_world(4):
        mesh = world.tp_mesh(shape, mesh_lib.FAKE)
        rec = dryrun.lower_cell(
            "gemma_2b", "train_4k", mesh, cfg=world.tp_config(name),
            ranks=[{"model": m} for m in range(4)], engine="pallas",
            seq=seq, gbatch=world.TP_TRAIN_BATCH)
    assert [r["bytes_sent"] for r in rec["ranks"]] == [
        s["bytes_sent"] for s in sent]
    assert all(s["wire_bytes"] == {} for s in sent)    # no batch axis
    kinds = set(sent[0]["bytes_sent"])
    assert {"reduce_adjoint", "chunk_adjoint", "replicate_adjoint",
            "relayout_adjoint", "gather_adjoint", "grads"} <= kinds


def test_main_runs_the_dense_train_cells(capsys):
    """Gemma-2B's and Granite-MoE-3B's ``train_4k`` cells on 16x16 (first
    and last model rank; the moe family trains since sub-slice (iii)(b));
    Falcon-Mamba's still waits for the ssm family, sub-slice (iv)."""
    assert dryrun.main(["--arch", "gemma_2b", "--shape", "train_4k",
                        "--fast", "--single-pod"]) == 0
    assert dryrun.main(["--arch", "granite_moe_3b", "--shape", "train_4k",
                        "--fast", "--single-pod"]) == 0
    assert dryrun.main(["--arch", "falcon_mamba_7b", "--shape", "train_4k",
                        "--single-pod"]) == 0
    out = capsys.readouterr().out
    assert "[ok] gemma_2b x train_4k x single_pod:" in out
    assert "[ok] granite_moe_3b x train_4k x single_pod:" in out
    assert "[not ported: 5(d)(iv)] falcon_mamba_7b x train_4k" in out
    assert "[FAIL]" not in out
    assert not dist.is_initialized()
