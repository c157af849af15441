"""End-to-end training driver (port of ``repro.launch.train``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma_2b \\
      --steps 200 --smoke --batch 8 --seq 64 --ckpt-dir /tmp/ck [--resume]
      [--compress]

Runs branch-only ReBranch training (frozen int8 ROM trunk) with:
  * deterministic resumable data (``data/synthetic.py``),
  * AdamW on the SRAM tree + cosine schedule + grad clip,
  * atomic keep-k checkpoints every ``--ckpt-every`` steps, written on a
    background thread (+ a SIGTERM trap for preemption: a final
    checkpoint before exit).

The CLI runs on the CUDA card; :func:`main` takes ``device=`` for other
devices (the CPU tests).  When ``torch.distributed`` is initialised (by
the launcher, on every rank), it trains data-parallel under
``launch.mesh.make_local_mesh`` (every rank on ``data``, on the world's
backend): each rank takes its ``batch_pspec`` block of the global
``markov_batch``, the gradients are averaged over the ranks before AdamW
(``--compress``: through the int8 error-feedback all-reduce,
``optim/compress.py``), rank 0 logs and writes the checkpoints, and
``--resume`` restores each rank's block of every leaf
(``model_state_shardings``).  Without a world there is no all-reduce, so
``--compress`` changes nothing.
"""

from __future__ import annotations

import argparse
import contextlib
import signal
import sys
import time

import torch.distributed as dist

from repro_torch import configs, deploy, optim
from repro_torch import device as device_lib
from repro_torch.checkpoint import manager as ckpt
from repro_torch.core import rebranch
from repro_torch.data import synthetic
from repro_torch.distributed import sharding as shd
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps as steps_lib
from repro_torch.optim import schedule


def main(argv=None, *, device=None):
    """Train; returns the per-step losses of this run (from ``--resume``'s
    step on)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma_2b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--compress", action="store_true",
                    help="int8 error-feedback gradient all-reduce "
                         "(inside a torch.distributed world)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    dev = device_lib.resolve(device)
    world = dist.is_available() and dist.is_initialized()
    mesh = (mesh_lib.make_local_mesh(backend=dist.get_backend())
            if world else None)
    with shd.use_mesh(mesh) if mesh is not None else contextlib.nullcontext():
        return _train(args, dev, mesh)


def _train(args, dev, mesh):
    lead = mesh is None or dist.get_rank() == 0
    log = (lambda msg: print(msg, flush=True)) if lead else (lambda msg: None)
    cfg = (configs.get_smoke(args.arch) if args.smoke
           else configs.get(args.arch))
    dcfg = synthetic.DataConfig(
        seed=args.seed, vocab_size=cfg.vocab_size, seq_len=args.seq,
        global_batch=args.batch, num_codebooks=cfg.num_codebooks)

    model = deploy.compile_model(cfg)
    params = model.init(seed=args.seed, device=dev)
    trainable, frozen = rebranch.partition(params)
    opt_state = optim.init(trainable)
    lr_fn = lambda step: schedule.cosine_with_warmup(
        step, peak_lr=args.lr, warmup_steps=args.warmup,
        total_steps=args.steps)
    opt_cfg = optim.AdamWConfig(lr=args.lr)
    train_step = steps_lib.make_train_step(
        cfg, opt_cfg, lr_fn=lr_fn, loss_chunks=4, model=model,
        compress=args.compress, global_batch=args.batch)

    start = 0
    if args.resume and args.ckpt_dir and ckpt.latest_steps(args.ckpt_dir):
        shardings = None
        if mesh is not None:
            t_sh, _, o_sh, _ = steps_lib.model_state_shardings(cfg, mesh,
                                                               model)
            shardings = (t_sh, o_sh)
        start, trainable, opt_state, _ = ckpt.restore(
            args.ckpt_dir, trainable, opt_state, params, device=dev,
            shardings=shardings)
        log(f"[train] resumed from step {start}")

    # preemption: checkpoint on SIGTERM, then exit cleanly
    state = {"step": start, "trainable": trainable, "opt": opt_state}

    def _on_sigterm(signum, frame):
        if args.ckpt_dir:
            ckpt.save(args.ckpt_dir, state["step"], state["trainable"],
                      state["opt"], params)
            print(f"[train] SIGTERM: checkpointed step {state['step']}",
                  flush=True)
        sys.exit(0)

    # inside a world a save is a collective (rank 0 writes, all wait), so
    # a signal on one rank cannot checkpoint alone
    previous = (signal.signal(signal.SIGTERM, _on_sigterm) if mesh is None
                else None)
    try:
        n_sram = rebranch.trainable_count(params)
        n_rom = rebranch.frozen_count(params)
        log(f"[train] {cfg.name}: ROM {n_rom/1e6:.2f}M params (frozen), "
            f"SRAM {n_sram/1e6:.2f}M trainable "
            f"({n_rom/(n_rom+n_sram):.1%} in ROM)")
        if mesh is not None:
            log(f"[train] data-parallel over {mesh.size} ranks "
                f"({dist.get_backend()}); int8 error-feedback gradient "
                f"compression {'ON' if args.compress else 'off'}")
        elif args.compress:
            log("[train] --compress: one process, no gradient all-reduce "
                "to compress")

        losses = []
        t0 = time.time()
        io_thread = None
        for step in range(start, args.steps):
            batch = synthetic.markov_batch(dcfg, step, device=dev)
            if mesh is not None:
                batch = steps_lib.local_batch(cfg, mesh, batch, args.batch)
            trainable, opt_state, metrics = train_step(
                trainable, frozen, opt_state, batch)
            state.update(step=step + 1, trainable=trainable, opt=opt_state)
            losses.append(float(metrics["loss"]))
            if (step + 1) % args.log_every == 0:
                dt = (time.time() - t0) / args.log_every
                log(f"[train] step {step+1:5d} "
                    f"loss {losses[-1]:.4f} "
                    f"gnorm {float(metrics['grad_norm']):.3f} "
                    f"lr {float(metrics['lr']):.2e} "
                    f"({dt*1e3:.0f} ms/step)")
                t0 = time.time()
            if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
                if io_thread is not None:
                    io_thread.join()
                io_thread = ckpt.save(args.ckpt_dir, step + 1, trainable,
                                      opt_state, params,
                                      async_=mesh is None)
        if io_thread is not None:
            io_thread.join()
        if args.ckpt_dir:
            ckpt.save(args.ckpt_dir, args.steps, trainable, opt_state,
                      params)
    finally:
        if previous is not None:
            signal.signal(signal.SIGTERM, previous)

    floor = synthetic.entropy_floor(dcfg)
    if losses:
        log(f"[train] done. loss {losses[0]:.4f} -> {losses[-1]:.4f} "
            f"(entropy floor {floor:.4f})")
    return losses


if __name__ == "__main__":
    main()
