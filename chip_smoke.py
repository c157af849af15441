#!/usr/bin/env python3
"""Drive the PyTorch/H100 port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) on a failed check:

1. Build: the CUDA kernels compile from ``src/repro_torch/kernels/csrc``
   into ``build/`` (one nvcc per source, all started together).
2. Kernels: at every DarkNet-19 conv geometry at 416x416, batch 8, the
   trunk-conv kernel is held against its plain PyTorch version on the same
   card inputs: the unscaled trunk with ``torch.equal``, the fused
   ReBranch conv output within 1e-5 of its absmax (the trunk is
   bit-exact and both sides run the same branch GEMMs).  Times come from
   CUDA events over warmed launches.
3. Serving, the main path: a registry entry ``darknet19-416`` (all-ROM
   plan from ``plan.solve``, engine ``pallas_fused``), seeded parameters
   with non-zero ReBranch cores, ``CNNServer`` with 8 slots, three
   requests of 8, 8 and 5 images.  The launch count must rise by exactly
   20 per served chunk (one per conv site), the outputs must be finite,
   and the 5-image request's rows must equal, bit for bit, the same images
   served in a full chunk.  Then a sustained window: three runs of one
   request of 32 full chunks each (256 images), images/s as all images
   over the whole request, with the spread across the runs.
4. CPU reference: one image through the served model on the card, every
   conv layer's call recorded; each layer is run again on the CPU (the
   plain versions) on the same input and held within 1e-5 of its output's
   absmax (the trunk is bit-exact given the same input; the float branch
   GEMMs and convs sum in another order on the two devices).  The whole
   forward is compared with the CPU too, but only printed: the quantised
   network is chaotic at the ulp level (an ulp moved before a later
   layer's per-row quantiser moves an int8 code), so the script also
   prints how far the card's own output moves under a 1e-7 relative
   input perturbation.

It needs one card, exits non-zero without one, and prints as its last line
``{"ok": true, "device": {...}}``; the line before it is the kernel table
as JSON.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

# NVIDIA H100 SXM data sheet, dense: int8 tensor-core rate, HBM3 rate
PEAK_INT8_OPS = 1979e12
PEAK_BYTES = 3.35e12

SIZE, BATCH, SLOTS = 416, 8, 8
REQUESTS = (8, 8, 5)
SUSTAINED_CHUNKS, SUSTAINED_RUNS = 32, 3
FUSED_RTOL = 1e-5        # phase 2, of the fused output's absmax
LAYER_RTOL = 1e-5        # phase 4, of each layer output's absmax


def check(ok: bool, what: str):
    if not ok:
        raise SystemExit(f"FAILED: {what}")


def time_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` launches after one warm-up,
    from CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def trunk_bound_ms(m: int, r: int, n: int) -> tuple[float, str]:
    """Least time for P f32 [m, r] x W int8 [r, n] -> f32 [m, n]: int8
    operations over the tensor-core peak, or each input read once and the
    output written once over the HBM rate, whichever is larger."""
    ops_ms = 2.0 * m * r * n / PEAK_INT8_OPS * 1e3
    bytes_ms = (4.0 * m * r + r * n + 4.0 * m * n) / PEAK_BYTES * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def with_cores(tree, gen: torch.Generator):
    """Replace every (zero-initialised) ReBranch core by seeded N(0, 0.05)
    values, so every branch contributes to the output."""
    if isinstance(tree, dict):
        out = {k: with_cores(v, gen) for k, v in tree.items()}
        sram = out.get("sram")
        if isinstance(sram, dict) and "core" in sram:
            core = sram["core"]
            sram["core"] = (torch.randn(core.shape, generator=gen) * 0.05
                            ).to(core.device)
        return out
    if isinstance(tree, list):
        return [with_cores(v, gen) for v in tree]
    return tree


def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    reports = _build.build()
    secs = time.perf_counter() - t0
    for name in _build.SOURCES:
        print(f"built {_build.target(name).relative_to(ROOT)} from "
              f"{(_build.CSRC / (name + '.cu')).relative_to(ROOT)}")
        for line in reports.get(name, "").splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas: {line.strip()}")
    print(f"build_s {secs:.2f}")


def fused_plain(x, w_q, w_scale, c, core, u):
    """``rebranch_conv`` with the trunk from the plain version (stride 1,
    SAME): the reference the kernel route is held against."""
    from repro_torch.kernels import rebranch_conv as rc
    kh, kw, c_in, c_out = w_q.shape
    c_c, c_u = core.shape[2], core.shape[3]
    p, (n, oh, ow) = rc.patch_matrix(x, kh, kw, 1, "SAME")
    trunk = rc.trunk_patch_dot_plain(p, w_q.reshape(-1, c_out))
    t1 = rc.structured_compress(p, c.reshape(c_in, c_c), kh * kw)
    branch = (t1 @ core.reshape(kh * kw * c_c, c_u)) @ u.reshape(c_u, c_out)
    return (trunk * w_scale.reshape(1, -1) + branch).reshape(n, oh, ow, c_out)


def phase_kernels(dev, cfg) -> dict:
    """Kernel vs plain version at every conv geometry of ``cfg``."""
    from repro_torch.kernels import rebranch_conv as rc
    from repro_torch.models import cnn
    gen = torch.Generator(device=dev).manual_seed(1)
    tot = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "ops_ms": 0.0,
           "bytes_ms": 0.0, "conv_ms": 0.0, "im2col_ms": 0.0,
           "max_abs_err": 0.0}
    print("site k c_in c_out M R N trunk_equal fused_rel_err ms plain_ms "
          "bound_ms bound_by library_ms fused_conv_ms im2col_ms")
    for site, k, c_in, c_out, hw, stride in cnn.conv_site_shapes(cfg):
        check(stride == 1, f"{site}: DarkNet-19 convs are stride 1")
        x = torch.randn((BATCH, hw, hw, c_in), generator=gen, device=dev)
        w_q = torch.randint(-127, 128, (k, k, c_in, c_out), generator=gen,
                            device=dev, dtype=torch.int8)
        w_scale = torch.rand((1, 1, 1, c_out), generator=gen, device=dev
                             ) * 1e-2 + 1e-3
        c_c, c_u = max(1, c_in // 4), max(1, c_out // 4)
        c = torch.randn((1, 1, c_in, c_c), generator=gen, device=dev) / c_in ** .5
        core = torch.randn((k, k, c_c, c_u), generator=gen, device=dev) * 0.05
        u = torch.randn((1, 1, c_u, c_out), generator=gen, device=dev) / c_u ** .5

        p, _ = rc.patch_matrix(x, k, k, 1, "SAME")
        w2d = w_q.reshape(-1, c_out)
        m, r = p.shape
        got = rc.trunk_patch_dot(p, w2d)
        want = rc.trunk_patch_dot_plain(p, w2d)
        torch.cuda.synchronize()
        equal = torch.equal(got, want)
        err = (got - want).abs().max().item()
        check(equal, f"{site}: kernel trunk != plain trunk (max {err})")
        y = rc.rebranch_conv(x, w_q, w_scale, c, core, u)
        y_plain = fused_plain(x, w_q, w_scale, c, core, u)
        scale = y_plain.abs().max().item()
        ferr = (y - y_plain).abs().max().item() / scale
        check(ferr <= FUSED_RTOL and torch.isfinite(y).all().item(),
              f"{site}: fused conv off by {ferr} of its absmax")
        del got, want, y, y_plain

        ms = time_ms(lambda: rc.trunk_patch_dot(p, w2d), 5)
        plain_ms = time_ms(lambda: rc.trunk_patch_dot_plain(p, w2d), 3)
        # the whole fused conv around the kernel, and its im2col alone
        conv_ms = time_ms(lambda: rc.rebranch_conv(x, w_q, w_scale, c, core,
                                                   u), 3)
        im2col_ms = time_ms(lambda: rc.patch_matrix(x, k, k, 1, "SAME"), 3)
        bound, by = trunk_bound_ms(m, r, c_out)
        ops_ms = 2.0 * m * r * c_out / PEAK_INT8_OPS * 1e3
        print(f"{site} {k} {c_in} {c_out} {m} {r} {c_out} {equal} {ferr:.3e} "
              f"{ms:.4f} {plain_ms:.4f} {bound:.4f} {by} none "
              f"{conv_ms:.4f} {im2col_ms:.4f}", flush=True)
        tot["conv_ms"] += conv_ms
        tot["im2col_ms"] += im2col_ms
        tot["ms"] += ms
        tot["plain_ms"] += plain_ms
        tot["bound_ms"] += bound
        tot["ops_ms"] += ops_ms
        tot["bytes_ms"] += bound if by == "bytes" else 0.0
        tot["max_abs_err"] = max(tot["max_abs_err"], err)
        del p, x
        torch.cuda.empty_cache()
    print(f"per forward (20 launches): kernel {tot['ms']:.3f} ms, plain "
          f"{tot['plain_ms']:.3f} ms, bound {tot['bound_ms']:.3f} ms "
          f"(int8 operations alone {tot['ops_ms']:.3f} ms); the 20 fused "
          f"convs {tot['conv_ms']:.3f} ms, of which im2col "
          f"{tot['im2col_ms']:.3f} ms")
    return tot


def phase_serve(cfg):
    """The main path: registry -> compile_entry -> load -> CNNServer."""
    from repro_torch.kernels import rebranch_conv as rc
    from repro_torch.models import cnn
    from repro_torch.serve import registry, server

    registry.register(registry.ModelEntry(
        model_id="darknet19-416", config=lambda: cfg, engine="pallas_fused"))
    model, _plan = registry.compile_entry("darknet19-416")
    sites = [s[0] for s in cnn.conv_site_shapes(model.cfg)]
    for site in sites:
        spec = model.layer_spec(site)
        check(spec.enabled and spec.branch_enabled
              and spec.trunk_impl == "pallas_fused",
              f"{site}: the solved plan is not all-ROM pallas_fused ({spec})")
    params = model.init(seed=0)
    params = with_cores(params, torch.Generator().manual_seed(2))
    srv = server.load("darknet19-416", params=params, n_slots=SLOTS)
    rng = np.random.default_rng(3)
    images = rng.standard_normal((sum(REQUESTS), SIZE, SIZE, 3),
                                 dtype=np.float32)

    srv.submit(images[:SLOTS])                     # warm-up, not counted
    torch.cuda.synchronize()
    rc.launches = 0
    outs, lo, t_all = [], 0, time.perf_counter()
    for i, b in enumerate(REQUESTS):
        t0 = time.perf_counter()
        out = srv.submit(images[lo:lo + b])        # returns host numpy
        dt = time.perf_counter() - t0
        print(f"request {i}: {b} images, latency {dt * 1e3:.2f} ms, "
              f"{b / dt:.2f} images/s")
        outs.append(out)
        lo += b
    wall = time.perf_counter() - t_all
    launches = rc.launches
    chunks = sum(-(-b // SLOTS) for b in REQUESTS)
    n_sites = len(sites)
    print(f"served {sum(REQUESTS)} images in {wall * 1e3:.2f} ms "
          f"({sum(REQUESTS) / wall:.2f} images/s); trunk kernel launches "
          f"{launches} over {chunks} chunks")
    check(launches == n_sites * chunks,
          f"expected {n_sites} launches per chunk, got {launches} for "
          f"{chunks} chunks")
    for b, out in zip(REQUESTS, outs):
        check(out.shape == (b, SIZE // 32, SIZE // 32, 5, 25),
              f"output shape {out.shape}")
        check(bool(np.isfinite(out).all()), "non-finite output")

    # pad-row invisibility: the short request's rows, served in a full chunk
    short_lo = sum(REQUESTS[:-1])
    short = images[short_lo:]
    before = rc.launches
    full = srv.submit(np.concatenate([short, images[:SLOTS - len(short)]]))
    check(rc.launches - before == n_sites, "full chunk launch count")
    check(np.array_equal(full[:len(short)], outs[-1]),
          "pad rows changed a real row: short request != full chunk rows "
          f"(max diff {np.abs(full[:len(short)] - outs[-1]).max()})")
    print(f"pad rows invisible: {len(short)}-image request bitwise equal to "
          f"the same rows of a full chunk")

    # sustained window: requests of many full chunks, back to back
    n_img = SUSTAINED_CHUNKS * SLOTS
    batch = rng.standard_normal((n_img, SIZE, SIZE, 3), dtype=np.float32)
    rates = []
    for run in range(SUSTAINED_RUNS):
        before = rc.launches
        t0 = time.perf_counter()
        out = srv.submit(batch)
        dt = time.perf_counter() - t0
        check(rc.launches - before == n_sites * SUSTAINED_CHUNKS,
              "sustained window launch count")
        check(out.shape[0] == n_img and bool(np.isfinite(out).all()),
              "sustained window output")
        rates.append(n_img / dt)
        print(f"sustained run {run}: {n_img} images in {SUSTAINED_CHUNKS} "
              f"chunks, {dt * 1e3:.2f} ms, {n_img / dt:.2f} images/s")
    spread = (max(rates) - min(rates)) / min(rates)
    print(f"sustained images/s: mean {sum(rates) / len(rates):.2f}, min "
          f"{min(rates):.2f}, max {max(rates):.2f}, spread {spread:.2%}")
    del batch, out

    # where a chunk's time goes: the device forward vs the host copy
    chunk = torch.from_numpy(images[:SLOTS])
    x = chunk.to(srv.device)
    with torch.no_grad():
        fwd_ms = time_ms(lambda: model.forward(params, x), 5)
    copy_ms = time_ms(lambda: chunk.to(srv.device), 5)
    print(f"per {SLOTS}-image chunk: device forward {fwd_ms:.3f} ms, "
          f"host-to-device copy {copy_ms:.3f} ms")
    return model, params, images[:1], launches


def phase_cpu(model, params, image):
    """Every conv call of one image's forward on the card, replayed on the
    CPU on the same input."""
    from repro_torch import bridge
    from repro_torch.models import cnn

    calls = []
    apply_conv = cnn.apply_conv

    def recording(p, x, spec, stride=1, epilogue=None):
        y = apply_conv(p, x, spec, stride, epilogue)
        calls.append((p, x, spec, stride, epilogue, y))
        return y

    x = torch.from_numpy(image)
    cnn.apply_conv = recording
    try:
        with torch.no_grad():
            card = model.forward(params, x.cuda())
    finally:
        cnn.apply_conv = apply_conv
    check(len(calls) == 21, f"expected 21 conv calls, recorded {len(calls)}")
    worst = 0.0
    t0 = time.perf_counter()
    for p, xin, spec, stride, ep, y in calls:
        if ep is not None:
            ep = dataclasses.replace(ep, scale=ep.scale.cpu(),
                                     bias=ep.bias.cpu())
        with torch.no_grad():
            ref = apply_conv(bridge.to_torch(bridge.to_numpy(p), "cpu"),
                             xin.cpu(), spec, stride, ep)
        rel = ((ref - y.cpu()).abs().max() / ref.abs().max()).item()
        worst = max(worst, rel)
    secs = time.perf_counter() - t0
    print(f"cpu reference, layer by layer (21 convs, plain versions, "
          f"{secs:.1f} s): worst max abs diff {worst:.3e} of the layer "
          f"output's absmax (tolerance {LAYER_RTOL})")
    check(worst <= LAYER_RTOL, "a layer on the card disagrees with the CPU")

    cpu_params = bridge.to_torch(bridge.to_numpy(params), "cpu")
    noise = torch.randn(x.shape, generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        ref = model.forward(cpu_params, x)
        moved = model.forward(params, (x * (1 + 1e-7 * noise)).cuda())
    amax = ref.abs().max().item()
    whole = (ref - card.cpu()).abs().max().item() / amax
    self_moved = (moved - card).abs().max().item() / amax
    check(bool(torch.isfinite(card).all()), "non-finite card output")
    print(f"whole forward, card vs cpu: max abs diff {whole:.3e} of the "
          f"absmax; card vs card on a 1e-7 perturbed input: "
          f"{self_moved:.3e}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch import device as device_lib
    from repro_torch.models import cnn

    dev = device_lib.resolve()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    cfg = cnn.CNNConfig(name="darknet19", input_size=SIZE)

    phase_build()
    tot = phase_kernels(dev, cfg)
    model, params, image, launches = phase_serve(cfg)
    phase_cpu(model, params, image)

    by = "bytes" if tot["bytes_ms"] >= tot["bound_ms"] / 2 else "operations"
    print(json.dumps({"kernels": [{
        "name": "trunk_conv",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/trunk_conv.cu",
        "replaces": "src/repro/kernels/rebranch_conv.py:105",
        "launches": launches,
        "max_abs_err": tot["max_abs_err"],
        "ms": tot["ms"],
        "plain_ms": tot["plain_ms"],
        "bound_ms": tot["bound_ms"],
        "bound_by": by,
        "library_ms": None,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
