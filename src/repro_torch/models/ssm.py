"""Mamba-1 selective SSM (falcon-mamba-7b) with ReBranch projections (port
of ``repro.models.ssm``).

The large linear maps (in_proj, x_proj, dt_proj, out_proj) are ReBranch
layers, each its own site (``{prefix}.in_proj`` ...); the recurrence is
elementwise, not a CiM operation, and its small parameters (A_log, D, the
depthwise conv, the dt/B/C norms of falcon-mamba) stay trainable
("SRAM").

The scan is plain PyTorch, as it is jnp in the reference: a loop over
sequence chunks carrying the state h, and within a chunk a log-step
(Hillis-Steele) inclusive scan of the (decay, input) pairs.  It sums in
another order than the reference's ``associative_scan``, so its outputs
agree to f32 rounding, not bit for bit.

A decode step's batch-variant reductions (the depthwise conv's dot over
its taps, the readout ``C h``, and the norms) run on ``core.rows`` slices,
so a row gets the same bits in a batch as alone.  Caches are updated IN
PLACE, each leaf keeping its dtype (the reference's concatenation promotes
a narrower conv-state leaf to the activations' dtype; the two agree
whenever the cache is at least as wide as the activations, as the serving
pools' f32 caches are).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core import rebranch, rows
from repro_torch.models import layers, transformer
from repro_torch.models.config import ArchConfig, spec_for


def softplus(x):
    """``jax.nn.softplus``: ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def init_ssm_block(gen: torch.Generator, cfg: ArchConfig,
                   prefix: str = "blocks"):
    """One SSM block drawn from ``gen``; ``prefix`` is the site path of its
    projections (``'blocks'`` in the mamba backbone, ``'blocks.ssm'`` in
    the hybrid)."""
    dev = gen.device
    d, di, n, dtr = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.dt_rank
    a = torch.arange(1, n + 1, dtype=torch.float32,
                     device=dev)[None].repeat(di, 1)     # S4D-real
    p = {
        "in_proj": rebranch.init_linear(
            gen, d, 2 * di, spec_for(cfg, f"{prefix}.in_proj")),
        "conv": {"sram": {
            "w": torch.randn((cfg.d_conv, di), generator=gen, device=dev)
                 / math.sqrt(cfg.d_conv),
            "b": torch.zeros((di,), dtype=torch.float32, device=dev)}},
        "x_proj": rebranch.init_linear(
            gen, di, dtr + 2 * n, spec_for(cfg, f"{prefix}.x_proj")),
        "dt_proj": rebranch.init_linear(
            gen, dtr, di, spec_for(cfg, f"{prefix}.dt_proj"),
            use_bias=True),
        "A_log": {"sram": {"w": torch.log(a)}},
        "D": {"sram": {"w": torch.ones((di,), dtype=torch.float32,
                                       device=dev)}},
        "out_proj": rebranch.init_linear(
            gen, di, d, spec_for(cfg, f"{prefix}.out_proj")),
    }
    # dt bias so that softplus(dt) starts in [1e-3, 1e-1]
    lo, hi = math.log(1e-3), math.log(0.1)
    dt_init = torch.exp(torch.rand((di,), generator=gen, device=dev)
                        * (hi - lo) + lo)
    p["dt_proj"]["sram"]["b"] = dt_init + torch.log(-torch.expm1(-dt_init))
    if cfg.ssm_norm:
        p["dt_norm"] = layers.init_rmsnorm(dtr, dev)
        p["b_norm"] = layers.init_rmsnorm(n, dev)
        p["c_norm"] = layers.init_rmsnorm(n, dev)
    return p


def _scan_pairs(da, dbu):
    """Inclusive scan along dim 1 of the pairs (a, b) under
    ``(l, r) -> (a_l a_r, b_r + a_r b_l)``, in log2(len) doubling steps."""
    off, n = 1, da.shape[1]
    while off < n:
        dbu = torch.cat([dbu[:, :off],
                         dbu[:, off:] + da[:, off:] * dbu[:, :-off]], 1)
        da = torch.cat([da[:, :off], da[:, off:] * da[:, :-off]], 1)
        off *= 2
    return da, dbu


def _ssm_scan_chunked(u, dt, a, b, c, d_skip, chunk: int, h0=None):
    """Selective scan  h' = exp(dt A) h + dt B u;  y = C h + D u.

    u/dt: [B, S, di]; b/c: [B, S, N]; a: [di, N].  Chunks of ``chunk``
    positions in order, carrying h; within a chunk, :func:`_scan_pairs`.
    Returns (y [B, S, di], h_final [B, di, N]).
    """
    bsz, s, di = u.shape
    h = (torch.zeros((bsz, di, a.shape[1]), dtype=torch.float32,
                     device=u.device) if h0 is None else h0.float())
    ys = []
    for c0 in range(0, s, chunk):
        sl = slice(c0, c0 + chunk)
        da = torch.exp(dt[:, sl, :, None] * a[None, None])   # [B,ch,di,N]
        dbu = (dt[:, sl] * u[:, sl])[..., None] * b[:, sl, None, :]
        a_acc, b_acc = _scan_pairs(da, dbu)
        h_all = a_acc * h[:, None] + b_acc
        ys.append(torch.einsum("bsdn,bsn->bsd", h_all, c[:, sl]))
        h = h_all[:, -1]
    y = torch.cat(ys, 1)
    return y + u * d_skip[None, None], h


def _compute_ssm_inputs(params, x_conv, cfg: ArchConfig,
                        prefix: str = "blocks"):
    n, dtr = cfg.ssm_state, cfg.dt_rank
    xdbc = rebranch.apply_linear(params["x_proj"], x_conv,
                                 spec_for(cfg, f"{prefix}.x_proj"))
    dt_r, b, c = torch.split(xdbc, [dtr, n, n], dim=-1)
    if cfg.ssm_norm:                       # falcon-mamba
        dt_r = layers.apply_rmsnorm(params["dt_norm"], dt_r, cfg.norm_eps)
        b = layers.apply_rmsnorm(params["b_norm"], b, cfg.norm_eps)
        c = layers.apply_rmsnorm(params["c_norm"], c, cfg.norm_eps)
    dt = softplus(rebranch.apply_linear(
        params["dt_proj"], dt_r, spec_for(cfg, f"{prefix}.dt_proj")).float())
    a = -torch.exp(params["A_log"]["sram"]["w"])
    return dt, a, b.float(), c.float()


def _conv_taps(hist, w):
    """The depthwise conv's dot over its taps, hist [B, K, di] x w [K, di]
    -> [B, di], on bucketed rows."""
    return rows.rowwise(lambda h: (h.float() * w).sum(1), hist)


def _readout(h, c):
    """y = C h per row: h [B, di, N], c [B, N] -> [B, di], bucketed."""
    return rows.rowwise(lambda hh, cc: (hh * cc[:, None, :]).sum(-1), h, c)


def _recurrence(h, dt, a, b, c, u, d_skip):
    """One decode step of the scan per row: h' = exp(dt A) h + dt B u and
    y = C h' + D u, for h [B, di, N], dt and u [B, di], b and c [B, N];
    returns (h', y [B, di])."""
    da = torch.exp(dt[..., None] * a[None])              # [B, di, N]
    dbu = (dt * u.float())[..., None] * b[:, None, :]
    h_new = da * h.float() + dbu
    return h_new, _readout(h_new, c) + u.float() * d_skip


def apply_ssm_block(params, x, cfg: ArchConfig, cache=None, decode=False,
                    prefix: str = "blocks"):
    """Returns (out, cache); ``cache`` = {conv [B, K-1, di], h [B, di, N]}
    is updated in place."""
    s = x.shape[1]
    xz = rebranch.apply_linear(params["in_proj"], x,
                               spec_for(cfg, f"{prefix}.in_proj"))
    xi, z = xz.chunk(2, dim=-1)
    conv_w = params["conv"]["sram"]["w"]                 # [K, di]
    conv_b = params["conv"]["sram"]["b"]
    k = conv_w.shape[0]
    d_skip = params["D"]["sram"]["w"]

    if decode:
        if cache is None or s != 1:
            raise ValueError("an SSM decode step takes one token per row "
                             "and a cache")
        wide = torch.promote_types(cache["conv"].dtype, xi.dtype)
        hist = torch.cat([cache["conv"].to(wide), xi.to(wide)], 1)
        x_conv = _conv_taps(hist, conv_w)[:, None] + conv_b
        x_conv = F.silu(x_conv).to(x.dtype)
        dt, a, b, c = _compute_ssm_inputs(params, x_conv, cfg, prefix)
        h_new, y = _recurrence(cache["h"], dt[:, 0], a, b[:, 0], c[:, 0],
                               x_conv[:, 0], d_skip)
        y = y[:, None]
        cache["conv"].copy_(hist[:, 1:])
        cache["h"].copy_(h_new)
    else:
        if cache is not None:
            wide = torch.promote_types(cache["conv"].dtype, xi.dtype)
            xpad = torch.cat([cache["conv"].to(wide), xi.to(wide)], 1)
        else:
            xpad = F.pad(xi, (0, 0, k - 1, 0))
        x_conv = 0
        for i in range(k):                 # the reference's sum, in order
            x_conv = x_conv + xpad[:, i:i + s].float() * conv_w[i]
        x_conv = F.silu(x_conv + conv_b).to(x.dtype)
        dt, a, b, c = _compute_ssm_inputs(params, x_conv, cfg, prefix)
        y, h_last = _ssm_scan_chunked(
            x_conv.float(), dt, a, b, c, d_skip,
            chunk=min(cfg.attn_chunk, s),
            h0=None if cache is None else cache["h"])
        if cache is not None:
            cache["conv"].copy_(xpad[:, xpad.shape[1] - (k - 1):])
            cache["h"].copy_(h_last)

    y = (y * F.silu(z.float())).to(x.dtype)
    y = rebranch.apply_linear(params["out_proj"], y,
                              spec_for(cfg, f"{prefix}.out_proj"))
    return y, cache


def init_ssm_cache(cfg: ArchConfig, batch: int, dtype=torch.bfloat16,
                   device=None):
    return {
        "conv": torch.zeros((batch, cfg.d_conv - 1, cfg.d_inner),
                            dtype=dtype, device=device),
        "h": torch.zeros((batch, cfg.d_inner, cfg.ssm_state),
                         dtype=torch.float32, device=device),
    }


# ---------------------------------------------------------------------------
# full model (mamba backbone: norm -> ssm -> residual), stacked over L
# ---------------------------------------------------------------------------

def _layer_init(gen, cfg: ArchConfig):
    return {"ln": layers.init_rmsnorm(cfg.d_model, gen.device),
            "ssm": init_ssm_block(gen, cfg)}


def init(gen: torch.Generator, cfg: ArchConfig):
    """The embedding, the layers in order (stacked), ``ln_f``, the
    readout."""
    return {
        "embed": layers.init_embedding(gen, cfg.vocab_size, cfg.d_model),
        "layers": transformer.init_stacked(gen, cfg, _layer_init),
        "ln_f": layers.init_rmsnorm(cfg.d_model, gen.device),
        "lm_head": rebranch.init_linear(gen, cfg.d_model, cfg.vocab_size,
                                        spec_for(cfg, "lm_head")),
    }


def _run(params, x, cfg: ArchConfig, cache=None, decode=False):
    for i, blk in enumerate(transformer.unstack(params["layers"],
                                                cfg.num_layers)):
        lc = None if cache is None else transformer.layer(cache["layers"], i)
        h, _ = apply_ssm_block(
            blk["ssm"], layers.apply_rmsnorm(blk["ln"], x, cfg.norm_eps),
            cfg, cache=lc, decode=decode)
        x = x + h
    return x


def features(params, batch, cfg: ArchConfig):
    x = layers.apply_embedding(params["embed"], batch["tokens"], cfg)
    return _run(params, x, cfg)


def apply_head(params, x, cfg: ArchConfig):
    x = layers.apply_rmsnorm(params["ln_f"], x, cfg.norm_eps)
    return rebranch.apply_linear(params["lm_head"], x,
                                 spec_for(cfg, "lm_head"))


def forward(params, batch, cfg: ArchConfig):
    return apply_head(params, features(params, batch, cfg), cfg)


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None):
    """O(1) state per row whatever ``max_len``: [L, ...] stacked conv and
    h."""
    del max_len
    one = init_ssm_cache(cfg, batch, dtype, device)
    return {"layers": {k: v.new_zeros((cfg.num_layers, *v.shape))
                       for k, v in one.items()}}


def prefill(params, batch, cfg: ArchConfig, cache):
    x = layers.apply_embedding(params["embed"], batch["tokens"], cfg)
    x = _run(params, x, cfg, cache)
    return apply_head(params, x[:, -1:], cfg).float(), cache


def decode_step(params, tokens, cfg: ArchConfig, cache):
    x = layers.apply_embedding(params["embed"], tokens, cfg)
    x = _run(params, x, cfg, cache, decode=True)
    return apply_head(params, x, cfg).float(), cache
