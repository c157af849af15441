"""Deterministic, shardable, resumable synthetic data (port of
``repro.data.synthetic``).

Every batch is a pure function of (seed, step, shard): the pipeline has no
mutable state, so any host can produce any shard of any step and a resume
needs only the step.  The arrays are made with numpy exactly as the JAX
package makes them (equal for equal arguments) and handed back as tensors
on ``device`` (default: the CUDA card).

The LM stream is a fixed random Markov chain over the vocabulary, so
cross-entropy has a real floor (:func:`entropy_floor`); the image stream
is a class-conditional texture set that is deliberately hard.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import device as device_lib


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    vocab_size: int = 128
    seq_len: int = 64
    global_batch: int = 8
    num_codebooks: int = 0         # musicgen-style multi-stream tokens
    branch_factor: int = 8         # Markov out-degree (structure strength)


def _transition_table(cfg: DataConfig) -> np.ndarray:
    """[V, branch] successor table: the 'language' all batches share."""
    rng = np.random.default_rng(cfg.seed + 1000)
    return rng.integers(0, cfg.vocab_size,
                        size=(cfg.vocab_size, cfg.branch_factor))


def markov_batch(cfg: DataConfig, step: int, shard: int = 0,
                 num_shards: int = 1, *, device=None) -> dict:
    """``{"tokens", "labels"}`` int32 for ``step``, restricted to this
    shard of the batch, on ``device``."""
    if cfg.global_batch % num_shards:
        raise ValueError(f"global_batch {cfg.global_batch} does not split "
                         f"into {num_shards} shards")
    per = cfg.global_batch // num_shards
    table = _transition_table(cfg)
    rng = np.random.default_rng(
        (cfg.seed * 1_000_003 + step) * 65_537 + shard)
    q = cfg.num_codebooks if cfg.num_codebooks else 1
    toks = np.empty((per, cfg.seq_len + 1, q), np.int32)
    toks[:, 0] = rng.integers(0, cfg.vocab_size, size=(per, q))
    choices = rng.integers(0, cfg.branch_factor,
                           size=(per, cfg.seq_len, q))
    for t in range(cfg.seq_len):
        toks[:, t + 1] = np.take_along_axis(
            table[toks[:, t]], choices[:, t][..., None], axis=-1)[..., 0]
    if not cfg.num_codebooks:
        toks = toks[..., 0]
    dev = device_lib.resolve(device)
    return {"tokens": torch.from_numpy(toks[:, :-1].copy()).to(dev),
            "labels": torch.from_numpy(toks[:, 1:].copy()).to(dev)}


def entropy_floor(cfg: DataConfig) -> float:
    """The exact CE floor of the Markov language (nats/token)."""
    # successors drawn uniformly from `branch` entries (with collisions)
    table = _transition_table(cfg)
    ent = 0.0
    for v in range(cfg.vocab_size):
        _, counts = np.unique(table[v], return_counts=True)
        p = counts / counts.sum()
        ent += -(p * np.log(p)).sum()
    return float(ent / cfg.vocab_size)


def _image_arrays(seed: int, step: int, batch: int, size: int,
                 num_classes: int, shard: int = 0,
                 num_shards: int = 1) -> tuple[np.ndarray, np.ndarray]:
    """f32 NHWC images and int32 labels of :func:`image_batch`, in numpy."""
    if batch % num_shards:
        raise ValueError(f"batch {batch} does not split into {num_shards} "
                         f"shards")
    per = batch // num_shards
    rng = np.random.default_rng((seed * 7_919 + step) * 257 + shard)
    labels = rng.integers(0, num_classes, size=(per,))
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    imgs = np.empty((per, size, size, 3), np.float32)
    for i, c in enumerate(labels):
        crng = np.random.default_rng(seed * 31 + int(c))   # class style
        # overlapping frequency pool: classes differ in the *pairing* of
        # x/y components per channel, not in which frequencies exist
        f1 = 2 + (crng.integers(0, 5, size=3))             # in {2..6}
        f2 = 2 + (crng.integers(0, 5, size=3))
        sgn = crng.choice([-1.0, 1.0], size=3)
        shift = rng.uniform(0, 1, size=2)                  # per-IMAGE jitter
        contrast = rng.uniform(0.8, 1.2)
        chans = []
        for ch in range(3):
            g1 = np.sin(2 * np.pi * f1[ch] * (xx + shift[0]))
            g2 = np.sin(2 * np.pi * f2[ch] * (yy + shift[1]))
            chans.append(g1 * g2 * sgn[ch])                # 2nd-order cue
        base = contrast * np.stack(chans, axis=-1)
        imgs[i] = base + 0.6 * rng.standard_normal((size, size, 3))
    return imgs, labels.astype(np.int32)


def image_batch(seed: int, step: int, batch: int, size: int,
                num_classes: int, shard: int = 0, num_shards: int = 1, *,
                device=None):
    """Synthetic class-conditional texture 'dataset', deliberately HARD:
    classes are second-order combinations of overlapping frequency pairs
    with per-image random phase/contrast/shift and strong noise, so a
    linear probe on generic features underperforms and fine-tuning (full
    or branch) has headroom.  ``(images f32 [B, size, size, 3], labels
    int32 [B])`` on ``device``."""
    imgs, labels = _image_arrays(seed, step, batch, size, num_classes,
                                shard, num_shards)
    dev = device_lib.resolve(device)
    return torch.from_numpy(imgs).to(dev), torch.from_numpy(labels).to(dev)
