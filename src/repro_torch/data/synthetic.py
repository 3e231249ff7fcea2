"""Deterministic synthetic data (port of ``MarkovLM``,
``CheckpointableLoader``, ``batches_for`` and ``GaussianBlobs`` in
``repro/data/synthetic.py``). ``MarkovLM`` and ``GaussianBlobs`` draw numpy
as the reference does, so their batches are identical; ``batches_for``
draws a ``torch.Generator`` where the reference draws ``jax.random``, so
its batches have the reference's structure, not its values."""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np
import torch

IGNORE = -100      # the loss's ignored label (models/losses.py)


@dataclasses.dataclass
class MarkovLM:
    """Fixed-seed first-order Markov chain over the vocabulary with sparse
    transitions."""

    vocab_size: int
    seq_len: int
    batch_size: int
    branching: int = 4
    seed: int = 1234

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        self.successors = rng.integers(
            0, self.vocab_size, (self.vocab_size, self.branching))

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(hash((self.seed, step)) % 2 ** 32)
        toks = np.empty((self.batch_size, self.seq_len + 1), np.int32)
        toks[:, 0] = rng.integers(0, self.vocab_size, self.batch_size)
        choices = rng.integers(0, self.branching,
                               (self.batch_size, self.seq_len))
        for t in range(self.seq_len):
            toks[:, t + 1] = self.successors[toks[:, t], choices[:, t]]
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        """Batches 0, 1, 2, ... without end (a training loop's input)."""
        step = 0
        while True:
            yield self.batch(step)
            step += 1


@dataclasses.dataclass
class CheckpointableLoader:
    """A restartable iterator over any ``batch(step)`` source. Its cursor
    rides in the training checkpoint, so a resumed run consumes the exact
    batch the interrupted one would have consumed next: no batch repeated
    or skipped. ``batch(step)`` is a pure function of (seed, step), so a
    replayed cursor always yields the same batches."""

    source: object
    cursor: int = 0

    def __next__(self):
        b = self.source.batch(self.cursor)
        self.cursor += 1
        return b

    def __iter__(self):
        return self

    def state_dict(self) -> Dict[str, int]:
        return {"cursor": self.cursor}

    def load_state_dict(self, state: Dict[str, int]) -> None:
        self.cursor = int(state["cursor"])


def batches_for(cfg, batch_size: int, seq_len: int,
                seed: int = 0) -> Dict[str, np.ndarray]:
    """One random batch with the exact input structure of the arch (the
    reference's ``batches_for`` at ``batch_override``/``seq_override``):
    ``tokens`` and ``labels`` [B, S] for text; for ``vision_stub``,
    ``tokens`` [B, S - P] after P = ``n_prefix_embeds`` patch embeddings
    ``vision_embeds`` [B, P, D] (normal * 0.02), ``labels`` IGNORE over the
    prefix; for ``audio_stub``, frame embeddings ``embeds`` [B, S, D] and
    ``labels``. Numpy arrays, drawn on the CPU from ``seed``."""
    g = torch.Generator().manual_seed(int(seed))
    b, s, v, d = batch_size, seq_len, cfg.vocab_size, cfg.d_model

    def ints(*shape):
        return torch.randint(0, v, shape, generator=g,
                             dtype=torch.int32).numpy()

    def normal(*shape):
        return (torch.randn(shape, generator=g) * 0.02).numpy()
    if cfg.modality == "vision_stub":
        p = cfg.n_prefix_embeds
        toks, vis = ints(b, s - p), normal(b, p, d)
        labels = np.concatenate([np.full((b, p), IGNORE, np.int32),
                                 ints(b, s - p)], axis=1)
        return {"tokens": toks, "vision_embeds": vis, "labels": labels}
    if cfg.modality == "audio_stub":
        return {"embeds": normal(b, s, d), "labels": ints(b, s)}
    toks = ints(b, s)
    return {"tokens": toks, "labels": ints(b, s)}


@dataclasses.dataclass
class ArchBatches:
    """``batches_for`` as a ``batch(step)`` source (seed ``seed + step``,
    as the reference's launcher draws its non-text batches), so a
    :class:`CheckpointableLoader` can replay it."""

    cfg: object
    batch_size: int
    seq_len: int
    seed: int = 0

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        return batches_for(self.cfg, self.batch_size, self.seq_len,
                           seed=self.seed + step)


@dataclasses.dataclass
class GaussianBlobs:
    """K-class Gaussian blobs rendered as small NHWC images (the CNN
    benchmark task). ``batch`` returns numpy ``(x float32, y int32)``."""

    n_classes: int = 16
    image_size: int = 16
    channels: int = 3
    noise: float = 2.5
    seed: int = 7

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        self.centers = rng.standard_normal(
            (self.n_classes, self.image_size, self.image_size, self.channels))

    def batch(self, batch_size: int, step: int):
        rng = np.random.default_rng(hash((self.seed, step)) % 2 ** 32)
        y = rng.integers(0, self.n_classes, batch_size)
        x = self.centers[y] + rng.standard_normal(
            (batch_size, self.image_size, self.image_size,
             self.channels)) * self.noise
        return x.astype(np.float32), y.astype(np.int32)
