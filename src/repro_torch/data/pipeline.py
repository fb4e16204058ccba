"""Deterministic synthetic LM data (own copy of ``repro.data.pipeline``'s
``SyntheticDataset``, numpy only): the same seed gives the same batches as
the reference.

A learnable, Zipf-distributed token stream with short-range structure (a
token is followed by a fixed successor half the time), so training loss
measurably drops.  ``embed_inputs`` configs (audio, VLM) get (embeddings,
labels) pairs from the reference's stub frontend: a fixed table of
``min(V, 4096)`` fp32 rows of width d_model, indexed by ``token % rows``.
As in the reference, each of ``host_count`` hosts draws only its
``local_batch`` rows of the global batch (from its own seed), and
``state()`` / ``restore()`` carry the stream's position through a
checkpoint, so a resumed job sees the same batches.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.configs.base import ModelConfig, ShapeConfig


@dataclasses.dataclass
class SyntheticDataset:
    cfg: ModelConfig
    seq_len: int
    global_batch: int
    host_index: int = 0
    host_count: int = 1
    seed: int = 0
    _step: int = 0

    def __post_init__(self):
        if self.global_batch % self.host_count:
            raise ValueError(f"global batch {self.global_batch} does not split over "
                             f"{self.host_count} hosts")
        self.local_batch = self.global_batch // self.host_count
        v = self.cfg.vocab_size
        rng = np.random.default_rng(self.seed)
        # Zipf unigram table + a sticky successor table: token t is followed
        # by succ[t] w.p. 0.5, else a fresh Zipf draw
        ranks = np.arange(1, v + 1, dtype=np.float64)
        self._unigram = (1.0 / ranks) / np.sum(1.0 / ranks)
        self._succ = rng.integers(0, v, size=v, dtype=np.int64)
        # the stub modality frontend's table (stand-in for EnCodec frames /
        # ViT patches): the reference draws it anew every batch from the
        # same seed; drawn once here (at pixtral's width it is 84 MB of
        # normals), the same values
        self._frontend = None
        if self.cfg.embed_inputs:
            table_rng = np.random.default_rng(self.seed + 7)
            self._frontend = table_rng.standard_normal(
                (min(v, 4096), self.cfg.d_model)
            ).astype(np.float32) * 0.02

    def _rng_for(self, step: int) -> np.random.Generator:
        return np.random.default_rng(
            (self.seed * 1_000_003 + step) * 4096 + self.host_index
        )

    def _sample_tokens(self, rng: np.random.Generator, batch: int) -> np.ndarray:
        s = self.seq_len + 1
        fresh = rng.choice(
            self.cfg.vocab_size, size=(batch, s), p=self._unigram
        ).astype(np.int64)
        sticky = rng.random((batch, s)) < 0.5
        toks = fresh.copy()
        for t in range(1, s):
            toks[:, t] = np.where(sticky[:, t], self._succ[toks[:, t - 1]], fresh[:, t])
        return toks

    def next_batch(self) -> dict:
        """``{"inputs": [B, S] int32, "labels": [B, S] int32}`` over this
        host's ``B = local_batch`` rows, labels the inputs shifted by one;
        for an ``embed_inputs`` config the inputs are the frontend's rows,
        [B, S, d_model] fp32."""
        rng = self._rng_for(self._step)
        self._step += 1
        toks = self._sample_tokens(rng, self.local_batch)
        inputs = toks[:, :-1]
        if self._frontend is not None:
            inputs = self._frontend[inputs % self._frontend.shape[0]]
        else:
            inputs = inputs.astype(np.int32)
        return {"labels": toks[:, 1:].astype(np.int32), "inputs": inputs}

    # -- checkpointable state ------------------------------------------------
    def state(self) -> dict:
        return {"step": self._step}

    def restore(self, state: dict) -> None:
        self._step = int(state["step"])


def make_train_iterator(
    cfg: ModelConfig,
    shape: ShapeConfig,
    *,
    host_index: int = 0,
    host_count: int = 1,
    seed: int = 0,
):
    """``(dataset, endless iterator of its batches)`` at ``shape``'s
    sequence length and global batch."""
    ds = SyntheticDataset(
        cfg,
        seq_len=shape.seq_len,
        global_batch=shape.global_batch,
        host_index=host_index,
        host_count=host_count,
        seed=seed,
    )

    def it():
        while True:
            yield ds.next_batch()

    return ds, it()
