"""Deterministic synthetic LM data (port of `repro/data/pipeline.py`).

The batches are numpy, drawn from the same `default_rng` streams as the
JAX package's, so the tokens equal JAX's bit for bit:
  * deterministic as a function of (seed, step, host): after a restore at
    step k every host regenerates exactly the batch it would have seen;
  * host-sharded: each host draws only its slice of the global batch;
  * double-buffered: a background thread prefetches the next batch while
    the device computes.

Tokens mix Zipf-distributed unigrams with repeated motifs, so the stream
has learnable structure while staying fully synthetic.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator, Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class SyntheticLM:
    """Deterministic synthetic token distribution."""

    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    motif_len: int = 16
    n_motifs: int = 64
    motif_prob: float = 0.5
    n_hosts: int = 1
    host_id: int = 0

    @property
    def host_batch(self) -> int:
        if self.global_batch % self.n_hosts == 0:
            return self.global_batch // self.n_hosts
        # uneven host counts: first hosts take the remainder
        base, rem = divmod(self.global_batch, self.n_hosts)
        return base + (1 if self.host_id < rem else 0)

    def _motifs(self) -> np.ndarray:
        rng = np.random.default_rng(self.seed ^ 0xA5A5)
        return rng.integers(0, self.vocab, (self.n_motifs, self.motif_len),
                            dtype=np.int32)

    def batch(self, step: int) -> dict:
        """The batch for `step`, this host's slice: {"tokens", "labels",
        "mask"}, tokens and labels (host_batch, seq_len) int32, mask f32."""
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) * 4_096 + self.host_id)
        B, S = self.host_batch, self.seq_len
        # Zipf-ish unigram floor (bounded to the vocab)
        ranks = rng.zipf(1.3, size=(B, S + 1)).astype(np.int64)
        tokens = ((ranks - 1) % self.vocab).astype(np.int32)
        # overlay repeated motifs (skipped for sequences shorter than one)
        ml = self.motif_len
        if S + 1 > ml:
            motifs = self._motifs()
            n_spans = max(1, int((S + 1) * self.motif_prob) // ml)
            for b in range(B):
                starts = rng.integers(0, S + 1 - ml, size=n_spans)
                picks = rng.integers(0, self.n_motifs, size=n_spans)
                for s, p in zip(starts, picks):
                    tokens[b, s:s + ml] = motifs[p]
        return {
            "tokens": tokens[:, :-1],
            "labels": tokens[:, 1:].astype(np.int32),
            "mask": np.ones((B, S), np.float32),
        }


def batch_specs(vocab: int, seq_len: int, global_batch: int,
                extra: Optional[dict] = None) -> dict:
    """Meta-tensor stand-ins for a training batch (shapes and dtypes
    only, the analogue of JAX's ShapeDtypeStructs)."""
    del vocab  # the shapes do not depend on it (kept for JAX's signature)
    meta = lambda dt: torch.empty((global_batch, seq_len), dtype=dt,
                                  device="meta")
    specs = {"tokens": meta(torch.int32), "labels": meta(torch.int32),
             "mask": meta(torch.float32)}
    if extra:
        specs.update(extra)
    return specs


def make_batch_iterator(ds: SyntheticLM, start_step: int = 0,
                        prefetch: int = 2) -> Iterator[dict]:
    """Background-thread prefetching iterator (host-side double
    buffering); closing the iterator stops the thread."""
    q: queue.Queue = queue.Queue(maxsize=prefetch)
    stop = threading.Event()

    def producer():
        step = start_step
        while not stop.is_set():
            try:
                q.put(ds.batch(step), timeout=0.5)
                step += 1
            except queue.Full:
                continue

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            yield q.get()
    finally:
        stop.set()
