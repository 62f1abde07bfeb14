"""Deterministic, shardable, resumable data pipeline (a copy of the
reference's ``repro/data/pipeline.py``; numpy and a thread, no torch).

Sources:
  * synthetic  — seeded token streams (markov-ish mixture so small models
                 have learnable structure; loss decreases measurably)
  * file       — byte-level tokenization of a text file, chunked into
                 sequences (used by examples/train_lm.py)

Determinism contract: batch(step) is a pure function of (seed, step,
host_id) — restart/resume at any step reproduces the exact stream, and
elastic re-sharding (different host count) re-partitions the same global
stream. Prefetch is a background thread pipelining host batch assembly.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models.steps import LABEL_IGNORE


@dataclass(frozen=True)
class DataConfig:
    source: str = "synthetic"        # synthetic | file
    path: Optional[str] = None
    seed: int = 0
    num_hosts: int = 1
    host_id: int = 0
    prefetch: int = 2


class SyntheticTokens:
    """Seeded mixture of repeated n-grams + noise: predictable enough that
    a 100M model's loss visibly drops within tens of steps."""

    def __init__(self, vocab: int, seed: int):
        self.vocab = vocab
        rng = np.random.default_rng(seed)
        self.n_patterns = 64
        self.patterns = rng.integers(
            0, vocab, (self.n_patterns, 16)).astype(np.int32)

    def sequence(self, seed: int, length: int) -> np.ndarray:
        rng = np.random.default_rng(seed)
        out = np.empty(length + 1, np.int32)
        i = 0
        while i < length + 1:
            if rng.random() < 0.8:
                p = self.patterns[rng.integers(self.n_patterns)]
                n = min(len(p), length + 1 - i)
                out[i:i + n] = p[:n]
                i += n
            else:
                out[i] = rng.integers(self.vocab)
                i += 1
        return out


class FileTokens:
    """Byte-level tokenizer over a text file (vocab 256 + offset)."""

    def __init__(self, path: str, vocab: int):
        raw = Path(path).read_bytes()
        self.data = np.frombuffer(raw, np.uint8).astype(np.int32) % vocab
        self.vocab = vocab

    def sequence(self, seed: int, length: int) -> np.ndarray:
        rng = np.random.default_rng(seed)
        if len(self.data) <= length + 1:
            reps = (length + 2) // len(self.data) + 1
            data = np.tile(self.data, reps)
        else:
            data = self.data
        start = rng.integers(0, len(data) - length - 1)
        return data[start:start + length + 1].copy()


class DataPipeline:
    def __init__(self, cfg: ModelConfig, shape: ShapeConfig,
                 data_cfg: DataConfig):
        self.cfg, self.shape, self.dc = cfg, shape, data_cfg
        vocab = cfg.vocab_size
        if data_cfg.source == "file":
            assert data_cfg.path, "file source needs a path"
            self.src = FileTokens(data_cfg.path, vocab)
        else:
            self.src = SyntheticTokens(vocab, data_cfg.seed)
        assert shape.global_batch % data_cfg.num_hosts == 0
        self.host_batch = shape.global_batch // data_cfg.num_hosts
        self._queue: "queue.Queue" = queue.Queue(maxsize=data_cfg.prefetch)
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # ---- pure batch construction ----------------------------------------
    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """Pure function of (seed, step, host_id): the resume contract."""
        cfg, shape, dc = self.cfg, self.shape, self.dc
        S = shape.seq_len
        rows = []
        for b in range(self.host_batch):
            gidx = (step * shape.global_batch +
                    dc.host_id * self.host_batch + b)
            seed = (dc.seed * 1_000_003 + gidx) % (2 ** 63)
            if cfg.family == "audio":
                rows.append(self.src.sequence(seed, S // 2))
            elif cfg.family == "vlm":
                rows.append(self.src.sequence(seed, S - cfg.frontend_len))
            else:
                rows.append(self.src.sequence(seed, S))
        toks = np.stack(rows)
        batch: Dict[str, np.ndarray] = {}
        if cfg.family == "audio":
            Se = S // 2
            frng = np.random.default_rng((dc.seed, step, dc.host_id, 7))
            batch["frames"] = frng.normal(
                0, 1, (self.host_batch, Se, cfg.d_model)).astype(np.float32)
            batch["tokens"] = toks[:, :-1]
            batch["labels"] = toks[:, 1:]
        elif cfg.family == "vlm":
            Fl = cfg.frontend_len
            frng = np.random.default_rng((dc.seed, step, dc.host_id, 11))
            batch["patch_embeds"] = frng.normal(
                0, 1, (self.host_batch, Fl, cfg.d_model)).astype(np.float32)
            batch["tokens"] = toks[:, :-1]
            # labels cover the concatenated stream; patch positions masked
            lab = np.full((self.host_batch, S), LABEL_IGNORE, np.int32)
            lab[:, Fl:] = toks[:, 1:]
            batch["labels"] = lab
        else:
            batch["tokens"] = toks[:, :-1]
            batch["labels"] = toks[:, 1:]
        return batch

    # ---- prefetching iterator --------------------------------------------
    def iterate(self, start_step: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        def worker():
            step = start_step
            while not self._stop.is_set():
                try:
                    self._queue.put(self.batch_at(step), timeout=0.5)
                    step += 1
                except queue.Full:
                    continue

        self._stop.clear()
        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()
        try:
            while True:
                yield self._queue.get()
        finally:
            self._stop.set()

    def close(self):
        self._stop.set()


def make_batch_fn(cfg: ModelConfig, shape: ShapeConfig, data_cfg: DataConfig):
    pipe = DataPipeline(cfg, shape, data_cfg)
    return pipe.batch_at
