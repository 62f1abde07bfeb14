"""The one generator of training traffic: a traffic file's parameters,
the configuration's vocabulary and the seed give the token batches, made
on the host before the window.

A ``token_stream`` mix is one stream of ids drawn uniformly over the
vocabulary, cut into consecutive windows of ``seq + 1`` tokens: ``tokens``
the first ``seq``, ``labels`` the last ``seq`` (shifted by one). The
program packs sequences without document masks, so where documents end
changes no work; the batch, the length and the vocabulary are what a
step's work depends on. Every seed gives the same shapes and amount of
work."""
from __future__ import annotations

import numpy as np


def batches(mix: dict, vocab_size: int, seed: int, n: int) -> list:
    """``n`` batches of ``{"tokens", "labels"}``, int32 [batch, seq]."""
    if mix["kind"] != "token_stream":
        raise ValueError(f"unknown traffic kind {mix['kind']!r}")
    B, S = mix["batch"], mix["seq"]
    rng = np.random.default_rng(int(seed))
    rows = rng.integers(0, vocab_size, size=(n, B, S + 1), dtype=np.int32)
    return [{"tokens": np.ascontiguousarray(r[:, :-1]),
             "labels": np.ascontiguousarray(r[:, 1:])} for r in rows]
