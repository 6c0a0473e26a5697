"""Token streams for language-model training (port of ``data/text.py``).

A deterministic order-1 Markov chain over the vocabulary: structure a 2-layer
GPT can learn (next-token entropy well below uniform), generated hermetically
— the LM analogue of ``mnist.synthetic_mnist``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class LMData(NamedTuple):
    x: np.ndarray        # [N, T] int32 input tokens
    y: np.ndarray        # [N, T] int32 next-token targets


def synthetic_tokens(n_seqs: int, seq_len: int, vocab: int,
                     seed: int = 0) -> LMData:
    rng = np.random.default_rng(seed)
    # peaked transition matrix: each token has ~4 likely successors
    logits = rng.normal(size=(vocab, vocab)).astype(np.float32)
    top = np.argsort(logits, axis=1)[:, -4:]
    boost = np.zeros_like(logits)
    np.put_along_axis(boost, top, 4.0, axis=1)
    p = np.exp(logits * 0.1 + boost)
    p /= p.sum(1, keepdims=True)
    logp = np.log(p)

    toks = np.empty((n_seqs, seq_len + 1), np.int64)
    toks[:, 0] = rng.integers(0, vocab, n_seqs)
    for t in range(seq_len):
        g = rng.gumbel(size=(n_seqs, vocab))
        toks[:, t + 1] = np.argmax(logp[toks[:, t]] + g, axis=1)
    toks = toks.astype(np.int32)
    return LMData(toks[:, :-1], toks[:, 1:])


def byte_corpus(path: str, seq_len: int, test_frac: float = 0.1,
                max_seqs: int | None = None) -> tuple[LMData, LMData]:
    """Byte-level LM dataset from a LOCAL file: ``(train, test)``.

    The real-data path for ``--model gpt`` — the LM analogue of the MNIST
    IDX loader (real data first, synthetic as the fallback; the corpus is
    any file already on disk, nothing is downloaded). vocab is the full
    byte range (256). The file is chopped into non-overlapping ``seq_len``
    windows with next-byte targets (``y[t] = x[t+1]``'s byte); the split is
    contiguous AND skips the boundary byte — the last train window's final
    TARGET would otherwise be the first test byte, so test text starts one
    byte later and is strictly never seen in training (input or target).
    """
    with open(path, "rb") as f:
        raw = np.frombuffer(f.read(), np.uint8)
    n = (len(raw) - 1) // seq_len
    if max_seqs is not None:
        if max_seqs < 2:
            raise ValueError(
                f"max_seqs={max_seqs} leaves nothing to split (need >= 2 "
                f"windows, one each for train and test)")
        n = min(n, max_seqs)
    n_test = max(1, int(n * test_frac))
    n_train = n - n_test
    off = n_train * seq_len + 1        # +1: skip the leaked boundary byte
    # the skip can cost the last window a byte; recompute what still fits,
    # but never grow past the test_frac/max_seqs-derived count
    n_test = (min((len(raw) - off - 1) // seq_len, n_test)
              if n_train >= 1 else 0)
    if n_train < 1 or n_test < 1:
        raise ValueError(
            f"corpus {path!r} has {len(raw)} bytes — needs at least "
            f"2*seq_len+2 = {2 * seq_len + 2} for a held-out test split")
    tr_x = raw[:n_train * seq_len].reshape(n_train, seq_len)
    tr_y = raw[1:n_train * seq_len + 1].reshape(n_train, seq_len)
    te_x = raw[off:off + n_test * seq_len].reshape(n_test, seq_len)
    te_y = raw[off + 1:off + n_test * seq_len + 1].reshape(n_test, seq_len)
    return (LMData(tr_x.astype(np.int32), tr_y.astype(np.int32)),
            LMData(te_x.astype(np.int32), te_y.astype(np.int32)))
