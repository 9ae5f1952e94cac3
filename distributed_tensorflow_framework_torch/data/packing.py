"""Sequence packing: more real tokens through the same GEMMs.

The port's copy of ``data/packing.py``. BERT-style batches are mostly
padding: short documents in fixed ``seq_len`` rows spend the tensor cores
on zero positions. ``pack_documents`` lays documents end-to-end with
per-row segment ids (the segmented attention kernels keep them
independent), and ``packing_stats`` turns the real/padded token counters
the pipeline accumulates into the goodput-per-padded-token telemetry
(``KIND_DATA_PACKING``) that makes the gain measurable.
"""

from __future__ import annotations

import numpy as np

# Iterator-state counter keys (data/text_mlm.py accumulates them; the
# Trainer reads them off its data snapshot to emit KIND_DATA_PACKING).
REAL_TOKENS_KEY = "real_tokens"
PADDED_TOKENS_KEY = "padded_tokens"


def pack_documents(tokens: np.ndarray, out_rows: int, seq_len: int
                   ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Greedy in-order first-fit packing of zero-padded token rows.

    ``tokens`` (n, s): one document per row, trailing-zero padded (token 0
    is [PAD], never interior). Documents are laid end-to-end into
    ``out_rows`` rows of ``seq_len``; per-row ``segment_ids`` number the
    documents 1..k (0 = padding) for block-diagonal attention. In-order
    packing keeps the stream deterministic (resume replays identically);
    documents that do not fit the row budget are RETURNED as the leftover
    suffix — the caller carries them into the next packed batch so
    pack_factor overflow defers data instead of discarding it.

    Returns (packed (out_rows, seq_len), segment_ids,
    leftover (m, s) — the non-empty rows that did not fit, in order).
    """
    packed = np.zeros((out_rows, seq_len), np.int32)
    segs = np.zeros((out_rows, seq_len), np.int32)
    row, col, seg = 0, 0, 0
    leftover = tokens[:0]
    for i, doc in enumerate(tokens):
        length = int(np.count_nonzero(doc))
        if length == 0:
            continue
        if col + length > seq_len:
            row += 1
            col = 0
            seg = 0
            if row >= out_rows:
                rest = tokens[i:]
                leftover = rest[np.count_nonzero(rest, axis=1) > 0]
                break
        packed[row, col:col + length] = doc[:length]
        seg += 1
        segs[row, col:col + length] = seg
        col += length
    return packed, segs, leftover


def count_tokens(tokens: np.ndarray) -> tuple[int, int]:
    """``(real, pad)`` position counts for one emitted (b, s) batch —
    token 0 is reserved padding, so nonzero == real."""
    real = int(np.count_nonzero(tokens))
    return real, int(tokens.size) - real


def accumulate_counters(state: dict, tokens: np.ndarray) -> None:
    """Fold one emitted batch's token census into the iterator state.

    The counters ride the (JSON-serializable) state so they survive
    save/restore with the stream position and every snapshot pairs a
    batch with the cumulative census up to it.
    """
    real, pad = count_tokens(tokens)
    state[REAL_TOKENS_KEY] = int(state.get(REAL_TOKENS_KEY, 0)) + real
    state[PADDED_TOKENS_KEY] = int(state.get(PADDED_TOKENS_KEY, 0)) + pad


def packing_stats(real_tokens: int, padded_tokens: int) -> dict:
    """Goodput-per-padded-token rollup for KIND_DATA_PACKING.

    ``packing_efficiency`` is the fraction of fed positions that carry a
    real token — the number sequence packing exists to raise (unpacked
    short-document batches sit far below 1.0).
    """
    total = int(real_tokens) + int(padded_tokens)
    return {
        "real_tokens": int(real_tokens),
        "padded_tokens": int(padded_tokens),
        "total_tokens": total,
        "packing_efficiency": (real_tokens / total) if total else None,
    }
