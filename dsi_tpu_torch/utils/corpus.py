"""Deterministic synthetic corpus generator (copy of
``dsi_tpu/utils/corpus.py``: the same seed gives the same bytes).

The reference's inputs are Project Gutenberg texts ``pg-*.txt`` which are NOT
in its repo (gitignored, reference .gitignore:36; referenced by
test-mr.sh:30,36).  SURVEY.md §7 step 1 requires this rebuild to generate its
own corpus.  This produces Gutenberg-like ASCII text — Zipf-distributed words,
punctuation, line breaks — deterministically from a seed, vectorized with
numpy so multi-hundred-MB corpora generate in seconds.

ASCII-only by construction, so the byte-level letter classification used by
the TPU kernels agrees exactly with Unicode ``IsLetter`` semantics on this
corpus (SURVEY.md §7 hard part 1).
"""

from __future__ import annotations

import os
from typing import List

import numpy as np

from dsi_tpu_torch.utils.atomicio import atomic_write

_PUNCT = np.frombuffer(b".,;:!?", dtype=np.uint8)


def _make_vocab(rng: np.random.Generator, size: int) -> List[bytes]:
    """Random lowercase words, length ~ 2..12, plus some Capitalized forms."""
    lengths = rng.integers(2, 13, size=size)
    letters = rng.integers(ord("a"), ord("z") + 1, size=int(lengths.sum()),
                           dtype=np.uint8)
    out: List[bytes] = []
    pos = 0
    for L in lengths:
        w = letters[pos:pos + L].tobytes()
        pos += L
        out.append(w)
    # Capitalize ~10% to widen the key space like real prose.
    for i in range(0, size, 10):
        out[i] = out[i][:1].upper() + out[i][1:]
    return out


def generate_file(path: str, size_bytes: int, seed: int,
                  vocab_size: int = 20000) -> None:
    rng = np.random.default_rng(seed)
    vocab = _make_vocab(rng, vocab_size)
    # Zipf-ish rank weights: p(r) ~ 1/(r+2.7)
    ranks = np.arange(vocab_size, dtype=np.float64)
    probs = 1.0 / (ranks + 2.7)
    probs /= probs.sum()
    avg_word = sum(len(w) for w in vocab[:2000]) / 2000 + 1.0
    n_words = int(size_bytes / avg_word) + 16

    idx = rng.choice(vocab_size, size=n_words, p=probs)
    # Separators: mostly space, some punctuation+space, some newlines.
    sep_kind = rng.random(n_words)
    pieces: List[bytes] = []
    vocab_arr = vocab  # local ref
    for k, i in enumerate(idx):
        pieces.append(vocab_arr[i])
        s = sep_kind[k]
        if s < 0.80:
            pieces.append(b" ")
        elif s < 0.92:
            pieces.append(bytes([_PUNCT[int(s * 1000) % len(_PUNCT)]]) + b" ")
        else:
            pieces.append(b"\n")
    blob = b"".join(pieces)[:size_bytes]
    # Atomic commit (temp + rename, utils/atomicio): a generator killed
    # mid-write must not leave a torn pg-*.txt that happens to pass
    # ensure_corpus's size check on a later retry, and two processes
    # generating the same corpus dir concurrently (bench + soak) must
    # never interleave writes into one file.  Durability (fsync) is
    # deliberately not needed — the corpus is deterministic from its
    # seed and regenerates.
    with atomic_write(path, "wb") as f:
        f.write(blob)


def ensure_corpus(directory: str, n_files: int = 8,
                  file_size: int = 2 << 20, seed: int = 1234) -> List[str]:
    """Create pg-like input files if absent; return sorted paths."""
    os.makedirs(directory, exist_ok=True)
    paths = []
    for i in range(n_files):
        p = os.path.join(directory, f"pg-{i:02d}.txt")
        if not (os.path.exists(p) and os.path.getsize(p) == file_size):
            generate_file(p, file_size, seed + i)
        paths.append(p)
    return paths


def plan_corpus(path: str, mb: float = 8.0) -> str:
    """The plan row's corpus (``bench.py run_plan_row``): lines of at least
    ``mb`` MB in all, every third carrying ``dsi`` twice among a small
    vocabulary, the rest fillers that match nothing; returns ``path``."""
    target = mb * 1e6
    lines = []
    written = i = 0
    while written < target:
        if i % 3 == 0:
            line = (f"dsi chain w{i % 211:03d} step keeps bytes on "
                    f"device w{i % 97:02d} dsi\n")
        else:
            line = f"filler row{i} nothing matches here at all\n"
        lines.append(line)
        written += len(line)
        i += 1
    with atomic_write(path, "wb") as f:
        f.write("".join(lines).encode("ascii"))
    return path
