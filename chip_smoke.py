#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``dsi_tpu_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failure exits non-zero before the last line is printed):

1. device: require CUDA, print the card's name and power limit, build the
   kernels from ``dsi_tpu_torch/csrc`` (``kernels/build.py``);
2. kernels against their plain PyTorch versions, on the card, on the same
   device tensors: the slice shape (the bench corpus), 8-word keys at
   max_word_len 64 with ties, an empty buffer, non-ASCII bytes, a token
   longer than 64, n_tokens > t_cap at frac 4 and n_unique > u_cap; exact
   equality required; kernel B also in its own cases through both of its
   paths (a digit constant in every row, one row, a tile's edges, all
   rows equal, real rows equal to the pad value, 1-8 key words, the
   prefix sort, t at the switch between the paths); kernels A and C also
   on the shared edge cases (``dsi_tpu_torch/utils/kernel_cases.py``, the
   CPU tests' cases) at their own tile sizes: words and runs on the first,
   last and halo bytes and rows of a tile, t_cap and u_cap at and one
   below their counts, counts above 2^32; each kernel timed with CUDA
   events beside its plain version, its bound and (for the sort) a
   library yardstick, A also at the stream step's shape (2 MiB), A, B, C
   and F also with their launches a call and their device time from
   ``torch.profiler`` (A and C fail above 2 kernels a call), and B's
   skipped passes; kernel D on ``kernel_cases.fnv_cases`` in both its
   layouts (u64 words, u32 lanes, the lanes also 4 bytes off a 16-byte
   boundary), with and without its partition epilogue;
3. the slice at full size: the bench corpus (8 files x (2 MiB - 64),
   seed 1234) through ``corpus_wordcount`` + ``write_corpus_output`` with
   ``sort mr-out-*`` byte-equal to the sequential oracle; the same corpus
   with a 40-letter word appended (forces the max_word_len 64 rung); and
   ``count_words_host_result`` on one file against the oracle's counts;
4. kernel E (the shuffle) against its plain version at the stream shape
   and at 8 virtual shards, with all rows bound for one shard and with no
   valid row, and on ``kernel_cases.route_cases`` at its own tiles
   (``dsi_route_tile_rows``), each case also from rows and dests 4 bytes
   off a 16-byte boundary; E and D (``map_prologue``'s hash with its
   epilogue) at the stream step with their launches a call and device
   time (E fails above a memset and 2 kernels a call, D above 1
   launch); kernels B and C at the reduce shape;
5. the streaming SPMD word count: ``wordcount_sharded`` over the bench
   corpus at 1 and 8 virtual shards to ``mr-out-*`` parity, then the
   bench's stream row at full width (the corpus cycled to 64 MB, 2 MiB
   chunks, u_cap 2^15, 10 partitions, depth 2, sync every 8, one shard)
   through ``wordcount_streaming`` with the device table off and on (the
   call alone timed, so the two modes share one window), then through
   the ``wcstream`` CLI in-process with the table on, each holding every
   count to the oracle's times the cycles; kernels B and C held against
   their plain versions at the reduce and fold shapes of that stream;
6. the hash grouper (kernel F) against its plain version at the corpus
   shape with ``extra``, the split shape without, max_word_len 64, no
   token, a forced dirty bucket and a dirty overflow, and with the hashes
   forced (two words in one bucket, every bucket clean, two words that
   differ only in their last key word); the 6-bit decode
   (kernel G) on the bench corpus, a random 64-symbol buffer and one
   repeated byte; D (as ``route_dest`` launches it), E, B and C at the
   mesh-sharded fold's shapes; the CUDA launches a call of
   ``map_prologue``, ``route_dest`` and ``mesh_fold_step`` before D took
   the partition rule into its epilogue and after (``route_dest`` fails
   above one launch);
7. the word count in every configuration the JAX package offers, each to
   parity with the oracle: ``corpus_wordcount`` with the hash grouper,
   with the 6-bit transport under both groupers, the per-split path and
   ``wordcount_sharded`` (8 shards) under ``DSI_WC_GROUPER=hash``, the
   stream row with the table on and the hash grouper, and the stream row
   at 8 virtual shards with the mesh-sharded table (``mesh_shards`` 8),
   equal to the oracle's counts times the cycles and to the same stream
   without ``mesh_shards``, once at the table's own capacity and once
   under a ``DSI_DEVICE_TABLE_CAP`` that forces per-shard widens; the
   corpus and the stream (table on) with the sort and the hash grouper in
   turns, to show the gap beside its spread;
8. grep: kernels H (literal and class, ``csrc/grep.cu``), I (the NFA,
   ``csrc/nfa.cu``, in each state bucket, with its CUDA launches a call
   (at most 6: its own two and H's epilogue's four) and its device time
   by phase from ``torch.profiler``, and on the shared edge cases
   ``kernel_cases.nfa_cases`` at its own group, ``dsi_nfa_group_bytes``,
   one also from a chunk 5 bytes off a 16-byte boundary) and J (the grep step,
   ``csrc/grep_step.cu``, at 1 and 8 virtual shards, with its CUDA
   launches a call and device time from ``torch.profiler``: at most 3
   launches) against their plain versions at the main path's shapes, and
   B at the top-k snapshot's; J with and without its emit epilogue on the
   shared edge cases (``kernel_cases.grep_cases``) at its own tiles
   (``dsi_grep_step_tile_bytes``, ``dsi_grep_step_line_tile``), at 8
   shards, each row alone and from rows off a 16-byte boundary;
   ``cuda_map`` on ``pg-00.txt`` (n = 2^21) for ``the``, ``[Tt]he``,
   ``^a``, ``s$``, ``the|and`` and ``th[a-z]*e`` (tier 4 pinned to the
   kernel) against the host ``Map``, and a short-line input that
   overflows rung 0 and clears at n+1; the bench's grep row (the corpus
   once, 16,776,704 bytes, pattern ``the``, 2 MiB chunks, one shard)
   through ``grep_streaming`` with ``device_accumulate`` off and on
   against ``grep_host_oracle`` (MB/s beside the oracle's), at 8 virtual
   shards with the services mesh-sharded 8 ways against the same stream
   unsharded, and through the ``grepstream`` CLI with ``--check``; and
   the tier-4 calibration (host ``re`` against kernel I), a line a bucket;
9. TF-IDF: kernels L (the stable valid-first compaction,
   ``csrc/compact.cu``) and M (the postings append,
   ``csrc/postings_append.cu``) against their plain versions at the wave's
   shapes (one shard, eight shards, the 64-byte window, lane-0 pad rows;
   an append that fits, the bench's second-wave overflow, a dirty buffer,
   eight shards), L at its two small shapes in three rounds beside its
   library pair; the bench's TF-IDF row (the corpus once, eight 2 MiB
   documents, u_cap 2^15, packed) through ``tfidf_sharded`` at one
   virtual shard with the postings buffer off (``tfidf``) and on
   (``tfidf_acc``, which must overflow and recover), and at eight
   (``tfidf_n8``, one wave), each writing ``mr-out-*`` byte-equal to the
   sequential TF-IDF oracle's and holding the token invariant (the sum of
   tf equals the oracle's token count); D and E at ``tfidf_n8``'s wave;
10. the streaming indexer and the mesh-sharded postings append: D, E, L
   and M against their plain versions at the mesh append's shapes (one
   wave of the eight documents at eight shards, re-routed by D: E into
   [8, 2,097,152, 8], L with ``pad_lanes`` 1, M into an empty buffer);
   the TF-IDF row's shapes through ``indexer_streaming`` (depth 2) at one
   virtual shard with the services off (``indexer``) and on
   (``indexer_acc``, which must overflow), at eight (``indexer_n8``, one
   wave) and at eight with ``mesh_shards`` 8 (``indexer_mesh``), each
   writing ``mr-out-*`` byte-equal to the sequential indexer oracle's
   with the df top-k equal to the one the oracle's postings give; and
   the TF-IDF row at eight shards with ``mesh_shards`` 8
   (``tfidf_mesh``).  Each mesh path must equal its unsharded eight-shard
   path (posting order included) and launch D, E and L again for every
   append;
11. the compressed chunk upload: kernel N (``csrc/wire_decode.cu``)
   against ``decode_chunk_plain`` and the encoder's input at [1, 2 MiB]
   and [8, 2 MiB]: the bench stream's first batch (the 7-bit mode), the
   low-entropy text of ``tests/test_wire_ingest.py`` (the first nibble
   rung), text at the second rung, and a packed tensor whose escapes
   exceed its literal region (the clamp); ``pack_rows``/``unpack_rows``
   over one step's pulled table; the bench's wire A/B row (the corpus
   cycled to 16 MB, 2 MiB chunks, u_cap 2^15, depth 2) raw and with
   ``wire_upload`` at one shard with the table off (``wire_stream``) and
   on (``wire_stream_acc``), at 8 with ``mesh_shards`` 8
   (``wire_stream_mesh``), over 16 MB of the low-entropy text
   (``wire_stream_nib``, which must run the nibble mode) and through
   ``wcstream --wire-upload`` (``wire_cli``), each wire run equal to the
   oracle's counts and to its raw run, with N launched at least once a
   wire step;
12. the crash model checker: kernel O (``csrc/crash_sim.cu``) against
   the plain version, every output of every instance, on the shared cases
   (``kernel_cases.crash_cases``: logs past one mask word with timeout 1,
   no worker with a horizon of 1, one worker that always exits, a run
   from instance 37, the deadlines spilled to device memory with two
   workers that always stall), on a run whose whole state spills, on
   calls that alternate the shared bytes each of O's two instances asks
   for (``CRASH_ALTERNATION``), at 1,000 instances in the CLI's
   configuration and the reference tests' two others and at 2^16 in the
   CLI's; a fleet of 2^20, equal to the plain version too, whose first
   2^16 instances must equal the 2^16 run; each timed shape with its
   CUDA launches a call (at most a memset and one kernel), device time
   and scratch bytes; ``run_crash_model_check`` in the three
   configurations (``crashcheck``: every invariant holds, requeues under
   the CLI's faults, duplicates and reference-counter breaks under
   stalls) and ``crashcheck -n 1000`` in process (``crashcheck_cli``,
   exit 0);
13. the plan layer: J with its emit epilogue (K16e, ``grep_emit``)
   against ``grep_step_plain(emit=True)``, every output, at [1, 2 MiB] and
   [8, 2 MiB] for ``the`` and ``dsi``, on the optimistic ``l_cap`` rung and
   on short lines that overflow it, timed with and without emit through
   the wrapper and on the card (at most 4 CUDA launches a call with emit);
   P (``csrc/relay_pack.cu``) against
   ``relay_pack_plain`` at [1, 1 MiB] and [8, 1 MiB] with the offsets 0,
   mid-row and ``cap - kept``; a ``DeviceRelay`` fed 64 appends against
   the host concatenation; then ``run_plan`` on the bench's plan row
   (``bench.py:1884``: 8 MB of its corpus, ``grep-wc``, ``dsi``, 1 MiB
   chunks) chained, staged and pipelined at one shard and chained at 8
   with ``device_accumulate`` and ``mesh_shards`` 8, with ``stage_shards``
   4, the pg corpus cycled to 64 MB (``the``, 2 MiB chunks) chained and
   staged, and with ``th`` (which seals many buffers) chained, staged and
   under a spill budget, the grep→grep cascade (``the``, then
   ``and``) and word count → top-k over it, the indexer chain over the 8
   files as 8 documents (u_cap 2^15) with the services off and on, and
   ``planrun --chain grep-wc --check`` in process; each equal to its
   staged twin and to ``grep_host_oracle``, the sequential word count of
   the matching lines (``mr-out-*`` byte-equal for ``planrun``) or the
   sequential indexer's df top-k and postings, with
   ``plan_intermediate_bytes`` 0 in every chained run without a spill.
Launch counts are zeroed just before each path and read just after; each
path fails if a kernel of its own set never launched.

The second-to-last lines are the ``kernels`` JSON line and the card's
``name, power.limit``; the last line is ``{"ok": true, "device": ...}``.
Imports nothing of JAX or of the ``dsi_tpu`` package.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

REPO = os.path.dirname(os.path.abspath(__file__))
DEVICE = "cuda"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, NVIDIA data sheet
N_FILES, FILE_SIZE, SEED, N_REDUCE = 8, (2 << 20) - 64, 1234, 10
CORPUS_U_CAP, SPLIT_U_CAP, MWL = 1 << 18, 1 << 17, 16
# The stream row of bench.py (:158-159, :612-613) and the one-shot step.
STREAM_MB, STREAM_CHUNK, STREAM_U_CAP, SHARDED_U_CAP = 64.0, 1 << 21, \
    1 << 15, 1 << 15
KERNELS = {
    # name: (source, TPU-side program it replaces)
    "tokenize": ("dsi_tpu_torch/csrc/tokenize.cu",
                 "dsi_tpu/ops/wordcount.py:350"),
    "radix_sort": ("dsi_tpu_torch/csrc/radix_sort.cu",
                   "dsi_tpu/ops/wordcount.py:401"),
    "group": ("dsi_tpu_torch/csrc/group.cu",
              "dsi_tpu/ops/wordcount.py:161"),
    "fnv": ("dsi_tpu_torch/csrc/fnv.cu", "dsi_tpu/ops/wordcount.py:104"),
    "route": ("dsi_tpu_torch/csrc/route.cu",
              "dsi_tpu/parallel/shuffle.py:68"),
    "hash_group": ("dsi_tpu_torch/csrc/hash_group.cu",
                   "dsi_tpu/ops/wordcount.py:199"),
    "pack6": ("dsi_tpu_torch/csrc/pack6.cu", "dsi_tpu/ops/corpus_wc.py:90"),
    # H also replaces K14, dsi_tpu/ops/regexk.py:198 (its class shape).
    "grep": ("dsi_tpu_torch/csrc/grep.cu", "dsi_tpu/ops/grepk.py:116"),
    "nfa": ("dsi_tpu_torch/csrc/nfa.cu", "dsi_tpu/ops/nfak.py:303"),
    "grep_step": ("dsi_tpu_torch/csrc/grep_step.cu",
                  "dsi_tpu/parallel/grepstream.py:243"),
    # L also replaces compact_received, dsi_tpu/ops/meshroute.py:83.
    "compact": ("dsi_tpu_torch/csrc/compact.cu",
                "dsi_tpu/parallel/tfidf.py:124"),
    "postings_append": ("dsi_tpu_torch/csrc/postings_append.cu",
                        "dsi_tpu/device/postings.py:57"),
    # N also replaces _decode7_impl, dsi_tpu/ops/wirecodec.py:417.
    "wire_decode": ("dsi_tpu_torch/csrc/wire_decode.cu",
                    "dsi_tpu/ops/wirecodec.py:397"),
    # O also replaces simulate_job (:179) and its vmap (:223).
    "crash_sim": ("dsi_tpu_torch/csrc/crash_sim.cu",
                  "dsi_tpu/parallel/simulate.py:76"),
    # J's emit epilogue: _grep_step_device(emit=True), :243, its :324-339.
    "grep_emit": ("dsi_tpu_torch/csrc/grep_step.cu",
                  "dsi_tpu/parallel/grepstream.py:324"),
    "relay_pack": ("dsi_tpu_torch/csrc/relay_pack.cu",
                   "dsi_tpu/device/relay.py:58"),
}
# The kernels each path must launch.
WC = ("tokenize", "radix_sort", "group", "fnv", "route")  # A-E
HASH = ("tokenize", "radix_sort", "group", "fnv", "hash_group")
GREP_PLAN = ("grep_step", "grep_emit", "relay_pack")
PATH_KERNELS = {
    "corpus": ("tokenize", "radix_sort", "group"),
    "split": ("tokenize", "radix_sort", "group", "fnv"),
    "sharded": WC, "sharded_n8": WC,
    "stream": WC, "stream_acc": WC, "stream_cli": WC,
    # Crash-resume: the crashed run and its resume, the table on.
    "stream_ckpt": WC, "stream_ckpt_async": WC, "stream_ckpt_cli": WC,
    "corpus_hash": HASH,
    "corpus_pack6": ("tokenize", "radix_sort", "group", "pack6"),
    "corpus_pack6_hash": HASH + ("pack6",),
    "split_hash": HASH,
    "sharded_hash": HASH + ("route",),
    "stream_hash": WC + ("hash_group",),
    "stream_mesh_base": WC, "stream_mesh": WC, "stream_mesh_widen": WC,
    "grep_tiers": ("grep", "nfa"),
    "grep_stream": ("grep_step",),
    # The candidate folds run B and C; the snapshot sync runs B.
    "grep_stream_acc": ("grep_step", "radix_sort", "group"),
    "grep_stream_mesh_base": ("grep_step", "radix_sort", "group"),
    # The mesh fold routes with D and exchanges with E.
    "grep_stream_mesh": ("grep_step", "radix_sort", "group", "fnv",
                         "route"),
    "grep_cli": ("grep_step", "radix_sort", "group"),
    # Crash-resume: the crashed run and its resume, the services on.
    "grep_ckpt": ("grep_step", "radix_sort", "group"),
    "grep_ckpt_cli": ("grep_step", "radix_sort", "group"),
    # The TF-IDF wave: A-E, then L; with the device postings buffer, M.
    "tfidf": WC + ("compact",), "tfidf_n8": WC + ("compact",),
    "tfidf_acc": WC + ("compact", "postings_append"),
    # The indexer wave is the TF-IDF wave; the df top-k folds run B and C.
    # The mesh append re-routes with D and E and appends with M's received
    # entry (compact_received fused in); L runs in the wave step.
    "indexer": WC + ("compact",), "indexer_n8": WC + ("compact",),
    "indexer_acc": WC + ("compact", "postings_append"),
    "indexer_ckpt": WC + ("compact", "postings_append"),
    "tfidf_ckpt": WC + ("compact", "postings_append"),
    "indexer_mesh": WC + ("compact", "postings_append"),
    "tfidf_mesh": WC + ("compact", "postings_append"),
    # The wire streams decode every packed batch with N before the step.
    "wire_stream": WC + ("wire_decode",),
    "wire_stream_acc": WC + ("wire_decode",),
    "wire_stream_mesh": WC + ("wire_decode",),
    "wire_stream_nib": WC + ("wire_decode",),
    "wire_cli": WC + ("wire_decode",),
    "crashcheck": ("crash_sim",), "crashcheck_cli": ("crash_sim",),
    # The plan layer: J with its emit epilogue feeds the relay, P packs
    # each step after the open buffer's fill point, and the word-count
    # stage runs A-E over the relay's buffers.  The staged runs pull every
    # step instead (no P); at 8 shards the 8 MB row is one step (no pack,
    # the services' folds run B and C).
    "plan_chained": WC + GREP_PLAN, "plan_pipelined": WC + GREP_PLAN,
    "plan_staged": WC + ("grep_step", "grep_emit"),
    "plan_n8": WC + ("grep_step", "grep_emit"),
    "plan_stage_shards": WC + GREP_PLAN, "plan_pg": WC + GREP_PLAN,
    "plan_pg_th": WC + GREP_PLAN, "plan_pg_th_spill": WC + GREP_PLAN,
    "plan_cascade": GREP_PLAN,
    "plan_wc_topk": WC,
    "plan_indexer": WC + ("compact",),
    "plan_indexer_acc": WC + ("compact", "postings_append"),
    "plan_cli": WC + GREP_PLAN,
}
MESH_SHARDS = 8
# A table capacity far below a mesh shard's share of the corpus's
# 131,215 words: every shard widens at least once.
MESH_WIDEN_CAP = 4096
# Grep: the per-split tiers on one bench file (tier 4 pinned to the
# kernel), the bench's grep row (bench.py:1037-1101) and the tier-4
# calibration's state buckets.
GREP_PATTERNS = ("the", "[Tt]he", "^a", "s$", "the|and", "th[a-z]*e")
GREP_MB, GREP_PATTERN, GREP_CHUNK = 16.0, "the", 1 << 21
NFA_PATTERNS = {16: "th[a-z]*e", 32: "a{5,20}b", 48: "a{20,40}b"}
# TF-IDF: the bench's engine row (bench.py:949-1000): the corpus once
# (16 MB asked, one cycle), eight 2 MiB documents, u_cap 2^15, packed.
TFIDF_MB, TFIDF_U_CAP = 16.0, 1 << 15
# The wire A/B row (bench.py:1125-1250): the corpus cycled to 16 MB at the
# stream row's shapes.
WIRE_MB = 16.0
# H100 SXM float32 outside the tensor cores, NVIDIA data sheet.
SCALAR_OPS_PER_S = 67e12
# Hopper's INT32 lanes are half its FP32 lanes, and an FP32 FMA counts two
# operations in the 67 TFLOP/s: 67e12 / 2 / 2 integer operations a second
# (132 SMs x 64 INT32 lanes x 1.98 GHz), the one rate for the integer work
# of kernels I (bit sets) and O (threefry and the state machine).
INT32_OPS_PER_S = SCALAR_OPS_PER_S / 4
# Kernel I's CUDA launches a call: its own two (nfa_prep, nfa_scan, which
# also zeroes the epilogue's look-back state) and kernel H's one-pass line
# flags over the mask (mask_lines).
NFA_MOST_LAUNCHES = 3
# Kernel H a call: a memset of its look-back state and one kernel, one
# allocation, no Memcpy.
H_MOST_LAUNCHES, H_MOST_ALLOCS = 2, 1


def log(obj) -> None:
    print(json.dumps(obj) if not isinstance(obj, str) else obj, flush=True)


def sync() -> None:
    import torch

    torch.cuda.synchronize()


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()


# ── phase 2: every kernel against its plain version ──────────────────────


def _text_chunk(parts, size=None):
    import numpy as np

    data = b"".join(parts)
    n = size or max(256, 1 << len(data).bit_length())
    buf = np.zeros(n, np.uint8)
    buf[:len(data)] = np.frombuffer(data, np.uint8)
    return buf


def kernel_cases(corpus_buf):
    """(name, chunk, max_word_len, t_cap_frac, u_cap) per case."""
    import numpy as np

    rng = np.random.default_rng(SEED)
    letters = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz"
                            b"ABCDEFGHIJKLMNOPQRSTUVWXYZ", np.uint8)

    def word(lo, hi):
        return letters[rng.integers(0, len(letters),
                                    int(rng.integers(lo, hi)))].tobytes()

    vocab = [word(1, 80) for _ in range(400)]
    # Ties at max_word_len 64: words that share their first 64 letters and
    # differ after, so equal keys carry different payloads (stability).
    stem = word(64, 65)
    vocab += [stem + word(1, 9) for _ in range(20)]
    picks = rng.integers(0, len(vocab), 20000)
    seps = [b" ", b", ", b"\n", b"123 "]
    wide = [vocab[i] + seps[i % 4] for i in picks]
    return [
        ("bench_corpus", corpus_buf, MWL, 4, CORPUS_U_CAP),
        ("mwl64_ties", _text_chunk(wide), 64, 4, 1 << 12),
        ("empty", _text_chunk([]), MWL, 4, 16),
        ("non_ascii", _text_chunk([b"caf", "é".encode(), b" na",
                                   "ï".encode(), b"ve word"] * 50),
         MWL, 4, 64),
        ("long_token", _text_chunk([b"short ", b"q" * 100, b" tail"]),
         64, 4, 16),
        ("token_overflow", _text_chunk([b"a b c "] * 2000), MWL, 4, 64),
        ("unique_overflow", _text_chunk(wide[:3000]), MWL, 2, 100),
    ]


def _diff(a, b) -> int:
    """Max |a - b| over two integer tensors; -1 when shapes or types differ."""
    import torch

    if a is None and b is None:
        return 0
    if a.shape != b.shape or a.dtype != b.dtype:
        return -1
    if a.numel() == 0:
        return 0
    d = (a.to(torch.int64) - b.to(torch.int64)).abs().max()
    return int(d)


def _merge_err(a: int, b: int) -> int:
    """Worse of two max_abs_err values; -1 (a mismatch) wins."""
    return -1 if a < 0 or b < 0 else max(a, b)


def _worst(pairs) -> int:
    """max_abs_err over (kernel output, plain output) pairs."""
    err = 0
    for got, want in pairs:
        err = _merge_err(err, _diff(got, want))
    return err


def check_kernels(cases):
    """Run every kernel and its plain version on each case; return
    {kernel: max_abs_err} (-1 marks a shape/type mismatch)."""
    import torch
    from dsi_tpu_torch.ops import wordcount as w

    err = {k: 0 for k in KERNELS}

    def worst(name, got, want):
        err[name] = _merge_err(err[name], _worst(zip(got, want)))

    for name, buf, mwl, frac, u_cap in cases:
        chunk = torch.from_numpy(buf).to(DEVICE)
        t_cap = len(buf) // frac + 1
        tok = w.tokenize(chunk, max_word_len=mwl, t_cap=t_cap,
                         with_poslen=True)
        tok_p = w.tokenize_plain(chunk, max_word_len=mwl, t_cap=t_cap,
                                 with_poslen=True)
        worst("tokenize", tok, tok_p)
        srt = w.radix_sort(tok_p[0])
        srt_p = w.radix_sort_plain(tok_p[0])
        worst("radix_sort", srt, srt_p)
        ones = torch.ones(t_cap, dtype=torch.int64, device=DEVICE)
        groups = []
        for payload in (tok_p[1], tok_p[2]):  # lengths, poslen
            grp = w.group_sorted(srt_p[0], ones, u_cap, payload, srt_p[1])
            grp_p = w.group_sorted_plain(srt_p[0], ones, u_cap, payload,
                                         srt_p[1])
            worst("group", grp, grp_p)
            groups.append(grp_p)
        keys_u, len_u = groups[0][0], groups[0][3]
        worst("fnv", (w.fnv1a32_packed(keys_u, len_u, mwl),),
              (w.fnv1a32_packed_plain(keys_u, len_u, mwl),))
        sync()
        log({"case": name, "bytes": len(buf), "max_word_len": mwl,
             "t_cap": t_cap, "u_cap": u_cap,
             "n_tokens": int(tok_p[3][0]), "max_len": int(tok_p[3][1]),
             "has_high": int(tok_p[3][2]),
             "n_unique": int(groups[0][4]),
             "max_abs_err": dict(err)})
    return err


def check_tile_edges():
    """Kernels A and C against their plain versions on the shared edge
    cases (``dsi_tpu_torch/utils/kernel_cases.py``, the CPU tests' cases)
    at the kernels' own tile sizes: A on 8 tiles of bytes with and without
    poslen (one case also from a chunk 5 bytes past a 16-byte boundary),
    C on 4 tiles and 37 rows with and without a payload.  Returns
    (A's, C's) max_abs_err."""
    import torch
    from dsi_tpu_torch.kernels.build import library
    from dsi_tpu_torch.ops import wordcount as w
    from dsi_tpu_torch.utils.kernel_cases import group_cases, tokenize_cases

    lib = library()
    tb, tr = lib.dsi_tokenize_tile_bytes(), lib.dsi_group_tile_rows()
    a_err = c_err = 0
    cases = tokenize_cases(tb, 8 * tb)
    # A chunk that starts 5 bytes past a 16-byte boundary: no vector loads.
    name, buf, mwl, t_cap = cases[2]
    cases.append((f"{name}_offset_5", buf, mwl, t_cap))
    for name, buf, mwl, t_cap in cases:
        chunk = torch.from_numpy(buf).to(DEVICE)
        if name.endswith("_offset_5"):
            chunk = torch.zeros(len(buf) + 5, dtype=torch.uint8,
                                device=DEVICE)[5:]
            chunk.copy_(torch.from_numpy(buf))
        d = 0
        for pl in (True, False):
            d = _merge_err(d, _worst(zip(
                w.tokenize(chunk, max_word_len=mwl, t_cap=t_cap,
                           with_poslen=pl),
                w.tokenize_plain(chunk, max_word_len=mwl, t_cap=t_cap,
                                 with_poslen=pl))))
        a_err = _merge_err(a_err, d)
        sync()
        log({"tokenize_edge_case": name, "bytes": len(buf), "tile": tb,
             "max_word_len": mwl, "t_cap": t_cap, "max_abs_err": d})
    for name, keys, counts, u_cap, payload, perm in group_cases(tr,
                                                                 4 * tr + 37):
        dev = [torch.from_numpy(x).to(DEVICE) for x in
               (keys.view("int64"), counts, payload, perm)]
        d = 0
        for pay in ((dev[2], dev[3]), (None, None)):
            d = _merge_err(d, _worst(zip(
                w.group_sorted(dev[0], dev[1], u_cap, *pay),
                w.group_sorted_plain(dev[0], dev[1], u_cap, *pay))))
        c_err = _merge_err(c_err, d)
        sync()
        log({"group_edge_case": name, "rows": keys.shape[1], "tile": tr,
             "k64": keys.shape[0], "u_cap": u_cap, "max_abs_err": d})
    return a_err, c_err


def ac_profile(fn, name: str) -> dict:
    """``call_profile`` of one call of kernel A (``name`` "tokenize") or C
    ("group"): its CUDA launches, kernels among them and device time.
    Raises when a call takes more than the design's 2 kernel launches
    (its memset of the look-back state aside)."""
    anchor = {"tokenize": "tok_sweep", "group": "g_sweep"}[name]
    prof = call_profile(fn, anchor)
    k = prof["kernels_per_call"]
    if k is not None and (k > 2 or prof["launches_per_call"] > 3):
        raise RuntimeError(f"{name}: {k} kernels and "
                           f"{prof['launches_per_call']} launches a call, "
                           "the design allows 2 kernels and a memset")
    return prof


def radix_sort_cases(corpus_keys):
    """(name, keys [k64, t] int64 on the card, n_sort or None) per case of
    B: a digit constant in every row (the top-k words at a small cap), one
    row, one row either side of either path's tile, all rows equal, real
    rows equal to the pad value before pad rows, 1, 2, 3 and 8 key words,
    the prefix sort at n = 0, mid and t, and t at the switch between the
    paths and one row either side (the bench corpus's key words)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(SEED)

    def rand(k64, t, hi=4):
        a = rng.integers(0, hi, size=(k64, t), dtype=np.int64)
        a[0, 1::5] |= np.int64(-1 << 63)
        a[:, 3::11] = -1
        return torch.from_numpy(a).to(DEVICE)

    cases = [("topk_words", topk_words(1 << 10, 100), None),
             ("one_row", rand(2, 1), None)]
    cases += [(f"t={t}", rand(2, t), None)
              for t in (2047, 2048, 2049, 4095, 4096, 4097)]
    cases.append(("all_equal", torch.full((2, 3000), 0x0123456789ABCDEF,
                                          dtype=torch.int64, device=DEVICE),
                  None))
    pad = rand(2, 10000, hi=1 << 40)
    pad[:, [10, 500, 8999]] = -1
    pad[:, 9000:] = -1
    cases.append(("pad_valued_rows", pad, None))
    cases += [(f"k64={k}", rand(k, 9999), None) for k in (1, 2, 3, 8)]
    for t in (40000, 600000):
        k = rand(3, t, hi=1 << 40)
        n = t // 2
        k[:, n:] = -1
        k[:, n // 2] = -1
        for m in (0, n, t):
            kk = k if m else torch.full_like(k, -1)
            cases.append((f"prefix t={t} n={m}", kk, m))
    switch = radix_small_max()
    for t in (switch - 1, switch, switch + 1):
        cases.append((f"switch t={t}", corpus_keys[:, :t].contiguous(),
                      None))
    return cases


def radix_small_max() -> int:
    """The largest t that B sorts in one cooperative launch, as the built
    library reports it."""
    from dsi_tpu_torch.ops import wordcount as w

    return int(w._lib().dsi_radix_sort_small_max())


def sort_on_path(keys, n_sort, path: int, passes: bool = False):
    """B through its C entry point pinned to one design (1: one
    cooperative launch, 2: one launch a pass, 0: picked by t, as
    ``radix_sort`` calls it).  With ``passes`` it also returns the
    (skipped, run) 8-bit passes that the kernel counted on the card."""
    import torch
    from dsi_tpu_torch.ops import wordcount as w

    if keys.device.type != "cuda":
        out = w.radix_sort(keys, n_sort)
        return (*out, None) if passes else out
    lib = w._lib()
    k64, t = keys.shape
    out = torch.empty_like(keys)
    perm = torch.empty(t, dtype=torch.int32, device=keys.device)
    scratch = torch.empty(lib.dsi_radix_sort_scratch_bytes(t),
                          dtype=torch.uint8, device=keys.device)
    rc = lib.dsi_radix_sort_ex(keys.data_ptr(), k64, t, w._ptr(n_sort),
                               out.data_ptr(), perm.data_ptr(),
                               scratch.data_ptr(), w._stream(keys), path)
    if rc != 0:
        raise RuntimeError(f"radix_sort path {path}: CUDA error {rc}")
    if not passes:
        return out, perm
    off = lib.dsi_radix_sort_passes_offset(t)
    skipped, ran = scratch[off:off + 8].view(torch.int32).tolist()
    return out, perm, (skipped, ran)


def check_passes(keys, n, counted) -> None:
    """Raises unless B's own count of its passes (skipped, run) equals
    what these key words call for: a pass skipped exactly where its digit
    is the same in every row below ``n``, every other pass run."""
    if counted is None:
        return
    want = skipped_passes(keys, n)
    if counted != (want, 8 * keys.shape[0] - want):
        raise RuntimeError(f"radix_sort counted (skipped, run) passes "
                           f"{counted}, the keys call for "
                           f"({want}, {8 * keys.shape[0] - want})")


def check_radix_sort(cases):
    """B against its plain version on every case, through the wrapper's
    own choice of path and pinned to each path; returns max_abs_err (-1
    marks a mismatch of shape or type)."""
    import torch
    from dsi_tpu_torch.ops import wordcount as w

    err = 0
    for name, keys, n in cases:
        ns = (None if n is None
              else torch.tensor([n], dtype=torch.int32, device=DEVICE))
        want = w.radix_sort_plain(keys, ns)
        errs = {"auto": _worst(zip(w.radix_sort(keys, ns), want))}
        counted = {}
        for path, code in (("small", 1), ("large", 2)):
            sk, pm, counted[path] = sort_on_path(keys, ns, code, passes=True)
            errs[path] = _worst(zip((sk, pm), want))
            check_passes(keys, n, counted[path])
        sync()
        for e in errs.values():
            err = _merge_err(err, e)
        log({"radix_sort_case": name, "shape": list(keys.shape),
             "n_sort": n, "skipped_run_passes": counted,
             "max_abs_err": errs,
             **(path_ms(keys, ns) if name.startswith("switch") else {})})
    return err


def topk_words(cap: int, occupied: int):
    """The top-k snapshot's key words (``device/topk.py``): ~count, the
    packed word, its length, for ``occupied`` candidate rows of a table of
    ``cap``; 7 of word 0's bytes and 7 of word 2's are constant."""
    import numpy as np
    import torch
    from dsi_tpu_torch.ops import wordcount as w

    rng = np.random.default_rng(SEED)
    counts = np.zeros(cap, np.int64)
    counts[:occupied] = rng.integers(1, 9, occupied)
    keys = np.full((cap, 2), -1, np.int32)
    keys[:occupied, 1] = rng.permutation(200_000)[:occupied]
    keys[:occupied, 0] = 0
    lanes = torch.from_numpy(keys).to(DEVICE)
    return torch.stack([
        ~torch.from_numpy(counts).to(DEVICE),
        *w.pack_key_lanes((lanes[:, 0], lanes[:, 1])),
        torch.from_numpy(np.where(counts > 0, 8, 0)).to(DEVICE)])


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` on the card, from CUDA events around
    ``reps`` calls after one warm-up call."""
    import torch

    fn()
    sync()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    sync()
    return start.elapsed_time(end) / reps


# Idle seconds at each edge of a profiler step: torch.profiler drops the
# kernels it sees near a window's edges (on the H100, 2-5 windows of 40
# without it, none of 240 with 5 ms).
PROFILE_EDGE_S = 0.005


def _device_events(fn, reps: int, anchors, tries: int = 4):
    """[(kernel or copy name, count, device us)] of ``reps`` calls of
    ``fn()`` under ``torch.profiler``, after a warm-up call and a warm-up
    step of the profiler, or None.  A window counts only when it is whole:
    a kernel whose name holds one of ``anchors`` (each launched once a
    call) was seen ``reps`` times and every count is a whole number of
    calls.  The profiler can drop events at the edges of its window, so
    each step's calls sit PROFILE_EDGE_S away from its edges and it is
    asked again, up to ``tries`` times."""
    from torch.profiler import ProfilerActivity, profile, schedule

    anchors = (anchors,) if isinstance(anchors, str) else tuple(anchors)
    fn()
    sync()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            for _ in range(2):
                time.sleep(PROFILE_EDGE_S)
                for _ in range(reps):
                    fn()
                sync()
                time.sleep(PROFILE_EDGE_S)
                prof.step()
        events = []
        for e in prof.key_averages():
            t = getattr(e, "device_time_total",
                        getattr(e, "cuda_time_total", 0))
            if t > 0:
                events.append((e.key, e.count, t))
        calls = max([c for k, c, _ in events
                     if any(a in k for a in anchors)], default=0)
        if calls == reps and all(c % reps == 0 for _, c, _ in events):
            return events
    return None


def device_ms(fn, reps: int, name: str):
    """Mean device milliseconds a call of ``fn()`` spends in the CUDA
    kernels whose names contain ``name``, from ``torch.profiler``: the
    kernels alone, where :func:`cuda_ms` also holds the host's launch gaps
    of a short kernel.  None when no whole window was seen."""
    events = _device_events(fn, reps, name)
    if events is None:
        return None
    return sum(t for k, _, t in events if name in k) / 1e3 / reps


def call_profile(fn, anchors, reps: int = 20, names: bool = False) -> dict:
    """Every CUDA launch (kernels and memsets) of one call of ``fn()`` on
    the card, from ``torch.profiler``: ``launches_per_call``,
    ``kernels_per_call`` (the launches less memsets and copies) and
    ``device_ms`` (the launches' device time, without the host's gaps
    between them), with ``names`` also ``kernel_names``.  Calls are
    counted by a kernel whose name holds one of ``anchors``, launched once
    a call; every value is None when no whole window was seen."""
    events = _device_events(fn, reps, anchors)
    out = _launch_summary(events, reps)
    if names:
        out["kernel_names"] = (None if events is None
                               else [k for k, _, _ in events])
    return out


def _launch_summary(events, reps: int) -> dict:
    """``launches_per_call``, ``kernels_per_call`` (less memsets and
    copies), ``copies_per_call`` (Memcpys) and ``device_ms`` of ``reps``
    calls' events, each None without a whole window."""
    if events is None:
        return {"launches_per_call": None, "kernels_per_call": None,
                "copies_per_call": None, "device_ms": None}
    return {"launches_per_call": sum(c for _, c, _ in events) // reps,
            "kernels_per_call": sum(
                c for k, c, _ in events
                if not k.startswith(("Memset", "Memcpy"))) // reps,
            "copies_per_call": sum(
                c for k, c, _ in events if k.startswith("Memcpy")) // reps,
            "device_ms": sum(t for _, _, t in events) / 1e3 / reps}


def allocs_per_call(fn):
    """Device allocations that one call of ``fn()`` asks of PyTorch's
    caching allocator, after a warm-up call; None off the card."""
    import torch

    if DEVICE != "cuda":
        return None
    fn()
    sync()
    key = "allocation.all.allocated"
    before = torch.cuda.memory_stats()[key]
    out = fn()
    after = torch.cuda.memory_stats()[key]
    del out
    return after - before


def wrapper_profile(fn, anchor: str, reps: int = 20) -> dict:
    """A wrapper's CUDA launches, kernels and device time a call
    (:func:`call_profile`) and its allocations (:func:`allocs_per_call`)."""
    return {**call_profile(fn, anchor, reps),
            "allocs_per_call": allocs_per_call(fn)}


def over_budget(tag: str, prof: dict, launches: int, allocs: int) -> list:
    """Failures when a profiled wrapper took more CUDA launches or device
    allocations a call than its design (a whole window only)."""
    out = []
    got = prof.get("launches_per_call")
    if got is not None and got > launches:
        out.append(f"{tag}: {got} CUDA launches a call, above {launches}")
    got = prof.get("allocs_per_call")
    if got is not None and got > allocs:
        out.append(f"{tag}: {got} allocations a call, above {allocs}")
    return out


def unmeasured(tag: str, prof: dict, keys=("launches_per_call",
                                           "allocs_per_call")) -> list:
    """Failures for each of ``keys`` that ``prof`` left None (the profiler
    kept no whole window), so a gate on it cannot pass unmeasured."""
    return [f"{tag}: {k} not measured (no whole profiler window)"
            for k in keys if prof.get(k) is None]


def skipped_passes(keys, n=None) -> int:
    """B's 8-bit passes that the kernel skips on these key words: a digit
    that is the same in every row below ``n``."""
    k = keys[:, :n] if n is not None else keys
    if k.shape[1] == 0:
        return 8 * k.shape[0]
    skipped = 0
    for p in range(8):
        d = (k >> (8 * p)) & 255
        skipped += int((d.amin(dim=1) == d.amax(dim=1)).sum())
    return skipped


def b_row_extras(keys, library_ms: float) -> dict:
    """The fields every row of B carries beside its time: the CUDA launches
    of one call and their device time, the path whose kernels the profiler
    saw, the 8-bit passes that the kernel counted as skipped and as run
    (held to what the keys call for), and the one-word library call times
    k64 (it sorts 1/k64 of B's work).  Raises when the launches break the
    design: one a call on the small path, at most 1 + 11 * k64 above."""
    from dsi_tpu_torch.ops import wordcount as w

    k64, t = keys.shape
    prof = call_profile(lambda: w.radix_sort(keys), ("rs_coop", "rs_final"),
                        names=True)
    names = prof.pop("kernel_names")
    if names is None:
        path = "small" if t <= radix_small_max() else "large"
    else:
        path = "small" if any("rs_coop" in k for k in names) else "large"
    most = 1 if path == "small" else 1 + 11 * k64
    if prof["launches_per_call"] is not None \
            and prof["launches_per_call"] > most:
        raise RuntimeError(f"radix_sort t={t} k64={k64}: "
                           f"{prof['launches_per_call']} launches a call on "
                           f"the {path} path, the design allows {most}")
    *_, counted = sort_on_path(keys, None, 0, passes=True)
    check_passes(keys, None, counted)
    return {**prof, "skipped_passes": counted[0], "passes_run": counted[1],
            "path": path, "library_x_k64_ms": library_ms * k64,
            **path_ms(keys)}


def path_ms(keys, n_sort=None) -> dict:
    """B's time on each of its two paths, pinned, in turns: where the
    switch between them belongs."""
    turns = [(name, cuda_ms(lambda: sort_on_path(keys, n_sort, code), 20))
             for name, code in (("small", 1), ("large", 2), ("large", 2),
                                ("small", 1))]
    return {f"{name}_path_ms": min(ms for n, ms in turns if n == name)
            for name in ("small", "large")}


def time_kernels(corpus_buf, split_buf):
    """Time each kernel, its plain version and its yardstick at the shapes
    the main path gives it: A, B, C on the bench corpus (corpus path, rung
    0), A also at the stream step's shape (held to its plain version
    there), D on one file's uniques (count_words_host_result, rung 0); A
    and C with their launches a call.  Returns {kernel: {ms, plain_ms,
    library_ms, bound_ms, ...}}."""
    import numpy as np
    import torch
    from dsi_tpu_torch.ops import wordcount as w

    out = {}
    n = len(corpus_buf)
    chunk = torch.from_numpy(corpus_buf).to(DEVICE)
    t = n // 4 + 1
    u = w.rung0_cap(n, CORPUS_U_CAP)
    k64 = (MWL // 4 + 1) // 2
    keys, lengths, poslen, sc = w.tokenize(chunk, max_word_len=MWL, t_cap=t,
                                           with_poslen=True)
    skeys, perm = w.radix_sort(keys)
    ones = torch.ones(t, dtype=torch.int64, device=DEVICE)
    grp = w.group_sorted(skeys, ones, u, poslen, perm)
    nu = min(int(grp[4]), u)

    a_bytes = n + t * (8 * k64 + 4 + 4) + 16
    out["tokenize"] = {
        "ms": cuda_ms(lambda: w.tokenize(chunk, max_word_len=MWL, t_cap=t,
                                         with_poslen=True), 20),
        "plain_ms": cuda_ms(lambda: w.tokenize_plain(
            chunk, max_word_len=MWL, t_cap=t, with_poslen=True), 3),
        "library_ms": None, "bytes": a_bytes,
        "shape": f"n={n} t_cap={t} k64={k64}",
        **ac_profile(lambda: w.tokenize(chunk, max_word_len=MWL, t_cap=t,
                                        with_poslen=True), "tokenize")}
    # A at the stream step's shape (one 2 MiB chunk, no poslen): the shape
    # most of its launches take.
    s_buf = np.zeros(STREAM_CHUNK, np.uint8)
    s_buf[:len(split_buf)] = split_buf[:STREAM_CHUNK]
    s_chunk = torch.from_numpy(s_buf).to(DEVICE)
    st_cap = STREAM_CHUNK // 4 + 1
    s_tok = w.tokenize(s_chunk, max_word_len=MWL, t_cap=st_cap)
    s_bytes = STREAM_CHUNK + st_cap * (8 * k64 + 4) + 16
    out["tokenize"]["at_shapes"] = {"stream_step": {
        "max_abs_err": _worst(zip(s_tok, w.tokenize_plain(
            s_chunk, max_word_len=MWL, t_cap=st_cap))),
        "ms": cuda_ms(lambda: w.tokenize(s_chunk, max_word_len=MWL,
                                         t_cap=st_cap), 50),
        "plain_ms": cuda_ms(lambda: w.tokenize_plain(
            s_chunk, max_word_len=MWL, t_cap=st_cap), 5),
        "library_ms": None,
        "bound_ms": s_bytes / HBM_BYTES_PER_S * 1e3,
        "shape": f"stream step: n={STREAM_CHUNK} t_cap={st_cap} "
                 f"k64={k64} n_tokens={int(s_tok[3][0])}",
        **ac_profile(lambda: w.tokenize(s_chunk, max_word_len=MWL,
                                        t_cap=st_cap), "tokenize")}}
    b_bytes = t * 8 * k64 * 2 + 4 * t
    word0 = keys[0].clone()
    out["radix_sort"] = {
        "ms": cuda_ms(lambda: w.radix_sort(keys), 10),
        "plain_ms": cuda_ms(lambda: w.radix_sort_plain(keys), 3),
        # One stable torch.sort of ONE int64 key word with its indices:
        # the library yardstick; the port never calls it.
        "library_ms": cuda_ms(lambda: torch.sort(word0, stable=True), 10),
        "bytes": b_bytes,
        "radix_bytes": 8 * k64 * (8 + 4) * 2 * t,
        "shape": f"t={t} k64={k64}"}
    out["radix_sort"].update(b_row_extras(keys,
                                          out["radix_sort"]["library_ms"]))
    c_bytes = t * (8 * k64 + 8) + nu * 8 + u * (8 * k64 + 8 + 4 + 4) + 4
    sk_rows = skeys.T
    out["group"] = {
        "ms": cuda_ms(lambda: w.group_sorted(skeys, ones, u, poslen, perm),
                      20),
        "plain_ms": cuda_ms(lambda: w.group_sorted_plain(
            skeys, ones, u, poslen, perm), 3),
        # Run heads and counts over the sorted rows in one call; it leaves
        # out the u_cap compaction and the payload gather.
        "library_ms": cuda_ms(lambda: torch.unique_consecutive(
            sk_rows, dim=0, return_counts=True), 10),
        "bytes": c_bytes,
        "shape": f"t={t} u_cap={u} n_unique={int(grp[4])}",
        **ac_profile(lambda: w.group_sorted(skeys, ones, u, poslen, perm),
                     "group")}

    # D at the per-split path's shape: one file, max_word_len 16, rung 0.
    s_chunk = torch.from_numpy(split_buf).to(DEVICE)
    st = len(split_buf) // 4 + 1
    su = w.rung0_cap(len(split_buf), SPLIT_U_CAP)
    s_keys, s_len, _, _ = w.tokenize(s_chunk, max_word_len=MWL, t_cap=st)
    s_sk, s_perm = w.radix_sort(s_keys)
    s_grp = w.group_sorted(
        s_sk, torch.ones(st, dtype=torch.int64, device=DEVICE), su, s_len,
        s_perm)
    keys_u, len_u = s_grp[0], s_grp[3]
    out["fnv"] = fnv_entry(keys_u, len_u, MWL, f"split: u_cap={su} "
                                                 f"k64={k64}")
    for v in out.values():
        v["bound_ms"] = v["bytes"] / HBM_BYTES_PER_S * 1e3
        if "radix_bytes" in v:
            v["radix_bound_ms"] = v["radix_bytes"] / HBM_BYTES_PER_S * 1e3
    return out


# ── phase 3: the slice at full size ──────────────────────────────────────


def sorted_lines(paths) -> list:
    """``sort mr-out-* | grep .`` as a list of byte lines."""
    lines = []
    for p in paths:
        with open(p, "rb") as f:
            lines.extend(x for x in f.read().split(b"\n") if x)
    return sorted(lines)


def run_oracle(files, workdir) -> list:
    from dsi_tpu_torch.apps.wc import Map, Reduce
    from dsi_tpu_torch.mr.sequential import run_sequential

    out = run_sequential(Map, Reduce, files,
                         os.path.join(workdir, "mr-correct.txt"))
    return sorted_lines([out])


def corpus_path(files, workdir, tag, **kw):
    """Read -> corpus_wordcount(**kw) -> write_corpus_output, phase by
    phase; returns (sorted output lines, phase seconds, launches)."""
    import glob

    import torch
    from dsi_tpu_torch.ops import wordcount as w
    from dsi_tpu_torch.ops.corpus_wc import (corpus_wordcount,
                                             write_corpus_output)

    outdir = os.path.join(workdir, tag)
    os.makedirs(outdir, exist_ok=True)
    w.reset_launches()
    t0 = time.perf_counter()
    raws = []
    for p in files:
        with open(p, "rb") as f:
            raws.append(f.read())
    t1 = time.perf_counter()
    res = corpus_wordcount(raws, device=DEVICE, **kw)
    sync()
    t2 = time.perf_counter()
    if res is None:
        raise RuntimeError(f"{tag}: corpus_wordcount fell back to the host")
    write_corpus_output(res, N_REDUCE, outdir)
    t3 = time.perf_counter()
    launches = w.launch_counts()
    phases = {"read_s": t1 - t0, "kernel_s": t2 - t1, "write_s": t3 - t2}
    lines = sorted_lines(sorted(glob.glob(os.path.join(outdir, "mr-out-*"))))
    return lines, phases, launches, sum(len(r) for r in raws)

# ── phase 4: kernel E, and B / C at the stream's shapes ──────────────────


def stream_step_rows(raw: bytes):
    """The map rows and destinations of one full-width stream step (one
    shard, one 2 MiB chunk holding ``raw``): kernel E's main-path input."""
    import numpy as np
    import torch
    from dsi_tpu_torch.parallel.shuffle import map_prologue

    buf = np.zeros(STREAM_CHUNK, np.uint8)
    buf[:len(raw)] = np.frombuffer(raw, np.uint8)
    packed_u, len_u, cnt_u, part, dest, _ = map_prologue(
        torch.from_numpy(buf).to(DEVICE), n_dev=1, n_reduce=N_REDUCE,
        max_word_len=MWL, u_cap=STREAM_U_CAP, t_cap_frac=4)
    rows = torch.cat([packed_u, len_u[:, None], cnt_u[:, None],
                      part[:, None]], dim=1)
    return rows[None].contiguous(), dest[None].contiguous()


def route_cases(rows1, dest1):
    """(name, rows, dest, n_dev, k) per case for kernel E."""
    import numpy as np
    import torch

    rng = np.random.default_rng(SEED)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(DEVICE)

    def rows(n_dev, r, w):
        return dev(rng.integers(-(1 << 31), 1 << 31, (n_dev, r, w))
                   .astype(np.int32))

    r8 = rows(8, 4096, 7)
    return [
        ("stream_shape", rows1, dest1, 1, MWL // 4),
        ("parked_n1", rows1, torch.ones_like(dest1), 1, MWL // 4),
        ("random_n8", r8, dev(rng.integers(0, 9, (8, 4096))
                              .astype(np.int32)), 8, 4),
        ("one_dest_n8", r8, dev(np.full((8, 4096), 3, np.int32)), 8, 4),
        ("parked_n8", r8, dev(np.full((8, 4096), 8, np.int32)), 8, 4),
        ("wide_n8", rows(8, 1024, 19),
         dev(rng.integers(0, 9, (8, 1024)).astype(np.int32)), 8, 16),
    ]


def shared_route_cases():
    """(name, rows, dest, n_dev, k) of ``kernel_cases.route_cases`` at
    kernel E's own tiles (``dsi_route_tile_rows``), each also with rows
    and dests 4 bytes past a 16-byte boundary (no 16-byte loads)."""
    import torch
    from dsi_tpu_torch.kernels.build import library
    from dsi_tpu_torch.utils.kernel_cases import route_cases as shared

    out = []
    for name, rows, dest, n_dev, k in shared(library().dsi_route_tile_rows):
        r_t = torch.from_numpy(rows.view("int32")).to(DEVICE)
        d_t = torch.from_numpy(dest).to(DEVICE)
        out += [(name, r_t, d_t, n_dev, k),
                (f"{name}_offset_4", _offset_copy(r_t), _offset_copy(d_t),
                 n_dev, k)]
    return out


def _offset_copy(t):
    """A copy of ``t`` whose storage starts 4 bytes past ``t``'s alignment:
    the same values from an address 4 bytes off a 16-byte boundary."""
    import torch

    words = 4 // t.element_size()
    buf = torch.empty(t.numel() + words, dtype=t.dtype, device=t.device)
    out = buf[words:].view(t.shape)
    out.copy_(t)
    return out


def check_route(cases) -> int:
    """Kernel E against its plain version on every case; max_abs_err."""
    from dsi_tpu_torch.ops.wordcount import shuffle_rows, shuffle_rows_plain

    err = 0
    for name, rows, dest, n_dev, k in cases:
        got = shuffle_rows(rows, dest, n_dev=n_dev, k=k)
        want = shuffle_rows_plain(rows, dest, n_dev=n_dev, k=k)
        d = _diff(got, want)
        err = _merge_err(err, d)
        sync()
        log({"route_case": name, "shape": list(rows.shape), "k": k,
             "valid_rows": int(((dest >= 0) & (dest < n_dev)).sum()),
             "max_abs_err": d})
    return err


def check_fnv() -> int:
    """Kernel D against its plain version on ``kernel_cases.fnv_cases``:
    every case in both layouts (u64 words, u32 lanes), the lanes also 4
    bytes off a 16-byte boundary, with and without the epilogue;
    max_abs_err."""
    import torch
    from dsi_tpu_torch.ops import wordcount as w
    from dsi_tpu_torch.utils.kernel_cases import fnv_cases, lanes_to_words

    err = 0
    for name, lanes, lens, mwl, ep in fnv_cases():
        lanes_t = torch.from_numpy(lanes.view("int32")).to(DEVICE)
        layouts = {"words": torch.from_numpy(
                       lanes_to_words(lanes).view("int64")).to(DEVICE),
                   "lanes": lanes_t, "lanes_offset_4": _offset_copy(lanes_t)}
        lens_t = torch.from_numpy(lens).to(DEVICE)
        kw = dict(ep or {})
        if "valid" in kw:
            kw["valid"] = torch.from_numpy(kw["valid"]).to(DEVICE)
        if "n_valid" in kw:
            kw["n_valid"] = torch.tensor(kw["n_valid"], dtype=torch.int32,
                                         device=DEVICE)
        d = 0
        for keys in layouts.values():
            d = _merge_err(d, _diff(w.fnv1a32_packed(keys, lens_t, mwl),
                                    w.fnv1a32_packed_plain(keys, lens_t,
                                                           mwl)))
            if ep is not None:
                d = _merge_err(d, _worst(zip(
                    w.fnv1a32_route(keys, lens_t, mwl, **kw),
                    w.fnv1a32_route_plain(keys, lens_t, mwl, **kw))))
        err = _merge_err(err, d)
        sync()
        log({"fnv_case": name, "rows": len(lens), "kk": lanes.shape[1],
             "max_word_len": mwl, "epilogue": ep is not None,
             "layouts": list(layouts), "max_abs_err": d})
    return err


def route_profile(fn) -> dict:
    """``call_profile`` of one call of kernel E: its CUDA launches, kernels
    among them and device time.  Raises above the design's memset and 2
    kernels a call."""
    prof = call_profile(fn, "route_write")
    if prof["kernels_per_call"] is not None and (
            prof["kernels_per_call"] > 2 or prof["launches_per_call"] > 3):
        raise RuntimeError(f"route: {prof['kernels_per_call']} kernels and "
                           f"{prof['launches_per_call']} launches a call, "
                           "the design allows 2 kernels and a memset")
    return prof


def fnv_profile(fn) -> dict:
    """``call_profile`` of one call of kernel D; raises above its one
    launch a call (its epilogue included)."""
    prof = call_profile(fn, "fnv_rows")
    if prof["launches_per_call"] is not None \
            and prof["launches_per_call"] > 1:
        raise RuntimeError(f"fnv: {prof['launches_per_call']} launches a "
                           "call, the design allows 1")
    return prof


def route_entry(rows, dest, n_dev: int, k: int, shape: str,
                reps: int = 20) -> dict:
    """E at one shape of the main path: held against its plain version
    on the same device tensors, timed through the wrapper beside it, and
    profiled on the card."""
    from dsi_tpu_torch.ops.wordcount import shuffle_rows, shuffle_rows_plain

    def fn():
        return shuffle_rows(rows, dest, n_dev=n_dev, k=k)

    want = shuffle_rows_plain(rows, dest, n_dev=n_dev, k=k)
    # The rows this run routes are read once (a dropped row need not be),
    # every dest once, recv written once.
    routed = int(((dest >= 0) & (dest < n_dev)).sum())
    nbytes = 4 * (routed * rows.shape[2] + dest.numel() + want.numel())
    return {"max_abs_err": _diff(fn(), want), "ms": cuda_ms(fn, reps),
            "plain_ms": cuda_ms(lambda: shuffle_rows_plain(
                rows, dest, n_dev=n_dev, k=k), 2),
            # No one PyTorch call routes rows to shards.
            "library_ms": None, "bytes": nbytes,
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "shape": f"{shape}: n_dev={n_dev} rows={list(rows.shape)} "
                     f"-> {list(want.shape)}",
            **route_profile(fn)}


def fnv_entry(keys, lens, mwl: int, shape: str, **ep) -> dict:
    """D at one shape of the main path, with its epilogue when ``ep``
    holds ``fnv1a32_route``'s keywords: held against its plain version,
    timed through the wrapper beside it, and profiled on the card."""
    from dsi_tpu_torch.ops import wordcount as w

    if ep:
        def fn():
            return w.fnv1a32_route(keys, lens, mwl, **ep)

        def plain():
            return w.fnv1a32_route_plain(keys, lens, mwl, **ep)

        err = _worst(zip(fn(), plain()))
    else:
        def fn():
            return w.fnv1a32_packed(keys, lens, mwl)

        def plain():
            return w.fnv1a32_packed_plain(keys, lens, mwl)

        err = _diff(fn(), plain())
    u = lens.shape[0]
    valid = ep.get("valid")
    # Each row's key bytes up to its length are read once (this run's
    # lengths), its length and mask once, each output written once.
    key_bytes = int(lens.clamp(0, mwl).sum())
    nbytes = (key_bytes + 4 * u + (0 if valid is None else u)
              + 4 * u * (3 if ep else 1))
    return {"max_abs_err": err, "ms": cuda_ms(fn, 50),
            "plain_ms": cuda_ms(plain, 5), "library_ms": None,
            "bytes": nbytes, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes",
            "shape": f"{shape}: rows={u} keys={list(keys.shape)} "
                     f"{keys.dtype} epilogue={bool(ep)}",
            **fnv_profile(fn)}


def stream_fnv_entry(raw: bytes) -> dict:
    """D as ``map_prologue`` runs it on one full-width stream step (one
    shard, one 2 MiB chunk holding ``raw``): the u_cap rows' hash, part and
    dest in one launch."""
    import numpy as np
    import torch
    from dsi_tpu_torch.ops import wordcount as w

    buf = np.zeros(STREAM_CHUNK, np.uint8)
    buf[:len(raw)] = np.frombuffer(raw, np.uint8)
    keys_u, _, len_u, _, n_unique, *_ = w.group_chunk(
        torch.from_numpy(buf).to(DEVICE), max_word_len=MWL,
        u_cap=STREAM_U_CAP, t_cap_frac=4, grouper="sort")
    return fnv_entry(keys_u, len_u, MWL, "stream step (map_prologue)",
                     n_part=N_REDUCE, n_dest=1, park=1, n_valid=n_unique)


def time_sort_group(keys64, counts, payload, u_cap: int, tag: str):
    """B and C on one shape of the stream path, held against their plain
    versions on the same device tensors and timed beside them and their
    yardsticks: ``keys64`` [k64, t] unsorted key words, ``counts`` [t]
    int64 and ``payload`` [t] int32 in pre-sort order.  Each kernel's
    entry carries its ``max_abs_err`` at this shape (-1 marks a
    shape/type mismatch)."""
    import torch
    from dsi_tpu_torch.ops import wordcount as w

    k64, t = keys64.shape
    skeys, perm = w.radix_sort(keys64)
    b_err = _worst(zip((skeys, perm), w.radix_sort_plain(keys64)))
    scounts = counts[perm.long()]
    grp = w.group_sorted(skeys, scounts, u_cap, payload, perm)
    c_err = _worst(zip(grp, w.group_sorted_plain(skeys, scounts, u_cap,
                                                 payload, perm)))
    nu = int(grp[4])
    word0 = keys64[0].clone()
    b_bytes = 2 * 8 * k64 * t + 4 * t
    c_bytes = (t * (8 * k64 + 8) + 8 * min(nu, u_cap)
               + u_cap * (8 * k64 + 8 + 4 + 4) + 4)
    sk_rows = skeys.T
    b_lib = cuda_ms(lambda: torch.sort(word0, stable=True), 20)
    return {
        "radix_sort": {
            "max_abs_err": b_err,
            "ms": cuda_ms(lambda: w.radix_sort(keys64), 20),
            "plain_ms": cuda_ms(lambda: w.radix_sort_plain(keys64), 5),
            "library_ms": b_lib,
            "bound_ms": b_bytes / HBM_BYTES_PER_S * 1e3,
            "shape": f"{tag}: t={t} k64={k64}",
            **b_row_extras(keys64, b_lib)},
        "group": {
            "max_abs_err": c_err,
            "ms": cuda_ms(lambda: w.group_sorted(skeys, scounts, u_cap,
                                                 payload, perm), 20),
            "plain_ms": cuda_ms(lambda: w.group_sorted_plain(
                skeys, scounts, u_cap, payload, perm), 5),
            # Run heads and counts over the sorted rows in one call; it
            # leaves out the u_cap compaction and the payload gather.
            "library_ms": cuda_ms(lambda: torch.unique_consecutive(
                sk_rows, dim=0, return_counts=True), 20),
            "bound_ms": c_bytes / HBM_BYTES_PER_S * 1e3,
            "shape": f"{tag}: t={t} u_cap={u_cap} n_unique={nu}",
            **ac_profile(lambda: w.group_sorted(skeys, scounts, u_cap,
                                                payload, perm), "group")}}


def reduce_shape_times(rows1, dest1):
    """B and C as the step's reduce half runs them (K9)."""
    from dsi_tpu_torch.ops.wordcount import (_u32_value, pack_key_lanes,
                                             shuffle_rows)

    import torch

    k = MWL // 4
    recv = shuffle_rows(rows1, dest1, n_dev=1, k=k)[0]
    keys64 = torch.stack(pack_key_lanes(tuple(recv[:, j]
                                              for j in range(k))))
    return time_sort_group(keys64, _u32_value(recv[:, k + 1]),
                           recv[:, k].contiguous(), recv.shape[0], "reduce")


def fold_shape_times(raws, cap: int):
    """B and C as the fold runs them (K10) once the table has reached
    ``cap`` rows: a table holding the first files' steps, and the next
    file's step."""
    import numpy as np
    import torch
    from dsi_tpu_torch.device import table as dt
    from dsi_tpu_torch.parallel.shuffle import _slice_pack, mapreduce_step

    k = MWL // 4
    opts = {"device": DEVICE}
    state = (torch.full((1, cap, k), -1, dtype=torch.int32, **opts),
             torch.zeros((1, cap), dtype=torch.int32, **opts),
             torch.zeros((1, cap), dtype=torch.int64, **opts),
             torch.zeros((1, cap), dtype=torch.int32, **opts),
             torch.zeros(1, dtype=torch.int32, **opts))
    steps = []
    for raw in raws[:5]:
        buf = np.zeros(STREAM_CHUNK, np.uint8)
        buf[:len(raw)] = np.frombuffer(raw, np.uint8)
        out = mapreduce_step(torch.from_numpy(buf).to(DEVICE)[None],
                             n_dev=1, n_reduce=N_REDUCE, max_word_len=MWL,
                             u_cap=STREAM_U_CAP)
        steps.append((_slice_pack(*out[:4], mp=out[0].shape[1]), out[4]))
    for packed, scal in steps[:-1]:
        state = dt.fold_step(*state, packed, scal)[:5]
    packed, scal = steps[-1]
    keys64, cnts, lens, _ = dt._fold_operands(
        state[0][0], state[1][0], state[2][0], state[3][0], packed[0],
        scal[0], k)
    return time_sort_group(keys64, cnts, lens, cap, "fold")


# ── phase 6: F, G, and D / E / B / C at the mesh fold's shapes ───────────


def colliding_words(mask: int):
    """Two distinct lowercase words sharing one bucket at ``mask``: the
    search of ``tests/test_ops_wordcount.py`` (3 letters, then 4)."""
    from dsi_tpu_torch.mr.sequential import fnv32a

    seen: dict = {}
    for n in (3, 4):
        for tup in itertools.product(b"abcdefghijklmnopqrstuvwxyz",
                                     repeat=n):
            w = bytes(tup)
            b = fnv32a(w) & mask
            if b in seen and seen[b] != w:
                return seen[b], w
            seen[b] = w
    raise RuntimeError(f"no colliding words at mask {mask:#x}")


def hash_group_cases(corpus_buf, split_buf, raw0: bytes):
    """(name, chunk, max_word_len, with_extra, u_cap) per case for F."""
    import numpy as np
    from dsi_tpu_torch.ops.wordcount import hash_group_shape

    split_nb, split_dcap = hash_group_shape(len(split_buf) // 4 + 1)
    w1, w2 = colliding_words(split_nb - 1)
    pair = w1 + b" " + w2 + b" "
    return [
        ("corpus_extra", corpus_buf, MWL, True, CORPUS_U_CAP),
        ("split", split_buf, MWL, False, SPLIT_U_CAP),
        ("mwl64_extra", corpus_buf, 64, True, CORPUS_U_CAP),
        ("no_token", np.zeros(4096, np.uint8), MWL, True, 256),
        ("dirty_bucket", _text_chunk([raw0[:len(split_buf) // 2], b" ",
                                      pair * (split_dcap // 8)],
                                     len(split_buf)), MWL, False,
         SPLIT_U_CAP),
        ("dirty_overflow", _text_chunk([pair * (split_dcap // 2 + 1000)],
                                       len(split_buf)), MWL, False,
         SPLIT_U_CAP),
    ]


def forced_bucket_cases():
    """F's cases with the tokens' hashes forced, as (name, keys, lengths,
    fnv, n_valid, extra or None, u_cap), each with and without ``extra``:
    every token in one bucket with two distinct words, one word a bucket
    (every bucket clean), and two words that differ only in their last key
    word, sharing a bucket beside clean ones."""
    import numpy as np
    import torch
    from dsi_tpu_torch.ops import wordcount as w

    rng = np.random.default_rng(SEED)
    t, k = 2049, 4
    vocab = rng.integers(0x41414141, 0x5A5A5A5A, (700, k), dtype=np.int64)
    pairs = {}
    tok = np.zeros(t, np.int64)
    tok[:200] = np.arange(200) % 2
    pairs["one_bucket_two_words"] = (tok, np.full(t, 5), 200)
    tok = rng.integers(0, 700, t)
    pairs["one_word_a_bucket"] = (tok, tok, 1500)
    tok = rng.integers(2, 700, t)
    tok[::31] = 0
    tok[5::31] = 1
    vocab_last = vocab.copy()
    vocab_last[1, :k - 1] = vocab_last[0, :k - 1]  # differ in the last word
    pairs["last_word_differs"] = (tok, np.where(tok < 2, 1, tok), 1800)
    cases = []
    for name, (tok, bucket, n_valid) in pairs.items():
        voc = vocab_last if name == "last_word_differs" else vocab
        lanes = np.where((np.arange(t) < n_valid)[:, None], voc[tok],
                         -1).astype(np.uint32).view(np.int32)
        lanes_t = torch.from_numpy(lanes.copy()).to(DEVICE)
        keys = torch.stack(w.pack_key_lanes(
            tuple(lanes_t[:, j].contiguous() for j in range(k))))
        lens = torch.from_numpy(np.where(np.arange(t) < n_valid, 16, 0)
                                .astype(np.int32)).to(DEVICE)
        fnv = torch.from_numpy(bucket.astype(np.int32)).to(DEVICE)
        nv = torch.tensor([n_valid], dtype=torch.int32, device=DEVICE)
        extra = torch.from_numpy(rng.integers(0, 1 << 32, t, dtype=np.int64)
                                 .astype(np.uint32).view(np.int32)).to(DEVICE)
        for ex in (None, extra):
            cases.append((name + ("_extra" if ex is not None else ""), keys,
                          lens, fnv, nv, ex, 1024))
    return cases


def check_forced_buckets(cases):
    """F against its plain version on the forced-hash cases; returns
    max_abs_err and the failures of the cases' own conditions."""
    from dsi_tpu_torch.ops import wordcount as w

    err, failures = 0, []
    for name, keys, lens, fnv, nv, extra, u_cap in cases:
        got = w.hash_group(keys, lens, fnv, nv, u_cap, extra=extra)
        want = w.hash_group_plain(keys, lens, fnv, nv, u_cap, extra=extra)
        d = _worst(zip(got, want))
        err = _merge_err(err, d)
        sync()
        if bool(want[5]):
            failures.append(f"F: {name} overflowed its dirty buffer")
        log({"hash_group_case": name, "n_valid": int(nv[0]),
             "n_unique": int(want[4]), "max_abs_err": d})
    return err, failures


def check_hash_group(cases):
    """Kernel F against its plain version on every case, all six outputs
    in order; returns max_abs_err (-1 marks a mismatch of shape or type)
    and the failures of the cases' own conditions."""
    import torch
    from dsi_tpu_torch.ops import wordcount as w

    err, failures = 0, []
    for name, buf, mwl, with_extra, u_cap in cases:
        chunk = torch.from_numpy(buf).to(DEVICE)
        keys, lens, poslen, sc = w.tokenize(
            chunk, max_word_len=mwl, t_cap=len(buf) // 4 + 1,
            with_poslen=True)
        fnv = w.fnv1a32_packed(keys, lens, mwl)
        extra = poslen if with_extra else None
        got = w.hash_group(keys, lens, fnv, sc[:1], u_cap, extra=extra)
        want = w.hash_group_plain(keys, lens, fnv, sc[:1], u_cap,
                                  extra=extra)
        d = _worst(zip(got, want))
        err = _merge_err(err, d)
        sync()
        nu, overflow = int(want[4]), bool(want[5])
        if name == "dirty_overflow" and not overflow:
            failures.append("F: the dirty overflow case did not overflow")
        if name != "dirty_overflow" and overflow:
            failures.append(f"F: {name} overflowed its dirty buffer")
        log({"hash_group_case": name, "bytes": len(buf), "max_word_len": mwl,
             "extra": with_extra, "u_cap": u_cap,
             "n_tokens": int(sc[0]), "n_unique": nu,
             "group_overflow": overflow, "max_abs_err": d})
    return err, failures


def time_hash_group(buf, mwl: int, with_extra: bool, u_cap: int):
    """F (the whole ``hash_group``: two launches of F around B and C on the
    dirty rows) timed beside its plain version, its bound and the library
    yardstick, at one shape of the main path."""
    import torch
    from dsi_tpu_torch.ops import wordcount as w

    chunk = torch.from_numpy(buf).to(DEVICE)
    t = len(buf) // 4 + 1
    keys, lens, poslen, sc = w.tokenize(chunk, max_word_len=mwl, t_cap=t,
                                        with_poslen=True)
    fnv = w.fnv1a32_packed(keys, lens, mwl)
    extra = poslen if with_extra else None
    k64 = keys.shape[0]
    out = w.hash_group(keys, lens, fnv, sc[:1], u_cap, extra=extra)
    e = 4 if with_extra else 0
    nbytes = (t * (8 * k64 + 4 + 4 + e) + 4
              + u_cap * (8 * k64 + 4 + 8 + e) + 8)
    rows = keys.T
    return {
        "ms": cuda_ms(lambda: w.hash_group(keys, lens, fnv, sc[:1], u_cap,
                                           extra=extra), 20),
        "plain_ms": cuda_ms(lambda: w.hash_group_plain(
            keys, lens, fnv, sc[:1], u_cap, extra=extra), 3),
        # The same uniques and counts in sorted order, in one call; the
        # port never calls it.
        "library_ms": cuda_ms(lambda: torch.unique(
            rows, dim=0, return_counts=True), 5),
        "bytes": nbytes, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
        # Every launch of the call: F's four, B's and C's.
        **call_profile(lambda: w.hash_group(keys, lens, fnv, sc[:1], u_cap,
                                            extra=extra), "hg_reset"),
        "shape": (f"t={t} k64={k64} extra={with_extra} u_cap={u_cap} "
                  f"n_buckets={w.hash_group_shape(t)[0]} "
                  f"d_cap={w.hash_group_shape(t)[1]} "
                  f"n_unique={int(out[4])}")}


def check_pack6(corpus_buf):
    """Kernel G against its plain version and against the raw bytes on
    every case; returns (max_abs_err, the corpus case's tensors)."""
    import numpy as np
    import torch
    from dsi_tpu_torch.ops import corpus_wc as cw
    from dsi_tpu_torch.ops import wordcount as w

    rng = np.random.default_rng(SEED)
    cases = [("bench_corpus", corpus_buf),
             ("random_64_symbols", rng.choice(
                 np.arange(100, 164, dtype=np.uint8), 3 << 20)),
             ("one_byte", np.full(1 << 20, 0x61, np.uint8))]
    err, corpus_args = 0, None
    for name, buf in cases:
        wire, table = cw.pack6_encode(buf)
        pk = torch.from_numpy(wire).to(DEVICE)
        tb = torch.from_numpy(table).to(DEVICE)
        got = w.pack6_decode(pk, tb)
        d = _merge_err(_diff(got, w.pack6_decode_plain(pk, tb)),
                       _diff(got, torch.from_numpy(buf).to(DEVICE)))
        err = _merge_err(err, d)
        sync()
        log({"pack6_case": name, "bytes": len(buf), "max_abs_err": d})
        if corpus_args is None:
            corpus_args = (pk, tb)
    return err, corpus_args


def time_pack6(pk, tb):
    from dsi_tpu_torch.ops import wordcount as w

    n = pk.shape[0] // 3 * 4
    nbytes = pk.shape[0] + 64 + n
    return {"ms": cuda_ms(lambda: w.pack6_decode(pk, tb), 50),
            "plain_ms": cuda_ms(lambda: w.pack6_decode_plain(pk, tb), 5),
            "library_ms": None,  # no one PyTorch call decodes the codes
            "bytes": nbytes, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "shape": f"wire={pk.shape[0]} n={n}",
            **call_profile(lambda: w.pack6_decode(pk, tb), "pack6_decode")}


def mesh_fold_shapes(raws):
    """D, E, B and C as the mesh-sharded fold (K11) runs them on the
    stream at ``MESH_SHARDS`` virtual shards: a table holding one step of
    the eight files (one 2 MiB chunk per shard) and the next step, held
    against their plain versions and timed.  Returns {kernel: entry}."""
    import numpy as np
    import torch
    from dsi_tpu_torch.device import table as dt
    from dsi_tpu_torch.ops import wordcount as w
    from dsi_tpu_torch.ops.meshroute import route_dest
    from dsi_tpu_torch.parallel.shuffle import _slice_pack, mapreduce_step

    n_dev, k = MESH_SHARDS, MWL // 4
    buf = np.zeros((n_dev, STREAM_CHUNK), np.uint8)
    for i, raw in enumerate(raws[:n_dev]):
        buf[i, :len(raw)] = np.frombuffer(raw, np.uint8)
    out = mapreduce_step(torch.from_numpy(buf).to(DEVICE), n_dev=n_dev,
                         n_reduce=N_REDUCE, max_word_len=MWL,
                         u_cap=STREAM_U_CAP)
    packed = _slice_pack(*out[:4], mp=out[0].shape[1])
    scal = out[4]
    rows = packed.shape[1]
    opts = {"device": DEVICE}
    state = (torch.full((n_dev, rows, k), -1, dtype=torch.int32, **opts),
             torch.zeros((n_dev, rows), dtype=torch.int32, **opts),
             torch.zeros((n_dev, rows), dtype=torch.int64, **opts),
             torch.zeros((n_dev, rows), dtype=torch.int32, **opts),
             torch.zeros(n_dev, dtype=torch.int32, **opts))
    apply = torch.ones(n_dev, dtype=torch.bool, **opts)
    state = dt.mesh_fold_step(*state, packed, scal, apply,
                              n_shards=n_dev)[:5]

    skeys, slens, svalid = dt._route_operands(packed, scal)
    # D as route_dest launches it: the lanes as they lie, the rule fused.
    shapes = {"fnv": fnv_entry(skeys, slens, 4 * k, "mesh_fold route",
                               valid=svalid, n_part=n_dev, n_dest=n_dev,
                               park=n_dev)}
    dest = route_dest(skeys, slens, svalid, n_shards=n_dev,
                      park=n_dev).view(n_dev, rows)
    recv = w.shuffle_rows_plain(packed, dest, n_dev=n_dev, k=k)
    shapes["route"] = route_entry(packed, dest, n_dev, k,
                                  "mesh_fold exchange")

    # B and C on the busiest shard: its table rows and what it received.
    d = int(torch.argmax(state[4]))
    keys_d, cnts_d, lens_d, _ = dt._received_operands(
        state[0][d], state[1][d], state[2][d], state[3][d], recv[d], k)
    shapes.update(time_sort_group(keys_d, cnts_d, lens_d, rows,
                                  f"mesh_fold shard {d}"))
    return shapes


# ── phase 5: the streaming SPMD word count ───────────────────────────────


def oracle_counts(lines) -> dict:
    out = {}
    for ln in lines:
        word, _, c = ln.decode().rpartition(" ")
        out[word] = int(c)
    return out


def sharded_path(data: bytes, n_dev: int, workdir: str, oracle):
    """wordcount_sharded -> write_partitioned_output; (parity, seconds,
    launches)."""
    import glob

    from dsi_tpu_torch.ops import wordcount as w
    from dsi_tpu_torch.parallel.shuffle import (wordcount_sharded,
                                                write_partitioned_output)

    outdir = os.path.join(workdir, f"sharded-{n_dev}")
    os.makedirs(outdir)
    w.reset_launches()
    t0 = time.perf_counter()
    res = wordcount_sharded(data, n_dev=n_dev, n_reduce=N_REDUCE,
                            u_cap=SHARDED_U_CAP, device=DEVICE)
    sync()
    kernel_s = time.perf_counter() - t0
    launches = w.launch_counts()
    if res is None:
        raise RuntimeError(f"wordcount_sharded n_dev={n_dev} returned None")
    write_partitioned_output(res, N_REDUCE, outdir)
    lines = sorted_lines(sorted(glob.glob(os.path.join(outdir, "mr-out-*"))))
    return lines == oracle, kernel_s, launches


def stream_parity(counts: dict, want: dict, cycles: int) -> bool:
    return (len(counts) == len(want)
            and all(counts.get(w_, 0) == c * cycles
                    for w_, c in want.items()))


def stream_path(files, cycles: int, want: dict, device_accumulate: bool,
                n_dev: int = 1, mesh_shards: int = 0, wire_upload=None,
                blocks=None):
    """The stream row through ``wordcount_streaming``, the bench's input
    (``cycle_files``, or the ``blocks`` given) and window: the call alone,
    so the table off and on are timed alike; (parity, seconds, stats,
    launches, result)."""
    from dsi_tpu_torch.mr.sequential import ihash
    from dsi_tpu_torch.ops import wordcount as w
    from dsi_tpu_torch.parallel.streaming import (cycle_files,
                                                  wordcount_streaming)

    stats: dict = {}
    w.reset_launches()
    t0 = time.perf_counter()
    res = wordcount_streaming(cycle_files(files, cycles) if blocks is None
                              else blocks, n_dev=n_dev,
                              n_reduce=N_REDUCE, chunk_bytes=STREAM_CHUNK,
                              u_cap=STREAM_U_CAP,
                              device_accumulate=device_accumulate,
                              mesh_shards=mesh_shards, pipeline_stats=stats,
                              wire_upload=wire_upload, device=DEVICE)
    sync()
    seconds = time.perf_counter() - t0
    launches = w.launch_counts()
    if res is None:
        raise RuntimeError("the stream returned None (host path)")
    parity = (stream_parity({k: c for k, (c, _) in res.items()}, want,
                            cycles)
              and all(p == ihash(k) % N_REDUCE
                      for k, (_, p) in res.items()))
    return parity, seconds, stats, launches, res


def stream_cli_path(files, cycles: int, want: dict, workdir: str,
                    extra=(), outdir=None):
    """The stream row with the device table on, through the ``wcstream``
    CLI in-process (argument parsing, reading, the stream and writing
    ``mr-out-*`` into ``outdir``, default ``workdir/stream-cli``), with
    the ``extra`` arguments; (parity, seconds, stats, launches)."""
    import ast
    import contextlib
    import io

    from dsi_tpu_torch.cli import wcstream
    from dsi_tpu_torch.mr.sequential import ihash
    from dsi_tpu_torch.ops import wordcount as w

    outdir = outdir or os.path.join(workdir, "stream-cli")
    err = io.StringIO()
    w.reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(err):
        rc = wcstream.main(
            ["--device-accumulate", "--chunk-bytes", str(STREAM_CHUNK),
             "--u-cap", str(STREAM_U_CAP), "--nreduce", str(N_REDUCE),
             "--workdir", outdir, "--stats", "--device", DEVICE, *extra]
            + list(files) * cycles)
    sync()
    seconds = time.perf_counter() - t0
    launches = w.launch_counts()
    text = err.getvalue()
    if rc != 0 or "host path" in text:
        raise RuntimeError(f"wcstream rc={rc}: {text[-2000:]}")
    stats = ast.literal_eval(
        text.split("pipeline_stats=", 1)[1].splitlines()[0])
    counts, parts_ok = {}, True
    for r in range(N_REDUCE):
        with open(os.path.join(outdir, f"mr-out-{r}"), "rb") as f:
            for ln in f.read().split(b"\n"):
                if ln:
                    word, _, c = ln.decode().rpartition(" ")
                    counts[word] = int(c)
                    parts_ok = parts_ok and ihash(word) % N_REDUCE == r
    return (stream_parity(counts, want, cycles) and parts_ok, seconds,
            stats, launches, None)


# ── phase 5b: crash-resume checkpoints of the stream ────────────────────

CKPT_EVERY = 4
CKPT_STATS = ("ckpt_saves", "ckpt_deltas", "ckpt_s", "ckpt_capture_s",
              "ckpt_commit_s", "ckpt_barrier_s", "ckpt_full_bytes",
              "ckpt_delta_bytes", "ckpt_every", "ckpt_async", "ckpt_delta",
              "steps", "folds", "sync_pulls", "widens", "table_cap",
              "resume_gap_s", "resume_cursor", "resharded_resume")
FAULT_ENV = ("DSI_FAULT_MODE", "DSI_FAULT_POINT", "DSI_FAULT_STEP")
# The wave walks' checkpoint counters (the cursor a wave ordinal).
WAVE_CKPT = CKPT_STATS + ("resume_wave",)


@contextlib.contextmanager
def armed_fault(point: str, step: int):
    """``DSI_FAULT_POINT`` armed in this process in raise mode
    (``ckpt/fault.py``), and disarmed after."""
    from dsi_tpu_torch.ckpt import reset_faults

    reset_faults()
    os.environ.update({"DSI_FAULT_MODE": "raise", "DSI_FAULT_POINT": point,
                       "DSI_FAULT_STEP": str(step)})
    try:
        yield
    finally:
        for k in FAULT_ENV:
            os.environ.pop(k, None)
        reset_faults()


def ckpt_stream(files, cycles: int, ckdir: str, stats=None, *,
                device_accumulate: bool, **kw):
    """One call of the stream row with ``checkpoint_dir``, its
    ``pipeline_stats`` into ``stats``; (result, seconds, stats)."""
    from dsi_tpu_torch.parallel.streaming import (cycle_files,
                                                  wordcount_streaming)

    stats = {} if stats is None else stats
    t0 = time.perf_counter()
    try:
        res = wordcount_streaming(
            cycle_files(files, cycles), n_dev=1, n_reduce=N_REDUCE,
            chunk_bytes=STREAM_CHUNK, u_cap=STREAM_U_CAP,
            device_accumulate=device_accumulate, checkpoint_dir=ckdir,
            pipeline_stats=stats, device=DEVICE, **kw)
    finally:
        sync()
    return res, time.perf_counter() - t0, stats


def ckpt_rows(files, cycles: int, want: dict, nbytes: int, work: str, gpu,
              failures):
    """The stream row with checkpoints every ``CKPT_EVERY`` steps, table
    off and on, sync full and async delta, each call alone and right
    after the same stream without checkpoints: MB/s beside MB/s, the
    checkpoint's phase seconds and payload bytes."""
    rows = {}
    for dacc in (False, True):
        parity, plain_s, _, _, _ = stream_path(files, cycles, want, dacc)
        if not parity:
            failures.append(f"ckpt_plain dacc={dacc}: counts differ from "
                            "the oracle's")
        for mode, kw in (("sync_full", {}),
                         ("async_delta", {"checkpoint_async": True,
                                          "checkpoint_delta": True})):
            tag = f"ckpt_{'acc' if dacc else 'host'}_{mode}"
            res, secs, st = ckpt_stream(
                files, cycles, os.path.join(work, f"ck-{tag}"),
                device_accumulate=dacc, checkpoint_every=CKPT_EVERY, **kw)
            ok = res is not None and stream_parity(
                {k: c for k, (c, _) in res.items()}, want, cycles)
            rows[tag] = {"parity": ok, "seconds": secs,
                         "mb_per_s": nbytes / secs / 1e6,
                         "plain_seconds": plain_s,
                         "plain_mb_per_s": nbytes / plain_s / 1e6,
                         **{k: st[k] for k in CKPT_STATS if k in st}}
            log({tag: {**rows[tag], "gpu": gpu, "input_bytes": nbytes}})
            if not ok:
                failures.append(f"{tag}: counts differ from the oracle's")
            if st.get("ckpt_saves", 0) < 1:
                failures.append(f"{tag}: no checkpoint was saved")
            if kw and st.get("ckpt_deltas", 0) < 1:
                failures.append(f"{tag}: no delta checkpoint was saved")
    return rows


def ckpt_resume_path(tag, files, cycles: int, want: dict, work: str, *,
                     point: str, step: int, **kw):
    """The stream row with the table on, killed at ``point`` (raised, in
    process) on its ``step``-th occurrence, then resumed: launch counts
    zeroed before the crashed run and read after the resume; (entry,
    launches, failures)."""
    from dsi_tpu_torch.ckpt import FaultInjected
    from dsi_tpu_torch.mr.sequential import ihash
    from dsi_tpu_torch.ops import wordcount as w

    ckdir = os.path.join(work, f"ck-{tag}")
    fails = []
    w.reset_launches()
    crashed: dict = {}
    with armed_fault(point, step):
        try:
            ckpt_stream(files, cycles, ckdir, crashed,
                        device_accumulate=True, checkpoint_every=CKPT_EVERY,
                        **kw)
            fails.append(f"{tag}: the fault at {point} #{step} never fired")
        except FaultInjected:
            pass
    res, secs, st = ckpt_stream(files, cycles, ckdir, device_accumulate=True,
                                checkpoint_every=CKPT_EVERY, resume=True,
                                **kw)
    launches = w.launch_counts()
    parity = res is not None and stream_parity(
        {k: c for k, (c, _) in res.items()}, want, cycles) and all(
        p == ihash(k) % N_REDUCE for k, (_, p) in res.items())
    if not parity:
        fails.append(f"{tag}: resumed counts differ from the oracle's times "
                     f"{cycles}")
    if not st.get("resume_cursor"):
        fails.append(f"{tag}: the resume restored no checkpoint")
    entry = {"parity": parity, "seconds": secs, "fault": f"{point}#{step}",
             "crashed_steps": crashed.get("steps"),
             "crashed_ckpt_saves": crashed.get("ckpt_saves"),
             "crashed_ckpt_deltas": crashed.get("ckpt_deltas"),
             "launches": launches,
             **{k: st[k] for k in CKPT_STATS if k in st}}
    return entry, launches, fails


def ckpt_cli_path(files, cycles: int, want: dict, work: str):
    """``python -m dsi_tpu_torch.cli.wcstream`` with the table on and a
    checkpoint every ``CKPT_EVERY`` steps, killed for real at
    ``post-ckpt`` (``os._exit(87)``, its second commit) in a subprocess,
    then ``--resume`` through ``wcstream.main`` in this process; (entry,
    launches, failures)."""
    from dsi_tpu_torch.ckpt import FAULT_EXIT
    from dsi_tpu_torch.ops import wordcount as w

    ckdir = os.path.join(work, "ck-cli")
    outdir = os.path.join(work, "stream-ckpt-cli")
    ck_args = ["--checkpoint-dir", ckdir, "--checkpoint-every",
               str(CKPT_EVERY)]
    args = ["--device-accumulate", "--chunk-bytes", str(STREAM_CHUNK),
            "--u-cap", str(STREAM_U_CAP), "--nreduce", str(N_REDUCE),
            "--workdir", outdir, "--device", DEVICE, *ck_args]
    env = {k: v for k, v in os.environ.items() if k not in FAULT_ENV}
    env.update({"PYTHONPATH": REPO, "DSI_FAULT_POINT": "post-ckpt",
                "DSI_FAULT_STEP": "2"})
    fails = []
    w.reset_launches()
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, "-m", "dsi_tpu_torch.cli.wcstream",
                        *args, *(list(files) * cycles)], env=env,
                       capture_output=True, text=True, timeout=600)
    crash_s = time.perf_counter() - t0
    if p.returncode != FAULT_EXIT:
        fails.append(f"stream_ckpt_cli: the crashed run exited "
                     f"{p.returncode}, not {FAULT_EXIT}: "
                     f"{p.stderr[-1500:]}")
    parity, secs, st, _, _ = stream_cli_path(
        files, cycles, want, work, extra=ck_args + ["--resume"],
        outdir=outdir)
    launches = w.launch_counts()
    if not parity:
        fails.append("stream_ckpt_cli: mr-out-* differ from the oracle's "
                     f"times {cycles}")
    if not st.get("resume_cursor"):
        fails.append("stream_ckpt_cli: --resume restored no checkpoint")
    entry = {"parity": parity, "seconds": secs, "crash_seconds": crash_s,
             "crash_rc": p.returncode, "launches": launches,
             **{k: st[k] for k in CKPT_STATS if k in st}}
    return entry, launches, fails


def capture_copies(tab, reps: int = 3, tries: int = 4,
                   want: int = 2) -> list:
    """[(copy name, count)] of ``reps`` calls of ``tab.checkpoint_capture()``
    under ``torch.profiler``, windowed as :func:`_device_events` windows
    (a warm-up step, ``PROFILE_EDGE_S`` of idle at each edge), asked
    again until the window holds ``want`` copies a call."""
    from torch.profiler import ProfilerActivity, profile, schedule

    tab.checkpoint_capture()
    sync()
    copies = []
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            for _ in range(2):
                time.sleep(PROFILE_EDGE_S)
                for _ in range(reps):
                    tab.checkpoint_capture()
                sync()
                time.sleep(PROFILE_EDGE_S)
                prof.step()
        copies = [(e.key, e.count // reps) for e in prof.key_averages()
                  if e.key.startswith("Memcpy")]
        if sum(c for k, c in copies if "Device -> Pinned" in k) == want:
            break
    return copies


def ckpt_capture_check(raws):
    """The table's image captured on the card: two folds of the stream's
    steps, ``checkpoint_capture`` under ``torch.profiler`` (two copies a
    call, each ``Memcpy DtoH (Device -> Pinned)``), then one capture and
    a host copy of the live table at that instant, then a sync (which
    zeroes the live table in place), a fold and a sync before the image
    materializes: it must equal the host copy.  Returns (entry,
    failures)."""
    import numpy as np
    import torch

    from dsi_tpu_torch.device.table import DeviceTable
    from dsi_tpu_torch.parallel.merge import PackedCounts
    from dsi_tpu_torch.parallel.shuffle import _slice_pack, mapreduce_step

    steps = []
    for raw in raws[:3]:
        buf = np.zeros(STREAM_CHUNK, np.uint8)
        buf[:len(raw)] = np.frombuffer(raw, np.uint8)
        out = mapreduce_step(torch.from_numpy(buf).to(DEVICE)[None],
                             n_dev=1, n_reduce=N_REDUCE, max_word_len=MWL,
                             u_cap=STREAM_U_CAP)
        scal_np = out[4].cpu().numpy()
        if (scal_np[:, 3:].any() or int(scal_np[:, 1].max()) > STREAM_U_CAP
                or int(scal_np[:, 2].max()) > MWL):
            raise RuntimeError("a capture-check step did not clear rung 0")
        steps.append((_slice_pack(*out[:4], mp=out[0].shape[1]), out[4],
                      scal_np))
    tab = DeviceTable(1, kk=MWL // 4, cap=4 * int(steps[0][0].shape[1]),
                      acc=PackedCounts(), device=DEVICE, lag=1)
    tab.fold(*steps[0])
    tab.fold(*steps[1])
    copies = capture_copies(tab)
    t0 = time.perf_counter()
    deferred = tab.checkpoint_capture()
    capture_s = time.perf_counter() - t0
    # The table at the capture: a copy to the host (``.cpu()`` would
    # alias a CPU tensor, which the sync below zeroes in place).
    live = [x.to("cpu", copy=True) for x in tab._state]
    tab.sync()
    tab.fold(*steps[2])
    tab.sync()
    sync()
    t0 = time.perf_counter()
    img = deferred.materialize()
    materialize_s = time.perf_counter() - t0
    nrows = img["nrows"]
    n = int(nrows[0])
    keys, lens, cnts, parts, tn = (x.numpy() for x in live)
    equal = (n > 0 and int(tn[0]) == n
             and np.array_equal(img["keys"][0, :n], keys[0, :n].view(
                 np.uint32))
             and np.array_equal(img["lens"][0, :n], lens[0, :n])
             and np.array_equal(img["cnts"][0, :n], cnts[0, :n].view(
                 np.uint64))
             and np.array_equal(img["parts"][0, :n], parts[0, :n])
             and bool((img["keys"][0, n:] == 0xFFFFFFFF).all())
             and not img["cnts"][0, n:].any())
    cleared = int(tab.stats["sync_pulls"]) >= 2
    fails = []
    if not equal:
        fails.append("ckpt_capture: the image differs from the table at "
                     "the capture")
    if copies != [("Memcpy DtoH (Device -> Pinned)", 2)]:
        fails.append(f"ckpt_capture: a capture's copies a call are not two "
                     f"pinned D2H: {copies}")
    entry = {"image_equal": equal, "rows": n, "cap": tab.cap,
             "syncs_after_capture": cleared, "copies": copies,
             "capture_s": capture_s, "materialize_s": materialize_s,
             "image_bytes": sum(int(v.nbytes) for v in img.values())}
    tab.close()
    return entry, fails


GREP_PHASES = ("batch_s", "batch_wait_s", "upload_s", "dispatch_s",
               "kernel_s", "pull_s", "merge_s", "replay_s", "fold_s",
               "sync_s", "widen_s", "hist_s", "steps", "replays", "l_cap",
               "step_pulls", "sync_pulls", "folds", "fold_overflows",
               "widens", "table_cap", "topk_snapshots", "hist_folds",
               "hist_pulls", "pull_bytes", "mesh_shards", "shard_widens",
               "shard_imbalance", "max_inflight_chunks", "batch_allocs")
STREAM_PHASES = ("batch_s", "batch_wait_s", "upload_s", "dispatch_s",
                 "kernel_s", "pull_s", "merge_s", "replay_s", "fold_s",
                 "sync_s", "widen_s", "finalize_s",
                 "steps", "replays", "step_pulls", "folds",
                 "fold_overflows", "sync_pulls", "widens", "table_cap",
                 "max_inflight_chunks", "batch_allocs", "mesh_shards",
                 "shard_widens", "shard_imbalance", "pull_bytes")



# ── phase 8: grep ────────────────────────────────────────────────────────


def grep_tiers_path(raw0: bytes):
    """``cuda_map`` (the four tiers, tier 4 pinned to the kernel) on one
    bench file for every pattern of ``GREP_PATTERNS``, then on a short-line
    input that overflows rung 0, each against the host ``Map``.  Returns
    ({pattern: entry}, launches, failures)."""
    from dsi_tpu_torch.apps.cuda_grep import cuda_map
    from dsi_tpu_torch.apps.grep import Map
    from dsi_tpu_torch.ops import wordcount as w
    from dsi_tpu_torch.slice_profile import env_set

    short = b"a\nthe\nb\n" * (1 << 16)  # 2.7-byte lines: rung 0 overflows
    cases = [(p, raw0) for p in GREP_PATTERNS] + [("the", short)]
    out, failures = {}, []
    w.reset_launches()
    with env_set(DSI_NFA_DISPATCH="device"):
        for i, (pattern, data) in enumerate(cases):
            tag = pattern if i < len(GREP_PATTERNS) else "short_lines the"
            before = w.launch_counts()
            with env_set(DSI_GREP_PATTERN=pattern):
                t0 = time.perf_counter()
                got = cuda_map("pg-00.txt", data, device=DEVICE)
                sync()
                secs = time.perf_counter() - t0
                t0 = time.perf_counter()
                want = Map("pg-00.txt", data.decode())
                host_s = time.perf_counter() - t0
            out[tag] = {"matched_lines": len(want), "parity": got == want,
                        "seconds": secs, "host_map_s": host_s,
                        "launches": {k: w.LAUNCHES[k] - before[k]
                                     for k in ("grep", "nfa")}}
            if got != want:
                failures.append(f"grep_tiers: cuda_map {tag!r} differs "
                                "from the host Map")
    launches = w.launch_counts()
    if out["short_lines the"]["launches"]["grep"] != 2:
        failures.append("grep_tiers: the short-line input did not overflow "
                        "rung 0 and clear at n+1")
    if out["the|and"]["launches"]["grep"] != 1:  # one rung, both branches
        failures.append("grep_tiers: 'the|and' took "
                        f"{out['the|and']['launches']['grep']} H launches, "
                        "not one a rung")
    return out, launches, failures


def grep_stream_path(files, cycles: int, want, *, device_accumulate: bool,
                     n_dev: int = 1, mesh_shards: int = 0):
    """The bench's grep row through ``grep_streaming``, the call alone
    timed; (result, seconds, stats, launches, parity)."""
    from dsi_tpu_torch.ops import wordcount as w
    from dsi_tpu_torch.parallel.grepstream import grep_streaming
    from dsi_tpu_torch.parallel.streaming import cycle_files

    stats: dict = {}
    w.reset_launches()
    t0 = time.perf_counter()
    res = grep_streaming(cycle_files(files, cycles), GREP_PATTERN,
                         n_dev=n_dev, chunk_bytes=GREP_CHUNK,
                         device_accumulate=device_accumulate,
                         mesh_shards=mesh_shards, pipeline_stats=stats,
                         device=DEVICE)
    sync()
    seconds = time.perf_counter() - t0
    return res, seconds, stats, w.launch_counts(), res == want


def grep_cli_path(files, cycles: int, extra=()):
    """``python -m dsi_tpu_torch.cli.grepstream --check`` in-process over
    the same input, table on, with the ``extra`` arguments; (seconds,
    stats, launches, stdout)."""
    import ast
    import io

    from dsi_tpu_torch.cli import grepstream
    from dsi_tpu_torch.ops import wordcount as w

    out, err = io.StringIO(), io.StringIO()
    w.reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = grepstream.main(
            ["--pattern", GREP_PATTERN, "--chunk-bytes", str(GREP_CHUNK),
             "--device-accumulate", "--check", "--stats", "--device",
             DEVICE, *extra] + list(files) * cycles)
    sync()
    seconds = time.perf_counter() - t0
    text = err.getvalue()
    if rc != 0 or "parity OK" not in text:
        raise RuntimeError(f"grepstream rc={rc}: {text[-2000:]}")
    stats = ast.literal_eval(
        text.split("pipeline_stats=", 1)[1].splitlines()[0])
    return seconds, stats, w.launch_counts(), out.getvalue()


def grep_cli_text(res) -> str:
    """What ``grepstream`` prints on stdout for the result ``res``: the
    text a CLI run's output is held against."""
    return "".join([f"lines={res.lines} matched={res.matched} "
                    f"occurrences={res.occurrences}\n",
                    "hist=" + ",".join(str(h) for h in res.hist) + "\n",
                    *(f"top line={ln} occ={occ}\n" for ln, occ in res.topk)])


def nfa_calibration(gpu: str):
    """``calibrate_tier4`` in every state bucket on the card: host ``re``
    MB/s against kernel I's (the evidence the tier-4 gate waits for), one
    line a bucket."""
    from dsi_tpu_torch.ops.nfak import calibrate_tier4

    out = {}
    for s in (16, 32, 48):
        out[s] = calibrate_tier4(s, device=DEVICE)
        log({"nfa_calibration": {"s_bucket": s, **out[s],
                                 "kernel_wins": out[s]["kernel_mbps"]
                                 > out[s]["host_mbps"], "gpu": gpu}})
    return out


def nfa_profile(chunk, table, v0, l_cap: int) -> dict:
    """Kernel I's CUDA launches a call and device time (``call_profile``),
    with the device time of each phase: ``nfa_prep``, then the scan run
    to its phase 1 (block relations and in-group prefixes), 2 (the
    look-back over groups and the block entries) and 3 (the re-walk and
    the mask) read by difference, then H's epilogue.  Raises above
    NFA_MOST_LAUNCHES."""
    from dsi_tpu_torch.ops import nfak

    def events(phases):
        return _device_events(lambda: nfak.nfa_launch(
            chunk, table, v0, l_cap, phases), 20, "nfa_scan")

    full = events(3)
    prof = _launch_summary(full, 20)
    if prof["launches_per_call"] is None:
        raise RuntimeError("nfa: torch.profiler kept no whole window of "
                           "calls, so the launches a call are unknown")
    if prof["launches_per_call"] > NFA_MOST_LAUNCHES:
        raise RuntimeError(f"nfa: {prof['launches_per_call']} CUDA launches "
                           f"a call, the design allows {NFA_MOST_LAUNCHES}")
    part = [events(1), events(2), full]

    def dev(evs, key):
        if evs is None:
            return None
        return sum(t for k, _, t in evs if key in k) / 1e3 / 20

    scan = [dev(e, "nfa_scan") for e in part]
    if None in scan:
        raise RuntimeError("nfa: torch.profiler kept no whole window of "
                           "the scan run to one of its phases")
    prof["device_ms_by_phase"] = {
        "prep": dev(full, "nfa_prep"), "relations": scan[0],
        "prefix": scan[1] - scan[0], "walk": scan[2] - scan[1],
        "epilogue": prof["device_ms"] - dev(full, "nfa_")}
    return prof


def check_nfa_edges():
    """Kernel I against ``nfa_kernel_plain`` on the shared edge cases
    (``kernel_cases.nfa_cases``, the CPU tests' cases) at I's own group
    (``dsi_nfa_group_bytes``), one case also from a chunk 5 bytes past a
    16-byte boundary (no vector loads or stores).  Returns max_abs_err."""
    import numpy as np
    import torch
    from dsi_tpu_torch.kernels.build import library
    from dsi_tpu_torch.ops import nfak
    from dsi_tpu_torch.utils.kernel_cases import nfa_cases

    group = library().dsi_nfa_group_bytes()
    cases = nfa_cases(group)
    cases.append((f"{cases[-1][0]}_offset_5", *cases[-1][1:]))
    worst = 0
    for name, buf, pattern, bucket, l_cap in cases:
        table, v0 = nfak._build_table(*nfak.parse_nfa_pattern(pattern))
        t = torch.from_numpy(table).to(DEVICE)
        v = torch.from_numpy(v0).to(DEVICE)
        chunk = torch.from_numpy(np.ascontiguousarray(buf)).to(DEVICE)
        if name.endswith("_offset_5"):
            flat = torch.zeros(chunk.numel() + 5, dtype=torch.uint8,
                               device=DEVICE)[5:]
            flat.copy_(chunk)
            chunk = flat
        d = _worst(zip(nfak.nfa_kernel(chunk, t, v, l_cap=l_cap),
                       nfak.nfa_kernel_plain(chunk, t, v, l_cap=l_cap)))
        sync()
        worst = _merge_err(worst, d)
        log({"nfa_edge_case": name, "n": len(buf), "s_bucket": bucket,
             "group": group, "l_cap": l_cap, "max_abs_err": d})
    return worst


def check_hgrep_edges(raw0: bytes):
    """Kernel H against its plain version (``altk.altgrep_kernel_plain``,
    per branch, OR-ed) on the shared edge cases
    (``kernel_cases.hgrep_cases``, the CPU tests' cases) at H's own tile
    (``dsi_grep_tile_bytes``), each also from a chunk 5 bytes past a
    16-byte boundary and cut to an odd length; on the bench file padded
    to 2^21 with literal, class and alternation patterns (one a literal
    past the word, two of 8 and 24 bytes on the 32-byte warm-up); and its
    mask entry (``dsi_line_flags_prezeroed``, kernel I's) on
    ``kernel_cases.line_flag_cases`` against ``line_flags_from_match``.
    Returns max_abs_err."""
    import numpy as np
    import torch
    from dsi_tpu_torch.kernels.build import library
    from dsi_tpu_torch.ops import altk, grepk, regexk
    from dsi_tpu_torch.ops import wordcount as w
    from dsi_tpu_torch.utils.kernel_cases import (hgrep_cases,
                                                  line_flag_cases)

    lib = library()
    tile = lib.dsi_grep_tile_bytes()
    bench = w._pad_pow2(raw0)
    cases = hgrep_cases(tile) + [
        (f"bench {p}", bench, b, len(bench) // 8) for p, b in (
            ("the", (grepk.literal_branch(b"the"),)),
            ("[Tt]he|^a|s$", tuple(regexk.parse_class_pattern(q)
                                   for q in ("[Tt]he", "^a", "s$"))),
            ("literal of 8", (grepk.literal_branch(raw0[2000:2008]),)),
            ("literal of 24", (grepk.literal_branch(raw0[3000:3024]),)),
            ("literal of 36", (grepk.literal_branch(raw0[1000:1036]),)))]
    worst = 0
    for name, buf, branches, l_cap in cases:
        for off, cut in ((0, 0), (5, 0), (5, 3)):
            n = len(buf) - cut
            chunk = torch.zeros(n + off, dtype=torch.uint8,
                                device=DEVICE)[off:]
            chunk.copy_(torch.from_numpy(np.ascontiguousarray(buf[:n])))
            d = _worst(zip(altk.altgrep_kernel(chunk, branches, l_cap=l_cap),
                           altk.altgrep_kernel_plain(chunk, branches,
                                                     l_cap=l_cap)))
            sync()
            worst = _merge_err(worst, d)
            log({"hgrep_edge_case": name, "n": n, "offset": off,
                 "tile": tile, "branches": len(branches),
                 "calls": len(grepk.pack_branches(branches)),
                 "l_cap": l_cap, "max_abs_err": d})
    for name, buf, mask, l_cap in line_flag_cases(tile):
        n = len(buf)
        chunk = torch.from_numpy(buf).to(DEVICE)
        mk = torch.from_numpy(mask).to(DEVICE)
        # dsi_grep's buffer: flags, scalars, then the look-back state
        # (zeroed here, as nfa_prep zeroes it for kernel I) at its end.
        size = lib.dsi_grep_bytes(n, l_cap)
        out = torch.zeros(size, dtype=torch.uint8, device=DEVICE)
        at = size - lib.dsi_grep_scratch_bytes(n)
        w._launch("grep", lib.dsi_line_flags_prezeroed(
            w._ptr(chunk), n, w._ptr(mk), l_cap, w._ptr(out),
            w._ptr(out) + 4 * l_cap, w._ptr(out) + at, w._stream(chunk)))
        got = out[:4 * (l_cap + 2)].view(torch.int32)
        want = grepk.line_flags_from_match(chunk, mk != 0, l_cap)
        d = _worst(zip((got[:l_cap], got[l_cap], got[l_cap + 1] != 0),
                       want))
        sync()
        worst = _merge_err(worst, d)
        log({"line_flags_edge_case": name, "n": n, "tile": tile,
             "l_cap": l_cap, "max_abs_err": d})
    return worst


def grep_kernel_rows(raw0: bytes, stream_raw: bytes):
    """H, I, J and B at the grep paths' shapes, each held against its
    plain version on the same device tensors and timed beside it; H's rows
    (`the`, `[Tt]he`, `the|and`) fail above H_MOST_LAUNCHES CUDA launches
    or H_MOST_ALLOCS allocations a call, on any Memcpy, or unmeasured.
    Returns ({kernel: entry with at_shapes}, the top-k row, {kernel:
    max_abs_err}, failures)."""
    import numpy as np
    import torch
    from dsi_tpu_torch.ops import altk, grepk, nfak, regexk
    from dsi_tpu_torch.ops import wordcount as w
    from dsi_tpu_torch.parallel.grepstream import (grep_step,
                                                   grep_step_plain)

    buf = w._pad_pow2(raw0)
    n = len(buf)
    l_cap = grepk.line_cap_rungs(n)[0]
    chunk = torch.from_numpy(buf).to(DEVICE)

    def entry(fn, plain, nbytes, shape, reps=20, ops=None, anchor=None):
        err = _worst(zip(fn(), plain()))
        e = {"max_abs_err": err, "ms": cuda_ms(fn, reps),
             "plain_ms": cuda_ms(plain, 3), "library_ms": None,
             "bytes": nbytes, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
             "bound_by": "bytes", "shape": shape}
        if anchor is not None:  # the call's CUDA launches and device time
            e.update(call_profile(fn, anchor))
        if ops is not None:
            e["ops"] = ops
            ops_ms = ops / INT32_OPS_PER_S * 1e3
            if ops_ms > e["bound_ms"]:
                e["bound_ms"], e["bound_by"] = ops_ms, "operations"
        return e

    flags_bytes = n + 4 * l_cap + 8
    failures = []

    def h_entry(fn, plain, shape):
        e = entry(fn, plain, flags_bytes, shape)
        e.update(wrapper_profile(fn, "grep_lines"))
        tag = f"grep {shape}"
        failures.extend(over_budget(tag, e, H_MOST_LAUNCHES, H_MOST_ALLOCS)
                        + unmeasured(tag, e, ("launches_per_call",
                                              "copies_per_call",
                                              "allocs_per_call")))
        if e["copies_per_call"]:
            failures.append(f"{tag}: {e['copies_per_call']} Memcpys a call")
        return e

    rows = {"grep": h_entry(
        lambda: grepk.grep_kernel(chunk, b"the", l_cap=l_cap),
        lambda: grepk.grep_kernel_plain(chunk, b"the", l_cap=l_cap),
        f"literal 'the': n={n} l_cap={l_cap}")}
    ranges, a_s, a_e = regexk.parse_class_pattern("[Tt]he")
    kw = dict(ranges=ranges, anchor_start=a_s, anchor_end=a_e, l_cap=l_cap)
    alt = (grepk.literal_branch(b"the"), grepk.literal_branch(b"and"))
    rows["grep"]["at_shapes"] = {
        "class": h_entry(
            lambda: regexk.classgrep_kernel(chunk, **kw),
            lambda: regexk.classgrep_kernel_plain(chunk, **kw),
            f"class '[Tt]he' (K14): n={n} l_cap={l_cap}"),
        "alternation": h_entry(
            lambda: altk.altgrep_kernel(chunk, alt, l_cap=l_cap),
            lambda: altk.altgrep_kernel_plain(chunk, alt, l_cap=l_cap),
            f"alternation 'the|and' (K13 x 2, OR-ed): n={n} l_cap={l_cap}")}

    nfa = {}
    for s, pat in NFA_PATTERNS.items():
        table, v0 = nfak._build_table(*nfak.parse_nfa_pattern(pat))
        t = torch.from_numpy(table).to(DEVICE)
        v = torch.from_numpy(v0).to(DEVICE)
        # Bit-set work: at least one row lookup and one 64-bit OR (two
        # 32-bit operations) a state row a byte in phase 1, one a byte in
        # phase 3.
        nfa[s] = entry(
            lambda: nfak.nfa_kernel(chunk, t, v, l_cap=l_cap),
            lambda: nfak.nfa_kernel_plain(chunk, t, v, l_cap=l_cap),
            flags_bytes + 256 * s * s * 4 + 4 * s,
            f"S={s} {pat!r}: n={n} l_cap={l_cap}", ops=2 * n * (s + 1))
        nfa[s].update(nfa_profile(chunk, t, v, l_cap))
    rows["nfa"] = nfa[16]
    rows["nfa"]["at_shapes"] = {f"S={s}": nfa[s] for s in (32, 48)}

    steps = {}
    for n_dev in (1, 8):
        b = np.zeros((n_dev, GREP_CHUNK), np.uint8)
        lens = np.zeros(n_dev, np.int32)
        rest = stream_raw
        for r in range(n_dev):
            cut = rest.rfind(b"\n", 0, GREP_CHUNK) + 1
            b[r, :cut] = np.frombuffer(rest[:cut], np.uint8)
            lens[r] = cut
            rest = rest[cut:]
        ch = torch.from_numpy(b).to(DEVICE)
        pats = torch.from_numpy(np.tile(np.frombuffer(
            GREP_PATTERN.encode(), np.uint8), (n_dev, 1))).to(DEVICE)
        dl = torch.from_numpy(lens).to(DEVICE)
        bases = torch.zeros(n_dev, dtype=torch.int64, device=DEVICE)
        lc = GREP_CHUNK // 8
        kw = dict(l_cap=lc, bins=8, k=16)
        steps[n_dev] = entry(
            lambda: grep_step(ch, pats, dl, bases, **kw),
            lambda: grep_step_plain(ch, pats, dl, bases, **kw),
            n_dev * (GREP_CHUNK + 3 + 4 + 8 + 4 * (11 + 80 + 5)),
            f"n_dev={n_dev} N={GREP_CHUNK} l_cap={lc} k=16")
        steps[n_dev].update(j_profile(
            lambda: grep_step(ch, pats, dl, bases, **kw), False))
    rows["grep_step"] = steps[1]
    rows["grep_step"]["at_shapes"] = {"n_dev=8": steps[8]}

    # B as the top-k snapshot runs it: the candidate table at its rung-0
    # capacity (16,384 rows) holding one stream's 128 candidate rows.
    cap, occ = 1 << 14, 128
    words = topk_words(cap, occ)
    word0 = words[0].clone()
    topk = entry(lambda: w.radix_sort(words),
                 lambda: w.radix_sort_plain(words),
                 2 * 8 * 3 * cap + 4 * cap,
                 f"topk: t={cap} k64=3 occupied={occ}")
    topk["library_ms"] = cuda_ms(lambda: torch.sort(word0, stable=True), 20)
    topk.update(b_row_extras(words, topk["library_ms"]))
    errs = {name: _merge_err(rows[name]["max_abs_err"], _worst_err(rows[name]))
            for name in rows}
    return rows, topk, errs, failures


def check_grep_edges():
    """J, with and without its emit epilogue, against ``grep_step_plain``
    on the shared edge cases (``dsi_tpu_torch/utils/kernel_cases.py
    grep_cases``, the CPU tests' cases) at kernel J's own tiles
    (``dsi_grep_step_tile_bytes``, ``dsi_grep_step_line_tile``): each case
    at 8 shards and each of its rows alone, one case also from rows 5
    bytes past a 16-byte boundary (no vector loads).  Returns (J's, the
    emit's) max_abs_err."""
    import numpy as np
    import torch
    from dsi_tpu_torch.kernels.build import library
    from dsi_tpu_torch.parallel.grepstream import grep_step, grep_step_plain
    from dsi_tpu_torch.utils.kernel_cases import (GREP_BINS, GREP_K,
                                                  grep_cases)

    lib = library()
    tb, lt = lib.dsi_grep_step_tile_bytes(), lib.dsi_grep_step_line_tile()
    cases = grep_cases(tb, lt)
    cases.append((f"{cases[0][0]}_offset_5", *cases[0][1:]))
    j_err = e_err = 0
    for name, chunks, pats, dlen, bases, l_cap in cases:
        kw = dict(l_cap=l_cap, bins=GREP_BINS, k=GREP_K)
        d_j = d_e = 0
        for rows in [slice(0, 8)] + [slice(r, r + 1) for r in range(8)]:
            ch, p, d, b = (torch.from_numpy(np.ascontiguousarray(x[rows]))
                           .to(DEVICE) for x in (chunks, pats, dlen, bases))
            if name.endswith("_offset_5"):
                flat = torch.zeros(ch.numel() + 5, dtype=torch.uint8,
                                   device=DEVICE)[5:]
                flat.copy_(ch.reshape(-1))
                ch = flat.view(ch.shape)
            d_j = _merge_err(d_j, _worst(zip(
                grep_step(ch, p, d, b, **kw),
                grep_step_plain(ch, p, d, b, **kw))))
            d_e = _merge_err(d_e, _worst(zip(
                grep_step(ch, p, d, b, emit=True, **kw),
                grep_step_plain(ch, p, d, b, emit=True, **kw))))
        sync()
        j_err, e_err = _merge_err(j_err, d_j), _merge_err(e_err, d_e)
        log({"grep_edge_case": name, "N": chunks.shape[1], "tile": tb,
             "line_tile": lt, "m": pats.shape[1], "l_cap": l_cap,
             "max_abs_err": d_j, "emit_max_abs_err": d_e})
    return j_err, e_err


def j_profile(fn, emit: bool) -> dict:
    """``call_profile`` of one call of kernel J (with its emit epilogue
    when ``emit``), with each kernel's device time by name.  Raises when a
    call takes more CUDA launches than the design's bound: 3 without emit,
    4 with it, memsets included."""
    events = _device_events(fn, 20, "gs_sweep")
    prof = {**_launch_summary(events, 20), "device_ms_by_kernel": None}
    if events is not None:
        prof["device_ms_by_kernel"] = {
            next((n for n in ("gs_sweep", "gs_lines") if n in k), k[:40]):
            t / 1e3 / 20 for k, _, t in events}
    most = 4 if emit else 3
    if prof["launches_per_call"] is not None \
            and prof["launches_per_call"] > most:
        raise RuntimeError(f"grep_step (emit={emit}): "
                           f"{prof['launches_per_call']} CUDA launches a "
                           f"call, the design allows {most}")
    return prof


def _worst_err(row) -> int:
    err = 0
    for v in row.get("at_shapes", {}).values():
        err = _merge_err(err, v["max_abs_err"])
    return err


# ── phase 9: TF-IDF ──────────────────────────────────────────────────────


TFIDF_PHASES = ("materialize_s", "materialize_wait_s", "upload_s",
                "dispatch_s", "kernel_s", "pull_s", "merge_s", "replay_s",
                "append_s", "drain_s", "waves", "depth", "replays",
                "max_inflight_waves", "step_pulls", "appends",
                "append_overflows", "sync_pulls", "postings_widens",
                "pull_bytes", "sync_every", "mesh_shards")


def tfidf_oracle(files, workdir) -> list:
    """The sequential TF-IDF oracle's ``mr-out-0`` lines over ``files``."""
    from dsi_tpu_torch.apps import tfidf
    from dsi_tpu_torch.mr.sequential import run_sequential

    old = os.environ.get("DSI_TFIDF_NDOCS")
    os.environ["DSI_TFIDF_NDOCS"] = str(len(files))
    try:
        out = run_sequential(tfidf.Map, tfidf.Reduce, files,
                             os.path.join(workdir, "tfidf-correct.txt"))
    finally:
        if old is None:
            os.environ.pop("DSI_TFIDF_NDOCS", None)
        else:
            os.environ["DSI_TFIDF_NDOCS"] = old
    return sorted_lines([out])


def tfidf_path(files, workdir, tag, oracle, tokens, **kw):
    """The bench's TF-IDF row (``FileDocs`` over ``files``, u_cap 2^15,
    packed) through ``tfidf_sharded(**kw)``, the call alone timed, then
    ``write_tfidf_output``; returns (entry, launches, failures)."""
    import glob

    import numpy as np
    from dsi_tpu_torch.ops import wordcount as w
    from dsi_tpu_torch.parallel.tfidf import (FileDocs, tfidf_sharded,
                                              write_tfidf_output)

    docs = FileDocs(files)
    stats: dict = {}
    w.reset_launches()
    t0 = time.perf_counter()
    res = tfidf_sharded(docs, n_reduce=N_REDUCE, u_cap=TFIDF_U_CAP,
                        packed=True, wave_stats=stats, device=DEVICE, **kw)
    sync()
    seconds = time.perf_counter() - t0
    launches = w.launch_counts()
    if res is None:
        raise RuntimeError(f"{tag}: tfidf_sharded fell back to the host")
    got_tokens = int(res.tfs.astype(np.int64).sum())
    outdir = os.path.join(workdir, tag)
    os.makedirs(outdir)
    t0 = time.perf_counter()
    write_tfidf_output(res.to_dict(), files, N_REDUCE, outdir)
    write_s = time.perf_counter() - t0
    lines = sorted_lines(sorted(glob.glob(os.path.join(outdir, "mr-out-*"))))
    nbytes = sum(docs.lengths)
    entry = {"parity": lines == oracle, "tokens": got_tokens,
             "token_invariant": got_tokens == tokens, "words": len(res),
             "postings": res.n_postings, "seconds": seconds,
             "write_s": write_s, "input_bytes": nbytes,
             "mb_per_s": nbytes / seconds / 1e6, "launches": launches,
             "wave_stats": {k: stats[k] for k in TFIDF_PHASES + WAVE_CKPT
                            if k in stats}}
    failures = []
    if lines != oracle:
        failures.append(f"{tag}: mr-out-* differ from the TF-IDF oracle")
    if got_tokens != tokens:
        failures.append(f"{tag}: the sum of tf {got_tokens} is not the "
                        f"oracle's token count {tokens}")
    return entry, launches, failures, res


def check_compact_edges() -> int:
    """L against its plain version at its own tile's edges
    (``dsi_compact_tile_rows``): one row, one tile, one tile + 1, 128 tiles
    + 1, 1,024 tiles + 1 (a block of two tiles), all rows valid, none or some,
    both pad tests, a 64-byte row and rows wider than the stage (copied
    unstaged); one case from a base 4 bytes off a 16-byte boundary.
    Returns max_abs_err."""
    import numpy as np
    import torch
    from dsi_tpu_torch.kernels.build import library
    from dsi_tpu_torch.ops.meshroute import compact_rows, compact_rows_plain

    rng = np.random.default_rng(SEED)
    err = 0
    for n_dev, w, many in ((1, 8, 1024), (3, 8, 128), (2, 20, 128),
                           (1, 5000, 2)):
        tile = int(library().dsi_compact_tile_rows(n_dev, 1 << 16, w))
        for r in sorted({1, 64, 65, tile, tile + 1, many * tile + 1}):
            for frac in (0.0, 1.0, 0.5):
                x = rng.integers(0, 1 << 31, (n_dev, r, w)).astype(np.int32)
                pad = rng.random((n_dev, r)) < frac
                x[pad, :2] = -1
                x[~pad & (rng.random((n_dev, r)) < 0.2), 0] = -1
                rows = torch.from_numpy(x).to(DEVICE)
                for lanes in (1, 2):
                    err = _merge_err(err, _worst(zip(
                        compact_rows(rows, pad_lanes=lanes),
                        compact_rows_plain(rows, pad_lanes=lanes))))
    flat = torch.from_numpy(rng.integers(0, 1 << 31, 4097 * 8 + 1).astype(
        np.int32)).to(DEVICE)
    flat[1::16] = -1  # every other row a pad row (its lanes 0 and 1)
    flat[2::16] = -1
    off = flat[1:].view(1, 4097, 8)
    return _merge_err(err, _worst(zip(compact_rows(off, pad_lanes=2),
                                      compact_rows_plain(off, pad_lanes=2))))


def tfidf_kernel_rows(raws, failures):
    """L and M at the TF-IDF wave's shapes, each held against its plain
    version on the same device tensors and timed beside it, with its CUDA
    launches, allocations and device time a call (L at most 2 launches, M
    1, each one allocation).  Returns ({kernel: entry with at_shapes},
    {kernel: max_abs_err})."""
    import numpy as np
    import torch
    from dsi_tpu_torch.device.postings import (postings_append,
                                               postings_append_plain)
    from dsi_tpu_torch.ops import wordcount as w
    from dsi_tpu_torch.ops.meshroute import compact_rows, compact_rows_plain
    from dsi_tpu_torch.parallel.tfidf import _wave_chunk, wave_received

    size = 1 << max(8, max(len(r) for r in raws).bit_length())

    def received(n_dev, mwl):
        chunks = torch.from_numpy(_wave_chunk(raws, range(n_dev), n_dev,
                                              size)).to(DEVICE)
        ids = torch.arange(n_dev, dtype=torch.int32, device=DEVICE)
        cap = w.rung0_cap(size, TFIDF_U_CAP)
        recv, _ = wave_received(chunks, ids, n_dev=n_dev, n_reduce=N_REDUCE,
                                max_word_len=mwl, u_cap=cap)
        return recv

    def l_entry(rows, pad_lanes, shape, reps=20):
        err = _worst(zip(compact_rows(rows, pad_lanes=pad_lanes),
                         compact_rows_plain(rows, pad_lanes=pad_lanes)))
        flag = (rows[..., :pad_lanes] == -1).all(-1).to(torch.int8)
        nbytes = 2 * rows.numel() * 4 + 4 * rows.shape[0]
        prof = wrapper_profile(lambda: compact_rows(rows,
                                                    pad_lanes=pad_lanes),
                               "compact_write")
        failures.extend(over_budget(f"compact {shape}", prof, 2, 1))
        return {"max_abs_err": err,
                "ms": cuda_ms(lambda: compact_rows(rows,
                                                   pad_lanes=pad_lanes), reps),
                "plain_ms": cuda_ms(lambda: compact_rows_plain(
                    rows, pad_lanes=pad_lanes), 3),
                # One stable argsort of the pad flag plus the gather.
                "library_ms": cuda_ms(lambda: torch.gather(
                    rows, 1, torch.argsort(flag, dim=1, stable=True)[
                        ..., None].expand_as(rows)), reps),
                "bytes": nbytes, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                "bound_by": "bytes", "shape": shape, **prof}

    def l_rounds(rows, pad_lanes, reps=20):
        """Three rounds of L and its library pair at one shape, with L's
        device time from the profiler: to tell L from the wrapper."""
        flag = (rows[..., :pad_lanes] == -1).all(-1).to(torch.int8)

        def lib():
            return torch.gather(rows, 1, torch.argsort(
                flag, dim=1, stable=True)[..., None].expand_as(rows))

        def l_fn():
            return compact_rows(rows, pad_lanes=pad_lanes)

        return [{"ms": cuda_ms(l_fn, reps), "library_ms": cuda_ms(lib, reps),
                 "device_ms": device_ms(l_fn, reps, "compact_")}
                for _ in range(3)]

    edge_err = check_compact_edges()

    recv1, recv8, recv64 = received(1, MWL), received(8, MWL), received(1, 64)
    lane0 = recv1.clone()
    n0 = int((lane0[0, :, 0] != -1).sum())
    lane0[0, 1:n0:97, 0] = -1  # lane 0 alone all ones: pad for this test
    rng = np.random.default_rng(SEED)
    mixed = recv1[:, torch.from_numpy(rng.permutation(recv1.shape[1])).to(
        DEVICE)].contiguous()
    rows_l = {"n_dev=1": l_entry(recv1, 2, f"[1, {recv1.shape[1]}, 8] "
                                           "pad_lanes 2")}
    rows_l["n_dev=1"]["at_shapes"] = {
        "n_dev=8": l_entry(recv8, 2, f"[8, {recv8.shape[1]}, 8]", 10),
        "mwl64": l_entry(recv64, 2, f"[1, {recv64.shape[1]}, 20]"),
        "interleaved": l_entry(mixed, 2, "n_dev=1 rows permuted"),
        "received_lane0": l_entry(lane0, 1, "n_dev=1 pad_lanes 1 with "
                                            "lane-0-only rows")}
    rows_l["n_dev=1"]["rounds"] = l_rounds(recv1, 2)
    rows_l["n_dev=1"]["at_shapes"]["mwl64"]["rounds"] = l_rounds(recv64, 2)
    rows_l["n_dev=1"]["at_shapes"]["tile_edges"] = {
        "max_abs_err": edge_err, "shape": "dsi_compact_tile_rows edges"}

    def m_case(rows, scal, cap, n, dirty):
        opts = {"dtype": torch.int32, "device": DEVICE}
        base = torch.from_numpy(rng.integers(
            0, 1 << 31, (rows.shape[0], cap, rows.shape[2]),
            dtype=np.int64).astype(np.int32)).to(DEVICE)
        args = (torch.tensor(n, **opts), torch.tensor(dirty, **opts), rows,
                scal)
        kb, pb = base.clone(), base.clone()
        got = postings_append(kb, *args)
        want = postings_append_plain(pb, *args)
        return _worst(zip((kb,) + tuple(got), (pb,) + tuple(want))), \
            (base, args, got[2])

    def m_entry(rows, scal, cap, shape, reps=50):
        nr = int(scal[:, 0].sum())
        err, (base, args, _) = m_case(rows, scal, cap, [0] * rows.shape[0],
                                      [0] * rows.shape[0])
        nbytes = 2 * nr * rows.shape[2] * 4 + 4 * 5 * rows.shape[0]
        kb, pb = base.clone(), base.clone()
        prof = wrapper_profile(lambda: postings_append(kb, *args),
                               "postings_append_copy")
        failures.extend(over_budget(f"postings_append {shape}", prof, 1, 1))
        return {"max_abs_err": err,
                "ms": cuda_ms(lambda: postings_append(kb, *args), reps),
                "plain_ms": cuda_ms(lambda: postings_append_plain(pb, *args),
                                    5),
                "library_ms": None, "bytes": nbytes,
                "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                "bound_by": "bytes", "shape": shape, **prof}

    srecv1, n1 = compact_rows(recv1, pad_lanes=2)
    scal1 = torch.zeros((1, 5), dtype=torch.int32, device=DEVICE)
    scal1[:, 0] = n1
    cap1 = recv1.shape[1]  # n_dev x the rung-0 capacity
    srecv8, n8 = compact_rows(recv8, pad_lanes=2)
    scal8 = torch.zeros((8, 5), dtype=torch.int32, device=DEVICE)
    scal8[:, 0] = n8
    rows_m = {"fits": m_entry(srecv1, scal1, cap1,
                              f"cap {cap1}, {int(n1[0])} rows")}
    extra = {}
    nv = int(n1[0])
    # One row past the capacity, as the bench's second wave passes it.
    for name, n, dirty in (("overflow", [cap1 - nv + 1], [0]),
                           ("dirty", [0], [1])):
        err, (_, _, flags) = m_case(srecv1, scal1, cap1, n, dirty)
        extra[name] = {"max_abs_err": err,
                       "no_op": int(flags[0, 0]), "shape": f"n={n}"}
        if int(flags[0, 0]) != 1:
            extra[name]["max_abs_err"] = -1  # the append had to no-op
    extra["n_dev=8"] = m_entry(srecv8, scal8, recv8.shape[1],
                               f"[8, {recv8.shape[1]}, 8], "
                               f"{int(n8.sum())} rows", 20)
    rows_m["fits"]["at_shapes"] = extra
    out = {"compact": rows_l["n_dev=1"], "postings_append": rows_m["fits"]}
    errs = {name: _merge_err(row["max_abs_err"], _worst_err(row))
            for name, row in out.items()}
    return out, errs


def wave_shape_rows(raws):
    """D and E at ``tfidf_n8``'s wave (the bench's eight documents, one a
    shard, u_cap the rung-0 capacity of 2^15): D as ``map_prologue`` runs
    it on shard 0's uniques (hash, part and dest in one launch), E on the
    wave's send rows.  Returns {kernel: entry}."""
    import torch
    from dsi_tpu_torch.ops import wordcount as w
    from dsi_tpu_torch.parallel.tfidf import _wave_chunk, wave_rows

    n_dev = MESH_SHARDS
    size = 1 << max(8, max(len(r) for r in raws).bit_length())
    cap = w.rung0_cap(size, TFIDF_U_CAP)
    chunks = torch.from_numpy(_wave_chunk(raws, range(n_dev), n_dev,
                                          size)).to(DEVICE)
    ids = torch.arange(n_dev, dtype=torch.int32, device=DEVICE)
    keys_u, _, len_u, _, n_unique, *_ = w.group_chunk(
        chunks[0], max_word_len=MWL, u_cap=cap, t_cap_frac=4,
        grouper="sort")
    rows, dests, _ = wave_rows(chunks, ids, n_dev=n_dev, n_reduce=N_REDUCE,
                               max_word_len=MWL, u_cap=cap)
    return {"fnv": fnv_entry(keys_u, len_u, MWL, "tfidf_n8 map, shard 0",
                             n_part=N_REDUCE, n_dest=n_dev, park=n_dev,
                             n_valid=n_unique),
            "route": route_entry(rows, dests, n_dev, MWL // 4,
                                 "tfidf_n8 wave", 20)}


def _route_dest_before(keys, lens, valid, *, n_shards: int, park: int):
    """``route_dest`` as the port ran it before D took the rule into its
    epilogue: the lanes packed into u64 words, D, then five torch ops."""
    import torch
    from dsi_tpu_torch.ops import wordcount as w

    kk = keys.shape[1]
    keys64 = torch.stack(w.pack_key_lanes(tuple(keys[:, j]
                                                for j in range(kk))))
    h = w.fnv1a32_packed(keys64, lens.contiguous(), 4 * kk)
    dest = ((w._u32_value(h) & 0x7FFFFFFF) % n_shards).to(torch.int32)
    return torch.where(valid, dest, park).to(torch.int32)


def _map_prologue_before(chunk, *, n_dev, n_reduce, max_word_len, u_cap,
                         t_cap_frac):
    """``map_prologue`` as the port ran it before: the hash alone, then
    the partition rule in torch ops."""
    import torch
    from dsi_tpu_torch.ops import wordcount as w

    (packed_u, len_u, cnt_u, fnv_u, n_unique, max_len, has_high,
     token_overflow) = w.tokenize_group_core(
        chunk, max_word_len=max_word_len, u_cap=u_cap,
        t_cap_frac=t_cap_frac)
    uvalid = torch.arange(u_cap, device=chunk.device) < n_unique
    part = (fnv_u & 0x7FFFFFFF) % n_reduce
    dest = torch.where(uvalid, part % n_dev, n_dev).to(torch.int32)
    return (packed_u, len_u, cnt_u, part.to(torch.int32), dest,
            (n_unique, max_len, has_high, token_overflow))


def launches_before_after(raws) -> dict:
    """The CUDA launches a call (``torch.profiler``) of ``map_prologue``
    at the stream step, of ``route_dest`` and of ``mesh_fold_step`` at the
    mesh fold's shapes: as the port ran them before D took the partition
    rule into its epilogue (``_map_prologue_before``,
    ``_route_dest_before``, the fold with the older ``route_dest``) and
    now.  Each pair must give equal outputs."""
    import numpy as np
    import torch
    from dsi_tpu_torch.device import table as dt
    from dsi_tpu_torch.ops.meshroute import route_dest
    from dsi_tpu_torch.parallel.shuffle import (_slice_pack, map_prologue,
                                                mapreduce_step)

    buf = np.zeros(STREAM_CHUNK, np.uint8)
    buf[:len(raws[0])] = np.frombuffer(raws[0], np.uint8)
    chunk = torch.from_numpy(buf).to(DEVICE)
    kw = dict(n_dev=1, n_reduce=N_REDUCE, max_word_len=MWL,
              u_cap=STREAM_U_CAP, t_cap_frac=4)
    n_dev, k = MESH_SHARDS, MWL // 4
    mbuf = np.zeros((n_dev, STREAM_CHUNK), np.uint8)
    for i, raw in enumerate(raws[:n_dev]):
        mbuf[i, :len(raw)] = np.frombuffer(raw, np.uint8)
    out = mapreduce_step(torch.from_numpy(mbuf).to(DEVICE), n_dev=n_dev,
                         n_reduce=N_REDUCE, max_word_len=MWL,
                         u_cap=STREAM_U_CAP)
    packed, scal = _slice_pack(*out[:4], mp=out[0].shape[1]), out[4]
    rows = packed.shape[1]
    opts = {"device": DEVICE}
    state = (torch.full((n_dev, rows, k), -1, dtype=torch.int32, **opts),
             torch.zeros((n_dev, rows), dtype=torch.int32, **opts),
             torch.zeros((n_dev, rows), dtype=torch.int64, **opts),
             torch.zeros((n_dev, rows), dtype=torch.int32, **opts),
             torch.zeros(n_dev, dtype=torch.int32, **opts))
    apply = torch.ones(n_dev, dtype=torch.bool, **opts)
    operands = dt._route_operands(packed, scal)
    rkw = dict(n_shards=n_dev, park=n_dev)

    def fold():
        return dt.mesh_fold_step(*state, packed, scal, apply,
                                 n_shards=n_dev)

    def fold_before():
        dt.route_dest = _route_dest_before
        try:
            return fold()
        finally:
            dt.route_dest = route_dest

    pairs = {
        "map_prologue_stream": (lambda: _map_prologue_before(chunk, **kw),
                                lambda: map_prologue(chunk, **kw),
                                "fnv_rows"),
        "route_dest_mesh_fold": (lambda: _route_dest_before(*operands,
                                                            **rkw),
                                 lambda: route_dest(*operands, **rkw),
                                 "fnv_rows"),
        "mesh_fold_step": (fold_before, fold, "route_write")}
    result = {}
    for name, (before, after, anchor) in pairs.items():
        flat = [list(_flat(f())) for f in (before, after)]
        same = len(flat[0]) == len(flat[1]) and all(
            _diff(a, b) == 0 for a, b in zip(*flat))
        result[name] = {
            "before": call_profile(before, anchor)["launches_per_call"],
            "after": call_profile(after, anchor)["launches_per_call"],
            "outputs_equal": same}
    return result


def _flat(x):
    """The tensors of a nested tuple, in order."""
    if isinstance(x, (tuple, list)):
        for y in x:
            yield from _flat(y)
    else:
        yield x


# ── phase 10: the streaming indexer and the mesh-sharded postings ────────


INDEXER_PHASES = TFIDF_PHASES + ("folds", "fold_overflows", "widens",
                                 "topk_snapshots", "table_cap", "fold_s",
                                 "sync_s", "finalize_s")


def indexer_oracle(files, workdir):
    """The sequential indexer oracle's ``mr-out-0`` lines over ``files``,
    and the df top-k (df descending, word ascending) taken from its
    postings: each line is ``word df doc,doc,...``."""
    from dsi_tpu_torch.apps import indexer
    from dsi_tpu_torch.mr.sequential import run_sequential
    from dsi_tpu_torch.parallel.grepstream import DEFAULT_TOPK

    lines = sorted_lines([run_sequential(
        indexer.Map, indexer.Reduce, files,
        os.path.join(workdir, "indexer-correct.txt"))])
    df = []
    for ln in lines:
        word, count, _ = ln.decode().split(" ", 2)
        df.append((int(count), word))
    top = tuple(sorted(df, key=lambda r: (-r[0], r[1]))[:DEFAULT_TOPK])
    return lines, top


def indexer_path(files, workdir, tag, oracle, oracle_top, **kw):
    """The indexer over the TF-IDF row's shapes (``FileDocs`` over
    ``files``, 10 partitions, u_cap 2^15, depth 2) through
    ``indexer_streaming(**kw)``, the call alone timed, then
    ``write_indexer_output``; returns (entry, launches, failures,
    result)."""
    import glob

    from dsi_tpu_torch.ops import wordcount as w
    from dsi_tpu_torch.parallel.grepstream import (indexer_streaming,
                                                   write_indexer_output)
    from dsi_tpu_torch.parallel.tfidf import FileDocs

    docs = FileDocs(files)
    stats: dict = {}
    w.reset_launches()
    t0 = time.perf_counter()
    res = indexer_streaming(docs, n_reduce=N_REDUCE, u_cap=TFIDF_U_CAP,
                            depth=2, stats=stats, device=DEVICE, **kw)
    sync()
    seconds = time.perf_counter() - t0
    launches = w.launch_counts()
    if res is None:
        raise RuntimeError(f"{tag}: indexer_streaming fell back to the host")
    postings, top = res
    outdir = os.path.join(workdir, tag)
    os.makedirs(outdir)
    t0 = time.perf_counter()
    write_indexer_output(res, files, N_REDUCE, outdir)
    write_s = time.perf_counter() - t0
    lines = sorted_lines(sorted(glob.glob(os.path.join(outdir, "mr-out-*"))))
    nbytes = sum(docs.lengths)
    entry = {"parity": lines == oracle, "topk_parity": top == oracle_top,
             "words": len(postings),
             "postings": sum(len(ds) for _, ds in postings.values()),
             "top3": [list(t) for t in top[:3]], "seconds": seconds,
             "write_s": write_s, "input_bytes": nbytes,
             "mb_per_s": nbytes / seconds / 1e6, "launches": launches,
             "wave_stats": {k: stats[k] for k in INDEXER_PHASES + WAVE_CKPT
                            if k in stats}}
    failures = []
    if lines != oracle:
        failures.append(f"{tag}: mr-out-* differ from the indexer oracle")
    if top != oracle_top:
        failures.append(f"{tag}: the df top-k differs from the oracle's")
    return entry, launches, failures, res


def mesh_append_kernel_rows(raws, failures):
    """D, E and M's received entry as the mesh-sharded postings append
    (K20b) runs them on the TF-IDF row's one wave of eight documents at
    ``MESH_SHARDS`` shards: the wave's compacted rows [8, 262,144, 8]
    re-routed by D (its epilogue the rule), exchanged by E into [8,
    2,097,152, 8] with its per-pair totals, and appended by M's received
    entry (``compact_received`` fused into the append: at most 2 launches,
    one allocation) into an empty buffer of eight times the rung-0
    capacity, each held against its plain version on the same device
    tensors (the entry against L's then M's) and timed beside it; also L
    alone on the same received rows (its general path).  Returns ({kernel:
    entry}, {kernel: max_abs_err})."""
    import torch
    from dsi_tpu_torch.device.postings import (
        postings_append_plain, postings_append_received,
        postings_append_received_plain)
    from dsi_tpu_torch.ops import wordcount as w
    from dsi_tpu_torch.ops.meshroute import (compact_rows,
                                             compact_rows_plain,
                                             exchange_rows, route_dest,
                                             route_totals_plain)
    from dsi_tpu_torch.parallel.tfidf import _wave_chunk, tfidf_wave_step

    n_dev, kk = MESH_SHARDS, MWL // 4
    size = 1 << max(8, max(len(r) for r in raws).bit_length())
    cap = w.rung0_cap(size, TFIDF_U_CAP)
    chunks = torch.from_numpy(_wave_chunk(raws, range(n_dev), n_dev,
                                          size)).to(DEVICE)
    ids = torch.arange(n_dev, dtype=torch.int32, device=DEVICE)
    rows, scal = tfidf_wave_step(chunks, ids, n_dev=n_dev, n_reduce=N_REDUCE,
                                 max_word_len=MWL, u_cap=cap)
    r = rows.shape[1]
    valid = torch.arange(r, device=DEVICE)[None, :] < scal[:, :1]
    keys = torch.where(valid[..., None], rows[..., :kk], -1)
    lens = torch.where(valid, rows[..., kk], 0)
    keys, lens, valid = (keys.reshape(-1, kk), lens.reshape(-1),
                         valid.reshape(-1))
    dest = route_dest(keys, lens, valid, n_shards=n_dev,
                      park=n_dev).view(n_dev, r)
    out = {"fnv": fnv_entry(keys, lens, 4 * kk, "mesh_append route",
                            valid=valid, n_part=n_dev, n_dest=n_dev,
                            park=n_dev),
           "route": route_entry(rows, dest, n_dev, kk,
                                "mesh_append exchange", 10)}
    errs = {name: out[name]["max_abs_err"] for name in out}

    # E as the append runs it, with its per-pair totals.
    recv, totals = exchange_rows(rows, dest, n_dev=n_dev, kk=kk, totals=True)
    errs["route"] = _merge_err(errs["route"], _worst(zip(
        (recv, totals), (w.shuffle_rows_plain(rows, dest, n_dev=n_dev, k=kk),
                         route_totals_plain(dest, n_dev=n_dev)))))

    # L on the same received rows: its general path (compact_received).
    crows, n_recv = compact_rows_plain(recv, pad_lanes=1)
    errs["compact"] = _worst(zip(compact_rows(recv, pad_lanes=1),
                                 (crows, n_recv)))
    flag = (recv[..., 0] == -1).to(torch.int8)
    l_bytes = 2 * recv.numel() * 4 + 4 * n_dev
    l_prof = wrapper_profile(lambda: compact_rows(recv, pad_lanes=1),
                             "compact_write", 10)
    failures.extend(over_budget("compact at the mesh append's recv", l_prof,
                                2, 1))
    out["compact"] = {
        "max_abs_err": errs["compact"],
        "ms": cuda_ms(lambda: compact_rows(recv, pad_lanes=1), 10),
        "plain_ms": cuda_ms(lambda: compact_rows_plain(recv, pad_lanes=1),
                            2),
        "library_ms": cuda_ms(lambda: torch.gather(
            recv, 1, torch.argsort(flag, dim=1, stable=True)[
                ..., None].expand_as(recv)), 2),
        "bytes": l_bytes, "bound_ms": l_bytes / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes",
        "shape": f"{list(recv.shape)} pad_lanes 1, "
                 f"{int(n_recv.sum())} valid (L's general path; the mesh "
                 "append runs M's received entry)", **l_prof}

    # M's received entry against L then M plain, on the same tensors.
    bcap = n_dev * cap
    scal_m = n_recv.view(n_dev, 1).contiguous()
    opts = {"dtype": torch.int32, "device": DEVICE}
    zeros = torch.zeros(n_dev, **opts)
    kb = torch.zeros((n_dev, bcap, kk + 4), **opts)

    def received(n, dirty):
        k, p = kb.clone(), kb.clone()
        got = postings_append_received(k, n, dirty, recv, totals)
        want = postings_append_plain(p, n, dirty, crows, scal_m)
        return _worst(zip((k,) + tuple(got), (p,) + tuple(want))), got[2]

    err, flags = received(zeros, zeros)
    if int(flags[:, 0].max()) != 0:
        err = -1  # the wave fits: it had to commit
    over = zeros.clone()
    over[0] = bcap - int(n_recv[0]) + 1
    for n, dirty in ((over, zeros), (zeros, torch.ones_like(zeros))):
        e, flags = received(n, dirty)
        err = _merge_err(err, e if int(flags[:, 0].min()) == 1 else -1)
    errs["postings_append"] = err
    nr = int(n_recv.sum())
    # The kept rows read and written once; totals, n and dirty read; the
    # counts and flags written.
    m_bytes = 2 * nr * (kk + 4) * 4 + 4 * (n_dev * n_dev + 6 * n_dev)

    def fused():
        return postings_append_received(kb, zeros, zeros, recv, totals)

    m_prof = wrapper_profile(fused, "postings_append_write")
    failures.extend(over_budget("postings_append (received entry)", m_prof,
                                2, 1))
    pb = kb.clone()
    out["postings_append"] = {
        "max_abs_err": err,
        "ms": cuda_ms(fused, 20),
        "plain_ms": cuda_ms(lambda: postings_append_received_plain(
            pb, zeros, zeros, recv, totals), 2),
        "library_ms": None, "bytes": m_bytes,
        "bound_ms": m_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "shape": f"received entry: recv {list(recv.shape)} into cap {bcap},"
                 f" {nr} rows kept (L + M fused; overflow and dirty exact)",
        **m_prof}
    return out, errs


# ── phase 10b: crash-resume checkpoints of grep, the indexer, TF-IDF ────

#: Confirmed waves between checkpoints on the wave walks (8 waves a call).
WAVE_CKPT_EVERY = 2
CKPT_MODES = (("sync_full", {}),
              ("async_delta", {"checkpoint_async": True,
                               "checkpoint_delta": True}))


def grep_ckpt_call(files, cycles: int, ckdir: str, stats: dict, **kw):
    """The bench's grep row, services on, through ``grep_streaming`` with
    ``checkpoint_dir`` (every ``CKPT_EVERY`` steps); (result, seconds)."""
    from dsi_tpu_torch.parallel.grepstream import grep_streaming
    from dsi_tpu_torch.parallel.streaming import cycle_files

    t0 = time.perf_counter()
    try:
        res = grep_streaming(cycle_files(files, cycles), GREP_PATTERN,
                             chunk_bytes=GREP_CHUNK, device_accumulate=True,
                             checkpoint_dir=ckdir,
                             checkpoint_every=CKPT_EVERY,
                             pipeline_stats=stats, device=DEVICE, **kw)
    finally:
        sync()
    return res, time.perf_counter() - t0


def grep_ckpt_rows(files, cycles: int, want, nbytes: int, work: str, gpu,
                   failures):
    """The grep row with the services on and a checkpoint every
    ``CKPT_EVERY`` steps, sync full and async delta, each call right after
    the same call without checkpoints: MB/s beside MB/s, the save's phase
    seconds and payload bytes."""
    rows = {}
    for mode, kw in CKPT_MODES:
        tag = f"grep_ckpt_{mode}"
        _, plain_s, _, _, plain_ok = grep_stream_path(
            files, cycles, want, device_accumulate=True)
        st: dict = {}
        res, secs = grep_ckpt_call(files, cycles,
                                   os.path.join(work, f"ck-{tag}"), st, **kw)
        ok = plain_ok and res == want
        rows[tag] = {"parity": ok, "seconds": secs,
                     "mb_per_s": nbytes / secs / 1e6,
                     "plain_seconds": plain_s,
                     "plain_mb_per_s": nbytes / plain_s / 1e6,
                     **{k: st[k] for k in CKPT_STATS if k in st}}
        log({tag: {**rows[tag], "gpu": gpu, "input_bytes": nbytes}})
        if not ok:
            failures.append(f"{tag}: the result differs from "
                            "grep_host_oracle")
        if st.get("ckpt_saves", 0) < 1 or (kw and st.get("ckpt_deltas",
                                                         0) < 1):
            failures.append(f"{tag}: no checkpoint (or no delta) was saved")
    return rows


def grep_ckpt_path(files, cycles: int, want, work: str, full_launches):
    """``grep_ckpt``: the grep row, services on, killed at ``mid-fold`` (raised
    in process) on its sixth step, after the save at step 4, then resumed.
    The launch counts are zeroed before the crashed run and again before
    the resume, so ``launches`` (the counts the path's kernels are gated
    on) are the resume's own, and ``crashed_launches`` the crashed run's;
    the resume's J launches must be fewer than the whole stream's;
    (entry, failures)."""
    from dsi_tpu_torch.ckpt import FaultInjected
    from dsi_tpu_torch.ops import wordcount as w

    ckdir = os.path.join(work, "ck-grep_ckpt")
    fails = []
    w.reset_launches()
    crashed: dict = {}
    with armed_fault("mid-fold", 6):
        try:
            grep_ckpt_call(files, cycles, ckdir, crashed)
            fails.append("grep_ckpt: the fault at mid-fold #6 never fired")
        except FaultInjected:
            pass
    crashed_launches = w.launch_counts()
    w.reset_launches()
    st: dict = {}
    res, secs = grep_ckpt_call(files, cycles, ckdir, st, resume=True)
    launches = w.launch_counts()
    if res != want:
        fails.append("grep_ckpt: the resumed result differs from "
                     "grep_host_oracle")
    if not st.get("resume_cursor"):
        fails.append("grep_ckpt: the resume restored no checkpoint")
    entry = {"parity": res == want, "seconds": secs, "fault": "mid-fold#6",
             "crashed_steps": crashed.get("steps"),
             "crashed_ckpt_saves": crashed.get("ckpt_saves"),
             "full_stream_grep_steps": full_launches["grep_step"],
             "launches": launches, "crashed_launches": crashed_launches,
             **{k: st[k] for k in CKPT_STATS if k in st}}
    if launches["grep_step"] >= full_launches["grep_step"]:
        fails.append("grep_ckpt: the resume launched J for the whole "
                     "stream")
    return entry, fails


def grep_ckpt_cli_path(files, cycles: int, want, work: str, full_launches):
    """``grep_ckpt_cli``: ``python -m dsi_tpu_torch.cli.grepstream`` with the
    services on and a checkpoint every ``CKPT_EVERY`` steps, killed for
    real at ``post-ckpt`` (``os._exit(87)`` after its first commit) in a
    subprocess, then ``--resume --check`` through ``grepstream.main`` in
    this process, its stdout held against ``want``'s; (entry, failures)."""
    from dsi_tpu_torch.ckpt import FAULT_EXIT
    from dsi_tpu_torch.ops import wordcount as w

    ck_args = ["--checkpoint-dir", os.path.join(work, "ck-grep-cli"),
               "--checkpoint-every", str(CKPT_EVERY)]
    env = {k: v for k, v in os.environ.items() if k not in FAULT_ENV}
    env.update({"PYTHONPATH": REPO, "DSI_FAULT_POINT": "post-ckpt",
                "DSI_FAULT_STEP": "1"})
    fails = []
    w.reset_launches()
    t0 = time.perf_counter()
    p = subprocess.run(
        [sys.executable, "-m", "dsi_tpu_torch.cli.grepstream", "--pattern",
         GREP_PATTERN, "--chunk-bytes", str(GREP_CHUNK),
         "--device-accumulate", "--device", DEVICE, *ck_args,
         *(list(files) * cycles)], env=env, capture_output=True, text=True,
        timeout=600)
    crash_s = time.perf_counter() - t0
    if p.returncode != FAULT_EXIT or p.stdout:
        fails.append(f"grep_ckpt_cli: the crashed run exited {p.returncode}"
                     f", not {FAULT_EXIT}, or printed a result: "
                     f"{p.stderr[-1500:]}")
    secs, st, launches, out = grep_cli_path(files, cycles,
                                            extra=ck_args + ["--resume"])
    parity = out == grep_cli_text(want)
    if not parity:
        fails.append("grep_ckpt_cli: the resumed output differs from "
                     "grep_host_oracle's")
    if not st.get("resume_cursor"):
        fails.append("grep_ckpt_cli: --resume restored no checkpoint")
    if launches["grep_step"] >= full_launches["grep_step"]:
        fails.append("grep_ckpt_cli: the resume launched J for the whole "
                     "stream")
    entry = {"parity": parity, "seconds": secs, "crash_seconds": crash_s,
             "crash_rc": p.returncode, "launches": launches,
             "stdout": out.splitlines()[:3],
             **{k: st[k] for k in CKPT_STATS if k in st}}
    return entry, fails


def wave_ckpt_rows(run, tag: str, work: str, gpu, failures):
    """A wave walk's row (``run``: :func:`tfidf_path` or
    :func:`indexer_path` with its oracles bound) with the postings buffer
    on and a checkpoint every ``WAVE_CKPT_EVERY`` waves, sync full and
    async delta, each call right after the same call without checkpoints:
    wall seconds beside wall seconds, the save's phase seconds and payload
    bytes."""
    rows = {}
    for mode, kw in CKPT_MODES:
        name = f"{tag}_{mode}"
        plain, _, fails, _ = run(f"{name}_plain", device_accumulate=True)
        entry, _, more, _ = run(
            name, device_accumulate=True,
            checkpoint_dir=os.path.join(work, f"ck-{name}"),
            checkpoint_every=WAVE_CKPT_EVERY, **kw)
        st = entry["wave_stats"]
        rows[name] = {"parity": entry["parity"] and plain["parity"],
                      "seconds": entry["seconds"],
                      "plain_seconds": plain["seconds"],
                      "mb_per_s": entry["mb_per_s"],
                      "plain_mb_per_s": plain["mb_per_s"],
                      **{k: st[k] for k in WAVE_CKPT if k in st},
                      "append_overflows": st.get("append_overflows")}
        log({name: {**rows[name], "gpu": gpu,
                    "input_bytes": entry["input_bytes"]}})
        failures.extend(fails + more)
        if st.get("ckpt_saves", 0) < 1 or (kw and st.get("ckpt_deltas",
                                                         0) < 1):
            failures.append(f"{name}: no checkpoint (or no delta) was "
                            "saved")
    return rows


def wave_ckpt_path(run, tag: str, work: str, full_launches, *, point: str,
                   step: int, **kw):
    """A wave walk with the postings buffer on and a checkpoint every
    ``WAVE_CKPT_EVERY`` waves, killed at ``point`` (raised in process) on
    its ``step``-th occurrence, then resumed through ``run``; the resume
    must match the oracles, restore a cursor and launch L (once a wave)
    fewer times than the whole walk did.  Returns (entry, launches of the
    resume, failures)."""
    from dsi_tpu_torch.ckpt import FaultInjected

    ck = dict(device_accumulate=True,
              checkpoint_dir=os.path.join(work, f"ck-{tag}"),
              checkpoint_every=WAVE_CKPT_EVERY, **kw)
    fails = []
    with armed_fault(point, step):
        try:
            run(f"{tag}_crashed", **ck)
            fails.append(f"{tag}: the fault at {point} #{step} never fired")
        except FaultInjected:
            pass
    entry, launches, more, _ = run(tag, resume=True, **ck)
    fails += more
    st = entry["wave_stats"]
    if not st.get("resume_wave"):
        fails.append(f"{tag}: the resume restored no checkpoint")
    if launches["compact"] >= full_launches["compact"]:
        fails.append(f"{tag}: the resume launched L for every wave")
    entry = {**entry, "fault": f"{point}#{step}",
             "full_walk_compact_launches": full_launches["compact"]}
    return entry, launches, fails


def postings_capture_check(raws):
    """The postings buffer's image captured on the card: two TF-IDF waves
    (one 2 MiB document each) appended, ``checkpoint_capture`` under
    ``torch.profiler`` (one ``Memcpy DtoH (Device -> Pinned)`` a call, the
    committed prefix), then one capture and a host copy of the buffer at
    that instant, then a sync (the next append writes from row 0) and two
    more waves before the image materializes: it must equal the host
    copy.  Returns (entry, failures)."""
    import numpy as np
    import torch

    from dsi_tpu_torch.device.postings import DevicePostings
    from dsi_tpu_torch.ops import wordcount as w
    from dsi_tpu_torch.parallel.tfidf import _wave_chunk, tfidf_wave_step

    size = 1 << max(8, max(len(r) for r in raws).bit_length())
    cap = w.rung0_cap(size, TFIDF_U_CAP)
    waves = []
    for i in range(4):
        chunks = torch.from_numpy(_wave_chunk(raws, [i], 1, size)).to(DEVICE)
        ids = torch.tensor([i], dtype=torch.int32, device=DEVICE)
        rows, scal = tfidf_wave_step(chunks, ids, n_dev=1, n_reduce=N_REDUCE,
                                     max_word_len=MWL, u_cap=cap)
        scal_np = scal.cpu().numpy()
        if scal_np[:, 3:].any() or int(scal_np[:, 1].max()) > cap:
            raise RuntimeError("a capture-check wave did not clear rung 0")
        waves.append((rows, scal, scal_np[:, 0].astype(np.int64)))
    buf = DevicePostings(1, width=MWL // 4 + 4, cap=4 * cap,
                         sink=lambda r: None, device=DEVICE, lag=1)
    for rows, scal, nv in waves[:2]:
        buf.append(rows, scal, nvalid=nv)
    copies = capture_copies(buf, tries=8, want=1)
    t0 = time.perf_counter()
    deferred = buf.checkpoint_capture()
    capture_s = time.perf_counter() - t0
    n = int(buf._nrows[0])
    live = buf._buf[0, :n].to("cpu", copy=True).numpy().view(np.uint32)
    buf.sync()
    for rows, scal, nv in waves[2:]:
        buf.append(rows, scal, nvalid=nv)
    sync()
    t0 = time.perf_counter()
    img = deferred.materialize()
    materialize_s = time.perf_counter() - t0
    overwritten = not np.array_equal(
        buf._buf[0, :n].cpu().numpy().view(np.uint32), live)
    equal = (n > 0 and int(img["nrows"][0]) == n
             and np.array_equal(img["buf"][0, :n], live)
             and img["buf"].dtype == np.uint32)
    fails = []
    if not equal:
        fails.append("postings_capture: the image differs from the buffer "
                     "at the capture")
    if not overwritten:
        fails.append("postings_capture: the later appends did not write "
                     "over the captured rows, so the check proves nothing")
    if copies != [("Memcpy DtoH (Device -> Pinned)", 1)]:
        fails.append(f"postings_capture: a capture's copies a call are not "
                     f"one pinned D2H: {copies}")
    entry = {"image_equal": equal, "rows": n, "cap": buf.cap,
             "overwritten_after_capture": overwritten, "copies": copies,
             "capture_s": capture_s, "materialize_s": materialize_s,
             "image_bytes": sum(int(v.nbytes) for v in img.values())}
    buf.close()
    return entry, fails


# ── phase 11: the compressed chunk upload (kernel N) ─────────────────────


def _rare_text(n_dev: int, n: int, rare_frac: float):
    """[n_dev, n] ASCII of 14 frequent symbols and, at ``rare_frac``, 16
    rare ones that escape the nibble dictionary: the second literal rung."""
    import numpy as np

    rng = np.random.default_rng(SEED)
    common = np.frombuffer(b"etaoinshrdlu \n", np.uint8)
    rare = np.frombuffer(b"vwxyzqjkVWXYZQJK", np.uint8)
    pick = rng.random((n_dev, n)) < rare_frac
    return np.where(pick, rng.choice(rare, (n_dev, n)),
                    rng.choice(common, (n_dev, n))).astype(np.uint8)


def wire_cases(files):
    """(name, n_dev, batch or None, packed, mode, lit_cap) for kernel N:
    the bench stream's first batch at 1 and 8 shards (the 7-bit mode), the
    low-entropy text at each nibble rung, and a packed tensor whose
    escapes exceed its literal region (the clamp)."""
    import numpy as np
    from dsi_tpu_torch.ops import wirecodec as wcd
    from dsi_tpu_torch.parallel.streaming import batch_stream, cycle_files
    from dsi_tpu_torch.slice_profile import lowent_unit

    n = STREAM_CHUNK
    unit = lowent_unit()
    cases = []
    for n_dev in (1, 8):
        bench = next(batch_stream(cycle_files(files, 1), n_dev, n))
        reps = n_dev * n // len(unit) + 1
        lowent = np.frombuffer(unit * reps, np.uint8)[:n_dev * n].reshape(
            n_dev, n).copy()
        for name, batch, want in (
                ("bench", bench, ("b7", 0)),
                ("lowent", lowent, ("nib", n // 8)),
                ("rare18", _rare_text(n_dev, n, 0.18), ("nib", n // 4))):
            mode, packed, cap = wcd.encode_chunk(batch)
            if (mode, cap) != want:
                raise RuntimeError(f"wire case {name} n_dev={n_dev} encoded "
                                   f"as {mode}/{cap}, want {want}")
            cases.append((f"{name}_{mode}_n{n_dev}", n_dev, batch, packed,
                          mode, cap))
        rng = np.random.default_rng(SEED + n_dev)
        cap = n // 8
        packed = rng.integers(0, 256, (n_dev, wcd.packed_width(n, cap)),
                              dtype=np.uint8)
        packed[:, 16:16 + n // 4] = 0xFF  # n/2 escapes, 4x the region
        cases.append((f"clamp_nib_n{n_dev}", n_dev, None, packed, "nib", cap))
    return cases


def stream_handle_failures() -> list:
    """Every wrapper launches on ``ops/wordcount.py _stream``, which reads
    the private binding ``torch._C._cuda_getCurrentRawStream``: failures
    where that binding is gone or gives another stream than
    ``torch.cuda.current_stream(dev).cuda_stream``, on the default stream
    and on a side stream; logs the PyTorch version it was checked with and
    both handles' host time a call (1,000 calls each)."""
    import torch
    from dsi_tpu_torch.ops import wordcount as w

    t = torch.zeros(1, device=DEVICE)
    dev = t.device
    if not hasattr(torch._C, "_cuda_getCurrentRawStream"):
        return [f"torch {torch.__version__} has no "
                "torch._C._cuda_getCurrentRawStream (ops/wordcount.py "
                "_stream)"]
    got = {"default": (w._stream(t),
                       torch.cuda.current_stream(dev).cuda_stream)}
    side = torch.cuda.Stream(dev)
    with torch.cuda.stream(side):
        got["side"] = (w._stream(t),
                       torch.cuda.current_stream(dev).cuda_stream)
    us = {}
    for what, fn in (("_stream", lambda: w._stream(t)),
                     ("current_stream(dev).cuda_stream",
                      lambda: torch.cuda.current_stream(dev).cuda_stream)):
        fn()
        t0 = time.perf_counter()
        for _ in range(1000):
            fn()
        us[what] = (time.perf_counter() - t0) * 1e3
    log({"stream_handle": {k: list(v) for k, v in got.items()},
         "host_us_a_call": us, "torch": torch.__version__})
    return [f"_stream gives {a:#x} on the {k} stream, not {b:#x}"
            for k, (a, b) in got.items() if a != b]


def check_wire_edges() -> int:
    """Kernel N on ``kernel_cases.wire_cases`` at its own tile for each
    shape (``dsi_wire_decode_tile_bytes``): escapes across every tile edge,
    rows with none, rows of escapes only, the clamp and rows of odd width,
    at [1, 2 MiB], [8, 2 MiB] and [8, 2 MiB + 8] (rows off the 16-byte
    grid), each held to ``decode_chunk_plain`` and to
    the encoder's input where there is one.  Returns the worst
    max_abs_err."""
    import torch
    from dsi_tpu_torch.kernels.build import library
    from dsi_tpu_torch.ops import wirecodec as wcd
    from dsi_tpu_torch.utils import kernel_cases as kc

    err = 0
    tile = int(library().dsi_wire_decode_tile_bytes())
    for n_dev, n in ((1, STREAM_CHUNK), (8, STREAM_CHUNK),
                     (8, STREAM_CHUNK + 8)):
        for name, packed_np, cap, batch in kc.wire_cases(n_dev, n, tile):
            pk = torch.from_numpy(packed_np).to(DEVICE)
            kw = dict(n=n, lit_cap=cap, mode="nib")
            got = wcd.decode_chunk_device(pk, **kw)
            d = _diff(got, wcd.decode_chunk_plain(pk, **kw))
            if batch is not None:
                d = _merge_err(d, _diff(got,
                                        torch.from_numpy(batch).to(DEVICE)))
            err = _merge_err(err, d)
            log({"wire_edge_case": f"{name} [{n_dev}, {n}]", "tile": tile,
                 "lit_cap": cap, "max_abs_err": d})
    return err


def wire_kernel_rows(files, failures):
    """Kernel N against ``decode_chunk_plain`` on the card (and against the
    encoder's input), each case timed through the wrapper beside its plain
    version and its bound (the packed bytes read and n_dev * n written
    once), with its CUDA launches, Memcpys and allocations a call
    (``wrapper_profile``): the run fails above 1 launch and 1 allocation
    in the 7-bit mode, 2 and 2 in the nibble mode, or where either went
    unmeasured; then the edge cases (:func:`check_wire_edges`).  Returns
    (times entry, max_abs_err)."""
    import torch
    from dsi_tpu_torch.ops import wirecodec as wcd

    n = STREAM_CHUNK
    err, shapes = 0, {}
    for name, n_dev, batch, packed_np, mode, cap in wire_cases(files):
        pk = torch.from_numpy(packed_np).to(DEVICE)
        kw = dict(n=n, lit_cap=cap, mode=mode)
        got = wcd.decode_chunk_device(pk, **kw)
        d = _diff(got, wcd.decode_chunk_plain(pk, **kw))
        if batch is not None:
            d = _merge_err(d, _diff(got, torch.from_numpy(batch).to(DEVICE)))
        sync()
        err = _merge_err(err, d)
        nbytes = pk.numel() + n_dev * n
        ms = cuda_ms(lambda: wcd.decode_chunk_device(pk, **kw), 50)
        prof = wrapper_profile(
            lambda: wcd.decode_chunk_device(pk, **kw),
            "wire_decode_nib" if mode == "nib" else "wire_decode7")
        most = 2 if mode == "nib" else 1
        failures += unmeasured(f"wire_decode {name}", prof)
        failures += over_budget(f"wire_decode {name}", prof, most, most)
        shapes[name] = {
            "ms": ms,
            "plain_ms": cuda_ms(lambda: wcd.decode_chunk_plain(pk, **kw), 5),
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "library_ms": None, "max_abs_err": d,
            "shape": f"packed {list(pk.shape)} -> [{n_dev}, {n}], {mode}"
                     + (f" lit_cap {cap}" if mode == "nib" else ""),
            **prof}
        log({"wire_case": name, **shapes[name]})
    err = _merge_err(err, check_wire_edges())
    main = shapes["bench_b7_n1"]
    return {**main, "at_shapes": {k: v for k, v in shapes.items()
                                  if k != "bench_b7_n1"}}, err


def wire_pack_rows(files):
    """``pack_rows``/``unpack_rows`` over one real port step's pulled table,
    as the bench's wire row does: (round trip exact, ratio, entry)."""
    import numpy as np
    import torch
    from dsi_tpu_torch.ops import wirecodec as wcd
    from dsi_tpu_torch.parallel.shuffle import (_slice_pack, mapreduce_step,
                                                occupied_prefix)
    from dsi_tpu_torch.parallel.streaming import batch_stream, stream_files

    chunk = next(batch_stream(stream_files(files), 1, STREAM_CHUNK))
    keys, lens, cnts, parts, scal = mapreduce_step(
        torch.from_numpy(chunk).to(DEVICE), n_dev=1, n_reduce=N_REDUCE,
        max_word_len=MWL, u_cap=STREAM_U_CAP, t_cap_frac=4)
    scal_np = scal.cpu().numpy()
    if scal_np[:, 3].any() or scal_np[:, 4].any() or \
            int(scal_np[:, 1].max()) > keys.shape[1]:
        raise RuntimeError("the pack_rows probe step overflowed")
    nus = scal_np[:, 0].astype(np.int64)
    mp = occupied_prefix(int(nus.max()), keys.shape[1])
    packed = _slice_pack(keys, lens, cnts, parts,
                         mp=mp).cpu().numpy().view(np.uint32)
    t0 = time.perf_counter()
    blob = wcd.pack_rows(packed, nus)
    pack_s = time.perf_counter() - t0
    rows2, nus2 = wcd.unpack_rows(blob)
    ok = np.array_equal(nus2, nus) and all(
        np.array_equal(rows2[d, :int(nus[d])], packed[d, :int(nus[d])])
        for d in range(len(nus)))
    raw = wcd.rows_raw_bytes(nus, keys.shape[2])
    return ok, {"parity": ok, "rows": int(nus.sum()), "raw_bytes": raw,
                "packed_bytes": len(blob), "ratio": raw / len(blob),
                "pack_s": pack_s}


WIRE_STATS = ("wire_steps", "wire_raw_steps", "wire_packed_bytes",
              "wire_ratio", "wire_modes", "decode_s", "upload_s")


def wire_stream_runs(files, data, want, work, gpu, failures):
    """The bench's wire A/B row on the card: each stream raw and with
    ``wire_upload``, both held to the oracle's counts and to each other;
    returns ({tag: entry}, {tag: wire run's launches})."""
    import collections

    from dsi_tpu_torch.slice_profile import lowent_unit

    cycles = max(1, round(WIRE_MB * 1e6 / len(data)))
    unit = lowent_unit()
    reps = int(WIRE_MB * 1e6) // len(unit)
    lowent_want = {w_: c * reps for w_, c in collections.Counter(
        unit.decode().split()).items()}

    def lowent_blocks():
        step = (4 << 20) // len(unit)
        for i in range(0, reps, step):
            yield unit * min(step, reps - i)

    runs, launches = {}, {}
    for tag, kw, want_, cyc in (
            ("wire_stream", {"device_accumulate": False}, want, cycles),
            ("wire_stream_acc", {"device_accumulate": True}, want, cycles),
            ("wire_stream_mesh", {"device_accumulate": True,
                                  "n_dev": MESH_SHARDS,
                                  "mesh_shards": MESH_SHARDS}, want, cycles),
            ("wire_stream_nib", {"device_accumulate": True}, lowent_want, 1)):
        if tag == "wire_stream_nib":
            kw = {**kw, "blocks": lowent_blocks()}
        raw_ok, raw_s, _, _, raw_res = stream_path(files, cyc, want_, **kw)
        if tag == "wire_stream_nib":
            kw = {**kw, "blocks": lowent_blocks()}
        ok, secs, st, lc, res = stream_path(files, cyc, want_,
                                            wire_upload=True, **kw)
        mb = (len(unit) * reps if tag == "wire_stream_nib"
              else len(data) * cyc) / 1e6
        runs[tag] = {"parity": ok and raw_ok and res == raw_res,
                     "seconds": secs, "raw_seconds": raw_s,
                     "mb_per_s": mb / secs, "raw_mb_per_s": mb / raw_s,
                     **{k: st.get(k) for k in WIRE_STATS},
                     "pipeline_stats": {k: st[k] for k in STREAM_PHASES
                                        if k in st}}
        launches[tag] = lc
        log({tag: {**runs[tag], "launches": lc, "gpu": gpu,
                   "input_mb": mb}})
        if not (ok and raw_ok):
            failures.append(f"{tag}: counts differ from the oracle's")
        if res != raw_res:
            failures.append(f"{tag}: the wire run differs from the raw run")
    cli_ok, secs, st, lc, _ = stream_cli_path(
        files, cycles, want, os.path.join(work, "wire"),
        extra=("--wire-upload",))
    runs["wire_cli"] = {"parity": cli_ok, "seconds": secs,
                        "mb_per_s": len(data) * cycles / secs / 1e6,
                        **{k: st.get(k) for k in WIRE_STATS}}
    launches["wire_cli"] = lc
    log({"wire_cli": {**runs["wire_cli"], "launches": lc, "gpu": gpu}})
    if not cli_ok:
        failures.append("wire_cli: mr-out-* differ from the oracle's counts")
    for tag, r in runs.items():
        if not r["wire_steps"]:
            failures.append(f"{tag}: no step went through the wire codec")
        elif launches[tag]["wire_decode"] < r["wire_steps"]:
            failures.append(f"{tag}: wire_decode launched "
                            f"{launches[tag]['wire_decode']} times for "
                            f"{r['wire_steps']} wire steps")
    if not any(m.startswith("nib") for m in runs["wire_stream_nib"][
            "wire_modes"] or {}):
        failures.append("wire_stream_nib: the nibble mode never ran")
    return runs, launches


# ── phase 12: the crash model checker (kernel O) ─────────────────────────

# The CLI's defaults and the reference tests' two other configurations
# (tests/test_simulate.py), 8 map and 10 reduce tasks, 3 workers.
CRASH_CONFIGS = {
    "cli_default": dict(exit_prob=0.25, stall_prob=0.2, timeout=10,
                        horizon=800),
    "no_faults": dict(exit_prob=0.0, stall_prob=0.0, horizon=200),
    "stalls": dict(exit_prob=0.0, stall_prob=0.5, timeout=5, horizon=800),
}
CRASH_N, CRASH_LARGE, CRASH_FLEET = 1000, 1 << 16, 1 << 20
# Beside kernel_cases.crash_cases (the deadlines spilled): logs whose masks
# alone do not fit one warp's shared memory, so all of the state spills.
CRASH_SPILL_ALL = ("spill_all", 64, 0, dict(n_map=60000, n_reduce=10,
                                            horizon=20))
# Calls that alternate the shared bytes a launch asks of one instance of
# kernel O, each held against the plain version: the register instance
# (three workers) at 16 / 16 tasks (16 KiB a block), the CLI's sizes (9 KiB)
# and 32 / 32 (32 KiB); the general one with the whole state spilled
# (none), the deadlines spilled (the masks, 58 KiB), logs past one mask
# word and the CLI's logs with four workers (every region in shared
# memory).
_CRASH_REG16 = ("reg_16x16", 96, 0, dict(n_map=16, n_reduce=16,
                                         horizon=400))
_CRASH_SPILL_DL = ("spill_deadlines", 64, 0, dict(n_map=1800, n_reduce=40,
                                                  n_workers=1, horizon=60))
CRASH_ALTERNATION = [
    _CRASH_REG16, ("reg_cli", 96, 0, {}), _CRASH_REG16,
    ("reg_32x32", 96, 0, dict(n_map=32, n_reduce=32, horizon=400)),
    _CRASH_REG16,
    CRASH_SPILL_ALL, _CRASH_SPILL_DL,
    ("wide_logs", 64, 0, dict(n_map=33, n_reduce=65)), _CRASH_SPILL_DL,
    ("cli_logs_4_workers", 96, 0, dict(n_workers=4)), CRASH_SPILL_ALL,
    _CRASH_SPILL_DL]
# Kernel O's CUDA launches a call: the counter's memset and one kernel.
CRASH_MOST_LAUNCHES, CRASH_MOST_KERNELS = 2, 1
# One threefry-2x32 block: the key schedule (2 xors), the first injection
# (2 adds), 20 rounds of an add, a rotation (one funnel shift) and an xor,
# and 5 injections of 3 adds.
THREEFRY_OPS = 2 + 2 + 20 * 3 + 5 * 3


def crash_ops(n: int, ticks: int, work: dict) -> int:
    """Integer operations that ``n`` instances' run needs, from the plain
    version's ``work`` counts of the same run: the instance keys (one
    threefry block each), a tick key (one block) on each tick where some
    worker takes a task, and per assignment the worker's key and its draw
    (two blocks) and 12 more (the float: xor, shift, or, subtract; two
    fate compares; the duration's multiply, conversion, modulo and add;
    the deadline and busy adds); per completion report 3 (the duplicate
    test and two counters); per tick 2 (the clock and the loop test).
    The state machine's scans are left out, so no layout of the state
    could beat the bound."""
    blocks = n + work["keyed_ticks"] + 2 * work["assignments"]
    return (blocks * THREEFRY_OPS + 12 * work["assignments"]
            + 3 * work["reports"] + 2 * ticks)


def crash_profile(fn, cfg: dict, n: int) -> dict:
    """``call_profile`` of one kernel O call with the scratch bytes it
    takes after its outputs; raises above a memset and one kernel."""
    from dsi_tpu_torch.parallel import simulate as sim

    prof = call_profile(fn, "crash_sim")
    if prof["launches_per_call"] is None:
        raise RuntimeError("crash_sim: torch.profiler kept no whole window "
                           "of calls, so the launches a call are unknown")
    if prof["launches_per_call"] > CRASH_MOST_LAUNCHES \
            or prof["kernels_per_call"] > CRASH_MOST_KERNELS:
        raise RuntimeError(f"crash_sim: {prof['launches_per_call']} CUDA "
                           f"launches and {prof['kernels_per_call']} kernels "
                           "a call, the design allows a memset and one")
    prof["scratch_bytes"] = sim.crash_scratch_bytes(n, **_crash_sizes(cfg))
    return prof


def _crash_sizes(cfg: dict) -> dict:
    sizes = dict(n_map=8, n_reduce=10, n_workers=3)
    sizes.update({k: cfg[k] for k in sizes if k in cfg})
    return sizes


def check_crash_cases():
    """Kernel O against the plain version on the shared cases
    (``kernel_cases.crash_cases``, the CPU tests' cases), CRASH_SPILL_ALL
    and then CRASH_ALTERNATION in its order, every output of every
    instance.  Returns max_abs_err."""
    from dsi_tpu_torch.parallel import simulate as sim
    from dsi_tpu_torch.utils.kernel_cases import CRASH_SEED, crash_cases

    worst = 0
    for name, n, first, kw in (crash_cases() + [CRASH_SPILL_ALL]
                               + CRASH_ALTERNATION):
        got = sim.simulate_batch(CRASH_SEED, n, first=first, device=DEVICE,
                                 **kw)
        want = sim.simulate_batch_plain(CRASH_SEED, n, first=first,
                                        device=DEVICE, **kw)
        d = 0
        for k in sim.OUTPUTS:
            d = _merge_err(d, _diff(got[k], want[k]))
        sync()
        worst = _merge_err(worst, d)
        log({"crash_edge_case": name, "n": n, "first": first, **kw,
             "scratch_bytes": sim.crash_scratch_bytes(n, **_crash_sizes(kw)),
             "max_abs_err": d})
    return worst


def crash_kernel_rows():
    """Kernel O against the plain version on the card, every output of
    every instance: the shared cases (:func:`check_crash_cases`), 1,000
    instances in each configuration and 2^16 in the CLI's; then a fleet
    of 2^20, held to the plain version as well, whose first 2^16
    instances must equal the 2^16 run.  Each timed shape also has its
    launches a call, device time and scratch bytes (:func:`crash_profile`),
    and each bound counts the work the plain version's run reports
    (:func:`crash_ops`).  Returns (times entry, max_abs_err, failures)."""
    import torch
    from dsi_tpu_torch.parallel import simulate as sim

    err, shapes, fails, large = check_crash_cases(), {}, [], None
    for tag, cfg in CRASH_CONFIGS.items():
        for n in ((CRASH_N, CRASH_LARGE) if tag == "cli_default"
                  else (CRASH_N,)):
            got = sim.simulate_batch(0, n, device=DEVICE, **cfg)
            sync()
            work: dict = {}
            t0 = time.perf_counter()
            want = sim.simulate_batch_plain(0, n, device=DEVICE, work=work,
                                            **cfg)
            sync()
            plain_s = time.perf_counter() - t0
            d = 0
            for k in sim.OUTPUTS:
                d = _merge_err(d, _diff(got[k], want[k]))
            err = _merge_err(err, d)
            if n == CRASH_LARGE:
                large = got
            ticks = int(got["ticks"].sum())
            ops = crash_ops(n, ticks, work)
            nbytes = 8 + 16 * n  # the root key; 4 bool and 3 int32 outputs
            shapes[f"{tag}_{n}"] = {
                "ms": cuda_ms(lambda: sim.simulate_batch(
                    0, n, device=DEVICE, **cfg), 5),
                "plain_ms": plain_s * 1e3,
                "bound_ms": max(ops / INT32_OPS_PER_S,
                                nbytes / HBM_BYTES_PER_S) * 1e3,
                "bound_by": ("operations" if ops / INT32_OPS_PER_S
                             >= nbytes / HBM_BYTES_PER_S else "bytes"),
                "ops": ops, "ticks_sum": ticks, **work,
                "max_ticks": int(got["ticks"].max()),
                "library_ms": None, "max_abs_err": d,
                "shape": f"{n} instances, 8 map, 10 reduce, 3 workers, "
                         + ", ".join(f"{k} {v}" for k, v in cfg.items())}
            shapes[f"{tag}_{n}"].update(crash_profile(
                lambda: sim.simulate_batch(0, n, device=DEVICE, **cfg), cfg,
                n))
            log({"crash_case": f"{tag}_{n}", **shapes[f"{tag}_{n}"]})
    cfg = CRASH_CONFIGS["cli_default"]
    sync()
    t0 = time.perf_counter()
    fleet = sim.simulate_batch(0, CRASH_FLEET, device=DEVICE, **cfg)
    sync()
    fleet_s = time.perf_counter() - t0
    if not all(torch.equal(fleet[k][:CRASH_LARGE], large[k])
               for k in sim.OUTPUTS):
        fails.append(f"crash_sim: the {CRASH_FLEET}-instance fleet's first "
                     f"{CRASH_LARGE} instances differ from the {CRASH_LARGE} "
                     "run")
    work = {}
    t0 = time.perf_counter()
    want = sim.simulate_batch_plain(0, CRASH_FLEET, device=DEVICE, work=work,
                                    **cfg)
    sync()
    plain_s = time.perf_counter() - t0
    d = 0
    for k in sim.OUTPUTS:
        d = _merge_err(d, _diff(fleet[k], want[k]))
    err = _merge_err(err, d)
    del want
    ticks = int(fleet["ticks"].sum())
    ops = crash_ops(CRASH_FLEET, ticks, work)
    ms = cuda_ms(lambda: sim.simulate_batch(0, CRASH_FLEET, device=DEVICE,
                                            **cfg), 3)
    shapes[f"cli_default_{CRASH_FLEET}"] = {
        "ms": ms, "plain_ms": plain_s * 1e3,
        "bound_ms": ops / INT32_OPS_PER_S * 1e3,
        "bound_by": "operations", "ops": ops, "ticks_sum": ticks, **work,
        "max_ticks": int(fleet["ticks"].max()), "library_ms": None,
        "max_abs_err": d,
        "wall_s": fleet_s, "instances_per_s": CRASH_FLEET / (ms / 1e3),
        "wall_instances_per_s": CRASH_FLEET / fleet_s,
        "all_finished": bool(fleet["finished"].all()),
        "shape": f"{CRASH_FLEET} instances, the CLI's configuration",
        **crash_profile(lambda: sim.simulate_batch(
            0, CRASH_FLEET, device=DEVICE, **cfg), cfg, CRASH_FLEET)}
    log({"crash_fleet": shapes[f"cli_default_{CRASH_FLEET}"]})
    main = shapes[f"cli_default_{CRASH_N}"]
    return {**main, "at_shapes": {k: v for k, v in shapes.items()
                                  if k != f"cli_default_{CRASH_N}"}}, \
        err, fails


def crash_paths(gpu, failures):
    """The model checker's main path: ``run_crash_model_check`` in each
    configuration at 1,000 instances, then ``crashcheck -n 1000`` in
    process; returns ({path: launches}, {path: entry})."""
    import contextlib
    import io

    from dsi_tpu_torch.cli import crashcheck
    from dsi_tpu_torch.ops import wordcount as w
    from dsi_tpu_torch.parallel.simulate import run_crash_model_check

    w.reset_launches()
    t0 = time.perf_counter()
    aggs = {tag: run_crash_model_check(CRASH_N, device=DEVICE, **cfg)
            for tag, cfg in CRASH_CONFIGS.items()}
    secs = time.perf_counter() - t0
    launches = {"crashcheck": w.launch_counts()}
    for tag, agg in aggs.items():
        if not (agg["all_finished"] and agg["all_consistent"]
                and agg["all_safe"]):
            failures.append(f"crashcheck {tag}: an invariant failed: {agg}")
    if aggs["cli_default"]["total_requeues"] < 1:
        failures.append("crashcheck: no requeue under the CLI's faults")
    st = aggs["stalls"]
    if st["total_duplicate_completions"] < 1 or \
            st["instances_where_reference_counter_breaks_barrier"] < 1:
        failures.append("crashcheck stalls: no duplicate completion or no "
                        "reference-counter break")
    out = io.StringIO()
    w.reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = crashcheck.main(["-n", str(CRASH_N)])
    cli_s = time.perf_counter() - t0
    launches["crashcheck_cli"] = w.launch_counts()
    if rc != 0:
        failures.append(f"crashcheck -n {CRASH_N} exited {rc}")
    entry = {"aggregates": aggs, "seconds": secs, "cli_rc": rc,
             "cli_seconds": cli_s, "cli_line": out.getvalue().strip()}
    log({"crashcheck": {**entry, "launches": launches, "gpu": gpu}})
    return launches, entry


# ── phase 13: the plan layer (K16e on J, kernel P) ───────────────────────

# The bench's plan row (bench.py:1884 run_plan_row): 8 MB of its corpus
# (dsi_tpu_torch.utils.corpus.plan_corpus), pattern dsi, 1 MiB chunks,
# planrun's defaults (u_cap 2^12, 10 partitions, depth 2), one shard.
PLAN_MB, PLAN_PATTERN, PLAN_CHUNK, PLAN_U_CAP = 8.0, "dsi", 1 << 20, 1 << 12
# The pg corpus cycled to 64 MB, grepped for `the` in 2 MiB chunks.  In
# this synthetic corpus `the` keeps 0.3% of the bytes (216 KB of 64 MB, one
# relay buffer), so the seals and the spill run with `th` (17%, about 11 MB
# in 2 MiB buffers); under PLAN_SPILL_MB, less than two [1, 2 MiB]
# buffers, every seal spills.
PLAN_PG_MB, PLAN_PG_PATTERN, PLAN_PG_CHUNK = 64.0, "the", 1 << 21
PLAN_SEAL_PATTERN, PLAN_SPILL_MB = "th", 3.0
PLAN_CASCADE = ("the", "and")
PLAN_STAGE_SHARDS = 4
PLAN_RELAY_APPENDS = 64
PLAN_STATS = ("plan_s", "plan_stage_walls", "plan_relay_buffers",
              "plan_spilled_bytes", "plan_intermediate_bytes",
              "plan_handoff_bytes", "plan_overlap_s", "plan_handoff",
              "plan_pipelined", "plan_stage_shards")


def _line_batch(raw: bytes, n_dev: int, n: int):
    """[n_dev, n] uint8 rows of ``raw`` cut after a newline, with lens."""
    import numpy as np

    b = np.zeros((n_dev, n), np.uint8)
    lens = np.zeros(n_dev, np.int32)
    rest = raw
    for r in range(n_dev):
        cut = rest.rfind(b"\n", 0, n) + 1
        b[r, :cut] = np.frombuffer(rest[:cut], np.uint8)
        lens[r] = cut
        rest = rest[cut:]
    return b, lens


def _keep_mask(ch, pats, dl):
    """The bytes the emit keeps (a step that does not overflow): valid
    bytes of lines with a match, each line's newline included."""
    import torch

    n_dev, n = ch.shape
    c = ch.to(torch.int64)
    padded = torch.cat([c, torch.zeros((n_dev, pats.shape[1]),
                                       dtype=torch.int64, device=c.device)], 1)
    match = torch.ones((n_dev, n), dtype=torch.bool, device=c.device)
    for j in range(pats.shape[1]):
        match &= padded[:, j:j + n] == pats[:, j:j + 1].to(torch.int64)
    valid = (torch.arange(n, device=c.device)[None, :]
             < dl[:, None].to(torch.int64))
    nl = ((c == 10) & valid).to(torch.int64)
    line = torch.cumsum(nl, 1) - nl
    occ = torch.zeros((n_dev, n + 1), dtype=torch.int64, device=c.device)
    occ.scatter_add_(1, line, match.to(torch.int64))
    return valid & (occ.gather(1, line) > 0)


def emit_kernel_rows(plan_raw: bytes, pg_raw: bytes):
    """J with its emit epilogue (K16e) against ``grep_step_plain(emit=True)``
    on the same device tensors, every output: [1, 2 MiB] and [8, 2 MiB] for
    ``the`` (pg) and ``dsi`` (the plan corpus) at the optimistic l_cap rung,
    and short lines that overflow it (and clear at n + 1); then the times:
    the emit step and J alone (the same C call without emit) through the
    wrapper and on the card (``j_profile``: launches a call, device time by
    kernel; the epilogue's is what the emit adds to ``gs_lines``), the
    plain version and a stable ``argsort`` + ``gather`` of the same
    compaction.  Returns (times entry, max_abs_err)."""
    import numpy as np
    import torch
    from dsi_tpu_torch.ops import grepk
    from dsi_tpu_torch.parallel.grepstream import (grep_step,
                                                   grep_step_plain)

    n = PLAN_PG_CHUNK
    rung0 = grepk.line_cap_rungs(n)[0]
    short = b"".join(b"the\n" if i % 3 == 0 else b"x\n"
                     for i in range(2 * n))
    cases = []
    for n_dev in (1, 8):
        for tag, raw, pat, l_cap in (
                ("the", pg_raw, "the", rung0),
                ("dsi", plan_raw, "dsi", rung0),
                ("short", short, "the", rung0),
                ("short_n1", short, "the", n + 1)):
            cases.append((f"{tag}_d{n_dev}", raw, pat, l_cap, n_dev))
    err, shapes = 0, {}
    for name, raw, pat, l_cap, n_dev in cases:
        b, lens = _line_batch(raw, n_dev, n)
        args = (torch.from_numpy(b).to(DEVICE),
                torch.from_numpy(np.tile(np.frombuffer(
                    pat.encode(), np.uint8), (n_dev, 1))).to(DEVICE),
                torch.from_numpy(lens).to(DEVICE),
                torch.zeros(n_dev, dtype=torch.int64, device=DEVICE))
        kw = dict(l_cap=l_cap, bins=8, k=16, emit=True)
        got = grep_step(*args, **kw)
        want = grep_step_plain(*args, **kw)
        d = _worst(zip(got, want))
        err = _merge_err(err, d)
        kept = want[4].cpu().numpy()
        overflow = bool(want[2][:, 2].any())
        log({"emit_case": name, "n_dev": n_dev, "N": n, "l_cap": l_cap,
             "overflow": overflow, "kept": int(kept.sum()),
             "max_abs_err": d})
        if name.startswith("short_d") and not overflow:
            raise RuntimeError("the short-line batch did not overflow rung 0")
        if name in ("the_d1", "the_d8", "dsi_d1"):
            shapes[name] = (args, kw, kept, n_dev)
    rows = {}
    for name, (args, kw, kept, n_dev) in shapes.items():
        ch, pats, dl, bases = args
        step_kw = dict(kw, emit=False)
        d = _worst(zip(grep_step(*args, **kw), grep_step_plain(*args, **kw)))
        err = _merge_err(err, d)
        prof = j_profile(lambda: grep_step(*args, **kw), True)
        j_prof = j_profile(lambda: grep_step(*args, **step_kw), False)
        # The epilogue's device time: what the emit adds to gs_lines.
        by, j_by = prof["device_ms_by_kernel"], j_prof["device_ms_by_kernel"]
        epilogue = (None if by is None or j_by is None else
                    by.get("gs_lines", 0.0) - j_by.get("gs_lines", 0.0))
        # The library yardstick: the same stable partition by a sort.
        keep_inv = (~_keep_mask(ch, pats, dl)).to(torch.uint8)
        nbytes = n_dev * (2 * n + pats.shape[1] + 4 + 8 + 4
                          + 4 * (11 + 16 * 5 + 5))
        rows[name] = {
            "max_abs_err": d,
            "ms": cuda_ms(lambda: grep_step(*args, **kw), 20),
            "j_ms": cuda_ms(lambda: grep_step(*args, **step_kw), 20),
            **prof,
            "j_device_ms": j_prof["device_ms"],
            "j_launches_per_call": j_prof["launches_per_call"],
            "epilogue_device_ms": epilogue,
            "plain_ms": cuda_ms(lambda: grep_step_plain(*args, **kw), 3),
            "library_ms": cuda_ms(lambda: torch.gather(
                ch, 1, torch.argsort(keep_inv, dim=1, stable=True)), 10),
            "bytes": nbytes, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes", "kept": int(kept.sum()),
            "shape": f"n_dev={n_dev} N={n} l_cap={kw['l_cap']} k=16 "
                     f"pattern={'dsi' if name == 'dsi_d1' else 'the'}"}
    main = rows.pop("the_d1")
    return {**main, "at_shapes": rows}, err


def check_relay_edges() -> int:
    """Kernel P on ``kernel_cases.relay_cases`` at [1, 2^20], [8, 2^20],
    [8, 2^20 - 5] (rows off the 16-byte grid) and [40, 4093] (more rows
    than one launch takes): offsets at every residue mod 16 around
    mid-row, below 0, below ``-cap``, at and past ``cap``, mixed, each held
    to ``relay_pack_plain``.  Returns the worst max_abs_err."""
    import torch
    from dsi_tpu_torch.device.relay import relay_pack, relay_pack_plain
    from dsi_tpu_torch.utils import kernel_cases as kc

    err = 0
    for n_dev, cap in ((1, PLAN_CHUNK), (8, PLAN_CHUNK), (8, PLAN_CHUNK - 5),
                       (40, 4093)):
        for name, acc_np, off, new_np in kc.relay_cases(n_dev, cap):
            acc = torch.from_numpy(acc_np).to(DEVICE)
            new = torch.from_numpy(new_np).to(DEVICE)
            got = relay_pack(acc.clone(), off, new)
            d = _diff(got, relay_pack_plain(
                acc, torch.from_numpy(off).to(DEVICE), new))
            err = _merge_err(err, d)
            log({"relay_edge_case": f"{name} [{n_dev}, {cap}]",
                 "off": off.tolist(), "max_abs_err": d})
    return err


def relay_append_rows(failures) -> dict:
    """One packing ``DeviceRelay.append`` (one byte a row after an open
    buffer's fill point) at [1, 2^20] and [8, 2^20], through
    ``wrapper_profile``: its CUDA launches, Memcpys, device time and
    allocations a call, timed with CUDA events; the run fails above one
    launch, any Memcpy or any allocation a call, or where one of the
    three went unmeasured."""
    import numpy as np
    import torch
    from dsi_tpu_torch.device.relay import DeviceRelay

    rows = {}
    for n_dev in (1, 8):
        relay = DeviceRelay(n_dev, cap=PLAN_CHUNK, device=DEVICE)
        relay.append(torch.zeros((n_dev, PLAN_CHUNK), dtype=torch.uint8,
                                 device=DEVICE), np.ones(n_dev, np.int64))
        one = torch.ones((n_dev, PLAN_CHUNK), dtype=torch.uint8,
                         device=DEVICE)
        kept = np.ones(n_dev, np.int64)
        ms = cuda_ms(lambda: relay.append(one, kept), 50)
        prof = wrapper_profile(lambda: relay.append(one, kept),
                               "relay_pack_kernel")
        tag = f"relay_append [{n_dev}, {PLAN_CHUNK}]"
        failures += unmeasured(tag, prof, ("launches_per_call",
                                           "copies_per_call",
                                           "allocs_per_call"))
        failures += over_budget(tag, prof, 1, 0)
        if prof["copies_per_call"]:
            failures.append(f"{tag}: {prof['copies_per_call']} Memcpys a "
                            "call")
        rows[f"append_d{n_dev}"] = {
            "ms": ms, **prof,
            "shape": f"DeviceRelay.append [{n_dev}, {PLAN_CHUNK}], 1 byte a "
                     "row after the fill point"}
        log({"relay_append": tag, **rows[f"append_d{n_dev}"]})
    return rows


def relay_kernel_rows(failures):
    """P against ``relay_pack_plain`` at [1, 2^20] and [8, 2^20] with the
    offsets 0, mid-row and ``cap - kept`` (host arrays, as the relay
    passes them) on the same device tensors, timed beside it, each with
    its launches and allocations a call (the run fails above one launch
    or any allocation, or where either went unmeasured); P's edge cases
    (:func:`check_relay_edges`); one packing ``DeviceRelay.append``
    (:func:`relay_append_rows`); then a
    DeviceRelay fed 64 appends at [8, 1 MiB], every row held to the host
    concatenation of what was appended.  Returns (times entry,
    max_abs_err, relay entry)."""
    import numpy as np
    import torch
    from dsi_tpu_torch.device.relay import (DeviceRelay, relay_pack,
                                            relay_pack_plain)

    cap = PLAN_CHUNK
    rng = np.random.default_rng(SEED)
    err, rows = 0, {}
    for n_dev in (1, 8):
        acc = torch.from_numpy(rng.integers(0, 256, (n_dev, cap),
                                            dtype=np.uint8)).to(DEVICE)
        kept = rng.integers(cap // 8, cap // 4, n_dev)
        new_np = np.zeros((n_dev, cap), np.uint8)
        for r in range(n_dev):
            new_np[r, :kept[r]] = rng.integers(1, 256, kept[r])
        new = torch.from_numpy(new_np).to(DEVICE)
        for where, off_np in (("zero", np.zeros(n_dev, np.int64)),
                              ("mid", np.full(n_dev, cap // 2)),
                              ("cap-kept", cap - kept)):
            off_dev = torch.from_numpy(off_np).to(DEVICE)
            got = relay_pack(acc.clone(), off_np, new)
            d = _worst([(got, relay_pack_plain(acc, off_dev, new))])
            err = _merge_err(err, d)
            work = acc.clone()
            ms = cuda_ms(lambda: relay_pack(work, off_np, new), 50)
            prof = wrapper_profile(lambda: relay_pack(work, off_np, new),
                                   "relay_pack_kernel")
            failures += unmeasured(f"relay_pack {where}_d{n_dev}", prof)
            failures += over_budget(f"relay_pack {where}_d{n_dev}", prof, 1,
                                    0)
            moved = int((cap - off_np).sum())
            nbytes = 2 * moved
            rows[f"{where}_d{n_dev}"] = {
                "max_abs_err": d, "ms": ms, **prof,
                "plain_ms": cuda_ms(lambda: relay_pack_plain(acc, off_dev,
                                                             new), 10),
                "library_ms": None, "bytes": nbytes,
                "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                "bound_by": "bytes",
                "shape": f"[{n_dev}, {cap}] off {where}"}
            log({"relay_case": f"{where}_d{n_dev}",
                 **rows[f"{where}_d{n_dev}"]})
    err = _merge_err(err, check_relay_edges())
    rows.update(relay_append_rows(failures))
    # 64 appends of up to a quarter row: packs, seals and the open tail.
    n_dev = 8
    relay_st: dict = {}
    relay = DeviceRelay(n_dev, cap=cap, device=DEVICE, stats=relay_st)
    want = [bytearray() for _ in range(n_dev)]
    for _ in range(PLAN_RELAY_APPENDS):
        kept = rng.integers(0, cap // 4, n_dev)
        buf = np.zeros((n_dev, cap), np.uint8)
        for r in range(n_dev):
            buf[r, :kept[r]] = rng.integers(1, 256, kept[r])
            want[r] += buf[r, :kept[r]].tobytes()
        relay.append(torch.from_numpy(buf).to(DEVICE), kept)
    got = [bytearray() for _ in range(n_dev)]
    for b in relay.batches():
        host = b.cpu().numpy()
        for r in range(n_dev):
            nz = np.flatnonzero(host[r])
            got[r] += host[r, :int(nz[-1]) + 1 if nz.size else 0].tobytes()
    relay_entry = {"appends": PLAN_RELAY_APPENDS,
                   "bytes": relay.total_bytes,
                   "equal_to_host_concat": got == want,
                   **{k: relay_st[k] for k in ("plan_relay_buffers",
                                               "plan_intermediate_bytes")}}
    main = rows.pop("mid_d1")
    return {**main, "at_shapes": rows}, err, relay_entry


def matching_text(paths, pattern: str) -> bytes:
    """The lines of ``stream_files(paths)`` that contain ``pattern``, each
    with its newline (an unterminated last line without): the bytes a grep
    stage hands on."""
    from dsi_tpu_torch.parallel.streaming import stream_files

    pat = pattern.encode()
    parts = b"".join(stream_files(paths)).split(b"\n")
    return b"".join(ln + (b"\n" if i < len(parts) - 1 else b"")
                    for i, ln in enumerate(parts) if pat in ln)


def wc_oracle(text: bytes, workdir: str, tag: str) -> list:
    """The sequential word count's sorted output lines over ``text``."""
    d = os.path.join(workdir, tag)
    os.makedirs(d)
    path = os.path.join(d, "input.txt")
    with open(path, "wb") as f:
        f.write(text)
    return run_oracle([path], d)


def plan_run(tag, make, paths_bytes: int, **kw):
    """``run_plan(make(), **kw)`` on the card, the call alone timed, launch
    counts zeroed just before and read just after; returns (result, entry)."""
    from dsi_tpu_torch.ops import wordcount as w
    from dsi_tpu_torch.plan import run_plan

    stats: dict = {}
    plan = make()
    w.reset_launches()
    t0 = time.perf_counter()
    res = run_plan(plan, device=DEVICE, stats=stats, **kw)
    sync()
    seconds = time.perf_counter() - t0
    launches = w.launch_counts()
    entry = {"seconds": seconds, "mb_per_s": paths_bytes / seconds / 1e6,
             "input_bytes": paths_bytes, "launches": launches,
             # A staged run has no device relay: no buffers, no spills.
             **{k: stats.get(k, 0) for k in PLAN_STATS},
             "engines": {name: (st if isinstance(st, dict) else st[0])
                         for name, st in stats["plan_engine_stats"].items()}}
    for name, st in entry["engines"].items():
        entry["engines"][name] = {k: v for k, v in st.items()
                                  if isinstance(v, (int, float))}
    return res, entry


def _wc_parity(final: dict, want: dict, cycles: int = 1) -> bool:
    from dsi_tpu_torch.mr.sequential import ihash

    return (stream_parity({k: c for k, (c, _) in final.items()}, want,
                          cycles)
            and all(p == ihash(k) % N_REDUCE for k, (_, p) in final.items()))


def plan_paths(files, corpus, want_counts, work, gpu, failures):
    """Phase 13's paths over the plan row's ``corpus`` and the pg
    ``files`` (``want_counts``: their sequential word count), each held to
    its staged twin and its oracles.  Returns ({path: launches}, {path:
    entry})."""
    import glob
    import io

    from dsi_tpu_torch.cli import planrun
    from dsi_tpu_torch.ops import wordcount as w
    from dsi_tpu_torch.parallel.grepstream import (DEFAULT_TOPK,
                                                   grep_host_oracle)
    from dsi_tpu_torch.parallel.streaming import stream_files
    from dsi_tpu_torch.plan import (grep_cascade_plan, grep_wordcount_plan,
                                    indexer_join_plan, wordcount_topk_plan)
    from dsi_tpu_torch.plan.stagehost import build_plan

    runs, results = {}, {}

    def run(tag, make, nbytes, chained=True, **kw):
        res, entry = plan_run(tag, make, nbytes, **kw)
        runs[tag], results[tag] = entry, res
        log({tag: {k: v for k, v in entry.items() if k != "engines"},
             "gpu": gpu})
        log({f"{tag}_engines": entry["engines"]})
        if chained and entry["plan_spilled_bytes"] == 0 and \
                entry["plan_intermediate_bytes"] != 0:
            failures.append(f"{tag}: {entry['plan_intermediate_bytes']} "
                            "intermediate bytes crossed the host")
        return res

    def same(tag, twin):
        if results[tag].results != results[twin].results:
            failures.append(f"{tag}: differs from {twin}")

    # The bench's plan row.
    nbytes = os.path.getsize(corpus)
    spec = {"chain": "grep-wc", "pattern": PLAN_PATTERN, "files": [corpus],
            "chunk_bytes": PLAN_CHUNK, "u_cap": PLAN_U_CAP,
            "n_reduce": N_REDUCE}
    t0 = time.perf_counter()
    g_want = grep_host_oracle(stream_files([corpus]), PLAN_PATTERN)
    oracle_lines = wc_oracle(matching_text([corpus], PLAN_PATTERN), work,
                             "plan-oracle")
    wc_want = oracle_counts(oracle_lines)
    log({"plan_oracle_s": time.perf_counter() - t0,
         "matched": g_want.matched, "words": len(wc_want)})
    run("plan_warm", lambda: build_plan(spec), nbytes)  # first use
    run("plan_chained", lambda: build_plan(spec), nbytes)
    run("plan_staged", lambda: build_plan(spec), nbytes, chained=False,
        staged=True)
    run("plan_pipelined", lambda: build_plan(spec), nbytes, pipelined=True)
    run("plan_n8", lambda: build_plan(dict(
        spec, device_accumulate=True, mesh_shards=MESH_SHARDS)), nbytes,
        n_dev=MESH_SHARDS)
    for tag in ("plan_chained", "plan_pipelined", "plan_n8"):
        same(tag, "plan_staged")
    res = results["plan_staged"]
    if res.results["grep"] != g_want:
        failures.append("plan_staged: the grep stage differs from "
                        "grep_host_oracle")
    if not _wc_parity(res.final, wc_want):
        failures.append("plan_staged: the counts differ from the "
                        "sequential word count of the matching lines")
    if runs["plan_pipelined"]["plan_pipelined"] != 1:
        failures.append("plan_pipelined: the pair did not pipeline")
    sharded = lambda: build_plan(spec)  # noqa: E731
    run("plan_stage_shards", sharded, nbytes,
        stage_shards=PLAN_STAGE_SHARDS)
    run("plan_stage_shards_staged", sharded, nbytes, chained=False,
        staged=True, stage_shards=PLAN_STAGE_SHARDS)
    same("plan_stage_shards", "plan_stage_shards_staged")
    g = results["plan_stage_shards"].results["grep"]
    # A stage-sharded grep merge drops the order-sensitive top-k.
    if g != g_want._replace(topk=()) or not _wc_parity(
            results["plan_stage_shards"].final, wc_want):
        failures.append("plan_stage_shards: differs from the oracles")

    # The pg corpus cycled to 64 MB.
    corpus_bytes = sum(os.path.getsize(p) for p in files) + len(files) - 1
    cycles = max(1, round(PLAN_PG_MB * 1e6 / corpus_bytes))
    pg = list(files) * cycles
    pg_bytes = corpus_bytes * cycles + cycles - 1
    t0 = time.perf_counter()
    pg_grep = grep_host_oracle(stream_files(pg), PLAN_PG_PATTERN)
    # Every cycle hands on the same lines, so one cycle's counts times
    # the cycles are the stream's.
    pg_wc = oracle_counts(wc_oracle(matching_text(files, PLAN_PG_PATTERN),
                                    work, "pg-oracle"))
    pg_lines = matching_text(pg, PLAN_CASCADE[0])
    cascade_want = grep_host_oracle([pg_lines], PLAN_CASCADE[1])
    th_grep = grep_host_oracle(stream_files(pg), PLAN_SEAL_PATTERN)
    th_wc = oracle_counts(wc_oracle(matching_text(files, PLAN_SEAL_PATTERN),
                                    work, "pg-th-oracle"))
    log({"plan_pg_oracle_s": time.perf_counter() - t0, "cycles": cycles,
         "matched": pg_grep.matched, "th_matched": th_grep.matched})

    def pg_plan(pattern, **kw):
        return lambda: grep_wordcount_plan(
            pattern, paths=pg, chunk_bytes=PLAN_PG_CHUNK,
            u_cap=STREAM_U_CAP, **kw)

    for tag, pattern, g_want_, wc_want_ in (
            ("plan_pg", PLAN_PG_PATTERN, pg_grep, pg_wc),
            ("plan_pg_th", PLAN_SEAL_PATTERN, th_grep, th_wc)):
        run(tag, pg_plan(pattern), pg_bytes)
        run(f"{tag}_staged", pg_plan(pattern), pg_bytes, chained=False,
            staged=True)
        same(tag, f"{tag}_staged")
        res = results[tag]
        if res.results["grep"] != g_want_ or not _wc_parity(
                res.final, wc_want_, cycles):
            failures.append(f"{tag}: differs from the oracles")
    run("plan_pg_th_spill", pg_plan(PLAN_SEAL_PATTERN,
                                    spill_mb=PLAN_SPILL_MB), pg_bytes)
    same("plan_pg_th_spill", "plan_pg_th_staged")
    if runs["plan_pg_th"]["plan_relay_buffers"] < 4:
        failures.append("plan_pg_th: fewer than 4 relay buffers sealed")
    sp = runs["plan_pg_th_spill"]
    if sp["plan_spilled_bytes"] < 1 or \
            sp["plan_intermediate_bytes"] != sp["plan_spilled_bytes"]:
        failures.append(f"plan_pg_th_spill: spilled "
                        f"{sp['plan_spilled_bytes']}"
                        f", intermediate {sp['plan_intermediate_bytes']}")

    def cascade():
        return grep_cascade_plan(*PLAN_CASCADE, paths=pg,
                                 chunk_bytes=PLAN_PG_CHUNK)

    def topk():
        return wordcount_topk_plan(DEFAULT_TOPK, paths=pg,
                                   chunk_bytes=PLAN_PG_CHUNK,
                                   u_cap=STREAM_U_CAP)

    run("plan_cascade", cascade, pg_bytes, chained=False)
    run("plan_cascade_staged", cascade, pg_bytes, chained=False,
        staged=True)
    run("plan_wc_topk", topk, pg_bytes)
    run("plan_wc_topk_staged", topk, pg_bytes, chained=False, staged=True)
    same("plan_cascade", "plan_cascade_staged")
    same("plan_wc_topk", "plan_wc_topk_staged")
    c = results["plan_cascade"].results
    if c["grep1"] != pg_grep or c["grep2"] != cascade_want._replace(topk=()):
        failures.append("plan_cascade: differs from grep_host_oracle")
    # The cascade pulls its first relay through the host, counted.
    if runs["plan_cascade"]["plan_intermediate_bytes"] != len(pg_lines):
        failures.append("plan_cascade: the host crossing was not counted")
    top_want = tuple(sorted(((c * cycles, w_)
                             for w_, c in want_counts.items()),
                            key=lambda r: (-r[0], r[1]))[:DEFAULT_TOPK])
    if results["plan_wc_topk"].final != top_want:
        failures.append("plan_wc_topk: differs from the sequential top-k")

    # The indexer chain: the 8 pg files as 8 documents, u_cap 2^15.
    idx_lines, idx_top = indexer_oracle(files, work)
    idx_want = {}
    for ln in idx_lines:
        word, df, docs = ln.decode().split(" ", 2)
        idx_want[word] = (int(df), docs.split(","))
    docs = []
    for p in files:
        with open(p, "rb") as f:
            docs.append(f.read())
    for tag, dacc in (("plan_indexer", False), ("plan_indexer_acc", True)):
        def make(dacc=dacc):
            return indexer_join_plan(docs, topk=DEFAULT_TOPK,
                                     u_cap=TFIDF_U_CAP,
                                     device_accumulate=dacc)

        run(tag, make, sum(map(len, docs)))
        run(f"{tag}_staged", make, sum(map(len, docs)), chained=False,
            staged=True)
        r = results[tag]
        if r.results["dftopk"] != results[f"{tag}_staged"].results[
                "dftopk"] or r.final != results[f"{tag}_staged"].final:
            failures.append(f"{tag}: differs from its staged twin")
        if r.results["dftopk"] != idx_top:
            failures.append(f"{tag}: the df top-k differs from the oracle's")
        if len(r.final) != len(idx_top) or any(
                (df, sorted(files[d] for d in ds)) != idx_want.get(w_)
                for w_, (df, _, ds) in r.final.items()):
            failures.append(f"{tag}: the postings join differs from the "
                            "oracle's")

    # planrun --chain grep-wc --check in process, mr-out-* written.
    outdir = os.path.join(work, "planrun")
    out, err = io.StringIO(), io.StringIO()
    w.reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = planrun.main(["--chain", "grep-wc", "--pattern", PLAN_PATTERN,
                           "--chunk-bytes", str(PLAN_CHUNK), "--check",
                           "--workdir", outdir, "--device", DEVICE,
                           corpus])
    sync()
    cli_s = time.perf_counter() - t0
    launches = {"plan_cli": w.launch_counts()}
    text = err.getvalue()
    if rc != 0 or "parity OK" not in text:
        failures.append(f"planrun rc={rc}: {text[-1000:]}")
    cli_lines = sorted_lines(sorted(glob.glob(os.path.join(outdir,
                                                           "mr-out-*"))))
    if cli_lines != oracle_lines:
        failures.append("planrun: mr-out-* differ from the sequential word "
                        "count of the matching lines")
    runs["plan_cli"] = {"seconds": cli_s, "mb_per_s": nbytes / cli_s / 1e6,
                        "rc": rc, "parity": cli_lines == oracle_lines,
                        "launches": launches["plan_cli"],
                        "stderr": text.splitlines()[-4:]}
    log({"plan_cli": runs["plan_cli"], "gpu": gpu})
    runs.pop("plan_warm")
    return ({**{k: v["launches"] for k, v in runs.items()}, **launches},
            runs)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import numpy as np

    from dsi_tpu_torch.apps.wc import tokenize as host_tokenize
    from dsi_tpu_torch.kernels import build
    from dsi_tpu_torch.mr.sequential import ihash
    from dsi_tpu_torch.ops import wordcount as w
    from dsi_tpu_torch.ops.corpus_wc import _resolve_pieces
    from dsi_tpu_torch.slice_profile import pinned_grouper
    from dsi_tpu_torch.utils.corpus import ensure_corpus

    gpu = gpu_line()
    log(f"gpu: {gpu}")
    t0 = time.perf_counter()
    build.library()
    log({"build_s": time.perf_counter() - t0,
         "ptxas": [ln.strip() for ln in build.build_log.splitlines()
                   if "registers" in ln or ln.startswith("==")]})

    failures = stream_handle_failures()
    with tempfile.TemporaryDirectory(prefix="chip-smoke-") as work:
        t0 = time.perf_counter()
        files = ensure_corpus(os.path.join(work, "corpus"), N_FILES,
                              FILE_SIZE, SEED)
        raws = []
        for p in files:
            with open(p, "rb") as f:
                raws.append(f.read())
        corpus_buf, _, _ = _resolve_pieces(raws, None)
        split_buf = w._pad_pow2(raws[0])
        log({"corpus_s": time.perf_counter() - t0,
             "corpus_bytes": sum(len(r) for r in raws),
             "padded_bytes": len(corpus_buf)})

        # Phase 2: kernels against their plain versions, then their times.
        err = check_kernels(kernel_cases(corpus_buf))
        a_edge, c_edge = check_tile_edges()
        err["tokenize"] = _merge_err(err["tokenize"], a_edge)
        err["group"] = _merge_err(err["group"], c_edge)
        err["fnv"] = _merge_err(err["fnv"], check_fnv())
        corpus_keys = w.tokenize(torch.from_numpy(corpus_buf).to(DEVICE),
                                 max_word_len=MWL,
                                 t_cap=len(corpus_buf) // 4 + 1)[0]
        err["radix_sort"] = _merge_err(
            err["radix_sort"], check_radix_sort(radix_sort_cases(corpus_keys)))
        del corpus_keys
        failures += [f"{k} differs from its plain version"
                     for k, e in err.items() if e != 0]
        times = time_kernels(corpus_buf, split_buf)
        a_step = times["tokenize"]["at_shapes"]["stream_step"]["max_abs_err"]
        err["tokenize"] = _merge_err(err["tokenize"], a_step)
        if a_step != 0:
            failures.append("tokenize differs from its plain version at the "
                            "stream step's shape")

        # Phase 3: the slice at full size.
        t0 = time.perf_counter()
        oracle = run_oracle(files, work)
        oracle_s = time.perf_counter() - t0
        corpus_path(files, work, "warm")  # first use: allocator, context
        lines, phases, launch_main, nbytes = corpus_path(files, work, "main")
        if lines != oracle:
            failures.append("mr-out-* differ from the oracle")

        rng = np.random.default_rng(SEED)
        long_word = bytes(rng.integers(97, 123, 40).astype(np.uint8))
        dir64 = os.path.join(work, "corpus64")
        os.makedirs(dir64)
        files64 = []
        for i, raw in enumerate(raws):
            p = os.path.join(dir64, os.path.basename(files[i]))
            with open(p, "wb") as f:
                f.write(raw + (b" " + long_word if i == len(raws) - 1
                               else b""))
            files64.append(p)
        oracle64 = run_oracle(files64, dir64)
        lines64, phases64, launch64, _ = corpus_path(files64, work, "mwl64")
        if lines64 != oracle64:
            failures.append("mwl-64 mr-out-* differ from the oracle")
        if launch64["tokenize"] < 2:
            failures.append("the 40-letter word did not force a second rung")

        w.reset_launches()
        t0 = time.perf_counter()
        got = w.count_words_host_result(raws[0], device=DEVICE)
        split_s = time.perf_counter() - t0
        launch_split = w.launch_counts()
        want = collections.Counter(host_tokenize(raws[0].decode("ascii")))
        if got != {word: (c, ihash(word)) for word, c in want.items()}:
            failures.append("count_words_host_result differs from oracle")

        # Phase 4: kernel E against its plain version, its time, and B / C
        # at the reduce shape.
        rows1, dest1 = stream_step_rows(raws[0])
        err["route"] = check_route(route_cases(rows1, dest1)
                                   + shared_route_cases())
        times["route"] = route_entry(rows1, dest1, 1, MWL // 4,
                                     "stream step", 50)
        stream_fnv = stream_fnv_entry(raws[0])
        err["route"] = _merge_err(err["route"],
                                  times["route"]["max_abs_err"])
        err["fnv"] = _merge_err(err["fnv"], stream_fnv["max_abs_err"])
        for name in ("fnv", "route"):
            if err[name] != 0:
                failures.append(f"{name} differs from its plain version")
        shapes = {"reduce": reduce_shape_times(rows1, dest1)}

        # Phase 5: the streaming SPMD word count.
        data = b"\n".join(raws)
        sharded = {}
        for n_dev in (1, 8):
            parity, secs, launches = sharded_path(data, n_dev, work, oracle)
            sharded[n_dev] = {"parity": parity, "seconds": secs,
                              "launches": launches}
            if not parity:
                failures.append(f"wordcount_sharded n_dev={n_dev} mr-out-* "
                                "differ from the oracle")
        want_counts = oracle_counts(oracle)
        cycles = max(1, round(STREAM_MB * 1e6 / len(data)))
        stream = {}

        def stream_run(tag, run):
            parity, secs, stats, launches, res = run()
            stream[tag] = {"parity": parity, "seconds": secs,
                           "mb_per_s": len(data) * cycles / secs / 1e6,
                           "launches": launches,
                           "pipeline_stats": {k: stats[k]
                                              for k in STREAM_PHASES
                                              if k in stats}}
            log({tag: {**stream[tag], "gpu": gpu, "cycles": cycles,
                       "input_bytes": len(data) * cycles}})
            if not parity:
                failures.append(f"{tag}: counts differ from the oracle's "
                                f"times {cycles}")
            if tag != "stream" and stream[tag]["pipeline_stats"].get(
                    "folds", 0) < 1:
                failures.append(f"{tag}: no fold ran with the device table "
                                "on")
            return res

        stream_run("stream", lambda: stream_path(files, cycles, want_counts,
                                                 False))
        stream_run("stream_acc", lambda: stream_path(files, cycles,
                                                     want_counts, True))
        stream_run("stream_cli", lambda: stream_cli_path(files, cycles,
                                                         want_counts, work))
        shapes["fold"] = fold_shape_times(
            raws, stream["stream_acc"]["pipeline_stats"]["table_cap"])

        # Phase 5b: crash-resume checkpoints of the stream.
        nbytes_stream = len(data) * cycles
        ckpt = {"rows": ckpt_rows(files, cycles, want_counts, nbytes_stream,
                                  work, gpu, failures)}
        ckpt["capture"], fails = ckpt_capture_check(raws)
        failures += fails
        log({"ckpt_capture": {**ckpt["capture"], "gpu": gpu}})
        # The postings buffer's capture (phase 10b's services) here, early
        # in the process, where the profiler's windows are whole.
        ckpt["postings_capture"], fails = postings_capture_check(raws)
        failures += fails
        log({"postings_capture": {**ckpt["postings_capture"], "gpu": gpu}})
        ckpt_paths = {}
        for tag, point, step, kw in (
                ("stream_ckpt", "mid-fold", 9, {}),
                ("stream_ckpt_async", "mid-commit", 3,
                 {"checkpoint_async": True, "checkpoint_delta": True})):
            entry, _, fails = ckpt_resume_path(
                tag, files, cycles, want_counts, work, point=point,
                step=step, **kw)
            ckpt_paths[tag] = entry
            failures += fails
            log({tag: {**entry, "gpu": gpu, "input_bytes": nbytes_stream}})
        entry, _, fails = ckpt_cli_path(files, cycles, want_counts, work)
        ckpt_paths["stream_ckpt_cli"] = entry
        failures += fails
        log({"stream_ckpt_cli": {**entry, "gpu": gpu,
                                 "input_bytes": nbytes_stream}})

        # Phase 6: F and G against their plain versions, and D / E / B / C
        # at the mesh-sharded fold's shapes.
        err["hash_group"], fails = check_hash_group(
            hash_group_cases(corpus_buf, split_buf, raws[0]))
        failures += fails
        forced_err, fails = check_forced_buckets(forced_bucket_cases())
        err["hash_group"] = _merge_err(err["hash_group"], forced_err)
        failures += fails
        times["hash_group"] = time_hash_group(corpus_buf, MWL, True,
                                              w.rung0_cap(len(corpus_buf),
                                                          CORPUS_U_CAP))
        hash_shapes = {"split": time_hash_group(
            split_buf, MWL, False, w.rung0_cap(len(split_buf),
                                               SPLIT_U_CAP))}
        err["pack6"], (pk, tb) = check_pack6(corpus_buf)
        times["pack6"] = time_pack6(pk, tb)
        mesh_shapes = mesh_fold_shapes(raws)
        before_after = launches_before_after(raws)
        log({"launches_before_after": before_after, "gpu": gpu})
        for name, v in before_after.items():
            if not v["outputs_equal"]:
                failures.append(f"{name}: the older call sequence gives "
                                "other outputs")
        if before_after["route_dest_mesh_fold"]["after"] not in (None, 1):
            failures.append("route_dest takes more than one CUDA launch")
        for name in ("hash_group", "pack6"):
            if err[name] != 0:
                failures.append(f"{name} differs from its plain version")
        shapes["mesh_fold"] = {name: mesh_shapes[name]
                               for name in ("radix_sort", "group")}
        log({"sort_group_shapes": shapes, "mesh_fold_shapes": mesh_shapes,
             "hash_group_shapes": hash_shapes, "gpu": gpu})
        for name in ("radix_sort", "group"):
            for shape, v in shapes.items():
                err[name] = _merge_err(err[name], v[name]["max_abs_err"])
                if v[name]["max_abs_err"] != 0:
                    failures.append(f"{name} differs from its plain version "
                                    f"at the {shape} shape")
        for name in ("fnv", "route"):
            err[name] = _merge_err(err[name],
                                   mesh_shapes[name]["max_abs_err"])
            if mesh_shapes[name]["max_abs_err"] != 0:
                failures.append(f"{name} differs from its plain version at "
                                "the mesh_fold shape")

        # Phase 7: every configuration of the word count.
        corpus_runs = {}
        for tag, kw in (("corpus_hash", {"grouper": "hash"}),
                        ("corpus_pack6", {"pack6": True,
                                          "grouper": "sort"}),
                        ("corpus_pack6_hash", {"pack6": True,
                                               "grouper": "hash"})):
            c_lines, c_phases, c_launch, _ = corpus_path(files, work, tag,
                                                         **kw)
            c_total = sum(c_phases.values())
            corpus_runs[tag] = {"parity": c_lines == oracle, **c_phases,
                                "mb_per_s": nbytes / c_total / 1e6,
                                "launches": c_launch}
            if c_lines != oracle:
                failures.append(f"{tag}: mr-out-* differ from the oracle")
        # The sort and the hash grouper in turns (sort, hash, hash, sort,
        # twice for the corpus): the end-to-end gap beside its spread.
        turns = {"corpus": [], "stream_acc": []}
        for i, g in enumerate(("sort", "hash", "hash", "sort") * 2):
            t_lines, t_phases, _, _ = corpus_path(files, work, f"turn{i}",
                                                  grouper=g)
            if t_lines != oracle:
                failures.append(f"corpus turn {i} ({g}): mr-out-* differ "
                                "from the oracle")
            turns["corpus"].append(
                {"grouper": g, **t_phases,
                 "mb_per_s": nbytes / sum(t_phases.values()) / 1e6})
        for i, g in enumerate(("sort", "hash", "hash", "sort")):
            with pinned_grouper(g):
                parity, secs, st, _, _ = stream_path(files, cycles,
                                                     want_counts, True)
            if not parity:
                failures.append(f"stream turn {i} ({g}): counts differ "
                                "from the oracle's")
            turns["stream_acc"].append(
                {"grouper": g, "seconds": secs,
                 "mb_per_s": len(data) * cycles / secs / 1e6,
                 **{k: st[k] for k in ("dispatch_s", "fold_s",
                                       "finalize_s")}})
        log({"grouper_turns": turns, "gpu": gpu})
        with pinned_grouper("hash"):
            w.reset_launches()
            t0 = time.perf_counter()
            got = w.count_words_host_result(raws[0], device=DEVICE)
            split_hash_s = time.perf_counter() - t0
            launch_split_hash = w.launch_counts()
            if got != {word: (c, ihash(word)) for word, c in want.items()}:
                failures.append("split_hash: count_words_host_result "
                                "differs from the oracle")
            parity, secs, launch_sharded_hash = sharded_path(
                data, 8, os.path.join(work, "hash"), oracle)
            if not parity:
                failures.append("sharded_hash: mr-out-* differ from the "
                                "oracle")
            stream_run("stream_hash", lambda: stream_path(
                files, cycles, want_counts, True))
        base = stream_run("stream_mesh_base", lambda: stream_path(
            files, cycles, want_counts, True, n_dev=MESH_SHARDS))
        for tag in ("stream_mesh", "stream_mesh_widen"):
            old_cap = os.environ.pop("DSI_DEVICE_TABLE_CAP", None)
            if tag == "stream_mesh_widen":
                os.environ["DSI_DEVICE_TABLE_CAP"] = str(MESH_WIDEN_CAP)
            try:
                res = stream_run(tag, lambda: stream_path(
                    files, cycles, want_counts, True, n_dev=MESH_SHARDS,
                    mesh_shards=MESH_SHARDS))
            finally:
                os.environ.pop("DSI_DEVICE_TABLE_CAP", None)
                if old_cap is not None:
                    os.environ["DSI_DEVICE_TABLE_CAP"] = old_cap
            st = stream[tag]["pipeline_stats"]
            if res != base:
                failures.append(f"{tag}: differs from the same stream "
                                "without mesh_shards")
            if st.get("mesh_shards") != MESH_SHARDS:
                failures.append(f"{tag}: the table was not mesh-sharded")
            # The mesh fold launches D (the route) and E (the exchange)
            # on top of the steps' own: the base stream runs the same
            # steps with the unsharded fold.
            for name in ("fnv", "route"):
                extra = (stream[tag]["launches"][name]
                         - stream["stream_mesh_base"]["launches"][name])
                if extra < st.get("folds", 0) or extra < 1:
                    failures.append(f"{tag}: the fold launched {name} "
                                    f"{extra} times for {st.get('folds')} "
                                    "folds")
            log({f"{tag}_stats": {k: st.get(k) for k in (
                "mesh_shards", "shard_widens", "shard_imbalance",
                "pull_bytes", "folds", "fold_overflows", "widens",
                "table_cap")}, "gpu": gpu})
        if sum(stream["stream_mesh_widen"]["pipeline_stats"].get(
                "shard_widens", [])) < 1:
            failures.append("stream_mesh_widen: no shard widened")

        # Phase 8: grep.
        from dsi_tpu_torch.parallel.grepstream import grep_host_oracle
        from dsi_tpu_torch.parallel.streaming import cycle_files

        grep_tiers, launch_grep_tiers, fails = grep_tiers_path(raws[0])
        failures += fails
        log({"grep_tiers": grep_tiers, "gpu": gpu})
        corpus_bytes = sum(len(r) for r in raws)
        grep_cycles = max(1, round(GREP_MB * 1e6 / corpus_bytes))
        grep_bytes = corpus_bytes * grep_cycles
        t0 = time.perf_counter()
        grep_want = grep_host_oracle(cycle_files(files, grep_cycles),
                                     GREP_PATTERN)
        grep_oracle_s = time.perf_counter() - t0
        grep_stream_path(files, grep_cycles, grep_want,
                         device_accumulate=True)  # warm: first use
        grep = {}

        def grep_run(tag, **kw):
            res, secs, st, launches, parity = grep_stream_path(
                files, grep_cycles, grep_want, **kw)
            grep[tag] = {"parity": parity, "seconds": secs,
                         "mb_per_s": grep_bytes / secs / 1e6,
                         "launches": launches,
                         "pipeline_stats": {k: st[k] for k in GREP_PHASES
                                            if k in st}}
            log({tag: {**grep[tag], "gpu": gpu, "input_bytes": grep_bytes,
                       "oracle_mb_per_s": grep_bytes / grep_oracle_s / 1e6,
                       "matched": grep_want.matched,
                       "occurrences": grep_want.occurrences}})
            if not parity:
                failures.append(f"{tag}: the result differs from "
                                "grep_host_oracle")
            if kw.get("device_accumulate") and (
                    st.get("folds", 0) < 1 or st["step_pulls"] != 0):
                failures.append(f"{tag}: the device services did not fold")
            return res

        grep_run("grep_stream", device_accumulate=False)
        grep_run("grep_stream_acc", device_accumulate=True)
        base = grep_run("grep_stream_mesh_base", device_accumulate=True,
                        n_dev=MESH_SHARDS)
        if grep_run("grep_stream_mesh", device_accumulate=True,
                    n_dev=MESH_SHARDS, mesh_shards=MESH_SHARDS) != base:
            failures.append("grep_stream_mesh: differs from the same stream "
                            "without mesh_shards")
        if grep["grep_stream_mesh"]["pipeline_stats"].get(
                "mesh_shards") != MESH_SHARDS:
            failures.append("grep_stream_mesh: the services were not "
                            "mesh-sharded")
        secs, st, launches, cli_out = grep_cli_path(files, grep_cycles)
        cli_parity = cli_out == grep_cli_text(grep_want)
        if not cli_parity:
            failures.append("grep_cli: the output differs from "
                            "grep_host_oracle's")
        grep["grep_cli"] = {"parity": cli_parity, "seconds": secs,
                            "mb_per_s": grep_bytes / secs / 1e6,
                            "launches": launches,
                            "pipeline_stats": {k: st[k] for k in GREP_PHASES
                                               if k in st}}
        log({"grep_cli": {**grep["grep_cli"], "gpu": gpu,
                          "stdout": cli_out.splitlines()[:3]}})
        nfa_calibration(gpu)
        grep_rows, topk_row, grep_err, fails = grep_kernel_rows(raws[0],
                                                                data)
        failures += fails
        times.update(grep_rows)
        err.update(grep_err)
        err["grep"] = _merge_err(err["grep"], check_hgrep_edges(raws[0]))
        err["nfa"] = _merge_err(err["nfa"], check_nfa_edges())
        j_edge_err, emit_edge_err = check_grep_edges()
        err["grep_step"] = _merge_err(err["grep_step"], j_edge_err)
        err["radix_sort"] = _merge_err(err["radix_sort"],
                                       topk_row["max_abs_err"])
        for name in ("grep", "nfa", "grep_step"):
            if err[name] != 0:
                failures.append(f"{name} differs from its plain version")
        if topk_row["max_abs_err"] != 0:
            failures.append("radix_sort differs from its plain version at "
                            "the topk shape")

        # Phase 9: TF-IDF.
        tf_rows, tf_err = tfidf_kernel_rows(raws, failures)
        times.update(tf_rows)
        err.update(tf_err)
        wave_shapes = wave_shape_rows(raws)
        log({"tfidf_n8_wave_shapes": wave_shapes, "gpu": gpu})
        for name, v in wave_shapes.items():
            err[name] = _merge_err(err[name], v["max_abs_err"])
            if v["max_abs_err"] != 0:
                failures.append(f"{name} differs from its plain version at "
                                "the tfidf_n8 wave's shape")
        for name in ("compact", "postings_append"):
            if err[name] != 0:
                failures.append(f"{name} differs from its plain version")
        t0 = time.perf_counter()
        tf_oracle = tfidf_oracle(files, work)
        tf_oracle_s = time.perf_counter() - t0
        tf_cycles = max(1, round(TFIDF_MB * 1e6 / corpus_bytes))
        if tf_cycles != 1:
            raise RuntimeError(f"the TF-IDF row wants {tf_cycles} cycles; "
                               "its oracle covers one")
        tokens = sum(want_counts.values())
        tfidf_path(files, work, "tfidf_warm", tf_oracle, tokens)
        tfidf, tf_res = {}, {}
        for tag, kw in (("tfidf", {}),
                        ("tfidf_acc", {"device_accumulate": True}),
                        ("tfidf_n8", {"n_dev": MESH_SHARDS})):
            entry, _, fails, tf_res[tag] = tfidf_path(
                files, work, tag, tf_oracle, tokens, **kw)
            tfidf[tag] = entry
            failures += fails
            log({tag: {**entry, "gpu": gpu,
                       "oracle_s": tf_oracle_s}})
        if tfidf["tfidf_acc"]["wave_stats"].get("append_overflows", 0) < 1:
            failures.append("tfidf_acc: no postings append overflowed")
        if tfidf["tfidf_acc"]["wave_stats"].get("step_pulls", 1) != 0:
            failures.append("tfidf_acc: waves were pulled one by one")
        if tfidf["tfidf_n8"]["wave_stats"].get("waves") != 1:
            failures.append("tfidf_n8: the eight documents took more than "
                            "one wave")

        # Phase 10: the streaming indexer and the mesh-sharded postings.
        ma_rows, ma_err = mesh_append_kernel_rows(raws, failures)
        log({"mesh_append_shapes": ma_rows, "gpu": gpu})
        for name, e in ma_err.items():
            err[name] = _merge_err(err[name], e)
            if e != 0:
                failures.append(f"{name} differs from its plain version at "
                                "the mesh_append shape")
        t0 = time.perf_counter()
        idx_oracle, idx_top = indexer_oracle(files, work)
        idx_oracle_s = time.perf_counter() - t0
        indexer_path(files, work, "indexer_warm", idx_oracle, idx_top)
        indexer, idx_res = {}, {}
        for tag, kw in (("indexer", {}),
                        ("indexer_acc", {"device_accumulate": True}),
                        ("indexer_n8", {"n_dev": MESH_SHARDS}),
                        ("indexer_mesh", {"n_dev": MESH_SHARDS,
                                          "mesh_shards": MESH_SHARDS})):
            entry, _, fails, idx_res[tag] = indexer_path(
                files, work, tag, idx_oracle, idx_top, **kw)
            indexer[tag] = entry
            failures += fails
            log({tag: {**entry, "gpu": gpu, "oracle_s": idx_oracle_s}})
        entry, _, fails, tf_res["tfidf_mesh"] = tfidf_path(
            files, work, "tfidf_mesh", tf_oracle, tokens, n_dev=MESH_SHARDS,
            mesh_shards=MESH_SHARDS)
        tfidf["tfidf_mesh"] = entry
        failures += fails
        log({"tfidf_mesh": {**entry, "gpu": gpu, "oracle_s": tf_oracle_s}})
        ist = {k: v["wave_stats"] for k, v in indexer.items()}
        if ist["indexer_acc"].get("append_overflows", 0) < 1:
            failures.append("indexer_acc: no postings append overflowed")
        for tag in ("indexer_acc", "indexer_mesh"):
            if ist[tag].get("step_pulls", 1) != 0 or \
                    ist[tag].get("folds", 0) < 1:
                failures.append(f"{tag}: the device services did not take "
                                "the waves")
        if ist["indexer_n8"].get("waves") != 1:
            failures.append("indexer_n8: the eight documents took more "
                            "than one wave")
        # The mesh paths against the same walk unsharded, posting order
        # included, and their second route: D, E and M launch again in
        # every mesh append (and D, E in every mesh df fold).
        for tag, base_tag, same in (
                ("indexer_mesh", "indexer_n8",
                 idx_res["indexer_mesh"] == idx_res["indexer_n8"]),
                ("tfidf_mesh", "tfidf_n8",
                 tf_res["tfidf_mesh"].to_dict()
                 == tf_res["tfidf_n8"].to_dict())):
            runs = indexer if tag in indexer else tfidf
            st = runs[tag]["wave_stats"]
            if not same:
                failures.append(f"{tag}: differs from {base_tag}")
            if st.get("mesh_shards") != MESH_SHARDS:
                failures.append(f"{tag}: the postings were not "
                                "mesh-sharded")
            for name in ("fnv", "route", "postings_append"):
                extra = (runs[tag]["launches"][name]
                         - runs[base_tag]["launches"][name])
                if extra < max(1, st.get("appends", 0)):
                    failures.append(f"{tag}: the mesh append launched "
                                    f"{name} {extra} times for "
                                    f"{st.get('appends')} appends")

        # Phase 10b: crash-resume checkpoints of grep, the indexer, TF-IDF.
        def tf_run(tag, **kw):
            return tfidf_path(files, work, tag, tf_oracle, tokens, **kw)

        def idx_run(tag, **kw):
            return indexer_path(files, work, tag, idx_oracle, idx_top, **kw)

        eng_ckpt = {"grep": grep_ckpt_rows(files, grep_cycles, grep_want,
                                           grep_bytes, work, gpu, failures),
                    "indexer": wave_ckpt_rows(idx_run, "indexer_ckpt", work,
                                              gpu, failures),
                    "tfidf": wave_ckpt_rows(tf_run, "tfidf_ckpt", work, gpu,
                                            failures)}
        eng_paths = {}
        eng_paths["grep_ckpt"], fails = grep_ckpt_path(
            files, grep_cycles, grep_want, work,
            grep["grep_stream_acc"]["launches"])
        failures += fails
        eng_paths["grep_ckpt_cli"], fails = grep_ckpt_cli_path(
            files, grep_cycles, grep_want, work,
            grep["grep_stream_acc"]["launches"])
        failures += fails
        eng_paths["indexer_ckpt"], _, fails = wave_ckpt_path(
            idx_run, "indexer_ckpt", work, indexer["indexer_acc"]["launches"],
            point="mid-commit", step=3, checkpoint_async=True,
            checkpoint_delta=True)
        failures += fails
        eng_paths["tfidf_ckpt"], _, fails = wave_ckpt_path(
            tf_run, "tfidf_ckpt", work, tfidf["tfidf_acc"]["launches"],
            point="mid-capture", step=2)
        failures += fails
        for tag, entry in eng_paths.items():
            log({tag: {**entry, "gpu": gpu}})

        # Phase 11: the compressed chunk upload.
        times["wire_decode"], err["wire_decode"] = wire_kernel_rows(
            files, failures)
        if err["wire_decode"] != 0:
            failures.append("wire_decode differs from its plain version")
        ok, pack_row = wire_pack_rows(files)
        log({"wire_pack_rows": pack_row, "gpu": gpu})
        if not ok:
            failures.append("pack_rows/unpack_rows do not round-trip a step")
        wire, launch_wire = wire_stream_runs(files, data, want_counts, work,
                                             gpu, failures)

        # Phase 12: the crash model checker.
        times["crash_sim"], err["crash_sim"], fails = crash_kernel_rows()
        failures += fails
        if err["crash_sim"] != 0:
            failures.append("crash_sim differs from its plain version")
        launch_crash, crash = crash_paths(gpu, failures)

        # Phase 13: the plan layer.
        from dsi_tpu_torch.utils.corpus import plan_corpus

        plan_file = plan_corpus(os.path.join(work, "plan-corpus.txt"),
                                PLAN_MB)
        with open(plan_file, "rb") as f:
            plan_raw = f.read()
        times["grep_emit"], err["grep_emit"] = emit_kernel_rows(plan_raw,
                                                                data)
        err["grep_emit"] = _merge_err(err["grep_emit"], emit_edge_err)
        times["relay_pack"], err["relay_pack"], relay_entry = \
            relay_kernel_rows(failures)
        log({"relay_appends": relay_entry, "gpu": gpu})
        for name in ("grep_emit", "relay_pack"):
            if err[name] != 0:
                failures.append(f"{name} differs from its plain version")
        if not relay_entry["equal_to_host_concat"]:
            failures.append("the relay's rows differ from the host "
                            "concatenation of its appends")
        launch_plan, plan = plan_paths(files, plan_file, want_counts, work,
                                       gpu, failures)

    total_s = sum(phases.values())
    log({"slice": {
        "gpu": gpu, "input_bytes": nbytes, "mb_per_s": nbytes / total_s / 1e6,
        **phases, "oracle_s": oracle_s, "parity": lines == oracle,
        "mwl64": {**phases64, "parity": lines64 == oracle64,
                  "launches": launch64},
        "split": {"seconds": split_s, "bytes": len(raws[0]),
                  "launches": launch_split},
        "split_hash": {"seconds": split_hash_s,
                       "launches": launch_split_hash},
        "sharded": sharded,
        "launches_main": launch_main}})
    log({"end_to_end": {
        "gpu": gpu,
        "corpus_mb_per_s": {"raw_sort": nbytes / total_s / 1e6,
                            **{k: v["mb_per_s"]
                               for k, v in corpus_runs.items()}},
        "corpus_runs": corpus_runs,
        "stream_mb_per_s": {k: v["mb_per_s"] for k, v in stream.items()},
        "ckpt_stream_mb_per_s": {k: {"ckpt": v["mb_per_s"],
                                     "plain": v["plain_mb_per_s"]}
                                 for k, v in ckpt["rows"].items()},
        "ckpt_grep_mb_per_s": {k: {"ckpt": v["mb_per_s"],
                                   "plain": v["plain_mb_per_s"]}
                               for k, v in eng_ckpt["grep"].items()},
        "ckpt_wave_seconds": {k: {"ckpt": v["seconds"],
                                  "plain": v["plain_seconds"]}
                              for e in ("indexer", "tfidf")
                              for k, v in eng_ckpt[e].items()},
        "grep_mb_per_s": {k: v["mb_per_s"] for k, v in grep.items()},
        "grep_oracle_mb_per_s": grep_bytes / grep_oracle_s / 1e6,
        "tfidf_mb_per_s": {k: v["mb_per_s"] for k, v in tfidf.items()},
        "indexer_mb_per_s": {k: v["mb_per_s"] for k, v in indexer.items()},
        "indexer_oracle_mb_per_s": (indexer["indexer"]["input_bytes"]
                                    / idx_oracle_s / 1e6),
        "wire_mb_per_s": {k: {"wire": v["mb_per_s"],
                              "raw": v.get("raw_mb_per_s")}
                          for k, v in wire.items()},
        "crashcheck_s": {"run_crash_model_check_x3": crash["seconds"],
                         "cli": crash["cli_seconds"]},
        "plan_mb_per_s": {k: v["mb_per_s"] for k, v in plan.items()}}})

    by_path = {"corpus": launch_main, "corpus_mwl64": launch64,
               "split": launch_split, "sharded": sharded[1]["launches"],
               "sharded_n8": sharded[8]["launches"],
               **{k: v["launches"] for k, v in stream.items()},
               **{k: v["launches"] for k, v in ckpt_paths.items()},
               **{k: v["launches"] for k, v in eng_paths.items()},
               **{k: v["launches"] for k, v in corpus_runs.items()},
               "split_hash": launch_split_hash,
               "sharded_hash": launch_sharded_hash,
               "grep_tiers": launch_grep_tiers,
               **{k: v["launches"] for k, v in grep.items()},
               **{k: v["launches"] for k, v in tfidf.items()},
               **{k: v["launches"] for k, v in indexer.items()},
               **launch_wire, **launch_crash, **launch_plan}
    for path, names in PATH_KERNELS.items():
        failures += [f"{name} never launched on the {path} path"
                     for name in names if by_path[path][name] < 1]
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        tm = times[name]
        row = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces,
               "launches": sum(p[name] for p in by_path.values()),
               "max_abs_err": err[name], "match": err[name] == 0,
               "ms": tm["ms"], "plain_ms": tm["plain_ms"],
               "bound_ms": tm["bound_ms"],
               "bound_by": tm.get("bound_by", "bytes"),
               "library_ms": tm["library_ms"], "shape": tm["shape"],
               "launches_by_path": {k: p[name]
                                    for k, p in by_path.items()}}
        if "radix_bound_ms" in tm:
            row["radix_bound_ms"] = tm["radix_bound_ms"]
        if name in ("radix_sort", "group"):
            row["at_shapes"] = {k: v[name] for k, v in shapes.items()}
        if name == "tokenize":
            row["at_shapes"] = tm["at_shapes"]
        if name == "radix_sort":
            row["at_shapes"]["topk"] = topk_row
        if name in grep_rows or name in tf_rows:
            row["at_shapes"] = tm["at_shapes"]
        if name in ("fnv", "route"):
            row["at_shapes"] = {"mesh_fold": mesh_shapes[name],
                                "tfidf_n8": wave_shapes[name]}
        if name == "fnv":
            row["at_shapes"]["stream"] = stream_fnv
        if name == "hash_group":
            row["at_shapes"] = hash_shapes
        if name in ma_rows:
            row["at_shapes"]["mesh_append"] = ma_rows[name]
        if name in ("wire_decode", "crash_sim", "grep_emit", "relay_pack"):
            row["at_shapes"] = tm["at_shapes"]
        for key in ("j_ms", "j_device_ms", "j_launches_per_call",
                    "epilogue_device_ms", "device_ms_by_kernel",
                    "device_ms_by_phase", "scratch_bytes",
                    "device_ms", "launches_per_call", "kernels_per_call",
                    "copies_per_call", "allocs_per_call", "passes_run",
                    "skipped_passes", "path", "library_x_k64_ms", "rounds",
                    "small_path_ms", "large_path_ms"):
            if key in tm:
                row[key] = tm[key]
        kernels.append(row)
    log({"kernels": kernels})
    if failures:
        for f in failures:
            print(f"chip_smoke: FAILED: {f}", file=sys.stderr)
        return 1
    log(gpu)
    log({"ok": True, "device": {"platform": "gpu",
                                "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:  # any phase's fault ends the run non-zero
        traceback.print_exc()
        sys.exit(1)
