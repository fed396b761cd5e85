"""Token data: the seeded synthetic corpus and the deterministic LM batchers.

Own copies of the numpy-only pieces of
``k8s_distributed_deeplearning_tpu/train/data.py`` (``synthetic_tokens``,
``load_tokens``, ``_EpochShardedBatcher``, ``TokenBatcher``,
``split_documents``, ``PackedTokenBatcher``), unchanged in behaviour: the
same seed gives the same batches. One global permutation per epoch
(seeded, identical on every process), each process takes a disjoint
stride slice, and ``batch_at(step)`` is stateless. Nothing is downloaded.
"""
from __future__ import annotations

import gzip
import os
from typing import Iterator

import numpy as np

PyTree = dict


def synthetic_tokens(num_tokens: int = 1 << 17, vocab_size: int = 256,
                     seed: int = 0, order_prob: float = 0.9) -> np.ndarray:
    """Procedural token corpus with learnable structure (zero-egress stand-in
    for a text dataset): a seeded bigram chain — each token follows its
    designated successor with probability *order_prob*, else is uniform noise.
    A causal LM's achievable next-token accuracy is therefore ≈ order_prob,
    giving tests and smoke runs a meaningful convergence target.
    """
    rng = np.random.default_rng(seed)
    successor = rng.integers(0, vocab_size, size=(vocab_size,))
    noise = rng.integers(0, vocab_size, size=(num_tokens,))
    follow = rng.random(num_tokens) < order_prob
    toks = np.empty(num_tokens, np.int32)
    toks[0] = noise[0]
    for i in range(1, num_tokens):
        toks[i] = successor[toks[i - 1]] if follow[i] else noise[i]
    return toks


def load_tokens(path: str | None, *, num_tokens: int = 1 << 17,
                vocab_size: int = 256, seed: int = 0) -> np.ndarray:
    """Byte-level tokens from a file (``.gz`` decompressed — the vendored
    real corpus ``data/corpus/pydocs.txt.gz`` loads directly), a
    pre-tokenized ``.npy`` array, or the synthetic corpus when no path.

    An explicitly requested path that doesn't exist is an error — never
    silently train on fake data.
    """
    if path:
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"--data-path {path!r} does not exist; omit it for synthetic "
                "tokens")
        if path.endswith(".npy"):
            arr = np.load(path).astype(np.int32)
            if arr.size and (int(arr.min()) < 0
                             or int(arr.max()) >= vocab_size):
                raise ValueError(
                    f"token ids in {path!r} fall outside [0, {vocab_size}):"
                    f" min {int(arr.min())}, max {int(arr.max())} — "
                    "out-of-range ids would clamp silently in the embedding"
                    " gather; fix the data or pass the right vocab_size")
            return arr
        if path.endswith(".gz"):
            with gzip.open(path, "rb") as f:
                raw = np.frombuffer(f.read(), dtype=np.uint8)
        else:
            raw = np.fromfile(path, dtype=np.uint8)
        return raw.astype(np.int32)
    return synthetic_tokens(num_tokens, vocab_size, seed)


class _EpochShardedBatcher:
    """Shared scaffolding for the stateless batchers: one global permutation
    per epoch (seeded, identical on every host), per-host disjoint stride
    slices, and the stateless ``batch_at`` contract that makes checkpoint
    resume replay-free. Subclasses supply ``num_items`` and
    ``_make_batch(selected_indices)``."""

    def __init__(self, num_items: int, batch_size: int, seed: int,
                 process_index: int, num_processes: int, what: str = "items"):
        if batch_size <= 0:
            raise ValueError("batch_size must be positive")
        self.batch_size = batch_size
        self.seed = seed
        self.process_index = process_index
        self.num_processes = num_processes
        self.num_items = num_items
        # bpe derives from the MINIMUM per-host shard (num_items //
        # num_processes), not this host's own stride length: hosts whose
        # shards differ by one would otherwise disagree on the epoch
        # boundary, draw from different epoch permutations at the same step,
        # and break the disjointness guarantee.
        min_shard = num_items // num_processes
        self._bpe = min_shard // batch_size
        if self._bpe == 0:
            raise ValueError(
                f"per-host shard ({min_shard} {what}) is smaller than "
                f"batch_size={batch_size}")
        self._epoch_cache: tuple[int, np.ndarray] | None = None

    def shard_indices(self, epoch: int) -> np.ndarray:
        """This host's disjoint, shuffled slice of the epoch (memoized —
        the permutation is O(num_items) host work in the synchronous data
        path)."""
        if self._epoch_cache is None or self._epoch_cache[0] != epoch:
            rng = np.random.default_rng((self.seed, epoch))
            perm = rng.permutation(self.num_items)
            self._epoch_cache = (epoch,
                                 perm[self.process_index::self.num_processes])
        return self._epoch_cache[1]

    @property
    def batches_per_epoch(self) -> int:
        return self._bpe

    def batch_at(self, step: int) -> PyTree:
        """The step-th batch of the deterministic schedule (stateless: any
        step is addressable). The sub-batch tail of each epoch shard is
        dropped."""
        epoch, pos = divmod(step, self._bpe)
        idx = self.shard_indices(epoch)
        return self._make_batch(
            idx[pos * self.batch_size:(pos + 1) * self.batch_size])

    def _make_batch(self, sel: np.ndarray) -> PyTree:
        raise NotImplementedError

    def iter_from(self, start_step: int = 0) -> Iterator[PyTree]:
        step = start_step
        while True:
            yield self.batch_at(step)
            step += 1

    def __iter__(self) -> Iterator[PyTree]:
        return self.iter_from(0)


class TokenBatcher(_EpochShardedBatcher):
    """Infinite LM batches: disjoint seq_len+1 windows, epoch-shuffled,
    per-host disjoint.
    """

    def __init__(self, tokens: np.ndarray, batch_size: int, seq_len: int,
                 seed: int = 0, process_index: int = 0, num_processes: int = 1):
        if seq_len <= 0:
            raise ValueError("seq_len must be positive")
        self.tokens = np.ascontiguousarray(tokens, dtype=np.int32)
        self.seq_len = seq_len
        num_windows = (len(self.tokens) - 1) // seq_len
        if num_windows < 1:
            raise ValueError(
                f"corpus of {len(self.tokens)} tokens too small for "
                f"seq_len={seq_len}")
        super().__init__(num_windows, batch_size, seed, process_index,
                         num_processes, what="windows")

    @property
    def num_windows(self) -> int:
        return self.num_items

    def _make_batch(self, sel: np.ndarray) -> PyTree:
        # Window w covers tokens [w*S, w*S + S]: S inputs + 1 shifted target.
        rows = sel[:, None] * self.seq_len + np.arange(self.seq_len + 1)
        return {"tokens": self.tokens[rows]}


def split_documents(tokens: np.ndarray, sep_id: int | None = None,
                    *, approx_doc_len: int = 256,
                    seed: int = 0) -> list[np.ndarray]:
    """Corpus -> documents: split on *sep_id* (the separator stays at the
    end of its document, EOS-style); without a separator, cut at seeded
    pseudo-random lengths around *approx_doc_len* (for synthetic corpora,
    so the packed path is exercised end to end)."""
    if sep_id is not None:
        ends = np.flatnonzero(tokens == sep_id) + 1
        bounds = np.concatenate([[0], ends, [len(tokens)]])
    else:
        rng = np.random.default_rng((seed, 0xD0C5))
        cuts, pos = [0], 0
        while pos < len(tokens):
            pos += int(rng.integers(approx_doc_len // 2,
                                    approx_doc_len * 3 // 2 + 1))
            cuts.append(min(pos, len(tokens)))
        bounds = np.asarray(cuts)
    docs = [tokens[a:b] for a, b in zip(bounds[:-1], bounds[1:]) if b > a]
    return docs


class PackedTokenBatcher(_EpochShardedBatcher):
    """Packed-sequence LM batches: variable-length documents packed into
    fixed ``seq_len + 1`` rows with segment ids — the standard trick that
    recovers the padding waste of short documents. Feeds
    ``llama.loss_fn``'s packed path end to end: attention stays within a
    document (segment mask), RoPE positions restart per document, and
    cross-document / padding positions drop out of the loss.

    Packing is greedy first-fit in document order (documents longer than a
    row are chunked), computed once on the host; rows then shuffle per
    epoch, per-host disjoint, with the same stateless ``batch_at`` contract
    as :class:`TokenBatcher` (replay-free checkpoint resume). Batches:
    ``{"tokens": [B,S+1] int32, "segment_ids": [B,S+1] int32 (0 = padding),
    "mask": [B,S+1] f32}``.
    """

    PAD_SEGMENT = 0

    def __init__(self, documents: list[np.ndarray], batch_size: int,
                 seq_len: int, seed: int = 0, process_index: int = 0,
                 num_processes: int = 1, pad_id: int = 0):
        if seq_len <= 0:
            raise ValueError("seq_len must be positive")
        if not documents:
            raise ValueError("no documents to pack")
        self.seq_len = seq_len

        row_len = seq_len + 1
        rows_toks: list[np.ndarray] = []
        rows_segs: list[np.ndarray] = []
        cur_t = np.full(row_len, pad_id, np.int32)
        cur_s = np.full(row_len, self.PAD_SEGMENT, np.int32)
        fill, seg = 0, 1

        def flush():
            nonlocal cur_t, cur_s, fill, seg
            if fill:
                rows_toks.append(cur_t)
                rows_segs.append(cur_s)
                cur_t = np.full(row_len, pad_id, np.int32)
                cur_s = np.full(row_len, self.PAD_SEGMENT, np.int32)
                fill, seg = 0, 1

        for doc in documents:
            doc = np.asarray(doc, np.int32)
            for start in range(0, len(doc), row_len):
                chunk = doc[start:start + row_len]
                if fill + len(chunk) > row_len:
                    flush()
                cur_t[fill:fill + len(chunk)] = chunk
                cur_s[fill:fill + len(chunk)] = seg
                fill += len(chunk)
                seg += 1
                if fill == row_len:
                    flush()
        flush()

        self.rows_tokens = np.stack(rows_toks)
        self.rows_segments = np.stack(rows_segs)
        self.num_rows = len(self.rows_tokens)
        super().__init__(self.num_rows, batch_size, seed, process_index,
                         num_processes, what="packed rows")

    @property
    def packing_efficiency(self) -> float:
        """Fraction of row positions holding real tokens (1.0 = no pad)."""
        return float((self.rows_segments != self.PAD_SEGMENT).mean())

    def _make_batch(self, sel: np.ndarray) -> PyTree:
        segs = self.rows_segments[sel]
        return {"tokens": self.rows_tokens[sel],
                "segment_ids": segs,
                "mask": (segs != self.PAD_SEGMENT).astype(np.float32)}
