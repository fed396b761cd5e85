"""Data: MNIST (idx files, the digits fixture, the seeded synthetic set),
the seeded synthetic corpus, and the deterministic batchers.

Own copies of the numpy-only pieces of
``k8s_distributed_deeplearning_tpu/train/data.py``, unchanged in
behaviour: the same seed gives the same batches. One global permutation
per epoch (seeded, identical on every process), each process takes a
disjoint stride slice, and ``batch_at(step)`` is stateless. Nothing is
downloaded: MNIST is read from idx files already on disk (the JAX
package's ``fetch_mnist`` is not copied), or a stand-in is made. Large
corpora stream from a directory of pre-tokenized shards
(:func:`write_token_shards`, :class:`TokenShardBatcher`), byte-identical
to the JAX package's files.
"""
from __future__ import annotations

import gzip
import hashlib
import os
import struct
import sys
import time
from typing import Callable, Iterator, Mapping

import numpy as np

from k8s_distributed_deeplearning_torch import faults as _faults
from k8s_distributed_deeplearning_torch.utils.retry import retry_transient

PyTree = dict

# The four canonical MNIST idx archives with their well-known MD5 digests
# (the same pins torchvision ships).
MNIST_FILES: dict[str, str] = {
    "train-images-idx3-ubyte.gz": "f68b3c2dcbeaaa9fbdd348bbdeb94873",
    "train-labels-idx1-ubyte.gz": "d53e105ee54ea40749a09fcbcd1e9432",
    "t10k-images-idx3-ubyte.gz": "9fb629c4189551a2d022fa330f9573f3",
    "t10k-labels-idx1-ubyte.gz": "ec29112dd5afa0611ce80d1b7f02629c",
}


class ChecksumError(RuntimeError):
    """An on-disk dataset file does not match its pinned digest."""


def _md5(path: str) -> str:
    h = hashlib.md5()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def mnist_available(data_dir: str,
                    checksums: Mapping[str, str] | None = None,
                    verify: bool = True) -> bool:
    """True iff all four idx archives exist in *data_dir* (and, when
    *verify*, match their pinned MD5 digests). Unpacked (non-.gz) files are
    accepted without digest verification: the pins are for the archives."""
    checksums = MNIST_FILES if checksums is None else checksums
    for name, digest in checksums.items():
        gz = os.path.join(data_dir, name)
        if os.path.exists(gz):
            if verify and _md5(gz) != digest:
                return False
        elif not os.path.exists(os.path.join(data_dir, name[:-3])):
            return False
    return True


def resolve_mnist_dir(data_dir: str | None = None) -> str | None:
    """Locate real MNIST: explicit *data_dir*, else ``$MNIST_DATA_DIR``.
    Returns None when neither holds the four verified archives (the JAX
    package's copy also looks in a cache under the home directory and can
    download; this one reads only what it is pointed at)."""
    for d in (data_dir, os.environ.get("MNIST_DATA_DIR")):
        if d and os.path.isdir(d) and mnist_available(d):
            return d
    return None


def _open_maybe_gz(path: str):
    if os.path.exists(path + ".gz"):
        return gzip.open(path + ".gz", "rb")
    return open(path, "rb")


def _read_idx(path: str) -> np.ndarray:
    """Parse an IDX file (the MNIST on-disk format)."""
    with _open_maybe_gz(path) as f:
        magic = struct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xFF
        dims = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        data = np.frombuffer(f.read(), dtype=np.uint8)
    return data.reshape(dims)


def load_mnist(data_dir: str,
               split: str = "train") -> tuple[np.ndarray, np.ndarray]:
    """Load MNIST idx files from *data_dir*; images in [0,1] float32, HWC."""
    prefix = "train" if split == "train" else "t10k"
    images = _read_idx(os.path.join(data_dir, f"{prefix}-images-idx3-ubyte"))
    labels = _read_idx(os.path.join(data_dir, f"{prefix}-labels-idx1-ubyte"))
    return images.astype(np.float32)[..., None] / 255.0, labels.astype(np.int32)


def write_idx_dataset(data_dir: str, images: np.ndarray, labels: np.ndarray,
                      prefix: str) -> None:
    """Write a split in the canonical MNIST on-disk idx format (gzipped):
    *images* uint8 [N, H, W], *labels* uint8 [N], *prefix* "train"/"t10k".
    The exact inverse of :func:`load_mnist`'s parser."""
    if images.dtype != np.uint8 or labels.dtype != np.uint8:
        raise ValueError("idx images and labels must be uint8")
    n, h, w = images.shape
    with gzip.open(os.path.join(
            data_dir, f"{prefix}-images-idx3-ubyte.gz"), "wb") as f:
        f.write(struct.pack(">I", 0x00000803)
                + struct.pack(">III", n, h, w) + images.tobytes())
    with gzip.open(os.path.join(
            data_dir, f"{prefix}-labels-idx1-ubyte.gz"), "wb") as f:
        f.write(struct.pack(">I", 0x00000801)
                + struct.pack(">I", len(labels)) + labels.tobytes())


def make_digits_fixture(data_dir: str, *, n_test: int = 400,
                        seed: int = 0) -> str:
    """Real handwritten digits with no download: the UCI ML hand-written
    digits set bundled with scikit-learn (1,797 scanned 8x8 digits),
    upscaled nearest-neighbor to 28x28 (3x kron + 2px pad) so the
    reference ConvNet runs unchanged, written as idx files. Deterministic
    shuffled split (*seed*): *n_test* held out. Not MNIST: a stand-in
    that makes the engine's convergence on real scanned digits run."""
    from sklearn.datasets import load_digits  # bundled data, no download

    os.makedirs(data_dir, exist_ok=True)
    d = load_digits()
    images = d.images.astype(np.float32)            # [N, 8, 8] in 0..16
    up = np.kron(images, np.ones((1, 3, 3), np.float32))   # [N, 24, 24]
    up = np.pad(up, ((0, 0), (2, 2), (2, 2)))              # [N, 28, 28]
    xs = np.clip(up * (255.0 / 16.0), 0, 255).astype(np.uint8)
    ys = d.target.astype(np.uint8)
    order = np.random.default_rng(seed).permutation(len(xs))
    xs, ys = xs[order], ys[order]
    write_idx_dataset(data_dir, xs[n_test:], ys[n_test:], "train")
    write_idx_dataset(data_dir, xs[:n_test], ys[:n_test], "t10k")
    return data_dir


def synthetic_images(num: int, *, size: int = 32, channels: int = 3,
                     num_classes: int = 10, seed: int = 0,
                     noise: float = 0.25,
                     sample_seed: int | None = None
                     ) -> tuple[np.ndarray, np.ndarray]:
    """Procedural image-classification set: fixed random class templates
    plus per-example Gaussian noise. ``seed`` fixes the templates (the
    "dataset"); ``sample_seed`` varies the drawn examples, so train and
    test splits share templates but not samples."""
    tmpl_rng = np.random.default_rng(seed)
    templates = tmpl_rng.normal(
        size=(num_classes, size, size, channels)).astype(np.float32)
    rng = np.random.default_rng(seed if sample_seed is None else sample_seed)
    labels = rng.integers(0, num_classes, size=(num,)).astype(np.int32)
    images = templates[labels] + noise * rng.normal(
        size=(num, size, size, channels)).astype(np.float32)
    return images.astype(np.float32), labels


def synthetic_mnist(num: int = 4096, seed: int = 0, noise: float = 0.25,
                    sample_seed: int | None = None
                    ) -> tuple[np.ndarray, np.ndarray]:
    """MNIST-shaped instance of :func:`synthetic_images` (28x28x1, 10
    classes)."""
    return synthetic_images(num, size=28, channels=1, num_classes=10,
                            seed=seed, noise=noise, sample_seed=sample_seed)


def load_or_synthesize(data_dir: str | None, split: str = "train",
                       synth_size: int = 4096, seed: int = 0):
    """Real MNIST from *data_dir*, or the synthetic set when no dir is
    given (``synth_size`` train examples, a quarter of that for test).

    An explicitly requested directory that doesn't exist is an error:
    never silently train on fake data because a volume failed to mount.
    """
    if data_dir:
        if not os.path.isdir(data_dir):
            raise FileNotFoundError(
                f"--data-dir {data_dir!r} does not exist; refusing to fall "
                "back to synthetic data (omit --data-dir for synthetic)")
        return load_mnist(data_dir, split)
    return synthetic_mnist(synth_size if split == "train" else synth_size // 4,
                           seed=seed,
                           sample_seed=seed if split == "train" else seed + 10_000)


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


# Raw little-endian shard files: "<name>.<dtype>.bin"; .npy keeps its own
# header. uint16 is the natural on-disk width for sub-65k vocabularies
# (llama's 32000), uint8 for byte-level.
_SHARD_DTYPES = {"uint8": np.uint8, "uint16": np.uint16, "int32": np.int32}


def write_token_shards(tokens: np.ndarray, out_dir: str, *,
                       shard_tokens: int = 1 << 24,
                       dtype: str = "uint16") -> list[str]:
    """Split a token stream into numbered shard files for
    :class:`TokenShardBatcher` (raw little-endian, dtype in the filename).
    The offline tokenize-once step of the streaming path."""
    if dtype not in _SHARD_DTYPES:
        raise ValueError(f"dtype must be one of {sorted(_SHARD_DTYPES)}")
    np_dtype = _SHARD_DTYPES[dtype]
    info = np.iinfo(np_dtype)
    if tokens.min() < info.min or tokens.max() > info.max:
        raise ValueError(f"token ids outside {dtype} range")
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for i, start in enumerate(range(0, len(tokens), shard_tokens)):
        p = os.path.join(out_dir, f"shard_{i:05d}.{dtype}.bin")
        tokens[start:start + shard_tokens].astype(
            np.dtype(np_dtype).newbyteorder("<")).tofile(p)
        paths.append(p)
    return paths


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


class TokenShardBatcher(_EpochShardedBatcher):
    """Streaming LM batches over a DIRECTORY of pre-tokenized shards —
    the large-corpus path: shards are memory-mapped lazily, so resident
    memory is the touched pages of the current batches, not the corpus.

    Accepts ``shard_*.{uint8,uint16,int32}.bin`` (raw little-endian, see
    :func:`write_token_shards`) and ``*.npy`` files, sorted by filename
    for a stable global order. The window index space spans all shards
    (windows never cross a shard boundary; each shard's sub-window tail
    is dropped). Epoch shuffling, per-process disjoint striding, and the
    stateless ``batch_at``/``iter_from`` replay-free-resume contract are
    inherited from the same scaffolding as :class:`TokenBatcher` — a
    restored step addresses exactly the batch it would have seen. A batch
    is ``{"tokens": [B, S+1] int32}`` in host memory, copied out of the
    maps (a window of a map is not contiguous host RAM to pin).
    """

    def __init__(self, data_dir: str, batch_size: int, seq_len: int,
                 seed: int = 0, process_index: int = 0,
                 num_processes: int = 1, hold_out_tail: int = 0,
                 vocab_size: int | None = None, io_retries: int = 2,
                 io_backoff_s: float = 0.05,
                 sleep: Callable[[float], None] = time.sleep):
        """*hold_out_tail* excludes the last N tokens of the final shard
        from the training window space (the held-out eval slice — read it
        via :meth:`tail_tokens`; without the exclusion, eval tokens would
        also appear in training epochs). *vocab_size* (when given) range-
        checks the FIRST and LAST shard's token ids — cheap relative to a
        full-corpus scan, and catches the common corruptions (wrong
        tokenizer, wrong dtype decode, truncation garbage) at both ends
        instead of letting the embedding gather clamp them silently.

        *io_retries*/*io_backoff_s*: a batch read that raises ``OSError``
        (network-filesystem blip on a mmap page fault, or the injected
        ``shard_read`` fault) is retried with bounded exponential backoff
        before the error surfaces — transient IO must cost latency, not
        the job."""
        if seq_len <= 0:
            raise ValueError("seq_len must be positive")
        names = sorted(n for n in os.listdir(data_dir)
                       if n.endswith(".bin") or n.endswith(".npy"))
        if not names:
            raise FileNotFoundError(
                f"no token shards (*.bin / *.npy) in {data_dir!r}")
        self.seq_len = seq_len
        self._shards: list[np.ndarray] = []
        for n in names:
            p = os.path.join(data_dir, n)
            if n.endswith(".npy"):
                arr = np.load(p, mmap_mode="r")
            else:
                stem = n[:-len(".bin")]
                suffix = stem.rsplit(".", 1)[-1]
                if suffix not in _SHARD_DTYPES:
                    raise ValueError(
                        f"shard {n!r}: name must encode its dtype as "
                        f"<name>.<dtype>.bin with dtype one of "
                        f"{sorted(_SHARD_DTYPES)}")
                arr = np.memmap(p, dtype=np.dtype(
                    _SHARD_DTYPES[suffix]).newbyteorder("<"), mode="r")
            if arr.ndim != 1:
                raise ValueError(f"shard {n!r} must be 1-D, got {arr.shape}")
            self._shards.append(arr)
        if vocab_size is not None:
            for i in sorted({0, len(self._shards) - 1}):
                arr = self._shards[i]
                if arr.size and (int(arr.min()) < 0
                                 or int(arr.max()) >= vocab_size):
                    raise ValueError(
                        f"shard {names[i]!r}: token ids outside "
                        f"[0, {vocab_size}) (min {int(arr.min())}, max "
                        f"{int(arr.max())}) — out-of-range ids would clamp "
                        "silently in the embedding gather")
        self.hold_out_tail = hold_out_tail
        if hold_out_tail and hold_out_tail >= len(self._shards[-1]):
            raise ValueError(
                f"hold_out_tail={hold_out_tail} consumes the whole final "
                f"shard ({len(self._shards[-1])} tokens)")
        # Global window index space: windows per shard, cumulative bounds
        # (the final shard's held-out tail is outside the window space).
        lens = [len(s) for s in self._shards]
        lens[-1] -= hold_out_tail
        per_shard = np.array([max(0, (n - 1) // seq_len) for n in lens])
        self._cum = np.concatenate([[0], np.cumsum(per_shard)])
        total = int(self._cum[-1])
        if total < 1:
            raise ValueError(
                f"shards in {data_dir!r} too small for seq_len={seq_len}")
        self._io_retries = io_retries
        self._io_backoff_s = io_backoff_s
        self._io_sleep = sleep
        super().__init__(total, batch_size, seed, process_index,
                         num_processes, what="windows")

    @property
    def num_windows(self) -> int:
        return self.num_items

    @property
    def final_shard_tokens(self) -> int:
        """Token count of the last shard (callers size ``hold_out_tail``
        from it without touching internals)."""
        return len(self._shards[-1])

    def tail_tokens(self) -> np.ndarray:
        """The held-out eval slice (requires ``hold_out_tail > 0``)."""
        if not self.hold_out_tail:
            raise ValueError("constructed without hold_out_tail")
        return np.asarray(self._shards[-1][-self.hold_out_tail:], np.int32)

    def _make_batch(self, sel: np.ndarray) -> PyTree:
        def read() -> PyTree:
            inj = _faults.active()
            if inj is not None:
                inj.fire("shard_read")
            out = np.empty((len(sel), self.seq_len + 1), np.int32)
            shard_of = np.searchsorted(self._cum, sel, side="right") - 1
            for i, (w, s) in enumerate(zip(sel, shard_of)):
                off = (int(w) - int(self._cum[s])) * self.seq_len
                out[i] = self._shards[s][off:off + self.seq_len + 1]
            return {"tokens": out}

        def warn(attempt: int, exc: BaseException, delay: float) -> None:
            print(f"shard read failed (attempt {attempt}): {exc}; "
                  f"retrying in {delay:.2f}s", file=sys.stderr, flush=True)

        return retry_transient(
            read, retries=self._io_retries, backoff_s=self._io_backoff_s,
            sleep=self._io_sleep, on_retry=warn)


class ShardedBatcher(_EpochShardedBatcher):
    """Infinite per-process image batches with true epoch sharding.

    Parity surface: ``train_input_generator`` (``tensorflow_mnist.py:76-85``)
    (infinite, shuffled, fixed batch size), but each process sees a
    disjoint 1/num_processes slice of every epoch. ``batch_size`` is the
    per-process batch: one replica a process here."""

    def __init__(self, images: np.ndarray, labels: np.ndarray, batch_size: int,
                 seed: int = 0, process_index: int = 0, num_processes: int = 1):
        self.images, self.labels = images, labels
        super().__init__(len(images), batch_size, seed, process_index,
                         num_processes, what="examples")

    def _make_batch(self, sel: np.ndarray) -> PyTree:
        return {"image": self.images[sel], "label": self.labels[sel]}
