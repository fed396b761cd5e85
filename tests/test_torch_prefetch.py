"""PyTorch port, ``train/prefetch.py``: the contracts ``tests/test_prefetch.py``
pins for the JAX package's Prefetcher (order and placement, exhaustion,
error propagation, running ahead, clean shutdown, idempotent close), run
against the port's own copy, and ``maybe``/``close_all`` with the port's
``to_device`` as the placement."""
import itertools
import time

import numpy as np
import pytest
import torch

from k8s_distributed_deeplearning_torch.parallel import (
    data_parallel as t_dp)
from k8s_distributed_deeplearning_torch.train import prefetch
from k8s_distributed_deeplearning_torch.train.prefetch import Prefetcher


def test_order_and_placement_preserved():
    with Prefetcher(iter(range(20)), place_fn=lambda x: x * 10) as p:
        got = [next(p) for _ in range(20)]
    assert got == [i * 10 for i in range(20)]


def test_exhaustion_raises_stopiteration():
    p = Prefetcher(iter([1, 2]))
    assert list(p) == [1, 2]
    p.close()


def test_worker_exception_propagates():
    def bad():
        yield 1
        raise RuntimeError("boom in data pipeline")

    p = Prefetcher(bad())
    assert next(p) == 1
    with pytest.raises(RuntimeError, match="boom"):
        next(p)
    p.close()


def test_runs_ahead_of_consumer():
    produced = []

    def source():
        for i in range(10):
            produced.append(i)
            yield i

    p = Prefetcher(source(), depth=4)
    deadline = time.monotonic() + 5
    while len(produced) < 4 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert len(produced) >= 4          # filled without the consumer asking
    assert next(p) == 0
    p.close()


def test_close_stops_infinite_source():
    alive = {"n": 0}

    def infinite():
        for i in itertools.count():
            alive["n"] = i
            yield i

    p = Prefetcher(infinite(), depth=2)
    next(p)
    p.close()
    n_at_close = alive["n"]
    time.sleep(0.2)
    assert alive["n"] <= n_at_close + 2, "worker kept producing after close"
    assert not p._thread.is_alive()


def test_bad_depth_rejected():
    with pytest.raises(ValueError, match="depth"):
        Prefetcher(iter([]), depth=0)


def test_repeated_next_after_exhaustion_and_error_keeps_raising():
    p = Prefetcher(iter([1]))
    assert next(p) == 1
    for _ in range(3):
        with pytest.raises(StopIteration):
            next(p)
    p.close()
    with pytest.raises(StopIteration):
        next(p)

    def bad():
        raise RuntimeError("immediate failure")
        yield  # pragma: no cover

    p2 = Prefetcher(bad())
    for _ in range(2):
        with pytest.raises(RuntimeError, match="immediate"):
            next(p2)
    p2.close()


def test_double_close_is_idempotent():
    p = Prefetcher(iter(range(8)), depth=2)
    assert next(p) == 0
    p.close()
    p.close()
    with p:
        pass
    assert not p._thread.is_alive()
    with pytest.raises(StopIteration):
        next(p)


@pytest.mark.parametrize("depth", [0, 2])
def test_maybe_places_batches_with_to_device(depth):
    """The CLIs' wiring: threaded at depth > 0 (registered for
    ``close_all``), a plain mapping at 0; either way the same tensors."""
    batches = [{"image": np.full((2, 3), i, np.float32),
                "label": np.arange(2, dtype=np.int32)} for i in range(4)]
    registry: list = []
    it = prefetch.maybe(iter(batches),
                        lambda b: t_dp.to_device(b, torch.device("cpu")),
                        depth, registry)
    got = [next(it) for _ in range(4)]
    assert len(registry) == (1 if depth else 0)
    prefetch.close_all(registry)
    assert registry == []
    for i, b in enumerate(got):
        assert isinstance(b["image"], torch.Tensor)
        assert torch.equal(b["image"], torch.full((2, 3), float(i)))
        assert b["label"].dtype == torch.int32
