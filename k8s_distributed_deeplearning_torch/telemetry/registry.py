"""Dependency-free Counter/Gauge/Histogram registry with Prometheus text
exposition.

The port's own copy of ``k8s_distributed_deeplearning_tpu/telemetry/
registry.py``: ``render()`` is byte for byte the JAX registry's after the
same operations, so the fleet plane scrapes either package.

The reference's metric plane stops at Loki (logs); anything Prometheus-
shaped — scrape targets, alerting rules, the Grafana panels that want an
instant vector rather than an unwrapped log stream — had nowhere to read
from. This registry is the missing pull plane: metrics are plain Python
objects updated from the train loop / serving engine / watch process, and
:meth:`MetricsRegistry.render` produces Prometheus text-format 0.0.4
exposition that :class:`telemetry.exporter.MetricsExporter` serves on
``/metrics``. No client library: the format is a stable line protocol and
the container image must not grow a dependency for it.

Thread-safety: one registry lock guards metric/child creation and every
value update — updates are a few float ops, contention is nil next to a
train step, and correctness under the serving engine's callback threads
matters more than lock-free elegance.

Labels: metrics declare ``labelnames`` up front and address children via
``.labels(rank="0")`` (prometheus_client idiom). Unlabeled metrics are
their own sample.
"""
from __future__ import annotations

import threading

DEFAULT_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
                   5.0, 10.0)


def _escape_label(v: str) -> str:
    return (str(v).replace("\\", r"\\").replace("\n", r"\n")
            .replace('"', r'\"'))


def _fmt_value(v: float) -> str:
    if v == float("inf"):
        return "+Inf"
    if v == float("-inf"):
        return "-Inf"
    f = float(v)
    if f != f:          # NaN: int(f) below would raise, and Prometheus
        return "NaN"    # spells it exactly "NaN"
    return repr(f) if f != int(f) else str(int(f))


class _Metric:
    """Base: a named metric family owning per-labelset children."""

    kind = "untyped"

    def __init__(self, name: str, help_: str, labelnames: tuple[str, ...],
                 lock: threading.Lock):
        self.name = name
        self.help = help_
        self.labelnames = tuple(labelnames)
        self._lock = lock
        self._children: dict[tuple[str, ...], _Metric] = {}

    def labels(self, **kv: str) -> "_Metric":
        if set(kv) != set(self.labelnames):
            raise ValueError(f"{self.name}: expected labels "
                             f"{self.labelnames}, got {tuple(kv)}")
        key = tuple(str(kv[n]) for n in self.labelnames)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = type(self)(
                    self.name, self.help, (), self._lock)
                child._labelvalues = key  # type: ignore[attr-defined]
            return child

    def _samples(self) -> "list[tuple[str, str, float]]":
        """(suffix, brace-less label string, value) rows for exposition."""
        raise NotImplementedError

    def _rows(self) -> "list[tuple[str, str, float]]":
        if not self.labelnames:
            return self._samples()
        rows = []
        with self._lock:
            children = list(self._children.items())
        for key, child in children:
            pairs = ",".join(f'{k}="{_escape_label(v)}"'
                             for k, v in zip(self.labelnames, key))
            for suffix, extra, value in child._samples():
                rows.append((suffix, pairs + ("," + extra if extra else ""),
                             value))
        return rows


class Counter(_Metric):
    kind = "counter"

    def __init__(self, name, help_, labelnames=(), lock=None):
        super().__init__(name, help_, labelnames, lock or threading.Lock())
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        return self._value

    def _samples(self):
        return [("", "", self._value)]


class Gauge(_Metric):
    kind = "gauge"

    def __init__(self, name, help_, labelnames=(), lock=None):
        super().__init__(name, help_, labelnames, lock or threading.Lock())
        self._value = 0.0

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)

    @property
    def value(self) -> float:
        return self._value

    def _samples(self):
        return [("", "", self._value)]


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name, help_, labelnames=(), lock=None,
                 buckets=DEFAULT_BUCKETS):
        super().__init__(name, help_, labelnames, lock or threading.Lock())
        self.buckets = tuple(sorted(buckets))
        self._counts = [0] * (len(self.buckets) + 1)   # +Inf last
        self._sum = 0.0
        self._count = 0

    def labels(self, **kv):
        child = super().labels(**kv)
        child.buckets = self.buckets  # children share the family's buckets
        if len(child._counts) != len(self.buckets) + 1:
            child._counts = [0] * (len(self.buckets) + 1)
        return child

    def observe(self, value: float) -> None:
        with self._lock:
            self._sum += value
            self._count += 1
            for i, b in enumerate(self.buckets):
                if value <= b:
                    self._counts[i] += 1
                    break
            else:
                self._counts[-1] += 1

    def _samples(self):
        rows = []
        cum = 0
        for b, c in zip(self.buckets, self._counts):
            cum += c
            rows.append(("_bucket", f'le="{_fmt_value(b)}"', cum))
        cum += self._counts[-1]
        rows.append(("_bucket", 'le="+Inf"', cum))
        rows.append(("_sum", "", self._sum))
        rows.append(("_count", "", cum))
        return rows


class MetricsRegistry:
    """Create-or-get metric families and render them all.

    *Collectors* are zero-arg callables run at the top of every
    :meth:`render` — the pull-time bridge for state that lives elsewhere
    (``ServingStats``, heartbeat files, ``/proc``): they read it and set
    gauges, so the scrape always sees current values without the owner
    pushing on its hot path.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[str, _Metric] = {}
        self._collectors: list = []

    def _get(self, cls, name: str, help_: str, labelnames, **kw) -> _Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if not isinstance(m, cls):
                    raise ValueError(f"metric {name!r} already registered "
                                     f"as {m.kind}")
                return m
            m = self._metrics[name] = cls(name, help_, tuple(labelnames),
                                          threading.Lock(), **kw)
            return m

    def counter(self, name: str, help_: str, labelnames=()) -> Counter:
        return self._get(Counter, name, help_, labelnames)

    def gauge(self, name: str, help_: str, labelnames=()) -> Gauge:
        return self._get(Gauge, name, help_, labelnames)

    def histogram(self, name: str, help_: str, labelnames=(),
                  buckets=DEFAULT_BUCKETS) -> Histogram:
        return self._get(Histogram, name, help_, labelnames, buckets=buckets)

    def register_collector(self, fn) -> None:
        """*fn()* runs before each render; exceptions are swallowed — a
        broken collector must never take down the scrape endpoint."""
        self._collectors.append(fn)

    def render(self) -> str:
        for fn in list(self._collectors):
            try:
                fn()
            except Exception:
                pass
        with self._lock:
            metrics = list(self._metrics.values())
        out = []
        for m in sorted(metrics, key=lambda m: m.name):
            out.append(f"# HELP {m.name} {m.help}")
            out.append(f"# TYPE {m.name} {m.kind}")
            for suffix, labelstr, value in m._rows():
                labels = f"{{{labelstr}}}" if labelstr else ""
                out.append(f"{m.name}{suffix}{labels} {_fmt_value(value)}")
        return "\n".join(out) + "\n"
