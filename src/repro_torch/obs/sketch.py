"""Streaming quantile sketches.

The serving hot path needs latency quantiles, and the previous
implementation sorted a 512-sample deque on every resolve round —
O(n log n) per round, a hard 512-sample history cap, and no way to
merge replicas.  This module provides the one quantile implementation
the whole stack now shares:

* :class:`QuantileSketch` — a DDSketch-style sketch with
  relative-accuracy guarantees: values land in log-spaced buckets
  (``gamma = (1 + a) / (1 - a)`` for relative accuracy ``a``), so
  ``quantile(q)`` is within ``a * |true value|`` of the exact sample
  quantile, inserts are O(1) (one dict bump), memory is bounded
  (``max_buckets``, lowest buckets collapse first so tail quantiles
  stay accurate), and two sketches **merge** by adding bucket counts —
  associative and lossless, which is what per-interval windows and
  multi-replica aggregation both need.
* :class:`WindowedSketch` — a ring of per-interval sketches: ``add``
  writes the current interval's sketch (O(1)), ``merged``/``quantile``
  merge the live intervals on *read*.  Rolling p99-over-the-last-minute
  without storing samples and without decay heuristics: expired
  intervals simply rotate out of the ring.

Consumers: :class:`repro_torch.obs.metrics.Histogram` (approximate
p50/p90/p99 in ``to_value()``), :meth:`repro_torch.serve.ModelServer.stats`
(the serving latency window), and :mod:`repro_torch.obs.slo` (rolling SLO
evaluation).  Stdlib-only, like the rest of ``repro_torch.obs``.

Thread safety: :class:`QuantileSketch` is not locked (its consumers
either own a lock — ``Histogram`` — or mutate from one worker thread);
:class:`WindowedSketch` takes a small lock around ring rotation so a
``stats()`` reader can never observe a half-rotated interval.
"""

from __future__ import annotations

import math
import threading
import time

__all__ = ["QuantileSketch", "WindowedSketch"]

_DEFAULT_ACCURACY = 0.01
_DEFAULT_MAX_BUCKETS = 1024


class QuantileSketch:
    """Mergeable DDSketch-style quantile sketch with bounded memory.

    ``relative_accuracy`` is the guarantee: for any quantile ``q``,
    ``|quantile(q) - exact_q| <= relative_accuracy * |exact_q|`` (as
    long as bucket collapse has not touched the rank being asked for —
    collapse eats the *lowest* buckets first, so p50/p90/p99 of a
    latency stream stay inside the bound).
    """

    __slots__ = (
        "relative_accuracy",
        "max_buckets",
        "count",
        "total",
        "min",
        "max",
        "collapsed",
        "_gamma",
        "_log_gamma",
        "_pos",
        "_neg",
        "_zero",
    )

    def __init__(
        self,
        relative_accuracy: float = _DEFAULT_ACCURACY,
        max_buckets: int = _DEFAULT_MAX_BUCKETS,
    ):
        if not 0.0 < relative_accuracy < 1.0:
            raise ValueError(
                f"relative_accuracy must be in (0, 1), got {relative_accuracy}"
            )
        if max_buckets < 8:
            raise ValueError(f"max_buckets must be >= 8, got {max_buckets}")
        self.relative_accuracy = float(relative_accuracy)
        self.max_buckets = int(max_buckets)
        self._gamma = (1.0 + relative_accuracy) / (1.0 - relative_accuracy)
        self._log_gamma = math.log(self._gamma)
        self._pos: dict[int, int] = {}  # key -> count, v in (gamma^(k-1), gamma^k]
        self._neg: dict[int, int] = {}  # same keys over |v| for v < 0
        self._zero = 0
        self.count = 0
        self.total = 0.0
        self.min = math.inf
        self.max = -math.inf
        self.collapsed = 0  # buckets eaten by the memory bound, if any

    # -- insert ----------------------------------------------------------
    def _key(self, v: float) -> int:
        return math.ceil(math.log(v) / self._log_gamma)

    def add(self, v: float, n: int = 1) -> None:
        """O(1) insert: one log, one dict bump."""
        v = float(v)
        self.count += n
        self.total += v * n
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v
        if v > 0.0:
            k = self._key(v)
            self._pos[k] = self._pos.get(k, 0) + n
            if len(self._pos) > self.max_buckets:
                self._collapse(self._pos)
        elif v < 0.0:
            k = self._key(-v)
            self._neg[k] = self._neg.get(k, 0) + n
            if len(self._neg) > self.max_buckets:
                self._collapse(self._neg)
        else:
            self._zero += n

    def _collapse(self, table: dict[int, int]) -> None:
        # fold the two lowest buckets together: tail quantiles (the ones
        # SLOs are written against) keep their accuracy guarantee
        lo = sorted(table)[:2]
        table[lo[1]] = table.get(lo[1], 0) + table.pop(lo[0])
        self.collapsed += 1

    # -- query -----------------------------------------------------------
    def _value(self, key: int) -> float:
        # midpoint of (gamma^(k-1), gamma^k] in relative terms: within
        # relative_accuracy of every value the bucket holds
        return 2.0 * self._gamma ** key / (self._gamma + 1.0)

    def quantile(self, q: float) -> float:
        """Approximate ``q``-quantile (same rank convention as
        ``sorted(xs)[int(q * (len(xs) - 1))]``); 0.0 when empty."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"q must be in [0, 1], got {q}")
        if self.count == 0:
            return 0.0
        rank = int(q * (self.count - 1))
        seen = 0
        # ascending value order: most-negative first (descending |v|
        # keys), then zeros, then positives (ascending keys)
        for k in sorted(self._neg, reverse=True):
            seen += self._neg[k]
            if seen > rank:
                return max(self.min, min(self.max, -self._value(k)))
        seen += self._zero
        if seen > rank:
            return 0.0
        for k in sorted(self._pos):
            seen += self._pos[k]
            if seen > rank:
                return max(self.min, min(self.max, self._value(k)))
        return self.max  # unreachable unless counts drifted; be safe

    def quantiles(self, qs=(0.5, 0.9, 0.99)) -> dict[str, float]:
        """``{"p50": ..., "p90": ..., "p99": ...}`` for the given qs."""
        return {f"p{round(q * 100):d}": self.quantile(q) for q in qs}

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    # -- merge -----------------------------------------------------------
    def merge(self, other: "QuantileSketch") -> "QuantileSketch":
        """Fold ``other`` into this sketch (bucket-count addition —
        associative and commutative; both sketches must share the same
        ``relative_accuracy``).  Returns ``self``."""
        if abs(other.relative_accuracy - self.relative_accuracy) > 1e-12:
            raise ValueError(
                "cannot merge sketches with different relative accuracies "
                f"({self.relative_accuracy} vs {other.relative_accuracy})"
            )
        for k, n in other._pos.items():
            self._pos[k] = self._pos.get(k, 0) + n
        while len(self._pos) > self.max_buckets:
            self._collapse(self._pos)
        for k, n in other._neg.items():
            self._neg[k] = self._neg.get(k, 0) + n
        while len(self._neg) > self.max_buckets:
            self._collapse(self._neg)
        self._zero += other._zero
        self.count += other.count
        self.total += other.total
        if other.count:
            if other.min < self.min:
                self.min = other.min
            if other.max > self.max:
                self.max = other.max
        self.collapsed += other.collapsed
        return self

    def copy(self) -> "QuantileSketch":
        out = QuantileSketch(self.relative_accuracy, self.max_buckets)
        out.merge(self)
        return out

    # -- export ----------------------------------------------------------
    def to_dict(self) -> dict:
        """JSON-safe summary (quantiles + shape, not raw buckets)."""
        return {
            "count": self.count,
            "sum": self.total,
            "mean": self.mean,
            "min": self.min if self.count else None,
            "max": self.max if self.count else None,
            "relative_accuracy": self.relative_accuracy,
            "buckets": len(self._pos) + len(self._neg) + (1 if self._zero else 0),
            "collapsed": self.collapsed,
            **self.quantiles(),
        }

    def __len__(self) -> int:
        return self.count

    def __repr__(self) -> str:  # pragma: no cover - debugging nicety
        return (
            f"QuantileSketch(n={self.count}, acc={self.relative_accuracy}, "
            f"p50={self.quantile(0.5):.3g}, p99={self.quantile(0.99):.3g})"
        )


class WindowedSketch:
    """Rolling-window quantiles: a ring of per-interval sketches.

    ``add`` is O(1) into the current interval's sketch; reads merge the
    intervals still inside the window — so p99-over-the-last-minute
    costs one merge of ``intervals`` small sketches *per read*, and the
    write path (the serving hot loop) never sorts, never scans, never
    grows.  Timestamps are caller-supplied monotonic seconds
    (``now_s``) so tests can drive the clock and the serving layer can
    reuse the tracer timestamp it already read; the default clock is
    ``time.monotonic``.
    """

    __slots__ = (
        "window_s",
        "intervals",
        "relative_accuracy",
        "max_buckets",
        "_interval_s",
        "_ring",
        "_lock",
    )

    def __init__(
        self,
        window_s: float = 60.0,
        intervals: int = 12,
        relative_accuracy: float = _DEFAULT_ACCURACY,
        max_buckets: int = _DEFAULT_MAX_BUCKETS,
    ):
        if window_s <= 0.0:
            raise ValueError(f"window_s must be > 0, got {window_s}")
        if intervals < 1:
            raise ValueError(f"intervals must be >= 1, got {intervals}")
        self.window_s = float(window_s)
        self.intervals = int(intervals)
        self.relative_accuracy = float(relative_accuracy)
        self.max_buckets = int(max_buckets)
        self._interval_s = self.window_s / self.intervals
        # slot -> (epoch, sketch); an interval whose epoch fell out of
        # the window is dead weight until its slot is overwritten
        self._ring: list[tuple[int, QuantileSketch] | None] = [None] * self.intervals
        self._lock = threading.Lock()

    def _epoch(self, now_s: float | None) -> int:
        now = time.monotonic() if now_s is None else float(now_s)
        return int(now / self._interval_s)

    def add(self, v: float, *, now_s: float | None = None) -> None:
        """Record one value into the current interval (O(1))."""
        epoch = self._epoch(now_s)
        slot = epoch % self.intervals
        entry = self._ring[slot]
        if entry is None or entry[0] != epoch:
            with self._lock:  # rare: once per interval rotation
                entry = self._ring[slot]
                if entry is None or entry[0] != epoch:
                    entry = (
                        epoch,
                        QuantileSketch(self.relative_accuracy, self.max_buckets),
                    )
                    self._ring[slot] = entry
        entry[1].add(v)

    def merged(self, *, now_s: float | None = None) -> QuantileSketch:
        """One sketch covering every live interval (merge-on-read)."""
        epoch = self._epoch(now_s)
        out = QuantileSketch(self.relative_accuracy, self.max_buckets)
        with self._lock:
            live = [e for e in self._ring if e is not None]
        for e_epoch, sk in live:
            if epoch - self.intervals < e_epoch <= epoch:
                out.merge(sk)
        return out

    def quantile(self, q: float, *, now_s: float | None = None) -> float:
        return self.merged(now_s=now_s).quantile(q)

    @property
    def count(self) -> int:
        return self.merged().count

    def to_dict(self) -> dict:
        d = self.merged().to_dict()
        d["window_s"] = self.window_s
        d["intervals"] = self.intervals
        return d
