"""LOMA-style temporal-mapping DSE (paper Sec. IV-B.1, ref. [32]).

LOMA enumerates valid, non-equivalent schedules from the **loop prime
factors** of each dimension and allocates operands to the lowest non-full
memory level.  Both hardware targets in this repo (MCU L2→L1 scratchpads
and TPU HBM→VMEM) expose exactly two software-managed levels per operand,
so the search specialises to:

* an **inner tile** per loop dim (a divisor of the dim built from a subset
  of its prime factors — the LPF split), resident at L1/VMEM, and
* a permutation of the **outer** loops, which determines stationarity
  (reload factors) and partial-sum spills.

Uneven mappings (paper: "different tensors tiled in different memory
levels") arise naturally when an operand's tile equals its full footprint.
Double-buffering support is the ``+`` vs ``max`` combine in the cost model
plus the 2x L1 footprint charge — both paper extensions to ZigZag.

The search is exhaustive up to a candidate ``budget``; above it, tile
candidates are subsampled deterministically, preferring spatial-unrolling
aligned sizes (the MXU wants multiples of 128, DIANA of 16).

Two caching layers sit in front of the search:

* a process-wide in-memory cache keyed by the name-agnostic geometry
  :func:`_workload_key` (identical layers share one search), and
* :class:`SchedulePlanner` — the batched front-end the DP dispatcher
  uses: it collects every (workload, module) query of a compile, dedupes
  them, evaluates misses through a ``concurrent.futures`` thread pool,
  and optionally persists results to a JSON file so a second compile of
  the same network never runs LOMA at all.
"""

from __future__ import annotations

import itertools
import json
import math
import os
import uuid
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field, replace
from functools import lru_cache
from pathlib import Path
from typing import Iterable, Mapping, Sequence

from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs.log import MatchWarning
from repro_torch.obs.log import warn as obs_warn

from .cost_model import INFEASIBLE, CostBreakdown, evaluate_mapping
from .target import ExecutionModule
from .workload import Workload, prod

__all__ = [
    "TemporalMapping",
    "ScheduleResult",
    "SchedulePlanner",
    "ScheduleCacheWarning",
    "prime_factors",
    "divisors",
    "tile_candidates",
    "order_candidates",
    "search_schedule",
    "clear_schedule_cache",
]


def prime_factors(n: int) -> list[int]:
    """Prime factorisation (multiset) of n — the LPF basis."""
    out: list[int] = []
    d = 2
    while d * d <= n:
        while n % d == 0:
            out.append(d)
            n //= d
        d += 1
    if n > 1:
        out.append(n)
    return out


@lru_cache(maxsize=4096)
def divisors(n: int) -> tuple[int, ...]:
    """All divisors of n (products of prime-factor subsets), sorted."""
    pf = prime_factors(n)
    divs = {1}
    for p in pf:
        divs |= {d * p for d in divs}
    return tuple(sorted(divs))


@dataclass(frozen=True)
class TemporalMapping:
    """One schedule candidate: L1 tile sizes + outer loop order."""

    tiles: Mapping[str, int]
    outer_order: tuple[str, ...]  # outermost first

    def describe(self, workload: Workload) -> str:
        full = workload.dim_sizes
        inner = " ".join(f"{d}={self.tiles.get(d, 1)}" for d in full)
        outer = ">".join(
            f"{d}/{math.ceil(full[d] / self.tiles.get(d, 1))}"
            for d in self.outer_order
            if math.ceil(full[d] / self.tiles.get(d, 1)) > 1
        )
        return f"tile[{inner}] outer[{outer or 'none'}]"


@dataclass(frozen=True)
class ScheduleResult:
    """Winning schedule for one (workload, module)."""

    workload_name: str
    module_name: str
    mapping: TemporalMapping
    cost: CostBreakdown
    candidates_evaluated: int = 0

    @property
    def latency_cycles(self) -> float:
        return self.cost.latency_cycles

    @property
    def feasible(self) -> bool:
        return self.cost.feasible

    def macs_per_cycle(self, workload: Workload) -> float:
        return self.cost.with_macs(workload.total_macs())


# ---------------------------------------------------------------------------
# Candidate generation
# ---------------------------------------------------------------------------


def tile_candidates(
    workload: Workload,
    module: ExecutionModule,
    max_per_dim: int = 12,
) -> dict[str, list[int]]:
    """Per-dim inner-tile size candidates.

    Divisors of the dim (LPF subsets) plus spatial-unrolling-aligned sizes
    (multiples of the PE/MXU count, which divide nothing but maximise
    utilization through ceil-padding), deterministically thinned to
    ``max_per_dim``.
    """
    su = module.spatial_for(workload)
    sequential = set(workload.attrs.get("sequential", ()))
    out: dict[str, list[int]] = {}
    for loop in workload.loops:
        n = loop.size
        cands = set(divisors(n))
        unroll = su.dims.get(loop.name)
        if unroll:
            m = unroll
            while m < n:
                cands.add(m)
                m *= 2
            cands.add(min(unroll, n))
        cands.add(n)
        if loop.name in sequential:
            # recurrence dims: tile = chunk size; any chunk works but the
            # op processes chunks in order — candidates unchanged.
            pass
        ordered = sorted(cands)
        if len(ordered) > max_per_dim:
            # keep extremes + geometric subsample, preferring aligned sizes
            keep = {ordered[0], ordered[-1]}
            if unroll:
                keep |= {c for c in ordered if c % unroll == 0}
            step = max(1, len(ordered) // max_per_dim)
            keep |= set(ordered[::step])
            ordered = sorted(keep)
            if len(ordered) > max_per_dim:
                # final thinning, keep largest (most reuse) biased sample
                ordered = sorted(set(ordered[:2] + ordered[-(max_per_dim - 2):]))
        out[loop.name] = ordered
    return out


def order_candidates(workload: Workload, max_orders: int = 64) -> list[tuple[str, ...]]:
    """Outer-loop order candidates (outermost first).

    Full permutations when small; otherwise canonical stationarity orders
    (each operand's relevant dims innermost = that operand stationary) plus
    a deterministic sample.
    """
    dims = [l.name for l in workload.loops]
    if len(dims) <= 4:
        perms = list(itertools.permutations(dims))
    else:
        perms = []
        # canonical orders: rotate each operand's dims to the inner slots
        for op in workload.operands:
            rel = [d for d in dims if d in op.dims]
            irr = [d for d in dims if d not in op.dims]
            perms.append(tuple(irr + rel))  # op-stationary-ish
            perms.append(tuple(rel + irr))  # op-streaming
        # reduction-outer and reduction-inner variants
        red = [l.name for l in workload.loops if l.kind == "reduction"]
        sp = [l.name for l in workload.loops if l.kind != "reduction"]
        perms.append(tuple(red + sp))
        perms.append(tuple(sp + red))
        for r in range(1, min(len(dims), 4)):
            perms.append(tuple(dims[r:] + dims[:r]))
        seen = set()
        uniq = []
        for p in perms:
            if p not in seen:
                seen.add(p)
                uniq.append(p)
        perms = uniq
    if len(perms) > max_orders:
        step = max(1, len(perms) // max_orders)
        perms = perms[::step][:max_orders]
    return perms


# ---------------------------------------------------------------------------
# Search
# ---------------------------------------------------------------------------

_SCHEDULE_CACHE: dict[tuple, ScheduleResult] = {}


def clear_schedule_cache() -> None:
    _SCHEDULE_CACHE.clear()


_OPAQUE_FN_COUNTER = itertools.count()
# Salting the counter with a per-process UUID guarantees an opaque-closure
# key can never match one persisted by another process: the disk cache
# *misses* and re-searches rather than risking a stale schedule.
_OPAQUE_FN_SALT = uuid.uuid4().hex


def _opaque_fn_token(fn) -> str:
    """Process-unique, never-recycled token for a callable whose closure
    cannot be keyed by value.  Stored on the function object itself so the
    same callable always maps to the same token while it is alive."""
    tok = getattr(fn, "_match_cache_token", None)
    if tok is None:
        tok = f"{_OPAQUE_FN_SALT}:{next(_OPAQUE_FN_COUNTER)}"
        try:
            fn._match_cache_token = tok
        except (AttributeError, TypeError):
            pass  # unsettable callables fall back to a fresh token per call
    return tok


def _callable_token(fn) -> tuple | None:
    """Stable-ish identity for a cost-model callable (custom/constraint).

    Qualified name + defaults + primitive closure-cell values distinguish
    the common cases (lambdas parameterised via defaults or closed-over
    constants) across processes.  An opaque closure cell falls back to the
    object id, which makes the key process-unique: the disk cache then
    *misses* and re-searches instead of serving a stale schedule.
    """
    if fn is None:
        return None
    cells = []
    for cell in fn.__closure__ or ():
        v = cell.cell_contents
        if isinstance(v, (int, float, str, bool, bytes, tuple, frozenset, type(None))):
            cells.append(repr(v))
        else:
            # opaque value: tag the *function* with a never-reused token
            # (id() could alias a GC'd callable's address within a process)
            cells.append(f"opaque:{_opaque_fn_token(fn)}")
    return (
        getattr(fn, "__module__", ""),
        getattr(fn, "__qualname__", repr(fn)),
        repr(getattr(fn, "__defaults__", None)),
        tuple(cells),
    )


def _workload_key(workload: Workload, module: ExecutionModule) -> tuple:
    """Geometry key for one (workload, module) DSE query.

    Deliberately excludes the workload *name* so identical layers (the
    repeated blocks of MobileNet/DSCNN) collapse to one search, and
    includes everything the cost model actually reads: loop nest, operand
    shapes/layouts, cost-relevant attrs, and the module's memory, compute
    and spatial-unrolling constants (custom compute / constraint
    callables are keyed via :func:`_callable_token`).
    """
    su = module.spatial_for(workload)
    cm = module.compute
    cost_attrs = tuple(
        sorted(
            (k, str(workload.attrs[k]))
            for k in ("stride", "sequential", "causal", "state", "depthwise")
            if k in workload.attrs
        )
    )
    return (
        workload.op_type,
        tuple((l.name, l.size, l.kind) for l in workload.loops),
        tuple(
            (o.name, o.elem_bytes, o.dims, o.layout, o.is_output) for o in workload.operands
        ),
        float(workload.macs_per_iter),
        cost_attrs,
        module.name,
        tuple(
            (m.name, m.size_bytes, m.bandwidth, m.chunk_overhead, m.serves)
            for m in module.memories
        ),
        tuple(sorted(su.dims.items())),
        (
            cm.cycles_per_iter,
            cm.output_elem_overhead,
            cm.macs_per_pe_cycle,
            cm.fixed_setup_cycles,
            cm.fixed_overhead_cycles,
            cm.custom_scale,
        ),
        _callable_token(cm.custom),
        _callable_token(module.constraint),
        module.async_dma,
        module.double_buffer,
        # calibration-profile tag (fingerprint:version) stamped by
        # ExecutionModule.recalibrated — calibrated and declared instances
        # of the same module must never share schedule-cache entries
        str(module.attrs.get("calibration", "")),
    )


def search_schedule(
    workload: Workload,
    module: ExecutionModule,
    *,
    budget: int = 4000,
    max_per_dim: int = 12,
    max_orders: int = 64,
    use_cache: bool = True,
) -> ScheduleResult:
    """Find the best temporal mapping of ``workload`` on ``module``.

    Returns an infeasible :class:`ScheduleResult` when no tile fits the
    module's L1 (the dispatcher then falls back — paper: offload to CPU).
    """
    # budget participates in the key: a low-budget result must never be
    # served (or persisted by a SchedulePlanner) for a high-budget query
    key = (_workload_key(workload, module), int(budget))
    if use_cache and key in _SCHEDULE_CACHE:
        hit = _SCHEDULE_CACHE[key]
        # the key is name-agnostic (identical layers share one search):
        # restamp the result with this query's workload name
        if hit.workload_name != workload.name:
            hit = replace(hit, workload_name=workload.name)
        return hit

    if not module.supports(workload):
        res = ScheduleResult(workload.name, module.name, TemporalMapping({}, ()), INFEASIBLE, 0)
        if use_cache:
            _SCHEDULE_CACHE[key] = res
        return res

    cands = tile_candidates(workload, module, max_per_dim=max_per_dim)
    orders = order_candidates(workload, max_orders=max_orders)
    dims = [l.name for l in workload.loops]

    state = _SearchState(workload, module, orders, budget)

    total_combos = prod(len(cands[d]) for d in dims)
    if total_combos * max(1, len(orders)) <= budget:
        # exhaustive enumeration (small workloads, unit tests)
        for combo in itertools.product(*(cands[d] for d in dims)):
            state.try_tiles(dict(zip(dims, combo)))
    else:
        # greedy feasible anchor + coordinate descent (large workloads)
        idx = {d: len(cands[d]) - 1 for d in dims}  # start at max tiles
        tiles = {d: cands[d][idx[d]] for d in dims}
        guard = 0
        while not state.try_tiles(tiles) and guard < 10_000:
            guard += 1
            # shrink the dim with the largest current tile that can shrink
            shrinkable = [d for d in dims if idx[d] > 0]
            if not shrinkable:
                break
            d = max(shrinkable, key=lambda d: cands[d][idx[d]])
            idx[d] -= 1
            tiles[d] = cands[d][idx[d]]
        # coordinate descent around the anchor (or around max if infeasible)
        improved = True
        while improved and state.n_eval < budget:
            improved = False
            for d in dims:
                base = dict(state.best_tiles or tiles)
                for v in cands[d]:
                    if v == base.get(d):
                        continue
                    trial = dict(base)
                    trial[d] = v
                    before = state.best_latency
                    state.try_tiles(trial)
                    if state.best_latency < before:
                        improved = True
                    if state.n_eval >= budget:
                        break
                if state.n_eval >= budget:
                    break

    best = state.result()
    if use_cache:
        _SCHEDULE_CACHE[key] = best
    return best


class _SearchState:
    """Tracks the incumbent during schedule search."""

    def __init__(self, workload: Workload, module: ExecutionModule, orders, budget: int):
        self.workload = workload
        self.module = module
        self.orders = orders
        self.budget = budget
        self.n_eval = 0
        self.best_cost: CostBreakdown | None = None
        self.best_tiles: dict | None = None
        self.best_order: tuple[str, ...] | None = None
        self._seen: set[tuple] = set()
        self._feas_cache: dict[tuple, bool] = {}

    @property
    def best_latency(self) -> float:
        return self.best_cost.latency_cycles if self.best_cost else math.inf

    def try_tiles(self, tiles: Mapping[str, int]) -> bool:
        """Evaluate tiles across all orders; returns feasibility."""
        sig = tuple(sorted(tiles.items()))
        if sig in self._seen:
            return self.best_tiles == dict(tiles) or self._was_feasible(sig)
        self._seen.add(sig)
        first = evaluate_mapping(self.workload, tiles, self.orders[0], self.module)
        self.n_eval += 1
        if not first.feasible:
            self._feas_cache[sig] = False
            return False
        self._feas_cache[sig] = True
        local = (self.orders[0], first)
        for order in self.orders[1:]:
            c = evaluate_mapping(self.workload, tiles, order, self.module)
            self.n_eval += 1
            if c.latency_cycles < local[1].latency_cycles:
                local = (order, c)
        order, cost = local
        if self.best_cost is None or cost.latency_cycles < self.best_cost.latency_cycles:
            self.best_cost = cost
            self.best_tiles = dict(tiles)
            self.best_order = tuple(order)
        return True

    def _was_feasible(self, sig) -> bool:
        return self._feas_cache.get(sig, False)

    def result(self) -> ScheduleResult:
        if self.best_cost is None:
            return ScheduleResult(
                self.workload.name, self.module.name, TemporalMapping({}, ()), INFEASIBLE, self.n_eval
            )
        return ScheduleResult(
            self.workload.name,
            self.module.name,
            TemporalMapping(self.best_tiles, self.best_order),
            self.best_cost,
            self.n_eval,
        )


# ---------------------------------------------------------------------------
# Batched, persistently cached DSE front-end (used by the DP dispatcher)
# ---------------------------------------------------------------------------


def _serialize_result(res: ScheduleResult) -> dict:
    c = res.cost

    def num(x):
        return None if math.isinf(x) else x

    return {
        "workload_name": res.workload_name,
        "module_name": res.module_name,
        "tiles": dict(res.mapping.tiles),
        "outer_order": list(res.mapping.outer_order),
        "feasible": c.feasible,
        "latency_cycles": num(c.latency_cycles),
        "l_ops": num(c.l_ops),
        "l_mem": num(c.l_mem),
        "traffic_bytes": dict(c.traffic_bytes),
        "dma_chunks": dict(c.dma_chunks),
        "utilization": c.utilization,
        "reason": c.reason,
        "candidates_evaluated": res.candidates_evaluated,
    }


def _deserialize_result(d: dict) -> ScheduleResult:
    def num(x):
        return math.inf if x is None else float(x)

    cost = CostBreakdown(
        feasible=bool(d["feasible"]),
        latency_cycles=num(d["latency_cycles"]),
        l_ops=num(d["l_ops"]),
        l_mem=num(d["l_mem"]),
        traffic_bytes=dict(d.get("traffic_bytes", {})),
        dma_chunks=dict(d.get("dma_chunks", {})),
        utilization=float(d.get("utilization", 0.0)),
        reason=str(d.get("reason", "")),
    )
    mapping = TemporalMapping(
        {k: int(v) for k, v in d.get("tiles", {}).items()},
        tuple(d.get("outer_order", ())),
    )
    return ScheduleResult(
        d["workload_name"],
        d["module_name"],
        mapping,
        cost,
        int(d.get("candidates_evaluated", 0)),
    )


class ScheduleCacheWarning(MatchWarning):
    """A persistent schedule cache could not be used (corrupt, stale, or
    version-mismatched) and a fresh search will run instead."""


class SchedulePlanner:
    """Collects DSE queries, dedupes, evaluates in a pool, caches on disk.

    The DP dispatcher enumerates *every* candidate (segment, module) pair
    up front instead of searching serially per node.  The planner:

    1. dedupes queries by the geometry :func:`_workload_key` (identical
       layers of a network — or of two networks — share one search; this
       dedup is where the cold-compile win comes from),
    2. evaluates the unique misses through a bounded
       ``concurrent.futures`` thread pool (:meth:`flush`) — note the
       analytic search is pure-Python and GIL-bound, so the pool bounds
       latency spikes rather than multiplying throughput,
    3. optionally persists results to a JSON file so a second compile of
       the same network skips the LOMA search entirely (warm-cache
       dispatch is pure dictionary lookups).

    ``cache_path=None`` keeps the planner purely in-memory; the
    ``MATCH_SCHEDULE_CACHE`` environment variable supplies a default path
    when set.
    """

    def __init__(
        self,
        cache_path: str | os.PathLike | None = None,
        max_workers: int | None = None,
    ):
        if cache_path is None:
            cache_path = os.environ.get("MATCH_SCHEDULE_CACHE") or None
        self.cache_path = Path(cache_path).expanduser() if cache_path else None
        self.max_workers = max_workers or min(8, os.cpu_count() or 1)
        self._results: dict[str, ScheduleResult] = {}
        self._pending: dict[str, tuple[Workload, ExecutionModule, int]] = {}
        self.stats = {"requests": 0, "deduped": 0, "hits": 0, "disk_hits": 0, "searched": 0}
        self._dirty = False
        if self.cache_path is not None and self.cache_path.exists():
            self._results = self._load_disk_cache()
        # distinguish true disk hits from same-planner in-memory hits
        self._from_disk = set(self._results)

    # Bump when evaluate_mapping / the traffic model / the search change
    # semantically: persisted entries from older cost models must miss.
    # v2: post-combine fixed_overhead_cycles + calibration tags in the key.
    CACHE_VERSION = 2

    def _load_disk_cache(self) -> dict[str, ScheduleResult]:
        """Read the persisted cache; any defect warns and falls back to a
        fresh search — a cache file must never be able to fail a compile."""

        def reject(why: str) -> dict[str, ScheduleResult]:
            obs_warn(
                f"schedule cache {self.cache_path}: {why}; ignoring it and "
                f"re-running the search",
                ScheduleCacheWarning,
                stacklevel=4,
                logger="loma",
            )
            return {}

        try:
            raw = json.loads(self.cache_path.read_text())
        except OSError as e:
            return reject(f"unreadable ({e})")
        except ValueError as e:
            return reject(f"corrupt JSON ({e})")
        if not isinstance(raw, dict) or "entries" not in raw:
            return reject("unrecognized (pre-versioning or foreign) format")
        version = raw.get("version")
        if version != self.CACHE_VERSION:
            return reject(
                f"stale version {version!r} (this build writes {self.CACHE_VERSION})"
            )
        entries = raw["entries"]
        if not isinstance(entries, dict):
            return reject("entries field is not a mapping")
        results: dict[str, ScheduleResult] = {}
        bad = 0
        for k, v in entries.items():
            try:
                results[str(k)] = _deserialize_result(v)
            except (KeyError, TypeError, ValueError, AttributeError):
                bad += 1
        if bad:
            obs_warn(
                f"schedule cache {self.cache_path}: skipped {bad} malformed "
                f"entr{'y' if bad == 1 else 'ies'} (kept {len(results)})",
                ScheduleCacheWarning,
                stacklevel=3,
                logger="loma",
            )
        return results

    @staticmethod
    def _key(workload: Workload, module: ExecutionModule, budget: int) -> str:
        return repr((SchedulePlanner.CACHE_VERSION, _workload_key(workload, module), int(budget)))

    def request(self, workload: Workload, module: ExecutionModule, *, budget: int = 4000) -> str:
        """Register one (workload, module) query; returns its cache key."""
        key = self._key(workload, module, budget)
        self.stats["requests"] += 1
        obs_metrics.counter("dse.requests").inc()
        if key in self._results:
            self.stats["hits"] += 1
            obs_metrics.counter("dse.cache_hits").inc()
            if key in self._from_disk:
                self.stats["disk_hits"] += 1
                obs_metrics.counter("dse.disk_hits").inc()
        elif key in self._pending:
            self.stats["deduped"] += 1
            obs_metrics.counter("dse.deduped").inc()
        else:
            self._pending[key] = (workload, module, budget)
        return key

    def flush(self) -> int:
        """Evaluate all pending unique queries through the thread pool;
        returns the LOMA candidates the searches evaluated (counter
        ``dse.candidates``)."""
        if not self._pending:
            return 0
        items = list(self._pending.items())
        self._pending.clear()

        def run(item):
            key, (wl, mod, budget) = item
            return key, search_schedule(wl, mod, budget=budget)

        if len(items) == 1:
            done = [run(items[0])]
        else:
            with ThreadPoolExecutor(max_workers=self.max_workers) as pool:
                done = list(pool.map(run, items))
        for key, res in done:
            self._results[key] = res
            self.stats["searched"] += 1
        obs_metrics.counter("dse.searched").inc(len(done))
        candidates = sum(res.candidates_evaluated for _, res in done)
        obs_metrics.counter("dse.candidates").inc(candidates)
        self._dirty = True
        self.save()
        return candidates

    def get(self, workload: Workload, module: ExecutionModule, *, budget: int = 4000) -> ScheduleResult:
        """Result for a query (flushing pending work if necessary)."""
        key = self._key(workload, module, budget)
        if key not in self._results:
            if key in self._pending:
                self.flush()
            else:
                self.request(workload, module, budget=budget)
                self.flush()
        res = self._results[key]
        if res.workload_name != workload.name:
            res = replace(res, workload_name=workload.name)
        return res

    def save(self) -> None:
        if self.cache_path is None or not self._dirty:
            return
        try:
            self.cache_path.parent.mkdir(parents=True, exist_ok=True)
            payload = {
                "version": self.CACHE_VERSION,
                "entries": {k: _serialize_result(v) for k, v in self._results.items()},
            }
            tmp = self.cache_path.with_suffix(".tmp")
            tmp.write_text(json.dumps(payload))
            tmp.replace(self.cache_path)
            self._dirty = False
        except OSError:
            pass  # cache is an optimisation; never fail a compile over it
