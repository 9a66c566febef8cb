"""Delta-debugging minimization of failing fuzz specs.

Classic ddmin over the *spec*, not the graph: every candidate is a
simplified spec (drop an op and splice its consumers onto its source,
collapse join arity, drop bias/relu epilogue flags, halve shapes and
channel counts), re-validated through ``build_graph`` — candidates that
no longer describe a buildable graph are discarded — and accepted only
when the **same invariant still fails** under a caller-supplied
predicate (usually :func:`repro_torch.fuzz.oracle.check_case` restricted to
the failing invariant).  Rounds repeat to a fixpoint, so the result is
1-minimal under the pass set: no single remaining simplification
preserves the failure.
"""

from __future__ import annotations

import copy
from typing import Callable, Iterator

from .generate import SpecError, build_graph

__all__ = ["shrink_spec"]


def _renumber(ops: list[dict], removed: int, replacement: int) -> list[dict] | None:
    """Ops with value ``removed+1`` spliced out (consumers fall back to
    ``replacement``) and later value indices shifted down by one."""
    out = []
    rm_val = removed + 1

    def remap(v: int) -> int:
        if v == rm_val:
            v = replacement
        return v - 1 if v > rm_val else v

    for i, op in enumerate(ops):
        if i == removed:
            continue
        op = copy.deepcopy(op)
        if "src" in op:
            op["src"] = remap(int(op["src"]))
        if "srcs" in op:
            op["srcs"] = [remap(int(s)) for s in op["srcs"]]
        out.append(op)
    return out


def _primary_src(op: dict) -> int:
    if "src" in op:
        return int(op["src"])
    return int(op["srcs"][0])


def _candidates(spec: dict) -> Iterator[dict]:
    """All one-step simplifications of ``spec``, most aggressive first."""
    ops = spec["ops"]

    # 1. drop one op, splicing its consumers onto its primary source
    for i in reversed(range(len(ops))):
        if len(ops) == 1:
            break
        new_ops = _renumber(ops, i, _primary_src(ops[i]))
        yield {**spec, "ops": new_ops}

    # 2. collapse join arity (rightmost source first)
    for i, op in enumerate(ops):
        srcs = op.get("srcs")
        if srcs and len(srcs) > 2:
            op2 = copy.deepcopy(op)
            op2["srcs"] = srcs[:-1]
            yield {**spec, "ops": [op2 if j == i else o for j, o in enumerate(ops)]}

    # 3. drop epilogue flags / widen strides back to 1
    for i, op in enumerate(ops):
        for key, off in (("relu", False), ("bias", False), ("stride", 1), ("F", 1)):
            if op.get(key) not in (None, off):
                op2 = copy.deepcopy(op)
                op2[key] = off
                yield {**spec, "ops": [op2 if j == i else o for j, o in enumerate(ops)]}

    # 4. halve per-op channel counts
    for i, op in enumerate(ops):
        k = op.get("K")
        if isinstance(k, int) and k > 1:
            op2 = copy.deepcopy(op)
            op2["K"] = k // 2
            yield {**spec, "ops": [op2 if j == i else o for j, o in enumerate(ops)]}

    # 5. halve the input tensor
    for key in ("H", "W", "C", "B"):
        v = int(spec[key])
        if v > 1:
            yield {**spec, key: v // 2}


def shrink_spec(
    spec: dict,
    still_fails: Callable[[dict], bool],
    *,
    max_checks: int = 400,
) -> tuple[dict, int]:
    """Minimize ``spec`` while ``still_fails(candidate)`` holds.

    Returns ``(minimal spec, predicate calls spent)``.  ``still_fails``
    must be deterministic; it is never called on unbuildable specs
    (those are filtered through :func:`build_graph` first).
    """
    cur = copy.deepcopy(spec)
    checks = 0
    progress = True
    while progress and checks < max_checks:
        progress = False
        for cand in _candidates(cur):
            if checks >= max_checks:
                break
            try:
                build_graph(cand)
            except SpecError:
                continue
            checks += 1
            if still_fails(cand):
                cur = cand
                progress = True
                break  # restart candidate enumeration on the smaller spec
    return cur, checks
