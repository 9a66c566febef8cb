"""The replayable regression corpus: shrunk failures as JSON cases.

The port of ``repro.fuzz.corpus``; a case is the reference's JSON, so
either package replays the other's cases.  A *case* freezes everything
needed to re-run one past failure: the minimal spec the shrinker
produced, the target name, the invariant that broke, and the io seed
used for the differential inputs.

The reference's own corpus (``tests/conformance/corpus/``) is replayed
by the reference's tests, so a case saved there would silently become a
test of the other package: this module reads it when given its path and
never writes into it.  Saved cases go to ``$MATCH_FUZZ_CORPUS`` or, when
that is unset, to ``./fuzz-corpus``.
"""

from __future__ import annotations

import hashlib
import json
import os
from pathlib import Path

from .oracle import CaseReport, check_case

__all__ = [
    "CASE_VERSION",
    "case_id",
    "default_corpus_dir",
    "load_cases",
    "make_case",
    "replay_case",
    "save_case",
]

CASE_VERSION = 1

# the reference package's replayed corpus, in a checkout of this repository
REFERENCE_CORPUS = Path(__file__).resolve().parents[3] / "tests" / "conformance" / "corpus"


def make_case(
    spec: dict,
    target: str,
    invariant: str,
    io_seed: int,
    *,
    note: str = "",
) -> dict:
    """Assemble a JSON-safe corpus case."""
    return {
        "case_version": CASE_VERSION,
        "target": str(target),
        "invariant": str(invariant),
        "io_seed": int(io_seed),
        "note": note,
        "spec": spec,
    }


def case_id(case: dict) -> str:
    """Stable content hash of what the case replays (spec x target x
    invariant); notes and metadata don't change identity."""
    payload = json.dumps(
        {k: case[k] for k in ("spec", "target", "invariant", "io_seed")},
        sort_keys=True,
        separators=(",", ":"),
    )
    return hashlib.sha256(payload.encode()).hexdigest()[:12]


def default_corpus_dir() -> Path:
    """``$MATCH_FUZZ_CORPUS`` if set, else ``./fuzz-corpus`` (never the
    reference's in-repo corpus)."""
    env = os.environ.get("MATCH_FUZZ_CORPUS")
    if env:
        return Path(env)
    return Path.cwd() / "fuzz-corpus"


def save_case(case: dict, corpus_dir: Path | str | None = None) -> Path:
    d = Path(corpus_dir) if corpus_dir is not None else default_corpus_dir()
    if d.resolve() == REFERENCE_CORPUS:
        raise ValueError(f"{d} is the reference's replayed corpus: save the port's cases elsewhere")
    d.mkdir(parents=True, exist_ok=True)
    path = d / f"{case['invariant']}_{case['target']}_{case_id(case)}.json"
    path.write_text(json.dumps(case, indent=2, sort_keys=True) + "\n")
    return path


def load_cases(corpus_dir: Path | str | None = None) -> list[tuple[Path, dict]]:
    d = Path(corpus_dir) if corpus_dir is not None else default_corpus_dir()
    if not d.is_dir():
        return []
    out = []
    for p in sorted(d.glob("*.json")):
        out.append((p, json.loads(p.read_text())))
    return out


def replay_case(
    case: dict,
    *,
    budget: int = 120,
    target_obj=None,
    full_battery: bool = False,
    device=None,
) -> CaseReport:
    """Re-run a corpus case's invariant (or the full battery) on its
    frozen spec, on ``device`` (CUDA unless told otherwise).  A clean
    report means the captured bug stays fixed."""
    # a "crash" can surface at any stage, so it always replays the full
    # battery; real invariants replay only themselves (fast, targeted)
    inv = case["invariant"]
    invariants = None if (full_battery or inv == "crash") else (inv,)
    return check_case(
        case["spec"],
        case["target"],
        io_seed=int(case.get("io_seed", 0)),
        invariants=invariants,
        budget=budget,
        target_obj=target_obj,
        device=device,
    )
