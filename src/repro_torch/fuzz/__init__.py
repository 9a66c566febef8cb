"""repro_torch.fuzz — seeded random-DAG differential fuzzer.

The port of ``repro.fuzz``.  Four parts, mirroring classic
compiler-fuzzing architecture (Csmith / TVM's relay fuzzers):

* :mod:`repro_torch.fuzz.generate` — a seeded, fully deterministic random
  quantized-DAG generator over the :class:`repro_torch.core.graph.Graph` IR.
  Graphs are described by a JSON-safe *spec dict*; ``build_graph(spec)``
  deterministically expands it into a topo-checked graph, and
  ``sample_spec(seed)`` samples a spec from knobs (fan-out degree,
  residual-ladder depth, join arity, shape ranges).
* :mod:`repro_torch.fuzz.oracle` — the differential oracle: for one graph on
  one registered target it runs ``dispatch -> lower`` onto the card (or
  ``device="cpu"``) and checks the full invariant battery (valid
  contiguous covers, the CPU interpreter vs compiled vs AOT vs pipelined
  vs batched bit-exactness on the device, memory-plan
  soundness under overlap and stream depth, ``makespan <=
  total_cycles()``, warm==cold schedule-cache roundtrips,
  ``report_dict()`` JSON-safety), classifying every failure by
  invariant and stage.
* :mod:`repro_torch.fuzz.shrink` — delta-debugging minimization over the spec
  (drop ops, collapse joins, shrink shapes/channels) re-running only
  the failing invariant.
* :mod:`repro_torch.fuzz.corpus` — replayable regression cases: every shrunk
  failure lands as JSON (the reference's format) under
  ``$MATCH_FUZZ_CORPUS`` or ``./fuzz-corpus``, never in the reference's
  replayed ``tests/conformance/corpus/``, which the port reads as data.

CLI: ``python -m repro_torch.fuzz run|replay|shrink`` (see ``--help``).
"""

from .corpus import (
    CASE_VERSION,
    case_id,
    default_corpus_dir,
    load_cases,
    make_case,
    replay_case,
    save_case,
)
from .generate import (
    FuzzKnobs,
    SpecError,
    build_graph,
    graph_for_seed,
    random_inputs,
    sample_spec,
)
from .oracle import INVARIANTS, CaseReport, FuzzFailure, check_case
from .shrink import shrink_spec

__all__ = [
    "CASE_VERSION",
    "CaseReport",
    "FuzzFailure",
    "FuzzKnobs",
    "INVARIANTS",
    "SpecError",
    "build_graph",
    "case_id",
    "check_case",
    "default_corpus_dir",
    "graph_for_seed",
    "load_cases",
    "make_case",
    "random_inputs",
    "replay_case",
    "sample_spec",
    "save_case",
    "shrink_spec",
]
