"""CLI: ``python -m repro_torch.fuzz run|replay|shrink``.

``run``     fuzz seeds across targets, shrink + save every failure.
``replay``  re-run the regression corpus (or specific case files).
``shrink``  minimize a saved (unshrunk) case file in place.

Every command runs the compiled paths on the CUDA card unless
``--device cpu`` is given.  An ``h100`` among ``--targets`` (or a case's
target) registers the card's own target first: it enters the registry
only on such an explicit request.  Cases are saved to ``--corpus``, else
``$MATCH_FUZZ_CORPUS``, else ``./fuzz-corpus``; ``replay`` reads the same
directory unless given case files.

Verdict output is deterministic for a fixed seed block: the summary on
stdout depends only on seeds and code, never on wall-clock, so two runs
of ``run --seed 0 --n 200`` are bit-identical (timings go to stderr).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

from repro_torch.core.loma import SchedulePlanner

from .corpus import REFERENCE_CORPUS, load_cases, make_case, replay_case, save_case
from .generate import FuzzKnobs, sample_spec
from .oracle import INVARIANTS, check_case
from .shrink import shrink_spec


def _register(names) -> None:
    """Register the card's own target when it is named."""
    if "h100" in names:
        from repro_torch.targets import register_h100_target

        register_h100_target()


def _targets(arg: str | None) -> list[str]:
    from repro_torch.targets.registry import list_targets

    if arg:
        names = [t.strip() for t in arg.split(",") if t.strip()]
        _register(names)
        return names
    return list_targets()


def _still_fails_fn(target: str, invariant: str, io_seed: int, budget: int,
                    device):
    """Predicate for the shrinker: does `invariant` still fail on spec?"""
    invs = None if invariant == "crash" else (invariant,)

    def pred(spec: dict) -> bool:
        rep = check_case(spec, target, io_seed=io_seed, invariants=invs,
                         budget=budget, device=device)
        return any(f.invariant == invariant for f in rep.failures)

    return pred


def _shrink_and_save(spec, target, invariant, io_seed, budget, corpus_dir,
                     note: str, device):
    pred = _still_fails_fn(target, invariant, io_seed, budget, device)
    small, checks = shrink_spec(spec, pred)
    case = make_case(small, target, invariant, io_seed, note=note)
    path = save_case(case, corpus_dir)
    return path, small, checks


def _cmd_run(args) -> int:
    seed = args.seed
    if args.seed_from_env:
        seed = int(os.environ.get("MATCH_FUZZ_SEED", seed))
    targets = _targets(args.targets)
    knobs = FuzzKnobs(max_ops=args.max_ops)
    planners = {t: SchedulePlanner() for t in targets}
    t0 = time.perf_counter()
    graphs = 0
    checks = 0
    inv_counts = {iv: 0 for iv in INVARIANTS}
    failures = []  # (seed, target, invariant, stage, message)

    for idx in range(args.n):
        if args.budget_s and time.perf_counter() - t0 > args.budget_s:
            print(f"[fuzz] wall budget {args.budget_s}s reached after "
                  f"{idx} seeds", file=sys.stderr)
            break
        s = seed + idx
        spec = sample_spec(s, knobs)
        exec_turn = args.exec_every > 0 and idx % args.exec_every == 0
        invs = INVARIANTS if exec_turn else tuple(
            iv for iv in INVARIANTS if iv not in ("bitexact", "cache")
        )
        graphs += 1
        for tname in targets:
            rep = check_case(spec, tname, io_seed=s, invariants=invs,
                             budget=args.budget, planner=planners[tname],
                             device=args.device)
            checks += 1
            for iv in rep.invariants_checked:
                inv_counts[iv] += 1
            for f in rep.failures:
                failures.append((s, tname, f.invariant, f.stage, f.message))
                print(f"[fuzz] FAIL seed={s} target={tname} "
                      f"invariant={f.invariant} stage={f.stage}: {f.message}")
                if not args.no_shrink:
                    path, small, n_checks = _shrink_and_save(
                        spec, tname, f.invariant, s, args.budget,
                        args.corpus, note=f"found by run --seed {seed}; "
                        f"seed {s}, stage {f.stage}", device=args.device)
                    print(f"[fuzz]   shrunk to {len(small['ops'])} spec ops "
                          f"-> {path}")

    dt = time.perf_counter() - t0
    # deterministic verdict summary on stdout; timing on stderr
    print(f"[fuzz] seeds={graphs} targets={','.join(targets)} "
          f"case-checks={checks}")
    print("[fuzz] invariant coverage: "
          + " ".join(f"{iv}={inv_counts[iv]}" for iv in INVARIANTS))
    print(f"[fuzz] failures={len(failures)}")
    print(f"[fuzz] wall={dt:.1f}s ({graphs / dt:.2f} graphs/s, "
          f"{sum(inv_counts.values()) / dt:.2f} invariant-checks/s)",
          file=sys.stderr)
    if args.json:
        Path(args.json).write_text(json.dumps({
            "seed": seed, "seeds_run": graphs, "targets": targets,
            "case_checks": checks, "invariant_coverage": inv_counts,
            "failures": [
                {"seed": s, "target": t, "invariant": iv, "stage": st,
                 "message": m}
                for s, t, iv, st, m in failures
            ],
        }, indent=2) + "\n")
    return 1 if failures else 0


def _cmd_replay(args) -> int:
    if args.cases:
        cases = [(Path(p), json.loads(Path(p).read_text())) for p in args.cases]
    else:
        cases = load_cases(args.corpus)
    if not cases:
        print("[fuzz] no corpus cases found")
        return 0
    _register({case["target"] for _, case in cases})
    bad = 0
    for path, case in cases:
        rep = replay_case(case, budget=args.budget,
                          full_battery=args.full_battery, device=args.device)
        verdict = "ok" if rep.ok else "FAIL"
        print(f"[fuzz] {verdict} {path.name} "
              f"(invariant={case['invariant']}, target={case['target']}, "
              f"{rep.n_nodes} nodes)")
        for f in rep.failures:
            bad += 1
            print(f"[fuzz]   {f.invariant}@{f.stage}: {f.message}")
    print(f"[fuzz] replayed {len(cases)} cases, {bad} failures")
    return 1 if bad else 0


def _cmd_shrink(args) -> int:
    path = Path(args.case)
    out = Path(args.out) if args.out else path
    if out.resolve().parent == REFERENCE_CORPUS:
        print(f"[fuzz] {out} is in the reference's replayed corpus: pass --out "
              "elsewhere", file=sys.stderr)
        return 2
    case = json.loads(path.read_text())
    _register({case["target"]})
    pred = _still_fails_fn(case["target"], case["invariant"],
                           int(case.get("io_seed", 0)), args.budget,
                           args.device)
    if not pred(case["spec"]):
        print(f"[fuzz] {path.name}: invariant {case['invariant']} no longer "
              "fails — nothing to shrink")
        return 1
    small, checks = shrink_spec(case["spec"], pred)
    case["spec"] = small
    out.write_text(json.dumps(case, indent=2, sort_keys=True) + "\n")
    print(f"[fuzz] shrunk to {len(small['ops'])} spec ops "
          f"({checks} oracle calls) -> {out}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.fuzz",
                                 description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("run", help="fuzz fresh seeds, shrink + save failures")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--n", type=int, default=50, help="seeds to fuzz")
    p.add_argument("--targets", help="comma list (default: all registered)")
    p.add_argument("--budget", type=int, default=120, help="DSE budget/dispatch")
    p.add_argument("--budget-s", type=float, default=0.0,
                   help="wall-clock cap in seconds (0 = no cap)")
    p.add_argument("--seed-from-env",
                   action="store_true",
                   help="read the base seed from $MATCH_FUZZ_SEED (CI)")
    p.add_argument("--exec-every", type=int, default=8,
                   help="run the expensive bitexact+cache battery every "
                        "K-th seed (0 = never)")
    p.add_argument("--max-ops", type=int, default=10)
    p.add_argument("--no-shrink", action="store_true")
    p.add_argument("--corpus", help="corpus dir (default: $MATCH_FUZZ_CORPUS "
                                    "or ./fuzz-corpus)")
    p.add_argument("--json", help="write a JSON summary here")
    p.add_argument("--device", default="cuda",
                   help="where the compiled paths run (default: cuda)")
    p.set_defaults(fn=_cmd_run)

    p = sub.add_parser("replay", help="re-run the regression corpus")
    p.add_argument("cases", nargs="*", help="case files (default: corpus dir)")
    p.add_argument("--corpus", help="corpus dir (default: $MATCH_FUZZ_CORPUS "
                                    "or ./fuzz-corpus)")
    p.add_argument("--budget", type=int, default=120)
    p.add_argument("--full-battery", action="store_true",
                   help="run every invariant, not just the captured one")
    p.add_argument("--device", default="cuda",
                   help="where the compiled paths run (default: cuda)")
    p.set_defaults(fn=_cmd_replay)

    p = sub.add_parser("shrink", help="minimize a saved case file")
    p.add_argument("case")
    p.add_argument("--out", help="write here instead of in place")
    p.add_argument("--budget", type=int, default=120)
    p.add_argument("--device", default="cuda",
                   help="where the compiled paths run (default: cuda)")
    p.set_defaults(fn=_cmd_shrink)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
