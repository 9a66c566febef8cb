"""Calibration CLI: the measure -> fit -> profile walkthrough.

  PYTHONPATH=src python -m repro_torch.calibrate sweep --target h100 --out samples.json
  PYTHONPATH=src python -m repro_torch.calibrate fit --samples samples.json --out profile.json
  PYTHONPATH=src python -m repro_torch.calibrate show profile.json

``sweep`` runs on the CUDA card unless ``--device cpu`` is given.  Naming
the card's own target (``--target h100``) registers it first: it enters
the registry only on such an explicit request.

Recompile with the fitted profile via
``MATCH_CALIBRATION_PROFILE=profile.json`` or
``get_target("h100", profile="profile.json")``.
"""

from __future__ import annotations

import argparse
import json
import sys


def _declared_target(name: str):
    """The declared (uncalibrated) target ``name``, registering the card's
    own target when it is the one named."""
    from repro_torch.targets import get_target, register_h100_target

    if name == "h100":
        register_h100_target()
    return get_target(name, profile=None)


def _cmd_sweep(args) -> int:
    from repro_torch.calibrate import run_microbench, save_samples, unsampled_modules

    target = _declared_target(args.target)
    samples = run_microbench(
        target,
        repeats=args.repeats,
        budget=args.budget,
        quick=args.quick,
        verbose=True,
        device=args.device,
    )
    save_samples(args.out, samples, target=args.target, meta={"quick": args.quick, "device": args.device})
    mods = sorted({s.module for s in samples})
    print(f"wrote {len(samples)} samples for modules {mods} -> {args.out}")
    unsampled = unsampled_modules(target, samples)
    if unsampled:
        print(f"no samples for {unsampled}: a fit leaves them as declared")
    return 0


def _cmd_fit(args) -> int:
    from repro_torch.calibrate import fit_profile, load_samples, profile_errors, unsampled_modules

    target, samples = load_samples(args.samples)
    target = args.target or target
    if not target:
        print("error: samples file carries no target name; pass --target", file=sys.stderr)
        return 2
    meta = {"samples_file": args.samples,
            "declared_as_is": unsampled_modules(_declared_target(target), samples)}
    profile = fit_profile(samples, target_name=target, meta=meta)
    profile.save(args.out)
    errs = profile_errors(samples, profile)
    print(
        f"fitted {len(profile.modules)} modules from {errs['n']} samples: "
        f"mean |pred-meas| {errs['mae_before']:.0f} -> {errs['mae_after']:.0f} "
        f"cycles; profile {profile.tag()} -> {args.out}"
    )
    if meta["declared_as_is"]:
        print(f"no samples for {meta['declared_as_is']}: left as declared")
    return 0


def _cmd_show(args) -> int:
    from repro_torch.calibrate import load_profile

    profile = load_profile(args.profile)
    if profile is None:
        return 1
    print(json.dumps(profile.to_dict(), indent=2, sort_keys=True))
    print(f"# fingerprint {profile.tag()}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.calibrate", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)

    sw = sub.add_parser("sweep", help="run the microbenchmark sweep")
    sw.add_argument("--target", required=True)
    sw.add_argument("--out", default="calibration_samples.json")
    sw.add_argument("--repeats", type=int, default=3)
    sw.add_argument("--budget", type=int, default=300)
    sw.add_argument("--quick", action="store_true", help="tiny sweep (CI smoke)")
    sw.add_argument("--device", default="cuda", help="where the sweep runs (default: cuda)")
    sw.set_defaults(fn=_cmd_sweep)

    ft = sub.add_parser("fit", help="fit a profile from sweep samples")
    ft.add_argument("--samples", required=True)
    ft.add_argument("--target", default="", help="override the samples' target name")
    ft.add_argument("--out", default="calibration_profile.json")
    ft.set_defaults(fn=_cmd_fit)

    sh = sub.add_parser("show", help="print a profile (validating it)")
    sh.add_argument("profile")
    sh.set_defaults(fn=_cmd_show)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
