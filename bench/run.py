"""One run of one benchmark cell, from the root of a checkout:

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints the run's result as the last line of standard output, one JSON
object, and each number the output check compared beside its limit as the
last lines of standard error.  Exits non-zero, printing no result, where
there is no CUDA card, fewer cards than the cell asks for, or no program
(``src/repro_torch``) in the checkout.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parents[1]
# every build and kernel cache at a fixed path inside the checkout
CACHES = {
    "REPRO_TORCH_BUILD_DIR": CHECKOUT / "build" / "repro_torch",
    "TRITON_CACHE_DIR": CHECKOUT / "build" / "triton",
    "TORCH_EXTENSIONS_DIR": CHECKOUT / "build" / "torch_extensions",
}
# settings of the program that would change what a run measures
UNSET = ("MATCH_SCHEDULE_CACHE", "MATCH_CALIBRATION_PROFILE", "MATCH_TRACE", "MATCH_FLIGHT", "MATCH_TARGET_PLUGINS")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()
    for k, v in CACHES.items():
        os.environ[k] = str(v)
    for k in UNSET:
        os.environ.pop(k, None)
    os.environ["USE_FLAX"] = "0"
    sys.path[:0] = [str(CHECKOUT / "src"), str(CHECKOUT)]

    from bench.spec import load_cell

    chips = load_cell(CHECKOUT, args.workload).chips
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"bench: the cell needs {chips} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    from bench.harness import check_lines, run_cell

    result = run_cell(CHECKOUT, args.workload, args.seed, args.seconds, bool(args.trace), t_process=T_PROCESS)
    sys.stdout.flush()
    print("\n".join(check_lines(result["checks"])), file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
