"""End-to-end numbers of checkouts of the PyTorch port, in turns, on one card.

    python3 tools/e2e_turns.py [--rounds R] DIR [DIR ...]

Each turn runs one checkout in a process of its own, with that checkout's
package, kernels and ``chip_smoke.py`` helpers (its inputs, its tick loop,
its timing), so two checkouts are compared on the same inputs and clock.
The checkouts run in the order given and then in reverse, R rounds of
it (default 1): ``A B`` gives ``A B B A`` a round.  A turn builds its
checkout's kernels first (``chip_smoke.phase_build``, cached after its
first turn), then measures:

* ``headline_solves_per_s``: ``DDPSolver.solve_batch`` through ``auto`` at
  the headline shape (cart-pole, B=4096, N=100, max_iter=10, fp32), B over
  the median of 10 synced solves after a warm one;
* ``tick_p50_ms`` / ``tick_p99_ms``: the 256-controller tick loop (N=200,
  max_iter=3, fp32, ``auto``), 20 ticks after a 2-tick warm-up;
* ``bipedal_solves_per_s``: the bipedal solve through ``auto`` (B=2048,
  N=300, max_iter=10, fp32), B over the median of 3 synced solves after a
  warm one.

Each turn prints one JSON line; then, per metric, every checkout's readings
and their median and, for each checkout after the first, whether every
one of its readings is better than every one of the first's, every one
worse, or the readings overlap (unresolved at this spread).  Needs a CUDA
card; exits non-zero if a turn fails.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

# each metric and whether a higher reading is better
METRICS = {"headline_solves_per_s": True, "tick_p50_ms": False,
           "tick_p99_ms": False, "bipedal_solves_per_s": True}


def measure(root: Path) -> dict:
    """The metrics of the checkout at ``root``, measured in this process."""
    os.chdir(root)
    sys.path.insert(0, str(root))
    import numpy as np
    import torch

    import chip_smoke as c

    assert Path(c.__file__).resolve().parent == root, c.__file__
    device = torch.device("cuda", 0)
    c.phase_build()
    fp32 = torch.float32
    problem = c.make_cartpole_problem(c.DT)
    B, N = c.HEADLINE
    x0s, us0 = c.hanging_inputs(B, N, fp32, device)
    solver = c.DDPSolver(problem, c.DDPConfig(horizon_steps=N, max_iter=10))
    headline = B / statistics.median(c.timed_solves(solver, x0s, us0, 10))
    c.tick_loop(device, problem, ("auto", "auto"), n_ticks=2)
    ms, _ = c.tick_loop(device, problem, ("auto", "auto"))
    B, N = c.BIPEDAL
    x0s, us0 = c.bipedal_start(B, N, fp32, device)
    solver = c.DDPSolver(c.bipedal_problem(),
                         c.DDPConfig(horizon_steps=N, max_iter=10))
    bipedal = B / statistics.median(c.timed_solves(solver, x0s, us0, 3))
    return {"checkout": str(root), "card": c.card_line(),
            "headline_solves_per_s": headline,
            "tick_p50_ms": float(np.percentile(ms, 50)),
            "tick_p99_ms": float(np.percentile(ms, 99)),
            "bipedal_solves_per_s": bipedal}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("checkouts", nargs="*", type=Path)
    parser.add_argument("--rounds", type=int, default=1,
                        help="rounds of the checkouts in order, then in "
                             "reverse")
    parser.add_argument("--measure", type=Path,
                        help="measure this one checkout and print its line")
    args = parser.parse_args()
    if args.measure:
        print(json.dumps(measure(args.measure.resolve())), flush=True)
        return 0
    roots = [d.resolve() for d in args.checkouts]
    if not roots:
        parser.error("name at least one checkout")
    readings = {root: [] for root in roots}
    for root in (roots + roots[::-1]) * args.rounds:
        run = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                              "--measure", str(root)], capture_output=True,
                             text=True, timeout=1200)
        if run.returncode != 0:
            print(run.stdout[-4000:], run.stderr[-4000:], file=sys.stderr)
            print(f"e2e_turns: the turn of {root} failed", file=sys.stderr)
            return 1
        line = json.loads(run.stdout.strip().splitlines()[-1])
        readings[root].append(line)
        print(f"[turn] {json.dumps(line)}", flush=True)
    for metric, higher in METRICS.items():
        runs = [[r[metric] for r in readings[root]] for root in roots]
        text = "; ".join(f"{root}: {', '.join(f'{v:.2f}' for v in vs)} "
                         f"(median {statistics.median(vs):.2f})"
                         for root, vs in zip(roots, runs))
        sign = 1 if higher else -1
        verdicts = []
        for root, vs in zip(roots[1:], runs[1:]):
            better = min(sign * v for v in vs) > max(sign * v
                                                     for v in runs[0])
            worse = max(sign * v for v in vs) < min(sign * v
                                                    for v in runs[0])
            verdicts.append(f"{root} vs {roots[0]}: " + (
                "better in every run" if better else "worse in every run"
                if worse else "readings overlap, unresolved at this spread"))
        print(f"[e2e-turns] {metric}: {text} ({'; '.join(verdicts)})",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
