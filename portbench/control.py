"""Readings that a cell's limit is set from, at the cell's own size, and
a whole run with the control in the program's place.

    python3 portbench/control.py --workload <cell> --seeds 1,2,... --control-seeds 1,2,3
    python3 portbench/control.py --workload <cell> --planted --seed <n> --seconds <s>

For each seed, the groups a run of the cell draws, and the first
``--groups`` of its window evaluated by the program as the window does;
each policy's relative gap to the float64 reference is the program's
reading (the lower one).  For each control seed, the same groups worked out
by the reference in float32, the precision below the configuration's, put
in the program's place: its gap to the float64 reference is the control's
reading (the upper one).  One JSON line a seed and side on standard
output, and the largest and least readings at the end.

With ``--planted``, a whole run of ``run.py`` (set-up, window, check,
result line) with :func:`float32_evaluate_many` in place of the program's
``evaluate_many``: its result has to read ``correct: false``.  Not part of
a benchmark run; it runs where the cell runs, on the card.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def float32_evaluate_many(config: dict):
    """The control in the program's place: ``evaluate_many`` answered by the
    plain reference in float32 from the group's job arrays, drawing from
    the caller's generator as the program does."""
    import numpy as np
    import torch

    from portbench.reference import evaluator as ref

    def evaluate_many(jobs, algs, rng, mc_samples=None, device=None):
        sizes = np.stack([j.sizes for j in jobs])
        probs = np.stack([j.probs for j in jobs])
        return ref.evaluate(sizes, probs, {**config, "policies": list(algs)}, rng,
                            torch.float32, device)
    return evaluate_many


def readings(cell, seed: int, n_groups: int, control: bool, device) -> dict:
    """``{"program": {policy: gap}, "control": {policy: gap} | None}``."""
    import torch

    from portbench.harness import session
    from portbench.reference import evaluator as ref
    from repro_torch.core import evaluator

    cfg = cell.config
    kw = {"mc_samples": int(cfg["mc_samples"])} if cfg["evaluation"] == "monte_carlo" else {}
    rng_groups, rng_eval, _, _ = session._streams(seed)
    groups = session.draw(cell, rng_groups, n_groups)
    out = {"program": {p: 0.0 for p in cfg["policies"]},
           "control": {p: 0.0 for p in cfg["policies"]} if control else None}
    for (sizes, probs), spec in zip(groups, session._specs(groups)):
        state = rng_eval.bit_generator.state
        got = evaluator.evaluate_many(spec, tuple(cfg["policies"]), rng_eval, device=device, **kw)
        want = ref.evaluate(sizes, probs, cfg, session._generator(state), torch.float64, device)
        low = (ref.evaluate(sizes, probs, cfg, session._generator(state), torch.float32, device)
               if control else None)
        for p in cfg["policies"]:
            out["program"][p] = max(out["program"][p], abs(got[p] - want[p]) / abs(want[p]))
            if control:
                out["control"][p] = max(out["control"][p], abs(low[p] - want[p]) / abs(want[p]))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="", help="comma-separated")
    p.add_argument("--control-seeds", default="", help="comma-separated")
    p.add_argument("--groups", type=int, default=1, help="groups a seed")
    p.add_argument("--planted", action="store_true", help="a whole run, the control planted")
    p.add_argument("--seed", type=int, help="with --planted")
    p.add_argument("--seconds", type=float, default=5.0, help="with --planted")
    args = p.parse_args(argv)

    import torch

    from portbench.harness import manifest

    cell = manifest.load(ROOT).cell(args.workload)
    if args.planted:
        from portbench import run
        from repro_torch.core import evaluator

        evaluator.evaluate_many = float32_evaluate_many(cell.config)
        return run.main(["--workload", args.workload, "--seed", str(args.seed),
                         "--seconds", str(args.seconds), "--trace", "0"])
    seeds = [int(s) for s in args.seeds.split(",") if s]
    control = {int(s) for s in args.control_seeds.split(",") if s}
    device = torch.device("cuda")
    lows, highs = {}, {}
    for seed in sorted(set(seeds) | control):
        t0 = time.perf_counter()
        r = readings(cell, seed, args.groups, seed in control, device)
        if seed not in seeds:
            r["program"] = None
        print(json.dumps({"workload": args.workload, "seed": seed, **r,
                          "seconds": time.perf_counter() - t0}), flush=True)
        for side, acc, pick in (("program", lows, max), ("control", highs, min)):
            for pol, v in (r[side] or {}).items():
                acc[pol] = pick(acc.get(pol, v), v)
    print(json.dumps({"workload": args.workload, "lower_reading": lows,
                      "upper_reading": highs}), flush=True)
    return 0


if __name__ == "__main__":
    sys.path[0] = str(ROOT)
    sys.path.insert(1, str(ROOT / "src"))
    sys.exit(main())
