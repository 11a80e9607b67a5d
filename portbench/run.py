"""Run one cell of the benchmark of ``repro_torch``'s evaluator.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the CUDA card(s) the cell
asks for.  Prints the checks on standard error and, as the last line of
standard output, one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, and last
``check``, each number compared beside its limit.  Exits with 2, printing
no result, without the card(s); with 3 when a JAX module or the JAX
package is loaded once the window has closed.  Writes only under
``portbench/out/``.  See README.md.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
#: Top-level modules that no process of the benchmark may hold: JAX and the
#: JAX package of the repo, compared by whole top-level name.
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})


def _finite(x):
    """``x`` with every non-finite float made ``None`` (JSON has no inf)."""
    if isinstance(x, dict):
        return {k: _finite(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_finite(v) for v in x]
    if isinstance(x, float) and not math.isfinite(x):
        return None
    return x


def forbidden_modules() -> list[str]:
    return sorted({name.split(".")[0] for name in sys.modules} & FORBIDDEN)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    os.environ.pop("REPRO_CACHE_DIR", None)  # no tables that an earlier run wrote
    os.environ["USE_FLAX"] = "0"
    from portbench.harness import manifest, session

    cell = manifest.load(ROOT).cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    result = session.run(cell, args.seed, args.seconds, bool(args.trace), device="cuda",
                         t_start=T_START, out_dir=cell.bench_dir / "out")
    found = forbidden_modules()
    if found:
        print(f"loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 3
    for name, c in result["check"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(_finite(result)), flush=True)
    return 0


if __name__ == "__main__":
    sys.path[0] = str(ROOT)  # the package ``portbench``, not this folder's files
    sys.path.insert(1, str(ROOT / "src"))
    sys.exit(main())
