"""Per-kernel device breakdown of the port's full-width paths, in one
process on one card.

    python -m wcsph_tpu_torch.profile_paths [--side 100] [--steps 3]

For each path of ``bench.flagship_paths`` (DFSPH, SESPH, PCISPH, IISPH,
DFSPH with surface tension, and those with a solver loop again in the
unfused form): 3 warm-up and 10 timed steps (the untraced
median step), then ``--steps`` more under torch.profiler
(``bench.profile``).  One JSON line per path on stdout, after a first line
with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import statistics

import torch

from . import bench


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--side", type=int, default=100,
                    help="liquid cube side (100 = 1M particles)")
    ap.add_argument("--steps", type=int, default=3,
                    help="traced steps per path")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("wcsph_tpu_torch.profile_paths measures the CUDA "
                         "device; torch.cuda.is_available() is False")
    print(json.dumps({"card": bench.card_info()}), flush=True)
    for path, (solver, over) in bench.flagship_paths(args.side).items():
        sim = bench.build_sim(args.side, "cuda", solver, **over)
        res = bench.measure(sim, 3, 10)
        print(json.dumps({
            "path": path,
            "step_ms_median": statistics.median(res["step_ms"]),
            "iters": res["iters"][-1],
            "profile": bench.profile(sim, args.steps)}), flush=True)
        del sim
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
