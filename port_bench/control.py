"""The readings that the limits of `correct` are set from, on the card at
the cell's own size (the benchmark's runs do not run this):

    python3 port_bench/control.py --workload <name> --what program \
        --seeds 1 2 3 ...
    python3 port_bench/control.py --workload <name> --what control \
        --seeds 1 2 3 [--precision tf32|fp8_blend|int4_colour]

`program`: the numbers a run compares, from the program's own outputs on
each seed (the map cells' compared steps run in set-up; the render cells
render a short window at the cell's load, long enough to reach every
compared position). `control`: the same numbers with the reference in the
next precision below the configuration's (the limits file's `control`) put
in the program's place. One JSON line a seed.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def readings(workload, seed, what, precision, dev, cfg=None, traffic=None):
    import torch

    from port_bench import bench

    _entry, cfg0, traffic0 = bench.cell(workload)
    cfg, traffic = cfg or cfg0, traffic or traffic0
    kind = bench.load_kind(traffic["kind"])
    x = kind.Inputs(cfg, traffic, seed, dev)
    if what == "control":
        return kind.control(x, precision)
    c = kind.Cell(x, False)
    c.setup()
    c.compared_run()
    c.release()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return c.check()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--what", choices=("program", "control"), required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--precision", default=None)
    args = p.parse_args(argv)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))

    import torch

    from port_bench import bench

    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 2
    limits = bench.load_json("limits", args.workload)
    precision = args.precision or limits["control"]
    for seed in args.seeds:
        t0 = time.perf_counter()
        out = readings(args.workload, seed, args.what, precision,
                       torch.device("cuda"))
        print(json.dumps({"workload": args.workload, "what": args.what,
                          "precision": precision if args.what == "control"
                          else "program", "seed": seed,
                          "numbers": out["numbers"],
                          "same_inputs": out["same_inputs"],
                          "detail": out["detail"],
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
