"""Run one benchmark cell once and print its result line.

    python3 port_bench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. The last line of standard output is the
result's JSON object; the compared numbers and their limits are also the
last lines of standard error. The run needs a CUDA card: without one it
exits with 2 and prints no result.
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "segs_slam_tpu")


def loaded_forbidden(modules=None) -> list[str]:
    """Modules whose top-level name, compared whole, is JAX's, jaxlib's,
    flax's or the JAX package's (segs_slam_tpu_torch is not
    segs_slam_tpu)."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names}
                  & set(FORBIDDEN))


def set_environment() -> None:
    """Every cache the program or a library may build at a fixed path
    inside the checkout (build/ holds the port's nvcc libraries too), and
    the checkout's root on sys.path."""
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "port_bench"
                                         / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "port_bench"
                                             / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    set_environment()
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from port_bench import bench

    entry, _cfg, _traffic = bench.cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < entry["chips"]:
        print(f"port_bench: the cell needs {entry['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = bench.run_cell(args.workload, args.seed, args.seconds,
                            bool(args.trace), torch.device("cuda"),
                            log=lambda *a, **k: print(*a, file=sys.stderr,
                                                      **k))
    found = loaded_forbidden()
    if found:
        print(f"port_bench: modules {found} were loaded in this process",
              file=sys.stderr)
        return 3
    bench.main_print(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
