"""Run one cell of the port's benchmark once and print its result line.

    python -m port_bench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1`` a
``breakdown``, and last ``checks``: each number the comparison took with its
limit. The checks are also the last lines of standard error. Without a card,
with fewer cards than the cell asks for, or with JAX or the JAX package
loaded once the window has closed, it prints no result and exits non-zero.
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# Every build and kernel cache inside the checkout, at fixed paths, so that a
# checkout's first run builds and the later ones find everything built. The
# port's own kernels build into build/fitclip_torch/<digest>/ (_build.py).
CACHES = {"TORCH_EXTENSIONS_DIR": "torch_extensions", "TRITON_CACHE_DIR": "triton",
          "CUDA_CACHE_PATH": "cuda"}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    for variable, directory in CACHES.items():
        os.environ[variable] = str(ROOT / "build" / "port_bench" / directory)

    import torch

    from port_bench import harness

    cell = harness.resolve(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"port_bench: {args.workload} needs {cell.chips} CUDA device(s), found {found}",
              file=sys.stderr)
        return 2
    torch.cuda.reset_peak_memory_stats()
    cell, reading = harness.run(args.workload, args.seed, args.seconds, bool(args.trace),
                                STARTED, cell=cell)
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"port_bench: JAX or the JAX package was loaded: {', '.join(loaded)}",
              file=sys.stderr)
        return 3
    line, _ = harness.result(cell, reading, bool(args.trace),
                             harness.device_record(cell.chips, reading, bool(args.trace)))
    print(f"notes {json.dumps(reading.notes)}", file=sys.stderr)
    for name, check in line["checks"].items():
        print(f"check {name} {check['value']!r} limit {check['limit']!r}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
