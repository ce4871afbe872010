"""The readings that a cell's limits are set from, many seeds in one process:
each seed's run as the benchmark makes it (a short window), with
``--control`` the control's readings on the same seed, with ``--fault`` the
readings of the run with that fault planted in its timed path. One JSON line
a seed.

    python -m port_bench.readings --workload <name> --seeds 11,12,13 --seconds 2 [--control]
"""

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True, help="comma-separated")
    parser.add_argument("--seconds", type=float, default=2.0)
    parser.add_argument("--control", action="store_true")
    parser.add_argument("--fault", default=None,
                        help="break the timed path with this fault of the cell's kind")
    args = parser.parse_args(argv)

    import torch

    from port_bench import harness

    if not torch.cuda.is_available():
        print("port_bench.readings: no CUDA device", file=sys.stderr)
        return 2
    cell = harness.resolve(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        torch.cuda.reset_peak_memory_stats()
        started = time.perf_counter()
        _, reading = harness.run(args.workload, seed, args.seconds, False, started, cell=cell,
                                 fault=args.fault)
        record = {"seed": seed, "fault": args.fault,
                  "correct": all(c.ok for c in reading.checks.values()),
                  "program": {k: c.value for k, c in reading.checks.items()},
                  "setup_s": reading.setup_s, "units": reading.units,
                  "memory_peak_bytes": reading.memory_peak_bytes,
                  "run_s": time.perf_counter() - started,
                  "notes": reading.notes}
        if args.control:
            start = time.perf_counter()
            record["control_notes"] = {}
            record["control"] = cell.kind.control(cell, seed, "cuda", record["control_notes"])
            record["control_s"] = time.perf_counter() - start
        print(json.dumps(record), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
