"""python -m fitclip_torch.bench {encode,block_layer,attn_int8,fit_block} [--cases ...]
[--block N] [--check]

The port's benchmarks on one CUDA card, one JSON line per case:

  encode       bench.py: CLIP ViT-B/16 clips/s with its gates (BENCH_DTYPE,
               BENCH_CLIPS);
  block_layer  scripts/bench_block_layer.py (S1, S1s): the int8 layer's arms;
  attn_int8    scripts/bench_attn_int8.py (S2): the attention core's variants;
  fit_block    scripts/bench_fit_block.py (S3): the FiT int8 block's arms.

The case names and defaults are the scripts'. A case that only renames an
arm (S1's `b2` or `heads3`, S3's `pad8`, ...) prints one record carrying
``same_function_as`` and is not timed again. ``--block`` (frames per amax
block) is attn_int8's alone: the other benches' kernels have no block rows. A
case that fails ends the run with a non-zero exit: nothing is skipped.
"""

import argparse
import importlib


def parse_args(argv=None):
    parser = argparse.ArgumentParser(prog="python -m fitclip_torch.bench")
    parser.add_argument("bench", choices=("encode", "block_layer", "attn_int8", "fit_block"))
    parser.add_argument("--cases", default="",
                        help="comma-separated case names (default: the script's)")
    parser.add_argument("--block", type=int, default=0,
                        help="attn_int8: frames per amax block (0 = 1)")
    parser.add_argument("--check", action="store_true",
                        help="also print each arm's agreement with `full` or its plain twin")
    args = parser.parse_args(argv)
    if args.block and args.bench != "attn_int8":
        parser.error(f"--block is attn_int8's; {args.bench} has no block rows")
    return args


def main(argv=None) -> None:
    args = parse_args(argv)
    importlib.import_module(f"fitclip_torch.bench.{args.bench}").main(args)


if __name__ == "__main__":
    main()
