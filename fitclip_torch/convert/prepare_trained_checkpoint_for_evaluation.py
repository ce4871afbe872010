"""A training checkpoint -> an evaluation-ready encoder state dict, the
generic (non-CLIP) variant with no ``logit_scale`` (port of
``scripts/prepare_trained_checkpoint_for_evaluation.py``):

    python -m fitclip_torch.convert.prepare_trained_checkpoint_for_evaluation \\
        INPUT_FILE OUTPUT_FILE [--prefix encoder.model]

The training module's prefix is stripped from every parameter name; a prefix
without a trailing ``.`` gets one. INPUT_FILE is the port's train-state file
(its ViT CLIP encoder in OpenAI's schema) or any other torch / Lightning
checkpoint. An Orbax directory of the JAX package needs JAX and is refused.
"""

import argparse
from typing import List, Optional

import torch

from fitclip_torch.convert.checkpoint_to_state_dict import checkpoint_state_dict


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("input_path", metavar="INPUT_FILE")
    parser.add_argument("output_path", metavar="OUTPUT_FILE")
    parser.add_argument("--prefix", default="encoder.model.")
    return parser.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> None:
    args = parse_args(argv)
    prefix = args.prefix + ("" if args.prefix.endswith(".") else ".")
    torch.save(checkpoint_state_dict(args.input_path, prefix), args.output_path)


if __name__ == "__main__":
    main()
