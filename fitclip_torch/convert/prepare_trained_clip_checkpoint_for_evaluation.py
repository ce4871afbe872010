"""A training checkpoint -> an evaluation-ready CLIP state dict with a NaN
``logit_scale`` (port of ``scripts/prepare_trained_clip_checkpoint_for_evaluation.py``;
the framework owns the temperature, so training checkpoints carry none):

    python -m fitclip_torch.convert.prepare_trained_clip_checkpoint_for_evaluation \\
        INPUT_FILE OUTPUT_FILE [--prefix encoder.model.]

INPUT_FILE is the port's train-state file, whose ViT CLIP ``encoder.*``
params are written in OpenAI's schema (``checkpoint_to_state_dict``), or any
other torch / Lightning checkpoint, whose keys under ``--prefix`` are kept
without it (the prefix is used as given). The output loads as
``load_clip_encoder(checkpoint_path=OUTPUT_FILE)``. An Orbax directory of the
JAX package needs JAX and is refused.
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
    state_dict = checkpoint_state_dict(args.input_path, args.prefix)
    state_dict["logit_scale"] = torch.tensor(float("nan"))
    torch.save(state_dict, args.output_path)


if __name__ == "__main__":
    main()
