"""Extract the (student) encoder of a training checkpoint as an OpenAI-schema
torch state dict (port of ``scripts/checkpoint_to_state_dict.py``):

    python -m fitclip_torch.convert.checkpoint_to_state_dict CKPT [--output FILE]
        [--prefix encoder.model.]

CKPT is the port's train-state file (``training/checkpointing.py``), whose
ViT CLIP ``encoder.*`` params are exported by ``openai_state_dict``, or any
other torch / Lightning checkpoint, whose keys under ``--prefix`` are kept
without it. The output (stdout by default) loads as
``load_clip_encoder(checkpoint_path=FILE)``, and so as a member of
``encoder=wise``. An Orbax directory of the JAX package needs JAX and is
refused.
"""

import argparse
import os
import sys
from typing import Dict, List, Optional

import torch


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("input_path", metavar="INPUT_FILE")
    parser.add_argument("--prefix", default="encoder.model.")
    parser.add_argument("--output", default=None, help="output file (default: stdout)")
    return parser.parse_args(argv)


def checkpoint_state_dict(input_path: str, prefix: str = "encoder.model.") -> Dict[
        str, torch.Tensor]:
    from fitclip_torch.convert.openai_state_dict import openai_state_dict
    from fitclip_torch.convert.torch_state_dict import load_torch_state_dict
    from fitclip_torch.training.checkpointing import is_full_train_state, load_checkpoint

    if os.path.isdir(input_path):
        raise NotImplementedError(f"{input_path} is a directory: an Orbax train state of the "
                                  "JAX package, which needs JAX to read")
    if is_full_train_state(input_path):
        params = load_checkpoint(input_path)["params"]
        return openai_state_dict({k[len("encoder."):]: v for k, v in params.items()
                                  if k.startswith("encoder.")})
    return {k: torch.from_numpy(v) for k, v in
            load_torch_state_dict(input_path, strip_prefix=prefix).items()}


def main(argv: Optional[List[str]] = None) -> None:
    args = parse_args(argv)
    state_dict = checkpoint_state_dict(args.input_path, args.prefix)
    if args.output:
        torch.save(state_dict, args.output)
    else:
        torch.save(state_dict, sys.stdout.buffer)


if __name__ == "__main__":
    main()
