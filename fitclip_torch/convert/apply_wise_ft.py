"""Offline WiSE-FT: merge two CLIP state dicts in weight space (port of
``scripts/apply_wise_ft.py``; https://arxiv.org/abs/2109.01903):

    python -m fitclip_torch.convert.apply_wise_ft INPUT_FILE_1 INPUT_FILE_2 OUTPUT_FILE \\
        [--weight-for-2 0.5]

Both inputs lose their ``logit_scale``; their parameter sets must then be the
same. The output is ``(1 - w) * a + w * b`` of every parameter in fp32
(``models/wise.py:wise_params``), with a NaN ``logit_scale``.
"""

import argparse
from typing import List, Optional

import torch

from fitclip_torch.convert.torch_state_dict import load_torch_state_dict
from fitclip_torch.models.wise import wise_params


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("input_path1", metavar="INPUT_FILE_1")
    parser.add_argument("input_path2", metavar="INPUT_FILE_2")
    parser.add_argument("output_path", metavar="OUTPUT_FILE")
    parser.add_argument("--weight-for-2", type=float, default=0.5)
    return parser.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> None:
    args = parse_args(argv)
    sd1, sd2 = (load_torch_state_dict(path) for path in (args.input_path1, args.input_path2))
    sd1.pop("logit_scale", None)
    sd2.pop("logit_scale", None)
    if set(sd1) != set(sd2):
        raise SystemExit("Checkpoints have different parameter sets: "
                         f"{sorted(set(sd1) ^ set(sd2))[:10]} ...")
    merged = wise_params({k: torch.from_numpy(v) for k, v in sd1.items()},
                         {k: torch.from_numpy(v) for k, v in sd2.items()}, args.weight_for_2)
    merged["logit_scale"] = torch.tensor(float("nan"))
    torch.save(merged, args.output_path)


if __name__ == "__main__":
    main()
