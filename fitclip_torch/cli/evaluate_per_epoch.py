"""The per-epoch evaluation loop (port of ``scripts/evaluate_per_epoch.sh``):
every saved training checkpoint through a WiSE-FT ensemble evaluation over
several benchmarks.

    CKPT_GLOB=... [WISE_WEIGHT=0.4] [BENCHMARKS=a,b] [FRAME_CACHE=DIR] \\
        python -m fitclip_torch.cli.evaluate_per_epoch [++override ...]

The environment is the shell script's, with its defaults:

- ``CKPT_GLOB``: the checkpoints to evaluate (default ``checkpoints/epoch_*``),
  in sorted order, as the shell expands a glob; the port's train-state files
  or torch / Lightning checkpoints (an Orbax directory needs JAX and is
  refused);
- ``WISE_WEIGHT``: the fine-tuned model's weight in the ensemble (0.4);
- ``BENCHMARKS``: comma-separated data configs, one ``--multirun`` job each
  (``moments_in_time,msrvtt,webvid,youcook2``);
- ``FRAME_CACHE``: a directory for the eval loaders' transformed frames
  (``++data.eval_frame_cache_dir``): every checkpoint after the first reads
  them back and opens no video.

For each checkpoint the loop writes an eval-ready state dict with
``convert/prepare_trained_clip_checkpoint_for_evaluation.py`` (a NaN
``logit_scale``), then runs ``python -m fitclip_torch --multirun
command=evaluate encoder=wise`` in this process: model1 the pretrained
``clip_vit_b_16``, model2 ``clip_from_pretrained`` on the prepared file. The
arguments are appended to every run's overrides (``++encoder.model1.device=cpu``,
say). Each job prints its metrics as the CLI does.
"""

import glob
import logging
import os
import sys
import tempfile
from typing import List, Optional

LOGGER = logging.getLogger(__name__)

DEFAULTS = {"CKPT_GLOB": "checkpoints/epoch_*", "WISE_WEIGHT": "0.4",
            "BENCHMARKS": "moments_in_time,msrvtt,webvid,youcook2"}


def wise_overrides(prepared: str, wise_weight: str, benchmarks: str,
                   frame_cache: Optional[str]) -> List[str]:
    """The CLI's overrides for one checkpoint's prepared state dict."""
    overrides = ["command=evaluate", "encoder=wise",
                 "+encoder@encoder.model1=clip_vit_b_16",
                 "+encoder@encoder.model2=clip_from_pretrained",
                 f"++encoder.model2.checkpoint_path={prepared}",
                 f"++encoder.weight_for_2={wise_weight}",
                 f"data={benchmarks}"]
    if frame_cache:
        overrides.append(f"++data.eval_frame_cache_dir={frame_cache}")
    return overrides + ["silent=true"]


def checkpoints(pattern: str) -> List[str]:
    found = sorted(glob.glob(pattern))
    if not found:
        raise SystemExit(f"CKPT_GLOB={pattern!r} matches no checkpoint")
    return found


def main(argv: Optional[List[str]] = None) -> None:
    from fitclip_torch.cli.main import main as cli_main
    from fitclip_torch.convert import prepare_trained_clip_checkpoint_for_evaluation as prepare

    extra = list(sys.argv[1:] if argv is None else argv)
    env = {key: os.environ.get(key) or default for key, default in DEFAULTS.items()}
    frame_cache = os.environ.get("FRAME_CACHE") or None
    found = checkpoints(env["CKPT_GLOB"])
    handle, prepared = tempfile.mkstemp(suffix=".pt")
    os.close(handle)
    try:
        for ckpt in found:
            LOGGER.info("per-epoch eval: %s", ckpt)
            # An eval-ready CLIP state dict (the NaN logit_scale re-injected).
            prepare.main([ckpt, prepared])
            # WiSE-FT: the pretrained zero-shot model blended with the student.
            cli_main(["--multirun", *wise_overrides(prepared, env["WISE_WEIGHT"],
                                                    env["BENCHMARKS"], frame_cache), *extra])
    finally:
        os.remove(prepared)


if __name__ == "__main__":
    main()
