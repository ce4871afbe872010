"""The port's CLI (port of ``fitclip_tpu/cli/main.py``):
``python -m fitclip_torch command=... encoder=... data=...``.

The JAX package's Hydra surface on the port's config engine, reading the
repository's ``config/`` tree: config groups, ``++``/``+``/``~`` overrides,
``--multirun`` and ``--config-name``. Commands: evaluate, validate, test
(the test split) and predict, on one device: CUDA unless
``++encoder.device=cpu``. A classification data module switches the eval to
zero-shot classification. A grouped data module (``data=drift_eval``) is
built member by member, each with the encoder, and evaluated per member
(``runners.py``). ``quant.calibration_batches`` and
``quant.scales_path`` calibrate and persist an int8 encoder's scales
(``runners.py``). ``checkpoint_path`` names a bare-params torch checkpoint
(OpenAI or HF layout) whose weights replace the encoder's; an Orbax directory
needs JAX and is refused. ``train`` and ``tune`` are not ported yet.
"""

import json
import logging
import os
import sys
from typing import Any, Dict, List, Mapping, Optional, Tuple

LOGGER = logging.getLogger(__name__)

DEFAULT_CONFIG_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "config")

COMMANDS = ("train", "evaluate", "validate", "test", "predict", "tune")
NOT_PORTED = ("train", "tune")

# The JAX package's combinators of data modules: their members are data
# module configs, instantiated one by one with the encoder.
GROUP_DATA_MODULE_TARGETS = {
    "fitclip_tpu.data.data_module_group.EvalDataModuleGroup",
    "fitclip_tpu.data.data_module_group.DataModuleStructuredGroup",
    "fitclip_tpu.data.data_module_group.MixedBatchDataModule",
    "fitclip_tpu.data.data_module_group.TrainAndEvalDataModules",
}


def parse_args(argv: List[str]) -> Tuple[str, str, bool, List[str]]:
    config_name = "trainer"
    config_dir = os.environ.get("FITCLIP_CONFIG_DIR", DEFAULT_CONFIG_DIR)
    multirun = False
    overrides: List[str] = []
    i = 0
    while i < len(argv):
        arg = argv[i]
        if arg in ("--config-name", "-cn"):
            config_name = argv[i + 1]
            i += 2
        elif arg.startswith("--config-name="):
            config_name = arg.split("=", 1)[1]
            i += 1
        elif arg in ("--config-dir", "--config-path", "-cd", "-cp"):
            config_dir = argv[i + 1]
            i += 2
        elif arg in ("--multirun", "-m"):
            multirun = True
            i += 1
        elif arg in ("--help", "-h"):
            print(__doc__)
            sys.exit(0)
        else:
            overrides.append(arg)
            i += 1
    if config_name.endswith(".yaml"):
        config_name = config_name[: -len(".yaml")]
    return config_name, config_dir, multirun, overrides


def seed_everything(seed: int) -> None:
    import random

    import numpy as np
    import torch

    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def instantiate_data_module(node: Mapping[str, Any], encoder_slot):
    """Group-aware instantiation (``fitclip_tpu/cli/main.py:instantiate_data_module``).
    A group's target resolves first, so that a combinator the port lacks raises
    before any member is built."""
    from fitclip_torch.config_engine import instantiate
    from fitclip_torch.config_engine.instantiate import resolve_target

    target = node.get("_target_", "")
    if target not in GROUP_DATA_MODULE_TARGETS:
        return instantiate(node, encoder=encoder_slot)
    cls = resolve_target(target)
    kwargs = {k: v for k, v in node.items() if k != "_target_"}
    if "data_modules" in kwargs:
        kwargs["data_modules"] = {name: instantiate_data_module(sub, encoder_slot)
                                  for name, sub in kwargs["data_modules"].items()}
    for key in ("train_data_module", "eval_data_module"):
        if key in kwargs:
            kwargs[key] = instantiate_data_module(kwargs[key], encoder_slot)
    return cls(**{k: instantiate(v) if isinstance(v, Mapping) and "_target_" in v else v
                  for k, v in kwargs.items()})


def load_checkpoint(loaded, checkpoint_path: str):
    """Replace the encoder's weights with a bare-params torch checkpoint's
    (quantized as the encoder is); the encoder keeps its architecture."""
    from fitclip_torch.convert.from_jax import params_from_jax
    from fitclip_torch.convert.torch_state_dict import clip_tree_from_torch, load_torch_state_dict
    from fitclip_torch.ops.quant import quantize_clip_params

    if os.path.isdir(checkpoint_path):
        raise NotImplementedError(
            f"checkpoint_path={checkpoint_path} is a directory: an Orbax train state of the "
            "JAX package, which needs JAX to read. Pass a torch .pt state dict.")
    encoder = loaded.encoder
    tree = clip_tree_from_torch(load_torch_state_dict(checkpoint_path), encoder.config)
    if encoder.quantized:
        tree = quantize_clip_params(tree)
    encoder.model.load_state_dict(params_from_jax(tree, encoder.config))
    return loaded


def run(cfg: Dict[str, Any]) -> Optional[float]:
    from fitclip_torch.cli.runners import run_eval, run_predict
    from fitclip_torch.config_engine import instantiate

    seed_everything(int(cfg.get("seed", 42)))
    command = cfg["command"]
    if command not in COMMANDS:
        raise SystemExit(f"Unknown command: {command!r} — expected one of "
                         f"{', '.join(COMMANDS)}")
    if command in NOT_PORTED:
        raise NotImplementedError(f"command={command} is not ported to fitclip_torch yet "
                                  "(ROADMAP.md, queue 1)")
    if not cfg.get("encoder"):
        raise SystemExit("No encoder selected — pass encoder=<name> "
                         "(e.g. encoder=clip_vit_b_16; see config/encoder/)")
    if not cfg.get("data"):
        raise SystemExit("No dataset selected — pass data=<name> "
                         "(e.g. data=msrvtt; see config/data/)")
    encoder_slot = instantiate(cfg["encoder"])
    if isinstance(encoder_slot, Mapping):
        raise NotImplementedError("a {student, teacher} encoder slot is for command=train, "
                                  "which is not ported to fitclip_torch yet (ROADMAP.md, queue 1)")
    data_module = instantiate_data_module(cfg["data"], encoder_slot)
    if cfg.get("checkpoint_path"):
        encoder_slot = load_checkpoint(encoder_slot, cfg["checkpoint_path"])

    metrics: Dict[str, float] = {}
    quant_cfg = cfg.get("quant")
    if command in ("evaluate", "validate", "test"):
        split = "test" if command == "test" else "val"
        metrics = run_eval(encoder_slot, data_module, split=split, quant_cfg=quant_cfg)
        print(json.dumps(metrics, indent=2))
    else:
        run_predict(encoder_slot, data_module,
                    output_path=cfg.get("output_path", "predictions.pt"), quant_cfg=quant_cfg)

    optimized_metric_name = cfg.get("optimized_metric_name")
    return metrics.get(optimized_metric_name) if optimized_metric_name else None


def main(argv: Optional[List[str]] = None) -> None:
    from fitclip_torch.config_engine import compose, expand_multirun

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    argv = argv if argv is not None else sys.argv[1:]
    config_name, config_dir, multirun, overrides = parse_args(argv)
    runs = expand_multirun(overrides) if multirun else [overrides]
    results = []
    for i, run_overrides in enumerate(runs):
        if multirun:
            LOGGER.info("=== multirun job %d/%d: %s ===", i + 1, len(runs),
                        " ".join(run_overrides))
        cfg = compose(config_dir, config_name, run_overrides)
        if cfg.get("silent"):
            logging.getLogger().setLevel(logging.WARNING)
        if cfg.get("hparam_search"):
            raise NotImplementedError("hparam_search sweeps are not ported to fitclip_torch "
                                      "yet (ROADMAP.md, queue 1)")
        results.append(run(cfg))
    if len(results) == 1 and results[0] is not None:
        print(results[0])
