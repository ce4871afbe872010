"""The port's CLI (port of ``fitclip_tpu/cli/main.py``):
``python -m fitclip_torch command=... encoder=... data=...``.

The JAX package's Hydra surface on the port's config engine, reading the
repository's ``config/`` tree: config groups, ``++``/``+``/``~`` overrides,
``--multirun`` and ``--config-name``. Commands, on one device (CUDA unless
``++encoder.device=cpu``):

- ``train``: contrastive fine-tuning, or with ``--config-name
  teacher_student_trainer`` and a {student, teacher} encoder slot
  (``+encoder@encoder.student=...``) the FitCLIP distillation over mixed
  batches (``training/train_runner.py``);
- ``evaluate``, ``validate``, ``test`` (the test split) and ``predict``: a
  classification data module switches the eval to zero-shot
  classification; a grouped data module (``data=drift_eval``) is built
  member by member, each with the encoder, and evaluated per member
  (``runners.py``); ``quant.calibration_batches`` and ``quant.scales_path``
  calibrate and persist an int8 encoder's scales;
- ``tune``: the batch-size and learning-rate searches (``tune.py``).

Several processes, one per GPU: ``torchrun --nproc_per_node=N -m
fitclip_torch command=...`` or ``++distributed={coordinator_address,
num_processes, process_id}`` on each process. ``run`` brings up the process
group before anything else (``parallel/multihost.py``) and destroys it when it
returns; evaluate, validate, test and predict run data-parallel, train on the
global batch (``batch_size`` is the global batch), ``++trainer.fsdp=true``
shards the train state, tune runs on every rank as on one device, and only
the main process prints, logs and writes.

``+profile_dir=DIR`` runs evaluate, validate, test or predict under
``torch.profiler`` with the program's spans on (``utils/profiling.py``),
writes ``DIR/trace.json`` and logs the spans' host times. ``train`` and
``tune`` take no profile: a whole training run under the profiler is
unbounded.

A config with ``hparam_search`` runs a sweep of trials (``sweep.py``) and
returns the best value of ``optimized_metric_name``. ``checkpoint_path``:
under ``train``, the port's full train-state file resumes everything; any
other file's weights replace the encoder's (the student's in a {student,
teacher} slot): the encoder params of a train-state file, or a bare-params
torch checkpoint (OpenAI or HF layout). An Orbax directory needs JAX and is
refused.
"""

import contextlib
import json
import logging
import os
import sys
from typing import Any, Dict, Iterator, List, Mapping, Optional, Tuple

LOGGER = logging.getLogger(__name__)

DEFAULT_CONFIG_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "config")

COMMANDS = ("train", "evaluate", "validate", "test", "predict", "tune")

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


def instantiate_encoder_slot(node: Mapping[str, Any]):
    """One encoder, or a {student, teacher} map instantiated slot by slot (the
    data modules then see the map: dual preprocessing)."""
    from fitclip_torch.config_engine import instantiate

    if "_target_" in node:
        return instantiate(node)
    return {key: instantiate(value) for key, value in node.items()}


def _load_encoder_tree(loaded, tree):
    """Load a JAX-layout CLIP tree (numpy) into the encoder, quantized as the
    encoder is."""
    from fitclip_torch.convert.from_jax import params_from_jax
    from fitclip_torch.ops.quant import quantize_clip_params

    encoder = loaded.encoder
    if encoder.quantized:
        tree = quantize_clip_params(tree)
    encoder.model.load_state_dict(params_from_jax(tree, encoder.config))
    return loaded


def load_checkpoint(loaded, checkpoint_path: str):
    """Replace the encoder's weights with a checkpoint's; the encoder keeps its
    architecture. The port's own train-state file (``training/checkpointing.py``)
    gives its encoder params; any other file is a bare-params torch state dict
    (OpenAI or HF layout). A directory, an Orbax train state of the JAX
    package, needs JAX and is refused."""
    from fitclip_torch.convert.from_jax import params_to_jax
    from fitclip_torch.convert.torch_state_dict import clip_tree_from_torch, load_torch_state_dict
    from fitclip_torch.models.clip.model import CLIPConfig
    from fitclip_torch.training.checkpointing import is_full_train_state
    from fitclip_torch.training.checkpointing import load_checkpoint as load_train_state

    if os.path.isdir(checkpoint_path):
        raise NotImplementedError(
            f"checkpoint_path={checkpoint_path} is a directory: an Orbax train state of the "
            "JAX package, which needs JAX to read. Pass a torch .pt state dict.")
    encoder = loaded.encoder
    if is_full_train_state(checkpoint_path):
        prefix = "encoder."
        state = {name[len(prefix):]: value for name, value
                 in load_train_state(checkpoint_path)["params"].items()
                 if name.startswith(prefix)}
        if not encoder.quantized:
            encoder.model.load_state_dict(state)
            return loaded
        return _load_encoder_tree(loaded, params_to_jax(state, encoder.config))
    if not isinstance(encoder.config, CLIPConfig):
        # The JAX CLI reads a bare-params file as a ViT CLIP's too, and refuses
        # a CLIP ResNet's (config_from_openai_state_dict).
        raise ValueError(f"checkpoint_path={checkpoint_path} is a bare-params file, read as a "
                         f"ViT CLIP's, and the encoder is a {type(encoder).__name__}: give its "
                         "weights as encoder.checkpoint_path")
    return _load_encoder_tree(loaded, clip_tree_from_torch(load_torch_state_dict(checkpoint_path),
                                                           encoder.config))


def _resolve_checkpoint(command: str, encoder_slot, checkpoint_path: Optional[str]):
    """(encoder slot, resume path): under command=train, the port's full
    train-state file resumes everything (params, moments, step, temperatures,
    the callback sidecar) inside run_train; otherwise the checkpoint's weights
    replace the encoder's, or the student's in a {student, teacher} slot."""
    from fitclip_torch.training.checkpointing import is_full_train_state

    if not checkpoint_path:
        return encoder_slot, None
    if command == "train" and is_full_train_state(checkpoint_path):
        return encoder_slot, checkpoint_path
    if isinstance(encoder_slot, Mapping):
        return {**encoder_slot,
                "student": load_checkpoint(encoder_slot["student"], checkpoint_path)}, None
    return load_checkpoint(encoder_slot, checkpoint_path), None


def run(cfg: Dict[str, Any]) -> Optional[float]:
    from fitclip_torch.parallel.multihost import (maybe_initialize_distributed,
                                                  shutdown_distributed)

    import torch.distributed

    # The process group comes up before any model or loader is built; a
    # configured init that fails raises here. A group the caller made stays up.
    created = not torch.distributed.is_initialized()
    maybe_initialize_distributed(cfg)
    try:
        return _run(cfg)
    finally:
        if created:
            shutdown_distributed()


@contextlib.contextmanager
def _profiled(profile_dir: Optional[str]) -> Iterator[None]:
    """``+profile_dir=DIR``: the command under ``device_trace`` with the
    program's spans on, a rank's trace in ``DIR`` (``DIR/rank<R>`` under a
    group of several processes); the spans' host times logged at the end."""
    if not profile_dir:
        yield
        return
    from fitclip_torch.parallel.multihost import process_count, process_index
    from fitclip_torch.utils.profiling import StageTimer, device_trace, tracing

    if process_count() > 1:
        profile_dir = os.path.join(profile_dir, f"rank{process_index()}")
    timer = StageTimer()
    with tracing(timer), device_trace(profile_dir):
        yield
    LOGGER.info("Wrote a trace to %s; spans: %s", os.path.join(profile_dir, "trace.json"),
                timer.report())


def _run(cfg: Dict[str, Any]) -> Optional[float]:
    from fitclip_torch.cli.runners import run_eval, run_predict
    from fitclip_torch.parallel.multihost import is_main_process, local_only

    # ++compilation_cache_dir sets XLA's persistent cache in the JAX package;
    # the port's kernels build once by their sources' hash instead.
    if cfg.get("compilation_cache_dir"):
        LOGGER.info("compilation_cache_dir is ignored: the port's kernels build once into "
                    "build/fitclip_torch/<hash>/ and later processes load them")
    seed_everything(int(cfg.get("seed", 42)))
    command = cfg["command"]
    if command not in COMMANDS:
        raise SystemExit(f"Unknown command: {command!r} — expected one of "
                         f"{', '.join(COMMANDS)}")
    if cfg.get("profile_dir") and command in ("train", "tune"):
        LOGGER.warning("profile_dir is ignored under command=%s: a whole run under the "
                       "profiler is unbounded", command)
    if not cfg.get("encoder"):
        raise SystemExit("No encoder selected — pass encoder=<name> "
                         "(e.g. encoder=clip_vit_b_16; see config/encoder/)")
    if not cfg.get("data"):
        raise SystemExit("No dataset selected — pass data=<name> "
                         "(e.g. data=msrvtt; see config/data/)")
    encoder_slot = instantiate_encoder_slot(cfg["encoder"])
    data_module = instantiate_data_module(cfg["data"], encoder_slot)
    checkpoint_path = cfg.get("checkpoint_path")
    encoder_slot, resume_path = _resolve_checkpoint(command, encoder_slot, checkpoint_path)

    metrics: Dict[str, float] = {}
    quant_cfg = cfg.get("quant")
    if command == "train":
        from fitclip_torch.training.train_runner import run_train

        trainer_cfg = cfg.get("trainer", {})
        metrics = run_train(encoder_slot, data_module, model_cfg=cfg.get("model", {}),
                            trainer_cfg=trainer_cfg, optimizer_cfg=cfg.get("optimizer", {}),
                            callbacks_cfg=trainer_cfg.get("callbacks"),
                            prompts_path=cfg.get("prompts"),
                            log_dir=cfg.get("log_dir", "logs"),
                            checkpoint_path=resume_path)["metrics"]
    elif command == "tune":
        from fitclip_torch.cli.tune import run_tune

        # The reference never tunes from a checkpoint (__main__.py:55-59).
        assert not checkpoint_path, "checkpoint_path can't be tuned from"
        # Every rank tunes as on one device (its own loader's batches, no
        # collective); the main process prints.
        with local_only():
            metrics = run_tune(encoder_slot, data_module, trainer_cfg=cfg.get("trainer", {}),
                               tune_cfg=cfg.get("tune"))
        if is_main_process():
            print(json.dumps(metrics, indent=2))
    else:
        if isinstance(encoder_slot, Mapping):
            raise ValueError(f"command={command} takes one encoder, not a "
                             f"{{{', '.join(encoder_slot)}}} slot")
        with _profiled(cfg.get("profile_dir")):
            if command in ("evaluate", "validate", "test"):
                split = "test" if command == "test" else "val"
                metrics = run_eval(encoder_slot, data_module, split=split, quant_cfg=quant_cfg)
                if is_main_process():
                    print(json.dumps(metrics, indent=2))
            else:
                run_predict(encoder_slot, data_module,
                            output_path=cfg.get("output_path", "predictions.pt"),
                            quant_cfg=quant_cfg)

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
            from fitclip_torch.cli.sweep import run_sweep

            best_value, _ = run_sweep(cfg, run)
            results.append(best_value)
        else:
            results.append(run(cfg))
    if len(results) == 1 and results[0] is not None:
        print(results[0])
