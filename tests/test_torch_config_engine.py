"""fitclip_torch/config_engine against the JAX package's: every file under
config/ composes to the same dict through both engines, overrides and
interpolation agree, and ``_target_`` maps fitclip_tpu to fitclip_torch
(a target that the port lacks raises, naming it)."""

import functools
from pathlib import Path

import pytest

from fitclip_tpu.config_engine import compose as jax_compose
from fitclip_tpu.config_engine import expand_multirun as jax_expand
from fitclip_tpu.config_engine.compose import ConfigError as JaxConfigError
from fitclip_torch.config_engine import compose, expand_multirun, instantiate
from fitclip_torch.config_engine.compose import ConfigError
from fitclip_torch.config_engine.instantiate import NotPortedError, port_target, resolve_target

CONFIG = Path(__file__).resolve().parent.parent / "config"
ROOTS = sorted(p.stem for p in CONFIG.glob("*.yaml"))
GROUP_FILES = sorted(p.relative_to(CONFIG) for p in CONFIG.glob("*/**/*.yaml"))


def _both(config_name, overrides):
    """Both engines' result, or both engines' error type."""
    results = []
    for engine, error in ((compose, ConfigError), (jax_compose, JaxConfigError)):
        try:
            results.append(engine(str(CONFIG), config_name, overrides))
        except error as e:
            results.append(("error", str(e).replace(str(CONFIG), "")))
    return results


ROOT_OVERRIDES = {"trainer": [],
                  "drift_eval_trainer": ["encoder=clip_vit_b_16"],
                  "teacher_student_trainer": ["+encoder@encoder.student=clip_vit_b_16",
                                              "+encoder@encoder.teacher=slip_vit_b_16"]}


@pytest.mark.parametrize("root", ROOTS)
def test_root_configs_compose_as_jax(root):
    port, ref = _both(root, ["command=evaluate", *ROOT_OVERRIDES[root]])
    assert port == ref and isinstance(port, dict)
    assert _both(root, []) == [("error", "Mandatory value 'command' (???) was not provided")] * 2


@pytest.mark.parametrize("rel", GROUP_FILES, ids=str)
def test_every_group_file_composes_as_jax(rel):
    group, name = str(rel.parent), rel.stem
    port, ref = _both("trainer", ["command=evaluate", f"{group}={name}"])
    assert port == ref
    if isinstance(port, dict):
        node = port
        for key in group.split("/"):
            node = node[key]
        assert node


def test_overrides_and_interpolation_match_jax(monkeypatch):
    monkeypatch.setenv("MSRVTT_PATH", "/data/msrvtt")
    monkeypatch.setenv("FIT_CKPT", "/ckpt/fit.pth")
    cases = [
        ("trainer", ["command=evaluate", "encoder=clip_vit_b_16", "data=msrvtt",
                     "++encoder.dtype=int8", "++quant.calibration_batches=1",
                     "data.eval_batch_size=8", "+data.num_threads=2", "optimizer.lr=3e-6",
                     "~model.min_temperature", "seed=-1"]),
        ("trainer", ["command=predict", "encoder=frozen_in_time", "data=ucf101"]),
        ("teacher_student_trainer", ["command=train", "+encoder@encoder.student=clip_vit_b_16",
                                     "+encoder@encoder.teacher=clip_vit_b_32",
                                     "data=mixed_batch_webvid_4_5k_all",
                                     "++model.labeled_dataset_loss_share=0.9999"]),
        ("trainer", ["command=evaluate", "encoder.missing=1"]),
        ("trainer", []),
    ]
    for root, overrides in cases:
        port, ref = _both(root, overrides)
        assert port == ref, overrides
    cfg = compose(str(CONFIG), "trainer", cases[0][1])
    assert cfg["data"]["base_path"] == "/data/msrvtt" and cfg["encoder"]["dtype"] == "int8"
    assert cfg["optimizer"]["lr"] == 3e-6 and "min_temperature" not in cfg["model"]
    overrides = ["command=evaluate", "data=msrvtt,ucf101", "seed=1,2", "x=[1,2]"]
    assert expand_multirun(overrides) == jax_expand(overrides)
    assert len(expand_multirun(overrides)) == 4


def test_targets_map_to_the_port():
    assert port_target("fitclip_tpu.models.clip.load.load_clip_encoder") == \
        "fitclip_torch.models.clip.load.load_clip_encoder"
    assert port_target("collections.OrderedDict") == "collections.OrderedDict"
    from fitclip_torch.models.clip.load import load_clip_encoder
    from fitclip_torch.utils.tensor import pad_axis_to

    assert resolve_target("fitclip_tpu.models.clip.load.load_clip_encoder") is load_clip_encoder
    node = {"_target_": "fitclip_tpu.utils.tensor.pad_axis_to", "_partial_": True, "size": 3}
    partial = instantiate(node)
    assert isinstance(partial, functools.partial) and partial.func is pad_axis_to
    made = instantiate({"a": [{"_target_": "collections.OrderedDict", "_args_": [[["k", 1]]]}],
                        "b": 2})
    assert made["a"][0] == {"k": 1} and made["b"] == 2
    with pytest.raises(NotPortedError, match="fitclip_tpu.models.clip.load.wise_encoder"):
        instantiate({"_target_": "fitclip_tpu.models.clip.load.wise_encoder"})
    with pytest.raises(NotPortedError, match="no_such_factory"):
        resolve_target("fitclip_tpu.models.clip.load.no_such_factory")
    with pytest.raises(ImportError):
        resolve_target("no_such_package.thing")


def test_every_config_target_resolves_in_the_port_or_raises():
    """Each _target_ named under config/ resolves to a fitclip_torch object or
    raises NotPortedError: every family's factory, every dataset and every
    combinator of data modules resolve; exactly WiSE-FT does not."""
    import yaml

    targets = set()

    def walk(node):
        if isinstance(node, dict):
            if isinstance(node.get("_target_"), str):
                targets.add(node["_target_"])
            for value in node.values():
                walk(value)
        elif isinstance(node, list):
            for value in node:
                walk(value)

    for path in CONFIG.rglob("*.yaml"):
        walk(yaml.safe_load(path.read_text()))
    resolved, unresolved = set(), set()
    for target in sorted(targets):
        assert target.startswith("fitclip_tpu."), target
        try:
            obj = resolve_target(target)
        except NotPortedError:
            unresolved.add(target)
            continue
        assert obj.__module__.startswith("fitclip_torch."), target
        resolved.add(target)
    datasets = {"msrvtt.MsrVttDataModule", "ucf.UcfDataModule", "kinetics.KineticsDataModule",
                "hmdb.HmdbDataModule", "moments_in_time.MomentsInTimeDataModule",
                "didemo.DidemoDataModule", "youcook2.YouCook2DataModule",
                "webvid.WebVidDataModule",
                "conceptual_captions.ConceptualCaptionsDataModule"}
    assert {"fitclip_tpu.models.clip.load.load_clip_encoder",
            "fitclip_tpu.models.clip.load.load_clip_from_scratch",
            "fitclip_tpu.models.frozen_in_time.encoder.load_frozen_in_time_encoder",
            "fitclip_tpu.models.slip.load_slip_encoder",
            "fitclip_tpu.models.mil_nce.load_mil_nce_encoder",
            "fitclip_tpu.models.videoclip.load_videoclip_encoder",
            *(f"fitclip_tpu.data.data_module_group.{c}" for c in (
                "EvalDataModuleGroup", "MixedBatchDataModule", "DataModuleStructuredGroup",
                "TrainAndEvalDataModules")),
            *(f"fitclip_tpu.data.datasets.{d}" for d in datasets)} <= resolved
    assert unresolved == {"fitclip_tpu.models.clip.load.wise_encoder"}
