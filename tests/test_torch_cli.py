"""The port's CLI (``python -m fitclip_torch``, fitclip_torch/cli) against the JAX
package's (``fitclip_tpu.cli.main.run``) on tiny fixtures, on the CPU
(``++encoder.device=cpu``):

- evaluate and predict on msrvtt give JAX's metrics and embeddings in fp32
  (the tiny encoder's JAX params carried across by convert/from_jax.py), with
  a video count that is not a multiple of the batch;
- a bare-params checkpoint_path replaces the weights as JAX's does;
- evaluate on ucf switches to zero-shot classification; command=test takes
  kinetics' test split;
- int8: the calibration over the head batches writes JAX's act-scales,
  teacher-forced (each layer and int8 site of the port's calibration fed
  JAX's input to it), and predict reuses them through quant.scales_path.

Both packages decode with OpenCV (``opencv_only``)."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as flax_nn

from fitclip_tpu.cli.main import DEFAULT_CONFIG_DIR
from fitclip_tpu.cli.main import parse_args as jax_parse_args
from fitclip_tpu.cli.main import run as jax_run
from fitclip_tpu.config_engine import compose as jax_compose
from fitclip_tpu.evaluation.retrieval import RetrievalEvaluator as JaxRetrievalEvaluator
from fitclip_tpu.models.clip import load as jax_load
from fitclip_tpu.models.clip import model as jax_clip_model
from fitclip_tpu.models.clip.tokenizer import write_tiny_test_vocab
from fitclip_torch.cli import main as cli
from fitclip_torch.cli import runners
from fitclip_torch.convert.from_jax import params_from_jax
from fitclip_torch.data import video_reader
from fitclip_torch.evaluation.retrieval import RetrievalEvaluator
from fitclip_torch.models.clip import load
from fitclip_torch.models.clip.model import CLIPConfig, TextConfig, VisionConfig
from fitclip_torch.ops import quant

from tests.test_torch_convert_state_dict import _save, openai_state_dict
from tests.test_torch_data import _write_textured_video

WORDS = ["a", "cat", "video", "of", "photo", "person", "doing", "the"] * 3


@pytest.fixture(scope="module", autouse=True)
def opencv_only():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(video_reader, "_native_reader", lambda: None)
        yield


def tiny_encoder_from_jax(bpe_path, vocab_path, num_frames=4, seed=0, device="cpu"):
    """The port's tiny encoder with the JAX tiny encoder's params (same seed)."""
    ref = jax_load.load_tiny_test_encoder(num_frames=num_frames, seed=seed, bpe_path=bpe_path,
                                          vocab_path=vocab_path)
    port = load.load_tiny_test_encoder(num_frames=num_frames, seed=seed, bpe_path=bpe_path,
                                       vocab_path=vocab_path, device=device)
    tree = jax.tree_util.tree_map(np.asarray, ref.params)
    port.encoder.model.load_state_dict(params_from_jax(tree, port.encoder.config))
    return port


@pytest.fixture(scope="module")
def vocab(tmp_path_factory):
    return write_tiny_test_vocab(str(tmp_path_factory.mktemp("vocab")), WORDS)


def _msrvtt_tree(root, count):
    for i in range(count):
        _write_textured_video(root / "videos" / "all" / f"video{i}.avi", num_frames=10 + i,
                              seed=100 + i)
    (root / "structured-symlinks").mkdir()
    (root / "structured-symlinks" / "val_list_jsfusion.txt").write_text(
        "\n".join(f"video{i}" for i in range(count)))
    (root / "annotation").mkdir()
    captions = [" ".join(np.random.default_rng(i).choice(WORDS, size=4)) for i in range(count)]
    (root / "annotation" / "MSR_VTT.json").write_text(json.dumps({"annotations": [
        {"image_id": f"video{i}", "caption": c} for i, c in enumerate(captions)]}))
    return str(root)


@pytest.fixture(scope="module")
def msrvtt_root(tmp_path_factory):
    return _msrvtt_tree(tmp_path_factory.mktemp("msrvtt"), 5)


def _port_argv(vocab, *overrides):
    merges, vocab_json = vocab
    return ["encoder=clip_vit_b_16", f"encoder._target_={__name__}.tiny_encoder_from_jax",
            "~encoder.name", f"+encoder.bpe_path={merges}", f"+encoder.vocab_path={vocab_json}",
            "++encoder.device=cpu", "+data.num_threads=2", *overrides]


def _jax_cfg(vocab, overrides):
    merges, vocab_json = vocab
    cfg = jax_compose(DEFAULT_CONFIG_DIR, "trainer",
                      ["encoder=clip_vit_b_16", "+data.num_threads=2", *overrides])
    cfg["encoder"] = {"_target_": "fitclip_tpu.models.clip.load.load_tiny_test_encoder",
                      "bpe_path": merges, "vocab_path": vocab_json}
    return cfg


def _printed_metrics(capsys):
    printed = capsys.readouterr().out
    return json.loads(printed[printed.index("{"): printed.rindex("}") + 1])


def test_parse_args_matches_jax():
    argv = ["--config-name", "teacher_student_trainer.yaml", "-m", "command=evaluate",
            "data=msrvtt,ucf101", "--config-dir", "/configs"]
    assert cli.parse_args(argv) == jax_parse_args(argv)


@pytest.fixture(scope="module")
def jax_msrvtt(vocab, msrvtt_root, tmp_path_factory):
    """The JAX CLI's evaluate metrics and predictions on msrvtt (batches of 2)."""
    out = tmp_path_factory.mktemp("jax_predict") / "predictions.pt"
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MSRVTT_PATH", msrvtt_root)
        import contextlib
        import io

        buffer = io.StringIO()
        with contextlib.redirect_stdout(buffer):
            jax_run(_jax_cfg(vocab, ["command=evaluate", "data=msrvtt",
                                     "data.eval_batch_size=2"]))
        printed = buffer.getvalue()
        jax_run(_jax_cfg(vocab, ["command=predict", "data=msrvtt", "data.eval_batch_size=2",
                                 f"+output_path={out}"]))
    return (json.loads(printed[printed.index("{"): printed.rindex("}") + 1]),
            torch.load(str(out), weights_only=False))


def test_evaluate_msrvtt_matches_jax(vocab, msrvtt_root, jax_msrvtt, monkeypatch, capsys):
    """5 videos in batches of 2: the last batch is short (JAX pads it to its
    8 CPU devices and drops the pad rows by the valid count)."""
    monkeypatch.setenv("MSRVTT_PATH", msrvtt_root)
    cli.main(_port_argv(vocab, "command=evaluate", "data=msrvtt", "data.eval_batch_size=2"))
    metrics = _printed_metrics(capsys)
    assert metrics == jax_msrvtt[0]
    assert set(metrics) == {"r1", "r5", "r10", "mr"}


def test_predict_msrvtt_matches_jax(vocab, msrvtt_root, jax_msrvtt, monkeypatch, tmp_path):
    monkeypatch.setenv("MSRVTT_PATH", msrvtt_root)
    out = tmp_path / "predictions.pt"
    cli.main(_port_argv(vocab, "command=predict", "data=msrvtt", "data.eval_batch_size=2",
                        f"+output_path={out}"))
    got, want = torch.load(str(out), weights_only=False), jax_msrvtt[1]
    assert sorted(got) == sorted(want) == ["encoded_texts", "encoded_videos", "video_ids"]
    assert got["video_ids"] == want["video_ids"] == [f"video{i}" for i in range(5)]
    for key in ("encoded_videos", "encoded_texts"):
        assert got[key].shape == want[key].shape == (5, 32)
        np.testing.assert_allclose(got[key].numpy(), want[key].numpy(), atol=2e-4, rtol=2e-4)


def test_evaluate_wise_matches_jax(vocab, msrvtt_root, monkeypatch, capsys):
    """``command=evaluate encoder=wise`` with two tiny seeded members
    (tests/test_cli_teacher_student.py::test_wise_encoder_cli's shape) at the
    released weight_for_2 0.4: JAX's metrics."""
    merges, vocab_json = vocab
    monkeypatch.setenv("MSRVTT_PATH", msrvtt_root)
    common = ["command=evaluate", "data=msrvtt", "data.eval_batch_size=2",
              "+data.num_threads=2"]
    members = []
    for i, slot in enumerate(("encoder.model1", "encoder.model2")):
        members += [f"+encoder@{slot}=clip_vit_b_16",
                    f"{slot}._target_=fitclip_tpu.models.clip.load.load_tiny_test_encoder",
                    f"~{slot}.name", f"+{slot}.bpe_path={merges}",
                    f"+{slot}.vocab_path={vocab_json}", f"+{slot}.seed={i}",
                    f"++{slot}.device=cpu"]
    cli.main(["encoder=wise", *members, *common])
    got = _printed_metrics(capsys)
    cfg = jax_compose(DEFAULT_CONFIG_DIR, "trainer", ["encoder=wise", *common,
                                                      "++encoder.model1={}",
                                                      "++encoder.model2={}"])
    # JAX's members carry the port's seeded weights (no JAX init to compile).
    for i, slot in enumerate(("model1", "model2")):
        cfg["encoder"][slot] = {"_target_": "tests.test_torch_train_cli.jax_tiny_encoder",
                                "bpe_path": merges, "vocab_path": vocab_json, "seed": i}
    assert cfg["encoder"]["weight_for_2"] == 0.4
    jax_run(cfg)
    assert got == _printed_metrics(capsys)
    assert set(got) == {"r1", "r5", "r10", "mr"}


def test_retrieval_evaluator_drops_padding_rows():
    """A padded last batch (7 videos in batches of 4, the last padded to 4)
    with its valid count gives the unpadded metrics, as JAX's evaluator does."""
    rng = np.random.default_rng(0)
    videos, texts = (rng.standard_normal((7, 16)).astype(np.float32) for _ in range(2))
    padded = [(videos[:4], texts[:4], None),
              (np.pad(videos[4:], ((0, 1), (0, 0))), np.pad(texts[4:], ((0, 1), (0, 0))), 3)]
    port, ref, whole = RetrievalEvaluator(), JaxRetrievalEvaluator(), RetrievalEvaluator()
    for v, t, valid in padded:
        port.update(torch.from_numpy(v), torch.from_numpy(t), valid=valid)
        ref.update(v, t, valid=valid)
    whole.update(torch.from_numpy(videos), torch.from_numpy(texts))
    assert port.compute() == whole.compute()
    assert port.compute() == pytest.approx(ref.compute())


def test_bare_params_checkpoint_replaces_the_weights_as_jax(vocab, msrvtt_root, monkeypatch,
                                                            tmp_path):
    """checkpoint_path: a torch state dict in OpenAI's layout with the tiny
    encoder's shapes; the encoder keeps its architecture. A directory (an
    Orbax train state) is refused."""
    merges, vocab_json = vocab
    size = jax_load.load_tiny_test_encoder(bpe_path=merges, vocab_path=vocab_json) \
        .encoder.config.text.vocab_size
    tiny = CLIPConfig.tiny_test(vocab_size=size)
    checkpoint = _save(tmp_path / "bare.pt", openai_state_dict(tiny, seed=7))
    monkeypatch.setenv("MSRVTT_PATH", msrvtt_root)
    common = ["command=predict", "data=msrvtt", "data.eval_batch_size=2",
              f"+checkpoint_path={checkpoint}"]
    cli.main(_port_argv(vocab, *common, f"+output_path={tmp_path / 'port.pt'}"))
    jax_run(_jax_cfg(vocab, [*common, f"+output_path={tmp_path / 'jax.pt'}"]))
    got = torch.load(str(tmp_path / "port.pt"), weights_only=False)
    want = torch.load(str(tmp_path / "jax.pt"), weights_only=False)
    for key in ("encoded_videos", "encoded_texts"):
        np.testing.assert_allclose(got[key].numpy(), want[key].numpy(), atol=2e-4, rtol=2e-4)
    (tmp_path / "orbax").mkdir()
    with pytest.raises(NotImplementedError, match="needs JAX"):
        cli.main(_port_argv(vocab, "command=evaluate", "data=msrvtt",
                            f"+checkpoint_path={tmp_path / 'orbax'}"))


@pytest.fixture(scope="module")
def ucf_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("ucf")
    categories = ["ApplyEyeMakeup", "Basketball", "YoYo"]
    (root / "classInd.txt").write_text(
        "\n".join(f"{i + 1} {c}" for i, c in enumerate(categories)))
    lines = []
    for i, category in enumerate(categories):
        for g in range(2):
            rel = f"{category}/v_{category}_g0{g}_c01.avi"
            _write_textured_video(root / "videos" / rel, seed=200 + 2 * i + g)
            lines.append(rel)
    (root / "testlist01.txt").write_text("\n".join(lines))
    return root


def test_evaluate_ucf_switches_to_classification_as_jax(vocab, ucf_root, monkeypatch, capsys,
                                                        tmp_path):
    monkeypatch.setenv("UCF101_CLASS_IND", str(ucf_root / "classInd.txt"))
    monkeypatch.setenv("UCF101_TEST_LIST", str(ucf_root / "testlist01.txt"))
    monkeypatch.setenv("UCF101_VIDEOS", str(ucf_root / "videos"))
    overrides = ["command=evaluate", "data=ucf101", "data.eval_batch_size=4"]
    jax_run(_jax_cfg(vocab, overrides))
    want = _printed_metrics(capsys)
    cli.main(_port_argv(vocab, *overrides))
    got = _printed_metrics(capsys)
    assert set(got) == {"a1", "a5", "mr"} and got == pytest.approx(want)
    predict = ["command=predict", "data=ucf101", "data.eval_batch_size=4"]
    jax_run(_jax_cfg(vocab, [*predict, f"+output_path={tmp_path / 'jax.pt'}"]))
    cli.main(_port_argv(vocab, *predict, f"+output_path={tmp_path / 'port.pt'}"))
    got = torch.load(str(tmp_path / "port.pt"), weights_only=False)
    want = torch.load(str(tmp_path / "jax.pt"), weights_only=False)
    assert got["video_ids"] == want["video_ids"] and len(got["video_ids"]) == 6
    np.testing.assert_array_equal(got["labels"].numpy(), want["labels"].numpy())
    np.testing.assert_array_equal(got["predictions"].numpy(), want["predictions"].numpy())


def test_command_test_takes_the_kinetics_test_split(vocab, monkeypatch, capsys, tmp_path):
    """val and test hold different videos and labels; command=test scores the
    test split, as JAX's CLI does."""
    categories = ["abseiling", "air drumming", "yoga"]
    (tmp_path / "categories.txt").write_text("\n".join(categories) + "\n")
    for split, offset in (("val", 0), ("test", 1)):
        rows = ["label,youtube_id,time_start,time_end,split"]
        for i in range(3):
            rows.append(f"{categories[(i + offset) % 3]},yt{split}{i},{i},{i + 10},{split}")
            _write_textured_video(tmp_path / split / f"yt{split}{i}_{i:06}_{i + 10:06}.mp4",
                                  seed=300 + 10 * offset + i)
        (tmp_path / f"{split}.csv").write_text("\n".join(rows) + "\n")
        monkeypatch.setenv(f"KINETICS_{split.upper()}_CSV", str(tmp_path / f"{split}.csv"))
        monkeypatch.setenv(f"KINETICS_{split.upper()}_VIDEOS", str(tmp_path / split))
    monkeypatch.setenv("KINETICS_CATEGORIES", str(tmp_path / "categories.txt"))
    results = {}
    for command in ("test", "validate"):
        overrides = [f"command={command}", "data=kinetics400", "data.eval_batch_size=2"]
        jax_run(_jax_cfg(vocab, overrides))
        want = _printed_metrics(capsys)
        cli.main(_port_argv(vocab, *overrides))
        results[command] = _printed_metrics(capsys)
        assert results[command] == pytest.approx(want), command


def test_commands_that_are_not_ported_raise(vocab, msrvtt_root, monkeypatch):
    """An unknown command and a missing data module exit; command=train over a
    structured group (a mapping of train loaders, which the train loop cannot
    iterate) raises before any loader is built, naming the combinator."""
    monkeypatch.setenv("MSRVTT_PATH", msrvtt_root)
    with pytest.raises(SystemExit, match="Unknown command"):
        cli.main(_port_argv(vocab, "command=fit", "data=msrvtt"))
    with pytest.raises(SystemExit, match="No dataset"):
        cli.main([a for a in _port_argv(vocab, "command=evaluate") if "data." not in a])
    with pytest.raises(ValueError, match="DataModuleStructuredGroup"):
        cli.main([a for a in _port_argv(vocab, "command=train",
                                        "data=structured_group_msrvtt_webvid")
                  if not a.startswith("+data.")])


def test_profile_dir_writes_a_trace_with_the_programs_spans(vocab, msrvtt_root, monkeypatch,
                                                            capsys, caplog, tmp_path):
    """+profile_dir=DIR: evaluate runs under the profiler with the spans on,
    writes DIR/trace.json holding them and logs their host times; the
    metrics are those of the run without it."""
    monkeypatch.setenv("MSRVTT_PATH", msrvtt_root)
    caplog.set_level("INFO", logger=cli.LOGGER.name)
    argv = _port_argv(vocab, "command=evaluate", "data=msrvtt", "data.eval_batch_size=2")
    cli.main(argv)
    plain = _printed_metrics(capsys)
    cli.main(argv + [f"+profile_dir={tmp_path / 'profile'}"])
    assert _printed_metrics(capsys) == plain
    with open(tmp_path / "profile" / "trace.json") as f:
        names = {event.get("name") for event in json.load(f)["traceEvents"]}
    assert {"fitclip/encode_video", "fitclip/encode_text", "fitclip/retrieval.update",
            "fitclip/retrieval.compute"} <= names
    assert "encode_video: " in caplog.text and "(3x)" in caplog.text


def test_profile_dir_is_logged_as_ignored_under_train(tmp_path, caplog):
    """A whole training run under the profiler is unbounded: train takes no profile."""
    caplog.set_level("INFO", logger=cli.LOGGER.name)
    with pytest.raises(SystemExit, match="No encoder"):
        cli.run({"command": "train", "profile_dir": str(tmp_path / "profile")})
    assert "profile_dir is ignored under command=train" in caplog.text
    assert not (tmp_path / "profile").exists()


def test_compilation_cache_dir_is_logged_as_ignored(tmp_path, caplog):
    """++compilation_cache_dir, which the JAX CLI applies before it checks the
    command (fitclip_tpu/cli/main.py:146-154), is logged as ignored: the
    port's kernels build once by their sources' hash."""
    caplog.set_level("INFO", logger=cli.LOGGER.name)
    with pytest.raises(SystemExit, match="Unknown command"):
        cli.run({"command": "bogus", "compilation_cache_dir": str(tmp_path / "cache")})
    assert "compilation_cache_dir is ignored" in caplog.text
    assert not (tmp_path / "cache").exists()


# --- int8: calibration on the head batches, teacher-forced ------------------------

INT8_CONFIG = CLIPConfig(embed_dim=32,
                         vision=VisionConfig(image_size=32, patch_size=16, width=64, layers=2,
                                             heads=1),
                         text=TextConfig(context_length=16, vocab_size=640, width=64, layers=2,
                                         heads=1))
# The int8 encoder's activations are bf16: a step (ulp) is at most 2^-7 of a
# value. XLA may take a site's abs-max, or sum a residual, at fp32 before the
# bf16 rounding (excess precision) where the port rounds each bf16 result, so
# JAX's scale and the abs-max of the bf16 input the port sees part by up to
# half a step, and the inputs the port computes are held within two steps of
# the largest.
BF16_STEP = 2 ** -7


def _jax_inputs(jax_cfg, qtree, frames, ids):
    """JAX's calibration forward (both towers in dynamic-quant mode, bf16) with
    the input of each layer and of each int8 site sown:
    {(tower, "layer" or the site's path in the layer): (layers, ...) fp32}."""
    def sow_input(next_fun, args, kwargs, context):
        if context.method_name == "__call__" and isinstance(
                context.module, (jax_clip_model.ResidualBlock, jax_clip_model.QuantDense)):
            context.module.sow("intermediates", "input", args[0])
        return next_fun(*args, **kwargs)

    def flat(node, prefix=""):
        for key, child in node.items():
            if key == "input":
                yield prefix[:-1] or "layer", np.asarray(child[0], np.float32)
            elif isinstance(child, dict):
                yield from flat(child, f"{prefix}{key}/")

    model = jax_clip_model.CLIPModel(jax_cfg, dtype=jnp.bfloat16, quantized="dynamic")
    inputs = {}
    with flax_nn.intercept_methods(sow_input):
        for tower, method, x in (("visual", jax_clip_model.CLIPModel.encode_image, frames),
                                 ("text", jax_clip_model.CLIPModel.encode_text, ids)):
            _, state = model.apply({"params": qtree}, x, method=method,
                                   mutable=["intermediates"])
            node = state["intermediates"][tower]["transformer"]["blocks"]
            inputs.update({(tower, path): value for path, value in flat(node)})
    return inputs


def teacher_forced_calibration(jax_encoder, qtree, computed, jax_seen):
    """A stand-in for runners._calibrate_on_batches: the port's own calibration,
    with each ``collect_act_amax`` call teacher-forced. Each layer and each
    int8 site of both towers computes its input (recorded in ``computed``)
    and goes on with JAX's input to it (recorded in ``jax_seen``)."""
    calibrate = runners._calibrate_on_batches

    def forced(encoder, observations, quant_cfg):
        collect = encoder.collect_act_amax

        def collect_forced(video, text):
            jax_inputs = _jax_inputs(jax_encoder.config, qtree,
                                     jax_encoder._prepare_frames(jnp.asarray(video.numpy())),
                                     jnp.asarray(text.numpy().astype(np.int32)))
            hooks = []

            def substitute(key, layer):
                def hook(module, args):
                    computed.setdefault(key, []).append(args[0].float().clone())
                    jax_seen.setdefault(key, []).append(jax_inputs[key][layer])
                    return (torch.from_numpy(jax_inputs[key][layer]).to(args[0].dtype),)
                return hook

            for tower, tower_module in (("visual", encoder.model.visual),
                                        ("text", encoder.model.text)):
                for i, layer in enumerate(tower_module.transformer.blocks):
                    hooks.append(layer.register_forward_pre_hook(substitute((tower, "layer"), i)))
                    for path, (site,) in quant.act_scale_sites(layer).items():
                        hooks.append(site.register_forward_pre_hook(substitute((tower, path), i)))
            try:
                return collect(video, text)
            finally:
                for hook in hooks:
                    hook.remove()

        encoder.collect_act_amax = collect_forced
        try:
            return calibrate(encoder, observations, quant_cfg)
        finally:
            del encoder.collect_act_amax

    return forced


def test_int8_calibration_writes_jax_scales_teacher_forced(vocab, tmp_path_factory, monkeypatch,
                                                           capsys):
    """10 videos in batches of 8 (the head batch is whole, so JAX pads no rows
    into it), calibrated on the first batch. The port's CLI writes JAX's
    act-scales (every site's abs-max is taken on JAX's input to it), each
    input the port computed from JAX's input where the previous one took it
    is within two bf16 steps of JAX's, and predict then reads the persisted
    scales (no second calibration)."""
    merges, _ = vocab
    root = tmp_path_factory.mktemp("int8")
    msrvtt_root = _msrvtt_tree(root / "msrvtt", 10)
    checkpoint = _save(root / "clip.pt", openai_state_dict(INT8_CONFIG, seed=11))
    monkeypatch.setenv("MSRVTT_PATH", msrvtt_root)
    common = ["data=msrvtt", "data.eval_batch_size=8", "+data.num_threads=2",
              "++quant.calibration_batches=1"]

    jax_cfg = jax_compose(DEFAULT_CONFIG_DIR, "trainer", [
        "command=evaluate", "encoder=clip_vit_b_16", "++encoder.dtype=int8",
        f"+encoder.checkpoint_path={checkpoint}", f"+encoder.bpe_path={merges}",
        f"++quant.scales_path={root / 'jax.npz'}", *common])
    jax_run(jax_cfg)
    capsys.readouterr()
    jax_encoder = jax_load.load_clip_encoder(checkpoint_path=checkpoint, dtype="int8",
                                             bpe_path=merges)
    qtree = jax.tree_util.tree_map(np.asarray, jax_encoder.params)

    computed, jax_seen = {}, {}
    monkeypatch.setattr(runners, "_calibrate_on_batches",
                        teacher_forced_calibration(jax_encoder.encoder, qtree, computed,
                                                   jax_seen))
    port = ["encoder=clip_vit_b_16", "++encoder.dtype=int8", "++encoder.device=cpu",
            f"+encoder.checkpoint_path={checkpoint}", f"+encoder.bpe_path={merges}",
            f"++quant.scales_path={root / 'port.npz'}", *common]
    cli.main(["command=evaluate", *port])
    metrics = _printed_metrics(capsys)
    assert set(metrics) == {"r1", "r5", "r10", "mr"}

    with np.load(root / "port.npz") as got, np.load(root / "jax.npz") as want:
        assert sorted(got.files) == sorted(want.files) and len(want.files) == 8
        for site in want.files:
            assert not np.all(want[site] == 1.0)
            np.testing.assert_allclose(got[site], want[site], rtol=BF16_STEP / 2, err_msg=site)
    assert sorted(computed) == sorted(jax_seen) and len(computed) == 10
    for key, values in computed.items():
        assert len(values) == 2  # one head batch, two layers
        for x, ref in zip(values, jax_seen[key]):
            scale = float(np.abs(ref).max())
            np.testing.assert_allclose(x.numpy(), ref, rtol=2 * BF16_STEP,
                                       atol=2 * BF16_STEP * scale, err_msg=str(key))

    # predict reads the persisted scales: calibration does not run again.
    computed.clear()
    cli.main(["command=predict", *port, f"+output_path={root / 'predictions.pt'}"])
    assert not computed
    predictions = torch.load(str(root / "predictions.pt"), weights_only=False)
    assert predictions["encoded_videos"].shape == (10, 32)
    assert bool(torch.isfinite(predictions["encoded_texts"]).all())


# --- predict through each ported family's config (F5) ------------------------------

BERT_WORDS = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", *dict.fromkeys(WORDS)]


def _family_encoder(family, tmp_path, vocab):
    """(config overrides, env, the factory called directly) of one family at the
    config's widths (FiT's and SLIP's, and VideoCLIP's BERT, at their tiny_test
    configs' widths: the test holds the factory's wiring, which no width
    changes), seeded, with a vocabulary the test writes."""
    from fitclip_torch.models import mil_nce, slip, videoclip
    from fitclip_torch.models.frozen_in_time import load as fit_load

    merges, _ = vocab
    (tmp_path / "vocab.txt").write_text("\n".join(BERT_WORDS) + "\n")
    np.save(tmp_path / "s3d_dict.npy", np.array(BERT_WORDS[5:]))
    bert = str(tmp_path / "vocab.txt")
    if family == "frozen_in_time":
        return ([], {"DISTILBERT_VOCAB": bert},
                lambda: fit_load.load_frozen_in_time_encoder(vocab_path=bert, device="cpu"))
    if family == "slip":
        return (["++encoder.model=SLIP_VITS16", f"+encoder.bpe_path={merges}"], {},
                lambda: slip.load_slip_encoder(model="SLIP_VITS16", bpe_path=merges,
                                               device="cpu"))
    if family == "mil_nce":
        npy = str(tmp_path / "s3d_dict.npy")
        return (["++encoder.num_frames=8"], {"MIL_NCE_VOCAB": npy},
                lambda: mil_nce.load_mil_nce_encoder(vocab_path=npy, num_frames=8,
                                                     device="cpu"))
    return ([], {"BERT_VOCAB": bert},
            lambda: videoclip.load_videoclip_encoder(vocab_path=bert, device="cpu"))


@pytest.mark.parametrize("family", ["frozen_in_time", "slip", "mil_nce", "videoclip"])
def test_predict_builds_each_family_from_its_config(vocab, family, tmp_path_factory,
                                                    monkeypatch):
    """``command=predict encoder=<family>`` through the config's factory (FiT's
    names ``fitclip_tpu.models.frozen_in_time.encoder``): the embeddings of the
    family's encoder called directly on the same clips. The JAX factories take
    no tiny config, so the port's own encoder is the reference here."""
    from fitclip_torch.data.datasets.msrvtt import MsrVttDataModule

    root = tmp_path_factory.mktemp(family)
    msrvtt_root = _msrvtt_tree(root / "msrvtt", 2)
    if family == "frozen_in_time":
        from fitclip_torch.models.frozen_in_time import encoder as fit_encoder
        from fitclip_torch.models.frozen_in_time import load as fit_load

        tiny = fit_encoder.FrozenInTimeConfig.tiny_test()
        tiny = dataclasses.replace(tiny, text=dataclasses.replace(tiny.text,
                                                                  max_position_embeddings=512))
        monkeypatch.setattr(fit_load, "FrozenInTimeConfig",
                            lambda num_frames: dataclasses.replace(tiny, num_frames=num_frames))
    if family == "videoclip":
        from fitclip_torch.models import videoclip

        tiny = videoclip.BertConfig.tiny_test(vocab_size=128)  # [CLS] is id 101, as in BERT
        monkeypatch.setattr(videoclip, "BertConfig", lambda: tiny)
    if family == "slip":
        from fitclip_torch.models import slip
        from fitclip_torch.models.clip.tokenizer import ClipTokenizer

        size = ClipTokenizer(bpe_path=vocab[0]).vocab_size
        monkeypatch.setitem(slip.SLIP_MODEL_CONFIGS, "VITS16",
                            lambda: slip.SlipConfig.tiny_test(vocab_size=size))
    overrides, env, direct = _family_encoder(family, root, vocab)
    for key, value in {"MSRVTT_PATH": msrvtt_root, **env}.items():
        monkeypatch.setenv(key, value)
    out = root / "predictions.pt"
    cli.main(["command=predict", f"encoder={family}", *overrides, "++encoder.device=cpu",
              "data=msrvtt", "data.eval_batch_size=2", "+data.num_threads=2",
              f"+output_path={out}"])
    got = torch.load(str(out), weights_only=False)
    assert got["video_ids"] == ["video0", "video1"]
    encoder = direct()
    batch = next(iter(MsrVttDataModule(base_path=msrvtt_root, encoder=encoder,
                                       eval_batch_size=2, num_threads=2).val_dataloader()))
    with torch.no_grad():
        want = {"encoded_videos": encoder.encode_video(torch.from_numpy(batch["video"])),
                "encoded_texts": encoder.encode_text(runners.to_device(batch["text"], "cpu"))}
    for key, value in want.items():
        assert got[key].shape == value.shape and bool(torch.isfinite(got[key]).all())
        np.testing.assert_allclose(got[key].numpy(), value.float().numpy(), atol=2e-4,
                                   rtol=2e-4, err_msg=key)
