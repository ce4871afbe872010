"""``python -m fitclip_torch command=train`` (fitclip_torch/cli, training/) against
the JAX package's CLI (``fitclip_tpu.cli.main.run``) on tiny fixtures, on the
CPU (``++encoder.device=cpu``):

- contrastive (config/trainer.yaml, data=webvid), teacher-student over
  ``data=mixed_batch_webvid_4_5k_all`` (float teacher) and
  ``--config-name drift_eval_trainer``: the logged losses at rtol 1e-5, the
  final params at atol 5e-5 with lr 1e-4 (the key third of each in_proj bias
  at 2 * lr a step: its exact gradient is 0, tests/test_torch_train_step.py),
  the validation metrics equal. Both packages start from the port's seeded
  tiny CLIP (``jax_tiny_encoder`` carries it to JAX by convert/from_jax.py);
- the JAX CLI keys a train-and-eval module's validation ``r10_0``,
  ``r10_1``, ... (it finds no ``names``); the port keys each member by its eval
  group's name (``r10_cc3m``, ...), so the two are held equal by position;
- the port alone: resume bit for bit through the CLI in both modes (1 step,
  then a mid-epoch resume to 4, equals 4 straight), ``command=evaluate`` of a
  train-state file, a bare-params checkpoint into the student, the
  ``trainer.logger`` sink, and ``trainer.callbacks.param_freeze_patterns``.

The JAX runs use one CPU device (``one_device_mesh``: the port runs on one,
and each of the test mesh's 8 devices would compute the whole replicated
step), drop the checkpoint callback (an Orbax save takes seconds and
checkpoints change no number) and their TensorBoard events (importing
TensorFlow takes longer than the run); their final state is taken from
``run_train``'s return. Both packages decode with OpenCV (``opencv_only``).
"""

import contextlib
import functools
import io
import json
import os

import jax
import numpy as np
import pytest
import torch

from fitclip_tpu.cli import runners as jax_runners
from fitclip_tpu.cli import train_runner as jax_train_runner
from fitclip_tpu.cli import tune as jax_tune
from fitclip_tpu.cli.main import DEFAULT_CONFIG_DIR
from fitclip_tpu.cli.main import run as jax_run
from fitclip_tpu.config_engine import compose as jax_compose
from fitclip_tpu.models.clip.encoder import ClipVideoTextEncoder as JaxEncoder
from fitclip_tpu.models.clip.load import LoadedEncoder as JaxLoadedEncoder
from fitclip_tpu.models.clip.model import CLIPConfig as JaxConfig
from fitclip_tpu.models.clip.tokenizer import ClipTokenizer as JaxTokenizer
from fitclip_tpu.models.clip.tokenizer import write_tiny_test_vocab
from fitclip_tpu.parallel import create_mesh
from fitclip_torch.cli import main as cli
from fitclip_torch.convert.from_jax import params_to_jax
from fitclip_torch.data import video_reader
from fitclip_torch.models.clip.model import CLIPConfig, CLIPModel, init_float_params
from fitclip_torch.training.checkpointing import is_full_train_state, load_checkpoint
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

LR = 1e-4
WORDS = ["a", "cat", "video", "of", "dog", "man", "the", "car", "red", "clip"]
FRAMES = 4


def jax_tiny_encoder(seed: int = 0, bpe_path=None, vocab_path=None, num_frames: int = FRAMES):
    """The JAX tiny CLIP with the port's seeded params (``load_tiny_test_encoder``
    of the port): both packages start from one tree, and JAX compiles no init."""
    tokenizer = JaxTokenizer(bpe_path=bpe_path, vocab_path=vocab_path, context_length=16)
    cfg = CLIPConfig.tiny_test(vocab_size=tokenizer.vocab_size)
    tree = params_to_jax(init_float_params(CLIPModel(cfg), seed).state_dict(), cfg)
    encoder = JaxEncoder(JaxConfig.tiny_test(vocab_size=tokenizer.vocab_size),
                         num_frames=num_frames, tokenizer=tokenizer)
    return JaxLoadedEncoder(encoder=encoder, params=jax.tree_util.tree_map(np.asarray, tree))


def one_device_mesh(mp):
    """The JAX CLI on one CPU device, as the port runs on one: the test mesh's
    8 devices would each compute the whole replicated step."""
    for module in (jax_train_runner, jax_runners, jax_tune):
        mp.setattr(module, "create_mesh", lambda: create_mesh(jax.devices()[:1]))


def write_clip(path, seed, num_frames=12, size=(64, 48)):
    """Seeded content (a low-resolution image upscaled and drifting); mp4v in an
    .mp4, MJPG otherwise."""
    import cv2

    path.parent.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    base = cv2.resize(rng.integers(0, 256, (6, 8, 3), dtype=np.uint8), size,
                      interpolation=cv2.INTER_LINEAR)
    fourcc = "mp4v" if path.suffix == ".mp4" else "MJPG"
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*fourcc), 10.0, size)
    assert writer.isOpened()
    for t in range(num_frames):
        writer.write(np.roll(base, (t, 2 * t), axis=(0, 1)))
    writer.release()


def _caption(rng, i):
    return " ".join(rng.choice(WORDS, size=3)) + f" {WORDS[i % len(WORDS)]}"


def write_trees(root):
    """WebVid train (8 clips) and val (4), MSR-VTT val (3) and CC3M val (3
    images) trees; returns the env settings that point the configs at them."""
    import cv2

    rng = np.random.default_rng(0)
    env = {}
    for split, count in (("train", 8), ("val", 4)):
        rows = ["videoid,name"]
        for i in range(count):
            write_clip(root / "webvid" / split / f"{split}{i}.mp4", seed=10 * count + i)
            rows.append(f"{split}{i},{_caption(rng, i)}")
        (root / "webvid" / f"{split}.csv").write_text("\n".join(rows) + "\n")
        env[f"WEBVID_{split.upper()}_CSV"] = str(root / "webvid" / f"{split}.csv")
        env[f"WEBVID_{split.upper()}_VIDEOS"] = str(root / "webvid" / split)
    env["WEBVID_TRAIN_4_5K_CSV"] = env["WEBVID_TRAIN_CSV"]
    msrvtt = root / "msrvtt"
    for i in range(3):
        write_clip(msrvtt / "videos" / "all" / f"video{i}.avi", seed=200 + i)
    (msrvtt / "structured-symlinks").mkdir()
    (msrvtt / "structured-symlinks" / "val_list_jsfusion.txt").write_text(
        "\n".join(f"video{i}" for i in range(3)))
    (msrvtt / "annotation").mkdir()
    (msrvtt / "annotation" / "MSR_VTT.json").write_text(json.dumps({"annotations": [
        {"image_id": f"video{i}", "caption": _caption(rng, i)} for i in range(3)]}))
    env["MSRVTT_PATH"] = str(msrvtt)
    images = root / "cc3m" / "val"
    images.mkdir(parents=True)
    rows = []
    for i in range(3):
        cv2.imwrite(str(images / f"{i:08d}.jpg"), cv2.resize(
            rng.integers(0, 256, (6, 8, 3), dtype=np.uint8), (64, 48)))
        rows.append(f'"{_caption(rng, i)}",http://images.invalid/{i}.jpg,{i:08d}.jpg')
    (root / "cc3m" / "val.csv").write_text("\n".join(rows) + "\n")
    env.update(CC3M_VAL_TSV=str(root / "cc3m" / "val.csv"), CC3M_VAL_IMAGES=str(images))
    return env


@pytest.fixture(scope="module", autouse=True)
def environment(tmp_path_factory):
    """OpenCV decoding in both packages, and the trees' settings."""
    env = write_trees(tmp_path_factory.mktemp("trees"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(video_reader, "_native_reader", lambda: None)
        for key, value in env.items():
            mp.setenv(key, value)
        yield env


@pytest.fixture(scope="module")
def vocab(tmp_path_factory):
    return write_tiny_test_vocab(str(tmp_path_factory.mktemp("vocab")), WORDS)


def _port_encoder(vocab, slot="encoder", seed=0):
    """Overrides that put the port's seeded tiny CLIP in an encoder slot."""
    merges, vocab_json = vocab
    return [f"{slot}._target_=fitclip_tpu.models.clip.load.load_tiny_test_encoder",
            f"~{slot}.name", f"+{slot}.bpe_path={merges}", f"+{slot}.vocab_path={vocab_json}",
            f"+{slot}.seed={seed}", f"++{slot}.device=cpu"]


def _jax_encoder(vocab, seed=0):
    merges, vocab_json = vocab
    return {"_target_": f"{__name__}.jax_tiny_encoder", "seed": seed, "bpe_path": merges,
            "vocab_path": vocab_json}


def _common(workdir, *extra):
    return ["trainer.max_epochs=1", f"optimizer.lr={LR}", "trainer.log_every_n_steps=1",
            f"+log_dir={workdir}/logs", f"trainer.callbacks.checkpoint.dirpath={workdir}/ckpt",
            "trainer.callbacks.checkpoint.every_n_epochs=0", *extra]


CONTRASTIVE = ["command=train", "encoder=clip_vit_b_16", "data=webvid", "data.batch_size=2",
               "+data.num_threads=2", "data.eval_batch_size=4", "model.fit_temperature=true"]
TEACHER_STUDENT = ["command=train", "+encoder@encoder.student=clip_vit_b_16",
                   "+encoder@encoder.teacher=clip_vit_b_16",
                   "data=mixed_batch_webvid_4_5k_all", "++model.labeled_dataset_loss_share=0.7",
                   "data.train_sequence_sizes.labeled=2",
                   "data.train_sequence_sizes.unlabeled=2",
                   "data.data_modules.labeled.batch_size=2",
                   "data.data_modules.unlabeled.batch_size=2",
                   "+data.data_modules.labeled.num_threads=2",
                   "+data.data_modules.unlabeled.num_threads=2",
                   "data.data_modules.labeled.eval_batch_size=4",
                   "data.data_modules.unlabeled.eval_batch_size=4",
                   "trainer.val_check_interval=1.0"]
DRIFT = ["command=train", "encoder=clip_vit_b_16", "data.train_data_module.batch_size=2",
         "+data.train_data_module.num_threads=2",
         *(f"data.eval_data_module.data_modules.{m}.eval_batch_size=4"
           for m in ("cc3m", "msrvtt", "webvid")),
         "trainer.val_check_interval=0.5"]


def _jax_train(config_name, overrides, encoder, workdir):
    """The JAX CLI's command=train without its checkpoint callback: (run's
    return, run_train's return, metrics.jsonl entries without their time)."""
    cfg = jax_compose(DEFAULT_CONFIG_DIR, config_name,
                      [*overrides, *_common(workdir), "~trainer.callbacks.checkpoint"])
    cfg["encoder"] = encoder
    results = []

    def recording(*args, **kwargs):
        results.append(run_train(*args, **kwargs))
        return results[-1]

    run_train = jax_train_runner.run_train
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_train_runner, "run_train", recording)
        mp.setattr(jax_train_runner, "MetricsLogger",
                   functools.partial(jax_train_runner.MetricsLogger, use_tensorboard=False))
        one_device_mesh(mp)
        value = jax_run(cfg)
    return value, results[0], _logged(workdir)


def _logged(workdir):
    entries = [json.loads(line) for line in
               (workdir / "logs" / "metrics.jsonl").read_text().splitlines()]
    return [{k: v for k, v in entry.items() if k != "time"} for entry in entries]


def _port_train(argv, workdir):
    """The port's CLI: (printed value or None, the train state of ckpt/last,
    metrics.jsonl entries without their time)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli.main([*argv, *_common(workdir)])
    last = workdir / "ckpt" / "last"
    assert is_full_train_state(str(last))
    return out.getvalue(), load_checkpoint(str(last)), _logged(workdir)


@pytest.fixture(scope="module")
def jax_contrastive(vocab, tmp_path_factory):
    return _jax_train("trainer", CONTRASTIVE, _jax_encoder(vocab),
                      tmp_path_factory.mktemp("jax_contrastive"))


@pytest.fixture(scope="module")
def jax_teacher_student(vocab, tmp_path_factory):
    encoder = {"student": _jax_encoder(vocab, seed=0), "teacher": _jax_encoder(vocab, seed=1)}
    return _jax_train("teacher_student_trainer", TEACHER_STUDENT, encoder,
                      tmp_path_factory.mktemp("jax_teacher_student"))


@pytest.fixture(scope="module")
def jax_drift(vocab, tmp_path_factory):
    return _jax_train("drift_eval_trainer", DRIFT, _jax_encoder(vocab),
                      tmp_path_factory.mktemp("jax_drift"))


def _assert_params_match(port_state, jax_state, steps):
    """The port's train-state params against JAX's final TrainState params."""
    cfg = CLIPConfig.tiny_test(vocab_size=port_state["params"][
        "encoder.text.token_embedding"].shape[0])
    prefix = "encoder."
    port_tree = params_to_jax({k[len(prefix):]: v for k, v in port_state["params"].items()
                               if k.startswith(prefix)}, cfg)
    ref = jax.device_get(jax_state.params)
    width = {"visual": cfg.vision.width, "text": cfg.text.width}
    checked = 0
    for path, leaf in jax.tree_util.tree_leaves_with_path(ref["encoder"]):
        keys = [k.key for k in path]
        value, leaf = np.array(_at(port_tree, keys)), np.array(leaf)
        if keys[-2:] == ["in_proj", "bias"]:
            key_bias = slice(width[keys[0]], 2 * width[keys[0]])
            np.testing.assert_allclose(value[:, key_bias], leaf[:, key_bias],
                                       atol=2 * LR * steps, rtol=0)
            value[:, key_bias] = leaf[:, key_bias]
        np.testing.assert_allclose(value, leaf, atol=5e-5, rtol=0, err_msg=str(keys))
        checked += 1
    assert checked > 20
    for key in ("logit_scale", "ts_logit_scale"):
        if key in ref:
            np.testing.assert_allclose(port_state["params"][key].numpy(),
                                       np.asarray(ref[key]), atol=5e-5, rtol=0)


def _at(tree, keys):
    for key in keys:
        tree = tree[key]
    return tree


def _losses(entries):
    return [{k: v for k, v in e.items() if k.startswith(("loss/", "temperature"))}
            for e in entries if "loss/train" in e]


def _assert_losses_match(got, want):
    got, want = _losses(got), _losses(want)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for key in w:
            np.testing.assert_allclose(g[key], w[key], rtol=1e-5, err_msg=key)


def _validations(entries):
    return [{k: v for k, v in e.items() if k != "step"} for e in entries
            if "loss/train" not in e]


def test_contrastive_train_matches_jax(vocab, jax_contrastive, tmp_path):
    """4 steps of 2 clips (8 train clips, one epoch), then validation on the
    4 val clips: config/trainer.yaml with the temperature fitted."""
    _, jax_result, jax_logged = jax_contrastive
    _, state, logged = _port_train([*CONTRASTIVE, *_port_encoder(vocab)], tmp_path)
    assert state["step"] == 4
    _assert_losses_match(logged, jax_logged)
    _assert_params_match(state, jax_result["state"], steps=4)
    assert _validations(logged) == _validations(jax_logged)
    assert set(_validations(logged)[-1]) == {"r1", "r5", "r10", "mr"}


def test_teacher_student_train_matches_jax(vocab, jax_teacher_student, tmp_path):
    """--config-name teacher_student_trainer over mixed_batch_webvid_4_5k_all:
    2 + 2 clips a step (the longest source, 8 clips, runs once: 4 steps), a
    float teacher, then validation of the student on each member's val loader."""
    _, jax_result, jax_logged = jax_teacher_student
    argv = ["--config-name", "teacher_student_trainer", *TEACHER_STUDENT,
            *_port_encoder(vocab, "encoder.student", seed=0),
            *_port_encoder(vocab, "encoder.teacher", seed=1)]
    _, state, logged = _port_train(argv, tmp_path)
    assert state["step"] == 4 and "ts_logit_scale" in state["params"]
    _assert_losses_match(logged, jax_logged)
    assert {"loss/train_labeled", "loss/train_unlabeled"} <= set(_losses(logged)[0])
    _assert_params_match(state, jax_result["state"], steps=4)
    validations = _validations(logged)
    assert validations == _validations(jax_logged)
    assert {"r1_labeled", "r1_unlabeled"} <= set(validations[-1])


def test_drift_eval_train_matches_jax_by_member_position(vocab, jax_drift, tmp_path):
    """--config-name drift_eval_trainer (train on webvid4_5k, validate on the
    drift_eval group twice an epoch): the same training, and the validation
    values equal JAX's member by member. JAX keys them by position (r10_0,
    r10_1, r10_2: a train-and-eval module has no names), the port by the eval
    group's names, so optimized_metric_name r10_cc3m is found."""
    jax_value, jax_result, jax_logged = jax_drift
    printed, state, logged = _port_train(
        ["--config-name", "drift_eval_trainer", *DRIFT, *_port_encoder(vocab)], tmp_path)
    assert state["step"] == 4
    _assert_losses_match(logged, jax_logged)
    _assert_params_match(state, jax_result["state"], steps=4)
    port_validations, jax_validations = _validations(logged), _validations(jax_logged)
    assert len(port_validations) == len(jax_validations) == 2
    members = ("cc3m", "msrvtt", "webvid")
    for got, want in zip(port_validations, jax_validations):
        assert sorted(got) == sorted(f"{k}_{m}" for k in ("r1", "r5", "r10", "mr")
                                     for m in members)
        assert sorted(want) == sorted(f"{k}_{i}" for k in ("r1", "r5", "r10", "mr")
                                      for i in range(3))
        for i, member in enumerate(members):
            for key in ("r1", "r5", "r10", "mr"):
                assert got[f"{key}_{member}"] == want[f"{key}_{i}"], (key, member)
    assert jax_value is None  # JAX never finds r10_cc3m
    assert float(printed.strip().splitlines()[-1]) == port_validations[-1]["r10_cc3m"]


# --- the port alone ------------------------------------------------------------------

def _resume_argv(vocab, mode, workdir, *extra):
    """Two epochs of two steps: batches of 4 clips (4 + 4 in teacher-student)."""
    if mode == "contrastive":
        argv = [*CONTRASTIVE, *_port_encoder(vocab), "data.batch_size=4"]
    elif mode == "resnet_contrastive":
        argv = [*CONTRASTIVE, *_port_encoder(vocab), "data.batch_size=4",
                "encoder._target_=fitclip_tpu.models.clip.load.load_tiny_rn_test_encoder"]
    else:
        argv = ["--config-name", "teacher_student_trainer", *TEACHER_STUDENT,
                *_port_encoder(vocab, "encoder.student", seed=0),
                *_port_encoder(vocab, "encoder.teacher", seed=1),
                "data.train_sequence_sizes.labeled=4", "data.train_sequence_sizes.unlabeled=4"]
    return [*argv, *_common(workdir), "trainer.max_epochs=2", "optimizer.lr=1e-3",
            "trainer.val_check_interval=1.0", *extra]


@pytest.mark.parametrize("mode", ["contrastive", "teacher_student", "resnet_contrastive"])
def test_resume_through_the_cli_is_bit_identical(vocab, mode, tmp_path):
    """4 steps straight (2 epochs of 2) against 1 step, then
    ``+checkpoint_path=<last> +trainer.max_steps=4``: the resumed run re-reads
    the partly trained epoch and drops the batch it has seen. A tiny CLIP
    ResNet's running statistics, moved by their EMA, are in the checkpoint and
    resume with the rest, frozen to the optimizer (no moment)."""
    cli.main(_resume_argv(vocab, mode, tmp_path / "straight"))
    straight = load_checkpoint(str(tmp_path / "straight" / "ckpt" / "last"))
    assert straight["step"] == 4
    cli.main(_resume_argv(vocab, mode, tmp_path / "resumed", "+trainer.max_steps=1"))
    last = tmp_path / "resumed" / "ckpt" / "last"
    assert load_checkpoint(str(last))["step"] == 1
    cli.main(_resume_argv(vocab, mode, tmp_path / "resumed", "+trainer.max_steps=4",
                          f"+checkpoint_path={last}"))
    resumed = load_checkpoint(str(last))
    assert resumed["step"] == 4 and resumed["opt_state"]["count"] == 4
    assert set(resumed["params"]) == set(straight["params"])
    for name, value in straight["params"].items():
        assert torch.equal(resumed["params"][name], value), name
        for key in ("mu", "nu"):
            assert torch.equal(resumed["opt_state"][key][name],
                               straight["opt_state"][key][name]), (key, name)
    assert torch.equal(resumed["max_logit_scale"], straight["max_logit_scale"])
    if mode == "resnet_contrastive":
        from fitclip_torch.models.clip.load import load_tiny_rn_test_encoder

        merges, vocab_json = vocab
        seeded = load_tiny_rn_test_encoder(seed=0, bpe_path=merges, vocab_path=vocab_json,
                                           device="cpu").encoder.model.state_dict()
        stats = [n for n in straight["params"] if n.endswith(("running_mean", "running_var"))]
        assert len(stats) == 2 * 19
        for name in stats:
            assert not torch.equal(straight["params"][name], seeded[name[len("encoder."):]])
            assert straight["opt_state"]["mu"][name].dim() == 0, name


def _printed_metrics(out):
    return json.loads(out[out.index("{"): out.rindex("}") + 1])


def test_evaluate_takes_the_encoder_of_a_train_state(vocab, tmp_path, capsys):
    """``command=evaluate +checkpoint_path=<ckpt/last>`` scores the trained
    weights: its metrics are RetrievalEvaluator's over the train state's encoder
    called directly, and differ from the untrained encoder's embeddings."""
    from fitclip_torch.cli.runners import run_eval
    from fitclip_torch.data.datasets.webvid import WebVidDataModule
    from fitclip_torch.models.clip.load import load_tiny_test_encoder

    merges, vocab_json = vocab
    cli.main([*CONTRASTIVE, *_port_encoder(vocab), *_common(tmp_path), "optimizer.lr=1e-2"])
    capsys.readouterr()
    last = tmp_path / "ckpt" / "last"
    cli.main(["command=evaluate", "encoder=clip_vit_b_16", *_port_encoder(vocab),
              "data=webvid", "data.eval_batch_size=4", "+data.num_threads=2",
              f"+checkpoint_path={last}"])
    printed = _printed_metrics(capsys.readouterr().out)

    trained = load_tiny_test_encoder(seed=0, bpe_path=merges, vocab_path=vocab_json,
                                     device="cpu")
    untrained = load_tiny_test_encoder(seed=0, bpe_path=merges, vocab_path=vocab_json,
                                       device="cpu")
    state = load_checkpoint(str(last))["params"]
    trained.encoder.model.load_state_dict(
        {k[len("encoder."):]: v for k, v in state.items() if k.startswith("encoder.")})
    data = WebVidDataModule(
        val_video_info_file_path=os.environ["WEBVID_VAL_CSV"],
        val_videos_folder=os.environ["WEBVID_VAL_VIDEOS"], encoder=trained,
        eval_batch_size=4, num_threads=2)
    assert printed == run_eval(trained, data)
    batch = next(iter(data.val_dataloader()))
    with torch.no_grad():
        video = torch.from_numpy(batch["video"])
        moved = (trained.encode_video(video) - untrained.encode_video(video)).abs().max()
    assert float(moved) > 1e-3


def test_bare_params_checkpoint_goes_into_the_student(vocab, tmp_path):
    """A {student, teacher} slot under command=train: a bare-params torch file
    in OpenAI's layout replaces the student's weights before the first step
    (at lr 0 they stay as loaded), as ``load_checkpoint`` loads them into the
    encoder alone."""
    from fitclip_torch.models.clip.load import load_tiny_test_encoder

    from tests.test_torch_convert_state_dict import _save, openai_state_dict

    merges, vocab_json = vocab
    reference = load_tiny_test_encoder(seed=0, bpe_path=merges, vocab_path=vocab_json,
                                       device="cpu")
    path = _save(tmp_path / "bare.pt", openai_state_dict(reference.encoder.config, seed=7))
    cli.main(["--config-name", "teacher_student_trainer", *TEACHER_STUDENT,
              *_port_encoder(vocab, "encoder.student", seed=0),
              *_port_encoder(vocab, "encoder.teacher", seed=1), *_common(tmp_path),
              "optimizer.lr=0.0", "optimizer.weight_decay=0.0", "+trainer.max_steps=1",
              f"+checkpoint_path={path}"])
    state = load_checkpoint(str(tmp_path / "ckpt" / "last"))["params"]
    seeded = {k: v.clone() for k, v in reference.encoder.model.state_dict().items()}
    want = cli.load_checkpoint(reference, str(path)).encoder.model.state_dict()
    assert not torch.equal(want["visual.proj"], seeded["visual.proj"])
    for name, value in want.items():
        assert torch.equal(state[f"encoder.{name}"], value), name


class RecordingSink:
    """A tracker stand-in for trainer.logger: writes each call to a file (the
    config engine may import this module under another name)."""

    def __init__(self, tag="sink", out_path=None):
        self.tag, self.out_path = tag, out_path

    def log(self, metrics, step):
        cudnn = [torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic]
        with open(self.out_path, "a") as file:
            file.write(json.dumps({"tag": self.tag, "step": step, "metrics": dict(metrics),
                                   "cudnn": cudnn}) + "\n")

    def close(self):
        with open(self.out_path, "a") as file:
            file.write(json.dumps({"closed": True}) + "\n")


def test_pluggable_logger_sink_and_freeze_patterns(vocab, tmp_path, monkeypatch):
    """``++trainer.logger._target_=...`` receives every logged dict and is
    closed at the end (tests/test_cli.py::test_pluggable_logger_sink);
    ``trainer.callbacks=clip_freeze_text`` leaves the text tower as it was;
    cuDNN runs in float32 on deterministic algorithms while training
    (``utils/precision.py:training_convolutions``), as set before after."""
    out_path = tmp_path / "sink.jsonl"
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", False)
    cli.main([*CONTRASTIVE, *_port_encoder(vocab), *_common(tmp_path),
              "trainer.callbacks=clip_freeze_text", "optimizer.lr=1e-2",
              f"++trainer.logger._target_={__name__}.RecordingSink",
              "++trainer.logger.tag=neptune_like", f"++trainer.logger.out_path={out_path}"])
    records = [json.loads(line) for line in out_path.read_text().splitlines()]
    logged = [r for r in records if "metrics" in r]
    assert [r["step"] for r in logged] == [1, 2, 3, 4, 4]
    assert all(r["tag"] == "neptune_like" and r["cudnn"] == [False, True] for r in logged)
    assert torch.backends.cudnn.allow_tf32 and not torch.backends.cudnn.deterministic
    assert "loss/train" in logged[0]["metrics"] and "r1" in logged[-1]["metrics"]
    assert records[-1] == {"closed": True}
    state = load_checkpoint(str(tmp_path / "ckpt" / "last"))["params"]
    initial = init_float_params(CLIPModel(CLIPConfig.tiny_test(
        vocab_size=state["encoder.text.token_embedding"].shape[0])), 0).state_dict()
    text = [n for n in initial if n.startswith("text.")]
    assert text and all(torch.equal(state[f"encoder.{n}"], initial[n]) for n in text)
    assert not torch.equal(state["encoder.visual.proj"], initial["visual.proj"])
