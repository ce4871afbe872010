"""The eval data layer's other datasets and the grouped eval, against the JAX
package on the CPU, on trees the tests write:

- HMDB51, Moments in Time, DiDeMo, YouCook2 (clip times), WebVid (both
  ``filter_videos_from_info_file`` settings) and CC3M (duplicate filenames,
  captions with commas and quotes): the same ids, targets, categories and
  templates as the JAX modules, and bit-equal uint8 batches;
- the CSV reader types columns as ``pd.read_csv`` does;
- grouped ``command=evaluate`` and ``predict`` over ``data=drift_eval`` and over a
  classification group give the JAX CLI's suffixed metrics and embeddings
  (fp32, 2e-4); in int8 the group calibrates once, on its first loader's head
  batch, to JAX's scales (rtol 2^-8, teacher-forced as in test_torch_cli.py).

Both packages decode with OpenCV (``opencv_only``)."""

import contextlib
import io
import json
import math

import jax
import numpy as np
import pandas as pd
import pytest
import torch

from fitclip_tpu.cli.main import DEFAULT_CONFIG_DIR
from fitclip_tpu.cli.main import run as jax_run
from fitclip_tpu.config_engine import compose as jax_compose
from fitclip_tpu.data.datasets import conceptual_captions as jax_cc
from fitclip_tpu.data.datasets import didemo as jax_didemo
from fitclip_tpu.data.datasets import hmdb as jax_hmdb
from fitclip_tpu.data.datasets import moments_in_time as jax_mit
from fitclip_tpu.data.datasets import webvid as jax_webvid
from fitclip_tpu.data.datasets import youcook2 as jax_youcook2
from fitclip_tpu.models.clip import load as jax_load
from fitclip_tpu.models.clip.tokenizer import write_tiny_test_vocab
from fitclip_torch.cli import main as cli
from fitclip_torch.cli import runners
from fitclip_torch.config_engine import compose
from fitclip_torch.data import video_reader
from fitclip_torch.data.datasets import (conceptual_captions, didemo, hmdb, moments_in_time,
                                         webvid, youcook2)
from fitclip_torch.data.datasets.table import read_table
from fitclip_torch.models.clip import load

from tests.test_torch_cli import (BF16_STEP, INT8_CONFIG, _printed_metrics,
                                  teacher_forced_calibration)
from tests.test_torch_convert_state_dict import _save, openai_state_dict
from tests.test_torch_data import _assert_same_batches, _write_textured_video

WORDS = ["a", "cat", "video", "of", "dog", "person", "cooking", "the", "in"] * 3


@pytest.fixture(scope="module", autouse=True)
def opencv_only():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(video_reader, "_native_reader", lambda: None)
        yield


@pytest.fixture(scope="module")
def vocab(tmp_path_factory):
    return write_tiny_test_vocab(str(tmp_path_factory.mktemp("vocab")), WORDS)


@pytest.fixture(scope="module")
def encoders(vocab):
    merges, vocab_json = vocab
    return (load.load_tiny_test_encoder(bpe_path=merges, vocab_path=vocab_json, device="cpu"),
            jax_load.load_tiny_test_encoder(bpe_path=merges, vocab_path=vocab_json))


def _modules(port_cls, jax_cls, encoders, **kwargs):
    port_enc, jax_enc = encoders
    return (port_cls(encoder=port_enc, num_threads=2, **kwargs),
            jax_cls(encoder=jax_enc, num_threads=2, **kwargs))


def _assert_same_datasets(port_loader, jax_loader):
    got, want = port_loader.dataset, jax_loader.dataset
    assert got.video_paths == want.video_paths
    for i in range(len(want)):
        assert got._get_video_id(i) == want._get_video_id(i)
        assert got._get_target(i) == want._get_target(i)
        assert got._get_times(i) == want._get_times(i)
    _assert_same_batches(list(port_loader), list(jax_loader))


# --- the trees -------------------------------------------------------------------


@pytest.fixture(scope="module")
def hmdb_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("hmdb")
    categories = ["brush_hair", "cartwheel", "ride_bike"]
    (root / "categories.txt").write_text("\n".join(c.replace("_", " ") for c in categories))
    (root / "splits").mkdir()
    for i, category in enumerate(categories):
        lines = []
        for j in range(3):
            name = f"{category}_v{j}.avi"
            _write_textured_video(root / "videos" / category / name, num_frames=10 + j,
                                  seed=40 + 3 * i + j)
            lines.append(f"{name} {1 if j == 0 else 2}")
        (root / "splits" / f"{category}_test_split1.txt").write_text("\n".join(lines) + "\n\n")
        (root / "splits" / f"{category}_test_split2.txt").write_text(f"{category}_v0.avi 2\n")
    return root


def hmdb_kwargs(root):
    return dict(categories_file_path=str(root / "categories.txt"),
                splits_folder=str(root / "splits"), split=1, videos_folder=str(root / "videos"))


def test_hmdb_module_matches_jax(encoders, hmdb_root):
    """Test tag 2 for eval (6 videos), tag 1 for train; underscores to spaces."""
    port_dm, jax_dm = _modules(hmdb.HmdbDataModule, jax_hmdb.HmdbDataModule, encoders,
                               eval_batch_size=4, batch_size=2, **hmdb_kwargs(hmdb_root))
    assert port_dm.categories == jax_dm.categories == \
        {"brush hair": 0, "cartwheel": 1, "ride bike": 2}
    assert port_dm.templates == jax_dm.templates and len(port_dm.templates) == 48
    val = port_dm.val_dataloader()
    _assert_same_datasets(val, jax_dm.val_dataloader())
    assert val.dataset._get_target(0) == ("brush hair", 0) and len(val.dataset) == 6
    train, jax_train = port_dm.train_dataloader(), jax_dm.train_dataloader()
    train.set_epoch(1)
    jax_train.set_epoch(1)
    _assert_same_batches(list(train), list(jax_train))


@pytest.fixture(scope="module")
def mit_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("mit")
    categories = {"cooking": 0, "running": 1, "singing": 2}
    (root / "categories.csv").write_text("\n".join(f"{c},{i}" for c, i in categories.items()))
    rows = []
    for i, category in enumerate(categories):
        for j in range(2):
            rel = f"{category}/clip{j}.avi"
            _write_textured_video(root / "validation" / rel, num_frames=10, seed=60 + 2 * i + j)
            rows.append(f"{rel},{category if j == 0 else list(categories)[(i + 1) % 3]},3,0")
    (root / "validation.csv").write_text("\n".join(rows) + "\n")
    return root


def test_moments_in_time_module_matches_jax(encoders, mit_root):
    """The target comes from the CSV row of "<folder>/<file>", not the folder."""
    port_dm, jax_dm = _modules(
        moments_in_time.MomentsInTimeDataModule, jax_mit.MomentsInTimeDataModule, encoders,
        eval_batch_size=4, categories_file_path=str(mit_root / "categories.csv"),
        val_video_info_file_path=str(mit_root / "validation.csv"),
        val_videos_folder=str(mit_root / "validation"))
    assert port_dm.categories == jax_dm.categories == {"cooking": 0, "running": 1, "singing": 2}
    val = port_dm.val_dataloader()
    _assert_same_datasets(val, jax_dm.val_dataloader())
    assert val.dataset._get_video_id(1) == "cooking/clip1.avi"
    assert val.dataset._get_target(1) == ("running", 1)


@pytest.fixture(scope="module")
def didemo_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("didemo")
    hashes, annotations = [], []
    for i in range(4):
        flickr_id, hash_ = f"{1000 + i}", f"{i:02d}ab{i}cd{i}ef"
        hashes.append(f"{flickr_id}\t{hash_}")
        video = f"user{i}_{flickr_id}_clip.mov"
        for j in range(1 + i % 3):
            annotations.append({"video": video, "description": f"a person {j} in video {i}"})
        _write_textured_video(root / "videos" / hash_[:3] / hash_[3:6] / f"{hash_}.mp4",
                              num_frames=11, seed=80 + i)
    (root / "hashes.txt").write_text("\n".join(hashes) + "\n")
    (root / "val.json").write_text(json.dumps(annotations))
    return root


def test_didemo_module_matches_jax(encoders, didemo_root):
    port_dm, jax_dm = _modules(
        didemo.DidemoDataModule, jax_didemo.DidemoDataModule, encoders, eval_batch_size=3,
        videos_folder=str(didemo_root / "videos"), hash_list_path=str(didemo_root / "hashes.txt"),
        val_annotation_path=str(didemo_root / "val.json"))
    val = port_dm.val_dataloader()
    _assert_same_datasets(val, jax_dm.val_dataloader())
    assert val.dataset._get_target(2) == "a person 0 in video 2 a person 1 in video 2 " \
                                         "a person 2 in video 2"


@pytest.fixture(scope="module")
def youcook2_root(tmp_path_factory):
    """task "0101" stays a string (dtype str); video_id "007" is typed as the
    int 7, so its file is 7.avi."""
    root = tmp_path_factory.mktemp("youcook2")
    rows = ["task,video_id,start,end,text"]
    for i, (task, video_id, stem) in enumerate((("0101", "007", "7"), ("0101", "12", "12"),
                                                ("226", "31", "31"))):
        _write_textured_video(root / "videos" / task / f"{stem}.avi", num_frames=30, fps=10.0,
                              seed=90 + i)
        rows.append(f"{task},{video_id},{0.5 + i},{2.0 + 0.25 * i},the person cooking {i}")
    rows.append(rows[1].replace(",0.5,", ",1.5,"))  # a second clip of the same video
    (root / "val.csv").write_text("\n".join(rows) + "\n")
    (root / "missing.csv").write_text("task,video_id,start,end,text\n0101,99,0,1,none\n")
    return root


def test_youcook2_module_matches_jax(encoders, youcook2_root):
    kwargs = dict(val_video_info_file_path=str(youcook2_root / "val.csv"),
                  val_videos_folder=str(youcook2_root / "videos"))
    port_dm, jax_dm = _modules(youcook2.YouCook2DataModule, jax_youcook2.YouCook2DataModule,
                               encoders, eval_batch_size=2, **kwargs)
    val = port_dm.val_dataloader()
    _assert_same_datasets(val, jax_dm.val_dataloader())
    assert val.dataset.video_paths[0].endswith("0101/7.avi")
    assert val.dataset._get_times(3) == (1.5, 2.0)
    for cls in (youcook2.YouCook2DataModule, jax_youcook2.YouCook2DataModule):
        module = cls(encoder=encoders[0] if cls is youcook2.YouCook2DataModule else encoders[1],
                     val_video_info_file_path=str(youcook2_root / "missing.csv"),
                     val_videos_folder=str(youcook2_root / "videos"))
        with pytest.raises(FileNotFoundError, match="id=99"):
            module.val_dataloader()


@pytest.fixture(scope="module")
def webvid_root(tmp_path_factory):
    """Numeric video ids (read as str), one listed video without a file in
    the val CSV's order, and a file the CSV does not list."""
    root = tmp_path_factory.mktemp("webvid")
    for split, ids in (("train", ["2001", "2002", "2003", "2004"]), ("val", ["1003", "0042", "1001"])):
        rows = ["videoid,name,page_dir"]
        for i, video_id in enumerate(ids):
            rows.append(f'{video_id},"a dog video, take {i}",dir{i}')
            _write_textured_video(root / split / f"{video_id}.mp4", num_frames=10 + i,
                                  seed=100 + int(video_id) % 50)
        (root / f"{split}.csv").write_text("\n".join(rows) + "\n")
    return root


def webvid_kwargs(root, filter_from_info):
    return dict(train_video_info_file_path=str(root / "train.csv"),
                train_videos_folder=str(root / "train"),
                train_filter_videos_from_info_file=filter_from_info,
                val_video_info_file_path=str(root / "val.csv"),
                val_videos_folder=str(root / "val"),
                val_filter_videos_from_info_file=filter_from_info)


@pytest.mark.parametrize("filter_from_info", [False, True])
def test_webvid_module_matches_jax(encoders, webvid_root, filter_from_info):
    port_dm, jax_dm = _modules(webvid.WebVidDataModule, jax_webvid.WebVidDataModule, encoders,
                               eval_batch_size=2, batch_size=2,
                               **webvid_kwargs(webvid_root, filter_from_info))
    val = port_dm.val_dataloader()
    _assert_same_datasets(val, jax_dm.val_dataloader())
    ids = [val.dataset._get_video_id(i) for i in range(3)]
    assert ids == (["1003", "0042", "1001"] if filter_from_info else ["0042", "1001", "1003"])
    assert val.dataset._get_target(ids.index("0042")) == "a dog video, take 1"
    for epoch in (0, 1):
        train, jax_train = port_dm.train_dataloader(), jax_dm.train_dataloader()
        train.set_epoch(epoch)
        jax_train.set_epoch(epoch)
        _assert_same_batches(list(train), list(jax_train))


def _write_image(path, seed):
    import cv2

    path.parent.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    cv2.imwrite(str(path), cv2.resize(rng.integers(0, 256, (6, 8, 3), dtype=np.uint8),
                                      (64, 48), interpolation=cv2.INTER_LINEAR))


def _write_cc3m_tree(root, count, seed=0):
    """``count`` JPEGs with captions holding commas and quotes, plus a
    filename listed twice (dropped with both its rows) and an image no row
    names."""
    rows = []
    for i in range(count):
        _write_image(root / "images" / f"{i:05d}.jpg", seed + i)
        rows.append(f'"a cat, {i}, says ""hi"" in the video",http://example.invalid/{i},'
                    f"{i:05d}.jpg")
    rows.insert(2, f'"a person, again",http://example.invalid/x,{1:05d}.jpg')
    _write_image(root / "images" / "unlisted.jpg", seed + count)
    (root / "captions.csv").write_text("\n".join(rows) + "\n")
    return root


@pytest.fixture(scope="module")
def cc3m_root(tmp_path_factory):
    return _write_cc3m_tree(tmp_path_factory.mktemp("cc3m"), 10, seed=120)


def test_cc3m_module_matches_jax(encoders, cc3m_root):
    kwargs = dict(val_video_info_file_path=str(cc3m_root / "captions.csv"),
                  val_videos_folder=str(cc3m_root / "images"),
                  train_video_info_file_path=str(cc3m_root / "captions.csv"),
                  train_videos_folder=str(cc3m_root / "images"))
    port_dm, jax_dm = _modules(conceptual_captions.ConceptualCaptionsDataModule,
                               jax_cc.ConceptualCaptionsDataModule, encoders, eval_batch_size=4,
                               batch_size=2, **kwargs)
    val = port_dm.val_dataloader()
    _assert_same_datasets(val, jax_dm.val_dataloader())
    ids = [val.dataset._get_video_id(i) for i in range(len(val.dataset))]
    assert "00001.jpg" not in ids and "unlisted.jpg" not in ids and len(ids) == 9
    assert val.dataset._get_target(0) == 'a cat, 0, says "hi" in the video'
    assert next(iter(val))["video"].shape == (4, 1, 32, 32, 3)
    train, jax_train = port_dm.train_dataloader(), jax_dm.train_dataloader()
    _assert_same_batches(list(train), list(jax_train))


@pytest.mark.parametrize("text,kwargs", [
    ("a,b,c,d,e,f,g\n1,x,1.5,,True,007,\"q, \"\"r\"\"\"\n2,NA,2,3,False,8,s\n\n"
     "-3,null,1e3,4,true,9,t\n", {"dtype": {"g": str}}),
    ("1,2.5,x\n3,nan,y\n", {"names": ["p", "q", "r"]}),
    ("v,w\nN/A,\n,1\n", {}),
])
def test_read_table_types_columns_as_pandas(tmp_path, text, kwargs):
    path = tmp_path / "table.csv"
    path.write_text(text)
    want = pd.read_csv(path, **kwargs)
    got = read_table(path, names=kwargs.get("names"),
                     str_columns=tuple(kwargs.get("dtype", {})))
    assert list(got) == list(want.columns)
    for column in want.columns:
        for g, w in zip(got[column], want[column].tolist(), strict=True):
            if isinstance(w, float) and math.isnan(w):
                assert isinstance(g, float) and math.isnan(g), column
            else:
                assert g == w and type(g) is type(w), (column, g, w)


# --- grouped eval through both CLIs ---------------------------------------------


@pytest.fixture(scope="module")
def drift_env(tmp_path_factory, cc3m_root, webvid_root):
    """The env of data=drift_eval: CC3M (8 listed images, so a head batch of 8
    is whole), the WebVid val tree and a 5-video MSR-VTT tree."""
    from tests.test_torch_cli import _msrvtt_tree

    cc3m = _write_cc3m_tree(tmp_path_factory.mktemp("cc3m8"), 9, seed=140)
    return {"CC3M_VAL_TSV": str(cc3m / "captions.csv"), "CC3M_VAL_IMAGES": str(cc3m / "images"),
            "MSRVTT_PATH": _msrvtt_tree(tmp_path_factory.mktemp("msrvtt"), 5),
            "WEBVID_VAL_CSV": str(webvid_root / "val.csv"),
            "WEBVID_VAL_VIDEOS": str(webvid_root / "val")}


def _group_overrides(batch):
    return ["data=drift_eval", *(f"data.data_modules.{name}.eval_batch_size={batch}"
                                 for name in ("cc3m", "msrvtt", "webvid"))]


def _tiny_port_argv(vocab, *overrides):
    merges, vocab_json = vocab
    return ["encoder=clip_vit_b_16", "encoder._target_=tests.test_torch_cli.tiny_encoder_from_jax",
            "~encoder.name", f"+encoder.bpe_path={merges}", f"+encoder.vocab_path={vocab_json}",
            "++encoder.device=cpu", *overrides]


def _tiny_jax_cfg(vocab, overrides):
    merges, vocab_json = vocab
    cfg = jax_compose(DEFAULT_CONFIG_DIR, "trainer", ["encoder=clip_vit_b_16", *overrides])
    cfg["encoder"] = {"_target_": "fitclip_tpu.models.clip.load.load_tiny_test_encoder",
                      "bpe_path": merges, "vocab_path": vocab_json}
    return cfg


def _jax_printed(cfg):
    buffer = io.StringIO()
    with contextlib.redirect_stdout(buffer):
        jax_run(cfg)
    printed = buffer.getvalue()
    return json.loads(printed[printed.index("{"): printed.rindex("}") + 1])


def test_grouped_evaluate_and_predict_match_jax(vocab, drift_env, monkeypatch, capsys,
                                                tmp_path):
    """data=drift_eval: r1/r5/r10/mr suffixed _cc3m, _msrvtt and _webvid, as
    JAX's CLI prints them; predict concatenates the three members' embeddings
    and ids in the group's order."""
    for key, value in drift_env.items():
        monkeypatch.setenv(key, value)
    overrides = ["command=evaluate", *_group_overrides(4)]
    want = _jax_printed(_tiny_jax_cfg(vocab, overrides))
    capsys.readouterr()
    cli.main(_tiny_port_argv(vocab, *overrides))
    got = _printed_metrics(capsys)
    assert set(got) == {f"{k}_{name}" for k in ("r1", "r5", "r10", "mr")
                        for name in ("cc3m", "msrvtt", "webvid")}
    assert got == pytest.approx(want, rel=2e-4, abs=2e-4)

    predict = ["command=predict", *_group_overrides(4)]
    jax_run(_tiny_jax_cfg(vocab, [*predict, f"+output_path={tmp_path / 'jax.pt'}"]))
    cli.main(_tiny_port_argv(vocab, *predict, f"+output_path={tmp_path / 'port.pt'}"))
    got = torch.load(str(tmp_path / "port.pt"), weights_only=False)
    want = torch.load(str(tmp_path / "jax.pt"), weights_only=False)
    assert got["video_ids"] == want["video_ids"] and len(got["video_ids"]) == 8 + 5 + 3
    assert got["video_ids"][:2] == ["00000.jpg", "00002.jpg"]
    for key in ("encoded_videos", "encoded_texts"):
        np.testing.assert_allclose(got[key].numpy(), want[key].numpy(), atol=2e-4, rtol=2e-4)


@pytest.fixture(scope="module")
def classification_env(hmdb_root, mit_root):
    env = {"HMDB51_CATEGORIES": str(hmdb_root / "categories.txt"),
           "HMDB51_SPLITS": str(hmdb_root / "splits"), "HMDB51_VIDEOS": str(hmdb_root / "videos"),
           "MIT_CATEGORIES": str(mit_root / "categories.csv"),
           "MIT_VAL_CSV": str(mit_root / "validation.csv"),
           "MIT_VAL_VIDEOS": str(mit_root / "validation")}
    return env


def _classification_group_cfg(vocab, command, extra=()):
    """A group of two classification modules (hmdb51, moments_in_time), built
    from their configs as a grouped config builds its members."""
    merges, vocab_json = vocab
    members = {name: compose(DEFAULT_CONFIG_DIR, "trainer",
                             ["command=evaluate", "encoder=clip_vit_b_16", f"data={config}",
                              "data.eval_batch_size=4"])["data"]
               for name, config in (("hmdb", "hmdb51"), ("mit", "moments_in_time"))}
    cfg = compose(DEFAULT_CONFIG_DIR, "trainer", _tiny_port_argv(vocab, f"command={command}",
                                                                 "data=msrvtt", *extra))
    cfg["data"] = {"_target_": "fitclip_tpu.data.data_module_group.EvalDataModuleGroup",
                   "data_modules": members}
    return cfg


def test_grouped_classification_matches_jax_per_member(vocab, classification_env, monkeypatch,
                                                       capsys, tmp_path):
    """A group of classification modules: each member scored against its own
    label bank, a1/a5/mr suffixed by its name. JAX's CLI routes a group to
    retrieval (its members have no text), so each member is held to JAX's CLI
    on that member alone; predict concatenates the members' predictions."""
    for key, value in classification_env.items():
        monkeypatch.setenv(key, value)
    want = {}
    for name, config in (("hmdb", "hmdb51"), ("mit", "moments_in_time")):
        overrides = ["command=evaluate", f"data={config}", "data.eval_batch_size=4"]
        want.update({f"{k}_{name}": v for k, v in _jax_printed(_tiny_jax_cfg(vocab,
                                                                            overrides)).items()})
        jax_run(_tiny_jax_cfg(vocab, ["command=predict", f"data={config}",
                                      "data.eval_batch_size=4",
                                      f"+output_path={tmp_path / name}.pt"]))
    capsys.readouterr()
    cli.run(_classification_group_cfg(vocab, "evaluate"))
    got = _printed_metrics(capsys)
    assert set(got) == {f"{k}_{name}" for k in ("a1", "a5", "mr") for name in ("hmdb", "mit")}
    assert got == pytest.approx(want)

    cli.run(_classification_group_cfg(vocab, "predict",
                                      [f"+output_path={tmp_path / 'port.pt'}"]))
    got = torch.load(str(tmp_path / "port.pt"), weights_only=False)
    members = [torch.load(str(tmp_path / f"{name}.pt"), weights_only=False)
               for name in ("hmdb", "mit")]
    assert got["video_ids"] == [i for m in members for i in m["video_ids"]]
    assert len(got["video_ids"]) == 12
    for key in ("predictions", "labels"):
        np.testing.assert_array_equal(got[key].numpy(),
                                      np.concatenate([m[key].numpy() for m in members]))


def test_grouped_int8_calibrates_once_to_jax_scales(vocab, drift_env, tmp_path, monkeypatch,
                                                    capsys):
    """int8 over data=drift_eval without persisted scales: one calibration, on
    the first member's head batch (8 CC3M images, a whole batch), whose
    teacher-forced scales are JAX's (rtol 2^-8); every member is then scored
    with them, and a second run loads them instead."""
    from fitclip_tpu.models.clip import load as jax_clip_load

    merges, _ = vocab
    for key, value in drift_env.items():
        monkeypatch.setenv(key, value)
    checkpoint = _save(tmp_path / "clip.pt", openai_state_dict(INT8_CONFIG, seed=11))
    common = ["encoder=clip_vit_b_16", "++encoder.dtype=int8",
              f"+encoder.checkpoint_path={checkpoint}", f"+encoder.bpe_path={merges}",
              *_group_overrides(8), "++quant.calibration_batches=1"]
    jax_run(jax_compose(DEFAULT_CONFIG_DIR, "trainer", [
        "command=evaluate", *common, f"++quant.scales_path={tmp_path / 'jax.npz'}"]))
    capsys.readouterr()
    jax_encoder = jax_clip_load.load_clip_encoder(checkpoint_path=checkpoint, dtype="int8",
                                                  bpe_path=merges)
    qtree = jax.tree_util.tree_map(np.asarray, jax_encoder.params)
    computed, jax_seen, calls = {}, {}, []
    forced = teacher_forced_calibration(jax_encoder.encoder, qtree, computed, jax_seen)

    def counted(encoder, observations, quant_cfg):
        calls.append(len(observations))
        return forced(encoder, observations, quant_cfg)

    monkeypatch.setattr(runners, "_calibrate_on_batches", counted)
    port = ["command=evaluate", "++encoder.device=cpu", *common,
            f"++quant.scales_path={tmp_path / 'port.npz'}"]
    cli.main(port)
    metrics = _printed_metrics(capsys)
    assert calls == [1]
    assert sorted(metrics) == sorted(f"{k}_{name}" for k in ("r1", "r5", "r10", "mr")
                                     for name in ("cc3m", "msrvtt", "webvid"))
    with np.load(tmp_path / "port.npz") as got, np.load(tmp_path / "jax.npz") as want:
        assert sorted(got.files) == sorted(want.files) and len(want.files) == 8
        for site in want.files:
            np.testing.assert_allclose(got[site], want[site], rtol=BF16_STEP / 2, err_msg=site)
    assert all(len(values) == 2 for values in computed.values())  # one batch, two layers
    cli.main(port)
    assert calls == [1] and _printed_metrics(capsys) == metrics
