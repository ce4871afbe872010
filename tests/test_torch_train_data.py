"""The train-side data layer of the port (fitclip_torch/data/{data_module_group,
multi_source_sampler,structured_batch}.py) against the JAX package's:

- ``MixedBatchLoader._index_plan()`` equals JAX's for several seeds and
  epochs; the longest source runs once, a cycled source draws a fresh
  permutation each cycle, and the plan does not depend on PYTHONHASHSEED
  (tests/test_mixed_batch_loader.py's cases);
- ``MixedBatchDataModule``'s batches over a written WebVid tree, dual
  preprocessed for a {student, teacher} encoder map, are bit-equal to JAX's;
- the round-robin sampler's golden sequences (the reference's own,
  aligner/tests/data/multi_source_sampler_test.py:18-33), ``cat_collate`` and
  ``merge_datasets_batch`` equal JAX's.
"""

import json
import os
import string
import subprocess
import sys

import numpy as np
import pytest

from fitclip_tpu.data import data_module_group as jax_group
from fitclip_tpu.data import multi_source_sampler as jax_sampler
from fitclip_tpu.data import structured_batch as jax_structured
from fitclip_tpu.data.datasets.webvid import WebVidDataModule as JaxWebVid
from fitclip_tpu.models.clip.encoder import ClipVideoTextEncoder as JaxEncoder
from fitclip_tpu.models.clip.model import CLIPConfig as JaxConfig
from fitclip_tpu.models.clip.tokenizer import ClipTokenizer as JaxTokenizer
from fitclip_tpu.models.clip.tokenizer import write_tiny_test_vocab
from fitclip_torch.data import data_module_group as group
from fitclip_torch.data import multi_source_sampler as sampler
from fitclip_torch.data import structured_batch, video_reader
from fitclip_torch.data.datasets.webvid import WebVidDataModule
from fitclip_torch.models.clip.encoder import ClipVideoTextEncoder
from fitclip_torch.models.clip.model import CLIPConfig
from fitclip_torch.models.clip.tokenizer import ClipTokenizer

from tests.test_torch_data import _assert_same_batches
from tests.test_torch_train_cli import WORDS, write_trees


class _Dataset:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i, rng=None):
        return {"index": i}


class _Loader:
    def __init__(self, n):
        self.dataset = _Dataset(n)
        self.epoch = 0

    def set_epoch(self, epoch):
        self.epoch = epoch

    def collate(self, items):
        return {"index": [item["index"] for item in items]}


def make_loader(module=group, seed=7, sizes=(40, 6), runs=(2, 2)):
    return module.MixedBatchLoader({"labeled": _Loader(sizes[0]), "unlabeled": _Loader(sizes[1])},
                                   {"labeled": runs[0], "unlabeled": runs[1]}, seed=seed,
                                   num_threads=2)


@pytest.mark.parametrize("seed,epoch,sizes,runs", [
    (7, 0, (40, 6), (2, 2)), (7, 1, (40, 6), (2, 2)), (0, 3, (5, 17), (1, 4)),
    (42, 2, (9, 9), (3, 2))])
def test_index_plan_matches_jax(seed, epoch, sizes, runs):
    port, ref = make_loader(group, seed, sizes, runs), make_loader(jax_group, seed, sizes, runs)
    port.set_epoch(epoch)
    ref.set_epoch(epoch)
    plan = port._index_plan()
    assert plan == ref._index_plan() and len(plan) == len(port) == len(ref)
    assert [{k: b[k]["index"] for k in b} for b in port] == plan


def test_plan_runs_the_longest_once_and_reshuffles_each_cycle():
    loader = make_loader()
    plan = loader._index_plan()
    assert len(plan) == 20
    assert sorted(i for spec in plan for i in spec["labeled"]) == list(range(40))
    unlabeled = [i for spec in plan for i in spec["unlabeled"]]
    cycles = [unlabeled[c: c + 6] for c in range(0, len(unlabeled) - 5, 6)]
    assert all(sorted(c) == list(range(6)) for c in cycles)
    assert len({tuple(c) for c in cycles}) > 1


def test_plan_independent_of_pythonhashseed():
    script = ("import json, sys\n"
              "sys.path.insert(0, %r)\n"
              "from fitclip_torch.data.data_module_group import MixedBatchLoader\n"
              "class Dataset(list):\n"
              "    pass\n"
              "class Loader:\n"
              "    def __init__(self, n):\n"
              "        self.dataset = Dataset(range(n))\n"
              "loader = MixedBatchLoader({'labeled': Loader(40), 'unlabeled': Loader(6)},\n"
              "                          {'labeled': 2, 'unlabeled': 2}, seed=7)\n"
              "print(json.dumps(loader._index_plan()))\n"
              % os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    plans = []
    for hashseed in ("0", "1"):
        env = dict(os.environ, PYTHONHASHSEED=hashseed)
        out = subprocess.run([sys.executable, "-c", script], env=env, capture_output=True,
                             text=True, check=True)
        plans.append(json.loads(out.stdout.strip().splitlines()[-1]))
    assert plans[0] == plans[1] == make_loader()._index_plan()


@pytest.fixture(scope="module")
def webvid_env(tmp_path_factory):
    env = write_trees(tmp_path_factory.mktemp("trees"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(video_reader, "_native_reader", lambda: None)
        yield env


def _encoder_map(package, vocab):
    merges, vocab_json = vocab
    if package == "port":
        def make(frames):
            tokenizer = ClipTokenizer(bpe_path=merges, vocab_path=vocab_json, context_length=16)
            return ClipVideoTextEncoder(CLIPConfig.tiny_test(vocab_size=tokenizer.vocab_size),
                                        num_frames=frames, tokenizer=tokenizer)
    else:
        def make(frames):
            tokenizer = JaxTokenizer(bpe_path=merges, vocab_path=vocab_json, context_length=16)
            return JaxEncoder(JaxConfig.tiny_test(vocab_size=tokenizer.vocab_size),
                              num_frames=frames, tokenizer=tokenizer)
    return {"student": make(4), "teacher": make(2)}


def test_mixed_batches_equal_jax_over_a_webvid_tree(webvid_env, tmp_path):
    """Labeled: the train CSV's videos (train_filter_videos_from_info_file, as
    webvid4_5k), 2 a batch; unlabeled: the train folder, 3 a batch, cycling.
    Student and teacher sample 4 and 2 frames (dual preprocessing)."""
    vocab = write_tiny_test_vocab(str(tmp_path), WORDS)
    batches = {}
    for package, module, data_module in (("port", group, WebVidDataModule),
                                         ("jax", jax_group, JaxWebVid)):
        encoders = _encoder_map(package, vocab)
        members = {
            "labeled": data_module(
                encoder=encoders, train_video_info_file_path=webvid_env["WEBVID_TRAIN_CSV"],
                train_videos_folder=webvid_env["WEBVID_TRAIN_VIDEOS"],
                train_filter_videos_from_info_file=True, num_threads=2),
            "unlabeled": data_module(
                encoder=encoders, train_video_info_file_path=webvid_env["WEBVID_TRAIN_CSV"],
                train_videos_folder=webvid_env["WEBVID_TRAIN_VIDEOS"], num_threads=2)}
        mixed = module.MixedBatchDataModule(members, {"labeled": 2, "unlabeled": 3}, seed=5)
        loader = mixed.train_dataloader()
        loader.set_epoch(1)
        batches[package] = list(loader)
    assert len(batches["port"]) == 4
    for got, want in zip(batches["port"], batches["jax"]):
        assert sorted(got) == sorted(want) == ["labeled", "unlabeled"]
        _assert_same_batches([got["labeled"], got["unlabeled"]],
                             [want["labeled"], want["unlabeled"]])
    first = batches["port"][0]["unlabeled"]
    assert first["video_student"].shape[:2] == (3, 4)
    assert first["video_teacher"].shape[:2] == (3, 2)
    assert {"text_student", "text_teacher"} <= set(first)


LETTERS = string.ascii_lowercase
CONCAT = list(LETTERS) + list(range(10))
GOLDEN = {
    "min_size": ["a", "b", "c", "d", 0, 1, 2, "e", "f", "g", "h", 3, 4, 5, "i", "j", "k", "l",
                 6, 7, 8, "m", "n", "o", "p", 9],
    "max_size_cycle": ["a", "b", "c", "d", 0, 1, 2, "e", "f", "g", "h", 3, 4, 5, "i", "j", "k",
                       "l", 6, 7, 8, "m", "n", "o", "p", 9, 0, 1, "q", "r", "s", "t", 2, 3, 4,
                       "u", "v", "w", "x", 5, 6, 7, "y", "z"]}


@pytest.mark.parametrize("mode", ["min_size", "max_size_cycle", "scalar"])
def test_round_robin_sampler_golden_sequences(mode):
    def make(module):
        if mode == "scalar":
            return module.RoundRobinMultiSourceSampler([range(4), range(4)], sequence_sizes=2)
        return module.RoundRobinMultiSourceSampler([range(26), range(10)],
                                                   sequence_sizes=[4, 3], mode=mode)

    port, ref = make(sampler), make(jax_sampler)
    assert list(port) == list(ref) and len(port) == len(ref)
    if mode in GOLDEN:
        assert [CONCAT[i] for i in port] == GOLDEN[mode] and len(port) == len(GOLDEN[mode])
    else:
        assert len(port) == 8


def _collate_cases():
    rng = np.random.default_rng(0)
    a = {"video": rng.integers(0, 255, (2, 3, 4, 4, 3), dtype=np.uint8),
         "text": rng.integers(1, 9, (2, 5)).astype(np.int32), "video_id": ["a1", "a2"]}
    b = {"video": rng.integers(0, 255, (3, 3, 4, 4, 3), dtype=np.uint8),
         "text": rng.integers(1, 9, (3, 8)).astype(np.int32), "video_id": ["b1", "b2", "b3"],
         }
    return {"pads_text": {"x": a, "y": b},
            "scalars": {"x": {"label": np.array([0, 1])}, "y": {"label": np.array([2])}},
            "other_values": {"x": {"label": np.array([0]), "split": "val"},
                             "y": {"label": np.array([1]), "split": "test"}}}


@pytest.mark.parametrize("case", sorted(_collate_cases()))
def test_cat_collate_and_merge_match_jax(case):
    batches = _collate_cases()[case]
    merged, lengths = structured_batch.merge_datasets_batch(batches)
    want, want_lengths = jax_structured.merge_datasets_batch(batches)
    assert lengths == want_lengths
    assert sorted(merged) == sorted(want)
    for key, value in want.items():
        if isinstance(value, np.ndarray):
            assert merged[key].dtype == value.dtype
            np.testing.assert_array_equal(merged[key], value)
        else:
            assert merged[key] == value
    cat = structured_batch.cat_collate(list(batches.values()))
    assert sorted(cat) == sorted(jax_structured.cat_collate(list(batches.values())))
    if case == "pads_text":
        assert merged["text"].shape == (5, 8) and merged["text"][0, 5:].sum() == 0
