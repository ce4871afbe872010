"""``command=tune`` and ``hparam_search`` sweeps of the port (fitclip_torch/cli/
{tune,sweep}.py) against the JAX package's, on the CPU:

- ``command=tune`` over data=webvid gives JAX's batch-size suggestion, and an
  LR within one step of the range test's geometric schedule of JAX's (the
  smoothed losses agree at rtol 1e-5, so the steepest descent lands on the
  same point or a neighbour); the encoder is left as it was;
- a simulated ``torch.OutOfMemoryError`` ends the doubling at the last size
  that ran; any other error propagates;
- random and TPE draw JAX's exact values from the same seed over each
  ``config/hparam_search/*.yaml`` space, and ``run_sweep`` with a stub
  objective picks JAX's best;
- ``+hparam_search=random`` through the port's CLI runs its trials and
  prints the best trial's ``optimized_metric_name`` value.
"""

import contextlib
import io
import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from fitclip_tpu.cli import sweep as jax_sweep
from fitclip_tpu.cli import tune as jax_tune
from fitclip_tpu.cli.main import DEFAULT_CONFIG_DIR
from fitclip_tpu.cli.main import run as jax_run
from fitclip_tpu.config_engine import compose as jax_compose
from fitclip_tpu.models.clip.tokenizer import write_tiny_test_vocab
from fitclip_torch.cli import main as cli
from fitclip_torch.cli import sweep, tune
from fitclip_torch.data import video_reader

from tests.test_torch_train_cli import WORDS, one_device_mesh, write_trees

SEARCHES = sorted(Path(DEFAULT_CONFIG_DIR, "hparam_search").glob("*.yaml"))
TUNE = ["command=tune", "encoder=clip_vit_b_16", "data=webvid", "data.batch_size=2",
        "+data.num_threads=2", "+tune.init_batch_size=2", "+tune.max_trials=1",
        "+tune.num_lr_steps=10", "+tune.lr_min=1e-5", "+tune.lr_max=1.0"]


@pytest.fixture(scope="module", autouse=True)
def environment(tmp_path_factory):
    env = write_trees(tmp_path_factory.mktemp("trees"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(video_reader, "_native_reader", lambda: None)
        for key, value in env.items():
            mp.setenv(key, value)
        yield env


@pytest.fixture(scope="module")
def vocab(tmp_path_factory):
    return write_tiny_test_vocab(str(tmp_path_factory.mktemp("vocab")), WORDS)


def _port_encoder(vocab):
    merges, vocab_json = vocab
    return ["encoder._target_=fitclip_tpu.models.clip.load.load_tiny_test_encoder",
            "~encoder.name", f"+encoder.bpe_path={merges}", f"+encoder.vocab_path={vocab_json}",
            "++encoder.device=cpu"]


def _printed(out):
    return json.loads(out[out.index("{"): out.rindex("}") + 1])


@pytest.fixture(scope="module")
def jax_tuned(vocab):
    """JAX's command=tune suggestions and its range test's learning rates."""
    merges, vocab_json = vocab
    cfg = jax_compose(DEFAULT_CONFIG_DIR, "trainer", TUNE)
    cfg["encoder"] = {"_target_": "tests.test_torch_train_cli.jax_tiny_encoder",
                      "bpe_path": merges, "vocab_path": vocab_json}
    found = []

    def recording(*args, **kwargs):
        found.append(lr_find(*args, **kwargs))
        return found[-1]

    lr_find = jax_tune.lr_find
    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(out):
        mp.setattr(jax_tune, "lr_find", recording)
        one_device_mesh(mp)
        jax_run(cfg)
    return _printed(out.getvalue()), found[0]


def test_tune_matches_jax(vocab, jax_tuned, monkeypatch):
    suggestions, jax_found = jax_tuned
    found, seen = [], []

    def recording(loaded, *args, **kwargs):
        seen.append({k: v.clone() for k, v in loaded.encoder.model.state_dict().items()})
        found.append(lr_find(loaded, *args, **kwargs))
        seen.append(loaded.encoder.model.state_dict())
        return found[-1]

    lr_find = tune.lr_find
    monkeypatch.setattr(tune, "lr_find", recording)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli.main([*TUNE, *_port_encoder(vocab)])
    got = _printed(out.getvalue())
    assert sorted(got) == sorted(suggestions) == ["batch_size", "lr"]
    assert got["batch_size"] == suggestions["batch_size"] == 2  # one trial, no OOM
    assert len(found[0]["losses"]) == len(jax_found["losses"]) == 10
    np.testing.assert_allclose(found[0]["losses"], jax_found["losses"], rtol=1e-5)
    np.testing.assert_allclose(found[0]["lrs"], jax_found["lrs"], rtol=1e-6)
    step = jax_found["lrs"][1] / jax_found["lrs"][0]
    assert abs(math.log(got["lr"] / suggestions["lr"])) <= math.log(step) * 1.000001
    before, after = seen
    assert all(torch.equal(after[name], value) for name, value in before.items())


class _Loaded:
    """A stand-in encoder slot: scale_batch_size only copies it into a trainee."""

    def __init__(self):
        self.encoder = torch.nn.Linear(1, 1)


def _stub_trainee(fail_from: int, error: Exception):
    class Trainee:
        def __init__(self, loaded, learning_rate):
            self.sizes = []

        def loss(self, batch):
            size = len(batch["video"])
            if size >= fail_from:
                raise error
            return 1.0
    return Trainee


def test_out_of_memory_ends_the_doubling_at_the_last_size_that_ran(monkeypatch):
    monkeypatch.setattr(tune, "_Trainee", _stub_trainee(8, torch.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 2.00 GiB")))
    batch = {"video": np.zeros((3, 2, 4, 4, 3), np.uint8), "text": np.ones((3, 5), np.int32)}
    assert tune.scale_batch_size(_Loaded(), batch, init_size=1, max_trials=6) == 4
    assert tune.scale_batch_size(_Loaded(), batch, init_size=8, max_trials=6) == 0


@pytest.mark.parametrize("error", [RuntimeError("CUDA error: an illegal memory access"),
                                   OSError("nvcc failed to build the kernels")])
def test_any_other_error_propagates(monkeypatch, error):
    monkeypatch.setattr(tune, "_Trainee", _stub_trainee(4, error))
    batch = {"video": np.zeros((3, 2, 4, 4, 3), np.uint8), "text": np.ones((3, 5), np.int32)}
    with pytest.raises(type(error), match=str(error)[:10]):
        tune.scale_batch_size(_Loaded(), batch, init_size=1, max_trials=6)


def _objective(trial_cfg):
    """A smooth stub of the sampled values, peaked inside each space."""
    value = trial_cfg["trainer"]["gradient_clip_val"]
    return -(math.log10(value) - 0.3) ** 2


@pytest.mark.parametrize("path", SEARCHES, ids=[p.stem for p in SEARCHES])
def test_samplers_draw_jax_values_and_pick_jax_best(path):
    import yaml

    search = yaml.safe_load(path.read_text())
    search["n_trials"] = 24  # TPE past its 8 startup trials
    runs = {}
    for name, module in (("port", sweep), ("jax", jax_sweep)):
        drawn = []

        def objective(trial_cfg):
            assert "hparam_search" not in trial_cfg
            drawn.append(trial_cfg["trainer"]["gradient_clip_val"])
            return _objective(trial_cfg)

        best = module.run_sweep({"trainer": {}, "hparam_search": dict(search)}, objective)
        runs[name] = (drawn, best)
    assert runs["port"][0] == runs["jax"][0] and len(runs["port"][0]) == 24
    space = search["search_space"]["trainer.gradient_clip_val"]
    assert all(space["low"] <= v <= space["high"] for v in runs["port"][0])
    assert runs["port"][1] == runs["jax"][1]


@pytest.mark.parametrize("spec", [
    {"type": "uniform", "low": 1, "high": 2}, {"type": "loguniform", "low": 0.1, "high": 10},
    {"type": "int", "low": 3, "high": 5}, {"type": "choice", "options": ["a", "b", "c"]}],
    ids=["uniform", "loguniform", "int", "choice"])
def test_sample_value_draws_jax_values(spec):
    port, ref = np.random.default_rng(3), np.random.default_rng(3)
    assert ([sweep.sample_value(spec, port) for _ in range(16)]
            == [jax_sweep.sample_value(spec, ref) for _ in range(16)])


def test_hparam_search_through_the_cli(vocab, tmp_path):
    """``--config-name drift_eval_trainer +hparam_search=random
    ++hparam_search.n_trials=2``: two trials of training, each validated on the
    drift_eval group; the printed value is the better trial's r10_cc3m."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli.main(["--config-name", "drift_eval_trainer", "command=train",
                  "encoder=clip_vit_b_16", *_port_encoder(vocab),
                  "data.train_data_module.batch_size=2", "+data.train_data_module.num_threads=2",
                  "+trainer.max_steps=2", "trainer.val_check_interval=0.5",
                  "trainer.log_every_n_steps=1",
                  f"+log_dir={tmp_path}/logs", f"trainer.callbacks.checkpoint.dirpath={tmp_path}",
                  "+hparam_search=random", "++hparam_search.n_trials=2"])
    entries = [json.loads(line) for line in (tmp_path / "logs" / "metrics.jsonl")
               .read_text().splitlines()]
    validations = [e for e in entries if "r10_cc3m" in e]
    assert len(validations) == 2
    assert {"r10_msrvtt", "r10_webvid"} <= set(validations[0])
    assert float(out.getvalue().strip().splitlines()[-1]) == max(
        v["r10_cc3m"] for v in validations)
