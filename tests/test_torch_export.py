"""The port's export slice on the CPU: every inference kernel entry as a
``fitclip::`` operator, ``serving/export.py`` (``torch.export`` of each tower)
against its JAX counterpart's contract (``tests/test_serving_export.py``), the
embed service from EMBED_EXPORT_DIR and ``python -m
fitclip_torch.serving.export_serving``.

One tiny int8 CLIP (pixel normalization folded, calibrated by the port) is
exported once per module: text at buckets (1, 2, 4), video at (1, 4). Its
loaded programs are held bit for bit against the eager encoder, and within
the reference's int8 tolerance (atol/rtol 2e-3, tests/test_block_kernel.py)
against the JAX package's ``encode_text`` and ``encode_video`` on the same
params and scales (Pallas in interpret mode, compiled at XLA's backend
optimization level 0)."""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fitclip_tpu.models.clip import CLIPConfig as JaxConfig
from fitclip_tpu.models.clip.encoder import ClipVideoTextEncoder as JaxEncoder
from fitclip_tpu.models.clip.model import fold_pixel_normalization as jax_fold
from fitclip_torch.convert.from_jax import params_from_jax, params_to_jax
from fitclip_torch.models.clip.encoder import ClipVideoTextEncoder
from fitclip_torch.models.clip.model import CLIPConfig, CLIPModel, init_float_params
from fitclip_torch.ops import attention as A
from fitclip_torch.ops import block as K
from fitclip_torch.ops import fit_block as FB
from fitclip_torch.ops import s3dg_stem as S
from fitclip_torch.ops.quant import quantize_clip_params
from fitclip_torch.serving import embed_service as es
from fitclip_torch.serving.export import export_encode_fn, load_exported

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRAMES = 2


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _i8(gen, *shape):
    return torch.randint(-127, 128, shape, generator=gen, dtype=torch.int8)


def _op_cases():
    """(op, args) of every operator this slice binds, at tiny shapes on the CPU."""
    g = _gen(0)
    x, w32 = torch.randn(6, 32, generator=g), torch.rand(32, generator=g)
    b32 = torch.randn(32, generator=g)
    a, w, scale = _i8(g, 6, 32), _i8(g, 48, 32), torch.rand(48, generator=g) * 1e-3
    bias, res = torch.randn(48, generator=g), torch.randn(6, 48, generator=g)
    ab, wb = torch.randn(6, 32, generator=g).bfloat16(), torch.randn(48, 32, generator=g).bfloat16()
    qkv = torch.randn(2, 5, 3 * 2 * 64, generator=g)
    fit_qkv = torch.randn(2, 1 + 2 * 3, 3 * 64, generator=g).bfloat16()
    gkv = torch.randn(2, 3 * 2 * 64, generator=g)
    x_q, w_q = _i8(g, 2, 5, 128), _i8(g, 3 * 128, 128)
    video = torch.randn(1, 2, 8, 8, 3, generator=g).bfloat16()
    weights, bias32 = S.stem_operands(torch.randn(2, 4, 4, 24, 64, generator=g),
                                      torch.randn(64, generator=g))
    f = torch.ops.fitclip
    return {
        "ln_quant": (f.ln_quant.default, (x, w32, b32, 12.0, 1e-5)),
        "ln_cast": (f.ln_cast.default, (x, w32, b32, torch.bfloat16, 1e-5)),
        "int8_gemm_bias": (f.int8_gemm_bias.default, (a, w, scale, bias, torch.float32)),
        "int8_gemm_residual": (f.int8_gemm_residual.default,
                               (a, w, scale, bias, res, torch.bfloat16)),
        "int8_gemm_gelu": (f.int8_gemm_gelu.default, (a, w, scale, bias, -0.03, True)),
        "bf16_gemm_bias": (f.bf16_gemm_bias.default, (ab, wb, bias)),
        "bf16_gemm_residual": (f.bf16_gemm_residual.default, (ab, wb, bias, res, torch.float32)),
        "bf16_gemm_gelu": (f.bf16_gemm_gelu.default, (ab, wb, bias, False)),
        "attention_int8": (f.attention_int8.default, (qkv, 2, 0.125, False, 40.0, 4)),
        "attention_block": (f.attention_block.default, (qkv.bfloat16(), 2, 0.125, True, None)),
        "fused_int8_qkv_attention": (f.fused_int8_qkv_attention.default,
                                     (x_q, w_q, torch.rand(3 * 128, generator=g) * 1e-3,
                                      torch.randn(3 * 128, generator=g), 2, 0.125, True,
                                      torch.bfloat16)),
        "fused_attention_qkv_gkv": (f.fused_attention_qkv_gkv.default, (qkv, gkv, 2, 0.125)),
        "fused_time_attention": (f.fused_time_attention.default,
                                 (qkv[:, :4].contiguous(), gkv, 2, 2, 0.125)),
        "fit_attention_int8": (f.fit_attention_int8.default, (fit_qkv, 1, 2, "space", 30.0)),
        "s3dg_stem": (f.s3dg_stem.default, (video, weights.to(torch.bfloat16), bias32)),
    }


@pytest.mark.parametrize("name", sorted(_op_cases()))
def test_opcheck_each_operator_on_the_cpu(name):
    """The schema, the fake implementation against the CPU one (shapes, dtypes,
    strides), no autograd registration that could drop a gradient, and the
    trace through AOT dispatch with dynamic shapes."""
    op, args = _op_cases()[name]
    torch.library.opcheck(op, args)


def test_cpu_operators_are_the_plain_versions():
    """A wrapper's CPU implementation is its plain version, bit for bit."""
    cases = _op_cases()
    for name, plain in (("ln_quant", K.ln_quant_plain), ("int8_gemm_gelu", K.int8_gemm_gelu_plain),
                        ("attention_int8", A.attention_int8_plain),
                        ("fit_attention_int8", FB.fit_attention_int8_plain)):
        op, args = cases[name]
        assert torch.equal(op(*args), plain(*args)), name
    video, weights, bias32 = cases["s3dg_stem"][1]
    kernel = S.unpack_stem_weights(weights)
    assert torch.equal(S.pack_stem_weights(kernel), weights)
    assert torch.equal(S.s3dg_stem(video, kernel, bias32), S.s3dg_stem_plain(video, kernel, bias32))


# --- one tiny int8 CLIP, exported once ----------------------------------------------

def _int8_clip(cfg):
    tree = params_to_jax(init_float_params(CLIPModel(cfg), seed=0).state_dict(), cfg)
    enc = ClipVideoTextEncoder(cfg, num_frames=FRAMES, quantized=True, fused_attention=True,
                               fused_block=True)
    enc.model.load_state_dict(params_from_jax(quantize_clip_params(tree), cfg))
    enc.fold_pixel_normalization()
    rng = np.random.default_rng(1)
    enc.calibrate(torch.from_numpy(rng.integers(0, 256, (4, FRAMES, 32, 32, 3), dtype=np.uint8)),
                  torch.from_numpy(rng.integers(1, 60, (4, 16))))
    return enc


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    cfg = CLIPConfig.tiny_test()
    enc = _int8_clip(cfg)
    rng = np.random.default_rng(2)
    video = torch.from_numpy(rng.integers(0, 256, (4, FRAMES, 32, 32, 3), dtype=np.uint8))
    ids = torch.from_numpy(rng.integers(1, 60, (4, 16)))
    directory = str(tmp_path_factory.mktemp("export"))
    paths = {"text": export_encode_fn(enc.encode_text, ids[0], (1, 2, 4), directory, "text"),
             "video": export_encode_fn(enc.encode_video, video[0], (1, 4), directory, "video")}
    return dict(cfg=cfg, enc=enc, video=video, ids=ids, dir=directory, paths=paths)


def test_export_writes_one_program_per_tower(exported):
    directory, paths = exported["dir"], exported["paths"]
    assert paths == {"text": {b: os.path.join(directory, "text.pt2") for b in (1, 2, 4)},
                     "video": {b: os.path.join(directory, "video.pt2") for b in (1, 4)}}
    with open(os.path.join(directory, "video.json")) as f:
        assert json.load(f) == {"buckets": [1, 4], "item_shape": [FRAMES, 32, 32, 3],
                                "dtype": "uint8"}
    # The text program holds the text tower's weights only.
    assert os.path.getsize(paths["text"][1]) < os.path.getsize(paths["video"][1])


def test_exported_graph_holds_the_operators_not_the_plain_versions(exported):
    program = torch.export.load(exported["paths"]["video"][1])
    targets = {str(n.target) for n in program.graph.nodes if n.op == "call_function"}
    for op in ("ln_quant", "int8_gemm_bias", "int8_gemm_residual", "int8_gemm_gelu",
               "attention_int8"):
        assert f"fitclip.{op}.default" in targets, op
    assert not any("_int_mm" in t for t in targets)
    for node in program.graph.nodes:
        val = node.meta.get("val")
        assert getattr(val, "dtype", None) != torch.float64, node
        assert torch.float64 not in node.args, node


@pytest.mark.parametrize("tower,buckets", [("text", (1, 2, 4)), ("video", (1, 4))])
def test_roundtrip_is_bit_equal_to_the_eager_encoder(exported, tower, buckets):
    enc, batch = exported["enc"], exported["ids" if tower == "text" else "video"]
    encode_fn, per_bucket = load_exported(exported["dir"], tower)
    assert sorted(per_bucket) == list(buckets)
    eager = enc.encode_text if tower == "text" else enc.encode_video
    for size in buckets:
        with torch.no_grad():
            want = eager(batch[:size])
        assert torch.equal(encode_fn(batch[:size]), want), size
        assert torch.equal(per_bucket[size](batch[:size]), want), size


def test_unknown_bucket_raises(exported):
    encode_fn, _ = load_exported(exported["dir"], "text")
    with pytest.raises(ValueError, match="batch size 3"):
        encode_fn(exported["ids"][:3])


def test_load_exported_missing_artifacts(tmp_path):
    with pytest.raises(FileNotFoundError):
        load_exported(str(tmp_path), "video")


def test_load_needs_no_model_module(exported, tmp_path):
    """A fresh interpreter loads and runs the text program with no
    fitclip_torch.models module imported."""
    out = tmp_path / "rows.npy"
    script = ("import sys, numpy as np, torch\n"
              "from fitclip_torch.serving.export import load_exported\n"
              f"encode, _ = load_exported({exported['dir']!r}, 'text')\n"
              f"ids = torch.from_numpy(np.load({str(tmp_path / 'ids.npy')!r}))\n"
              f"np.save({str(out)!r}, encode(ids).float().numpy())\n"
              "print(sorted(m for m in sys.modules if m.startswith('fitclip_torch.models')))\n")
    np.save(tmp_path / "ids.npy", exported["ids"].numpy())
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                          timeout=300, env=dict(os.environ, PYTHONPATH=ROOT), cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"
    with torch.no_grad():
        np.testing.assert_array_equal(np.load(out),
                                      exported["enc"].encode_text(exported["ids"]).float().numpy())


def _jax_run(fn, *args):
    """fn(*args) jitted, compiled at backend optimization level 0."""
    compiled = jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})
    return np.asarray(jax.block_until_ready(compiled(*args)))


def test_loaded_programs_match_the_jax_package(exported):
    """The slice against JAX: the loaded programs' rows against the JAX
    encoder's encode_text and encode_video on the same params and scales."""
    enc = exported["enc"]
    jax_enc = JaxEncoder(JaxConfig.tiny_test(), num_frames=FRAMES, quantized=True,
                         fused_attention=True, fused_block=True, pixel_normalization_folded=True)
    params = jax.tree_util.tree_map(jnp.asarray,
                                    params_to_jax(enc.model.state_dict(), exported["cfg"]))
    video = jnp.asarray(exported["video"].numpy())
    ids = jnp.asarray(exported["ids"].numpy().astype(np.int32))
    for tower, batch, want in (
            ("video", exported["video"], _jax_run(jax_enc.encode_video, params, video)),
            ("text", exported["ids"], _jax_run(jax_enc.encode_text, params, ids))):
        encode_fn, _ = load_exported(exported["dir"], tower)
        np.testing.assert_allclose(encode_fn(batch).float().numpy(), want, atol=2e-3, rtol=2e-3)


def test_params_to_jax_of_a_folded_encoder_is_jax_fold():
    """The JAX test above hands JAX the port's folded weights; they are JAX's
    own fold of the unfolded ones."""
    cfg = CLIPConfig.tiny_test()
    tree = params_to_jax(init_float_params(CLIPModel(cfg), seed=0).state_dict(), cfg)
    enc = ClipVideoTextEncoder(cfg, num_frames=FRAMES)
    enc.model.load_state_dict(params_from_jax(tree, cfg))
    folded = params_to_jax(enc.fold_pixel_normalization().model.state_dict(), cfg)
    want = jax_fold(jax.tree_util.tree_map(jnp.asarray, tree), enc.mean, enc.std)
    for path in (("visual", "patch_embed", "kernel"), ("visual", "patch_embed", "bias")):
        got, ref = folded, want
        for key in path:
            got, ref = got[key], ref[key]
        np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=1e-6, rtol=1e-5)


def test_fit_int8_persisted_scales_export_matches_live_encoder(tmp_path):
    """Frozen-in-Time int8 (K4) through the persisted-scales serving flow:
    save -> fresh quantize -> load -> export; the reloaded program equals the
    live encoder (tests/test_serving_export.py:149's counterpart)."""
    from fitclip_torch.convert.from_jax import fit_params_from_jax
    from fitclip_torch.models.frozen_in_time.encoder import (FrozenInTimeConfig,
                                                             FrozenInTimeVideoTextEncoder)
    from fitclip_torch.models.frozen_in_time.load import init_fit_params
    from fitclip_torch.ops.quant import (FIT_DENSE_NAMES, load_act_scales, require_calibrated,
                                         save_act_scales)

    cfg = FrozenInTimeConfig.tiny_test()
    tree = init_fit_params(cfg, 0)

    def int8_encoder():
        enc = FrozenInTimeVideoTextEncoder(cfg, num_frames=cfg.num_frames, quantized=True,
                                           fused_block=True)
        enc.load_state_dict(fit_params_from_jax(
            dict(tree, video=quantize_clip_params(tree["video"], FIT_DENSE_NAMES)), cfg))
        return enc

    video = torch.from_numpy(np.random.default_rng(7).integers(
        0, 256, (2, cfg.num_frames, cfg.img_size, cfg.img_size, 3), dtype=np.uint8))
    live = int8_encoder()
    with pytest.raises(ValueError, match="uncalibrated"):
        require_calibrated(live, context="test")
    live.calibrate(video)
    scales = str(tmp_path / "scales.npz")
    save_act_scales(scales, live)
    served = load_act_scales(scales, int8_encoder())
    require_calibrated(served, context="test")
    paths = export_encode_fn(served.encode_video, video[0], (2,), str(tmp_path), "video")
    assert sorted(paths) == [2]
    encode_fn, _ = load_exported(str(tmp_path), "video")
    with torch.no_grad():
        assert torch.equal(encode_fn(video), live.encode_video(video))


def test_text_service_serves_from_exported_artifacts(exported, monkeypatch):
    """build_service() with EMBED_EXPORT_DIR: the buckets come from the
    artifact set, and the served rows are the direct call's."""
    enc = exported["enc"]
    for name in ("_SERVICE", "_VIDEO_SERVICE", "_INDEX", "_GRAPHS"):
        monkeypatch.setattr(es, name, None)
    monkeypatch.setattr(es, "_LOADED", type("Loaded", (), {"encoder": enc})())
    monkeypatch.setattr(enc, "get_tokenizer",
                        lambda: lambda texts: exported["ids"][:len(texts)].numpy())
    monkeypatch.setenv("EMBED_EXPORT_DIR", exported["dir"])
    service = es.build_service()
    try:
        assert service.server._buckets == (1, 2, 4)
        served = service.embed_texts(["a", "b", "c"])
    finally:
        service.stop()
    with torch.no_grad():
        direct = enc.encode_text(exported["ids"][:3]).float().numpy()
    np.testing.assert_array_equal(served, direct)


def test_export_serving_writes_and_prints_the_artifact_map(tmp_path, capsys, monkeypatch):
    """python -m fitclip_torch.serving.export_serving on the tiny seeded CLIP,
    composed from config/encoder/ with overrides, on the CPU."""
    from fitclip_torch.models.clip.load import load_tiny_test_encoder
    from fitclip_torch.models.clip.tokenizer import write_tiny_test_vocab
    from fitclip_torch.serving import export_serving

    merges, vocab = write_tiny_test_vocab(str(tmp_path), ["a", "cat", "video"])
    out = tmp_path / "out"
    export_serving.main(["clip_vit_b_16", str(out), "--buckets", "1,2", "--device", "cpu",
                         "--overrides",
                         "encoder._target_=fitclip_torch.models.clip.load.load_tiny_test_encoder",
                         "~encoder.name", f"+encoder.bpe_path={merges}",
                         f"+encoder.vocab_path={vocab}"])
    printed = json.loads(capsys.readouterr().out)
    assert printed == {tower: {b: str(out / f"{tower}.pt2") for b in ("1", "2")}
                       for tower in ("text", "video")}
    encoder = load_tiny_test_encoder(bpe_path=merges, vocab_path=vocab, device="cpu").encoder
    ids = torch.from_numpy(encoder.get_tokenizer()(["a cat", "video"])).long()
    encode_fn, _ = load_exported(str(out), "text")
    with torch.no_grad():
        assert torch.equal(encode_fn(ids), encoder.encode_text(ids))
