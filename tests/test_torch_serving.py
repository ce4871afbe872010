"""The port's serving layer (fitclip_torch/serving) against the JAX package's
(``fitclip_tpu.serving.BatchServer``, ``demo/embed_service.py``) on the CPU:

- the batcher, both packages over the same numpy row-wise function: results,
  the bucket sizes called, padding that never leaks, coalescing,
  backpressure, error fan-out, submit after stop and the item-shape check;
- the text and video services on the tiny CLIP (the JAX params carried
  across by convert/from_jax.py) at 2e-4, the retrieval index on an .npz and
  on a port ``predict`` .pt, and ``_handle``'s status codes and bodies;
- the int8 service refuses to start without persisted scales, and
  EMBED_EXPORT_DIR raises;
- the whole service from EMBED_* settings on EMBED_DEVICE=cpu over HTTP.

The CUDA graphs of each bucket run on the card only (tests/test_torch_kernels.py).
Both packages decode with OpenCV (``opencv_only``)."""

import io
import json
import threading
import time
import urllib.request
from concurrent.futures import wait

import numpy as np
import pytest
import torch

import demo.embed_service as jax_es
from fitclip_tpu.models.clip import load as jax_load
from fitclip_tpu.models.clip.tokenizer import write_tiny_test_vocab
from fitclip_tpu.serving import BatchServer as JaxBatchServer
from fitclip_tpu.serving.batcher import ServerClosed as JaxServerClosed
from fitclip_tpu.serving.batcher import ServerOverloaded as JaxServerOverloaded
from fitclip_torch.data import video_reader
from fitclip_torch.serving import embed_service as es
from fitclip_torch.serving.batcher import BatchServer, ServerClosed, ServerOverloaded
from fitclip_torch.serving.graphs import BucketGraphs

from tests.test_torch_cli import tiny_encoder_from_jax
from tests.test_torch_data import _write_textured_video

ITEM = (5,)
WORDS = ["a", "cat", "video", "of", "dog", "piano", "the"] * 3
TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(scope="module", autouse=True)
def opencv_only():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(video_reader, "_native_reader", lambda: None)
        yield


def row_fn(x: np.ndarray) -> np.ndarray:
    return np.tanh(x) * 2.0 + np.arange(x.shape[-1], dtype=x.dtype)


def _server(package, fn=row_fn, sleep_s=0.0, **kwargs):
    """A server of ``package`` over the numpy function ``fn``, the list of the
    batches it was called with, and the package's (overloaded, closed) errors."""
    calls = []

    def encode_np(x):
        calls.append(np.array(x))
        if sleep_s:
            time.sleep(sleep_s)
        return fn(x)

    if package == "port":
        server = BatchServer(lambda t: torch.from_numpy(encode_np(t.numpy())), ITEM, **kwargs)
        return server, calls, (ServerOverloaded, ServerClosed)
    return JaxBatchServer(encode_np, ITEM, **kwargs), calls, (JaxServerOverloaded,
                                                             JaxServerClosed)


def _items(count):
    return [np.random.default_rng(i).normal(size=ITEM).astype(np.float32) for i in range(count)]


def test_batch_server_results_buckets_and_padding_match_jax():
    """23 items through a 4-row bucket (every batch padded): each row is the
    function of its item, every call is one bucket of 4 with zero padding
    rows, and both packages return the same rows."""
    outs, bucket_calls = {}, {}
    for package in ("port", "jax"):
        server, calls, _ = _server(package, bucket_sizes=(4,), max_wait_ms=20)
        with server:
            futures = [server.submit(it) for it in _items(23)]
            outs[package] = [f.result(timeout=30) for f in futures]
        bucket_calls[package] = {len(c) for c in calls}
        assert len(outs[package]) == 23
        for item, out in zip(_items(23), outs[package]):
            np.testing.assert_array_equal(out, row_fn(item[None])[0])
        served = np.concatenate(calls[1:])  # the warm-up call is all padding
        real = {tuple(r) for r in np.stack(_items(23))}
        padding = [r for r in served if tuple(r) not in real]
        assert len(padding) == len(served) - 23 and all(np.all(r == 0) for r in padding)
    assert bucket_calls["port"] == bucket_calls["jax"] == {4}
    for got, want in zip(outs["port"], outs["jax"]):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("package", ["port", "jax"])
def test_batch_server_coalesces_concurrent_requests(package):
    server, calls, _ = _server(package, bucket_sizes=(1, 2, 4, 8, 16), max_wait_ms=50)
    server.start()
    try:
        n_warmup = len(calls)
        barrier = threading.Barrier(12)
        futures = [None] * 12

        def client(i):
            barrier.wait()
            futures[i] = server.submit(np.full(ITEM, i, np.float32))

        threads = [threading.Thread(target=client, args=(i,)) for i in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wait(futures, timeout=30)
        dispatches = len(calls) - n_warmup
        assert dispatches < 12
        assert server.stats.batches == dispatches
        assert server.stats.mean_batch_fill > 0.4
        for i, fut in enumerate(futures):
            np.testing.assert_array_equal(fut.result(), row_fn(np.full((1, 5), i, np.float32))[0])
    finally:
        server.stop()


@pytest.mark.parametrize("case", ["backpressure", "error_fan_out", "submit_after_stop",
                                  "item_shape"])
def test_batch_server_failures_match_jax(case):
    """The same failure, raised as each package raises it."""
    outcomes = {}
    for package in ("port", "jax"):
        if case == "backpressure":
            server, _, (overloaded, _) = _server(package, sleep_s=0.2, bucket_sizes=(1,),
                                                 max_wait_ms=0, queue_size=2)
            server.start(warmup=False)
            try:
                with pytest.raises(overloaded):
                    for _ in range(50):  # outrun the 0.2 s/batch dispatcher
                        server.submit(np.zeros(ITEM, np.float32))
            finally:
                server.stop()
            outcomes[package] = server.stats.rejected >= 1
        elif case == "error_fan_out":
            toggle = {"fail": True}

            def fn(x):
                if toggle["fail"]:
                    raise RuntimeError("poisoned batch")
                return x * 2

            server, _, _ = _server(package, fn=fn, bucket_sizes=(1, 2), max_wait_ms=0)
            server.start(warmup=False)
            try:
                with pytest.raises(RuntimeError, match="poisoned"):
                    server.submit(np.ones(ITEM, np.float32)).result(timeout=10)
                toggle["fail"] = False
                outcomes[package] = server.submit(np.ones(ITEM, np.float32)).result(timeout=10)
            finally:
                server.stop()
        elif case == "submit_after_stop":
            server, _, (_, closed) = _server(package, bucket_sizes=(1,))
            server.start(warmup=False)
            server.stop()
            with pytest.raises(closed, match="stopped"):
                server.submit(np.zeros(ITEM, np.float32))
            outcomes[package] = True
        else:
            server, _, _ = _server(package, bucket_sizes=(1,))
            with server:
                with pytest.raises(ValueError, match="shape") as error:
                    server.submit(np.zeros((7,), np.float32))
            outcomes[package] = str(error.value)
    if case == "error_fan_out":
        np.testing.assert_array_equal(outcomes["port"], outcomes["jax"])
    else:
        assert outcomes["port"] == outcomes["jax"]


def test_bucket_graphs_need_a_cuda_device():
    with pytest.raises(ValueError, match="CUDA"):
        BucketGraphs(lambda t: t, ITEM, torch.float32, (1, 2), "cpu")


# --- the services on the tiny CLIP ------------------------------------------------


@pytest.fixture(scope="module")
def vocab(tmp_path_factory):
    return write_tiny_test_vocab(str(tmp_path_factory.mktemp("vocab")), WORDS)


@pytest.fixture(scope="module")
def encoders(vocab):
    merges, vocab_json = vocab
    ref = jax_load.load_tiny_test_encoder(bpe_path=merges, vocab_path=vocab_json)
    port = tiny_encoder_from_jax(merges, vocab_json)
    return ref, port


@pytest.fixture(scope="module")
def services(encoders):
    """The JAX and port text and video services, started once for the module."""
    ref, port = encoders
    made = {"jax_text": jax_es.TextEmbedService(ref.encoder, ref.params, bucket_sizes=(1, 2, 4),
                                                max_wait_ms=5),
            "port_text": es.TextEmbedService(port.encoder, bucket_sizes=(1, 2, 4),
                                             max_wait_ms=5),
            "jax_video": jax_es.VideoEmbedService(ref.encoder, ref.params, bucket_sizes=(1, 2),
                                                  max_wait_ms=5),
            "port_video": es.VideoEmbedService(port.encoder, bucket_sizes=(1, 2),
                                               max_wait_ms=5)}
    for service in made.values():
        service.start()
    yield made
    for service in made.values():
        service.stop()


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    root = tmp_path_factory.mktemp("clips")
    paths = {"long": root / "long.avi", "short": root / "short.avi"}
    _write_textured_video(paths["long"], num_frames=12, seed=7)
    _write_textured_video(paths["short"], num_frames=2, seed=8)
    return {name: path.read_bytes() for name, path in paths.items()}


def test_text_service_matches_jax_and_the_encoder(services, encoders):
    texts = ["a cat", "video of a cat", "a video", "the dog piano"]
    got = services["port_text"].embed_texts(texts)
    np.testing.assert_allclose(got, services["jax_text"].embed_texts(texts), **TOL)
    _, port = encoders
    ids = torch.from_numpy(port.encoder.get_tokenizer()(texts)).long()
    with torch.no_grad():
        direct = port.encoder.encode_text(ids).float().numpy()
    np.testing.assert_array_equal(got, direct)


@pytest.mark.parametrize("clip", ["long", "short"])
def test_video_service_matches_jax_and_the_eval_pipeline(services, encoders, clips, clip):
    """A served video embedding equals the JAX service's, and the eval data
    pipeline + encode_video by hand (a short clip pads with zero frames)."""
    got = services["port_video"].embed_video_bytes(clips[clip], fmt="avi")
    want = services["jax_video"].embed_video_bytes(clips[clip], fmt="avi")
    np.testing.assert_allclose(got, want, **TOL)
    _, port = encoders
    processed = services["port_video"].preprocess_bytes(clips[clip], fmt="avi")
    assert processed.shape == (4, 32, 32, 3) and processed.dtype == np.uint8
    with torch.no_grad():
        direct = port.encoder.encode_video(torch.from_numpy(processed[None])).float().numpy()[0]
    np.testing.assert_array_equal(got, direct)
    if clip == "short":
        assert not processed[2:].any()


def test_retrieval_index_matches_jax_on_npz_and_on_a_port_predict_dump(services, tmp_path):
    from fitclip_torch.cli.runners import _save_predictions

    texts = ["a cat video", "a video of a dog", "cat piano"]
    embs = services["port_text"].embed_texts(texts).astype(np.float32) * 0.7
    ids = [f"video{i}" for i in range(len(texts))]
    npz = tmp_path / "predictions.npz"
    np.savez(npz, encoded_videos=embs, encoded_texts=embs, video_ids=np.asarray(ids))
    pt = tmp_path / "predictions.pt"
    _save_predictions({"encoded_videos": torch.from_numpy(embs),
                       "encoded_texts": torch.from_numpy(embs), "video_ids": ids}, str(pt))
    query = services["port_text"].embed_texts(["a video of a dog"])[0]
    for path in (npz, pt):
        got, want = es.RetrievalIndex(str(path)), jax_es.RetrievalIndex(str(path))
        assert got.video_ids == want.video_ids == ids
        np.testing.assert_allclose(got.videos, want.videos, rtol=1e-6, atol=1e-7)
        results = got.search(query, top_k=2)
        assert results == want.search(query, top_k=2)
        assert results[0]["video_id"] == "video1" and results[0]["score"] > 0.999


def _call(module, method, path, body=b"", query=""):
    status = {}
    environ = {"REQUEST_METHOD": method, "PATH_INFO": path, "QUERY_STRING": query,
               "CONTENT_LENGTH": str(len(body)), "wsgi.input": io.BytesIO(body)}
    chunks = module.application(environ, lambda line, headers: status.update(line=line))
    return status["line"], json.loads(b"".join(chunks))


def test_handle_status_codes_and_bodies_match_jax(services, clips, tmp_path, monkeypatch):
    """Every request of the card's traffic (e) and the other refusals: the
    same status line and body from both packages; the successes agree in
    their numbers at 2e-4."""
    embs = services["port_text"].embed_texts(["a cat", "a dog"])
    index = tmp_path / "index.npz"
    np.savez(index, encoded_videos=embs, encoded_texts=embs,
             video_ids=np.asarray(["v0", "v1"]))
    for prefix, module in (("port", es), ("jax", jax_es)):
        monkeypatch.setattr(module, "_SERVICE", services[f"{prefix}_text"])
        monkeypatch.setattr(module, "_VIDEO_SERVICE", services[f"{prefix}_video"])
        monkeypatch.setattr(module, "_INDEX", None)
    monkeypatch.setenv("EMBED_MAX_VIDEO_MB", "1")
    monkeypatch.delenv("EMBED_INDEX", raising=False)
    refusals = [("POST", "/embed_video", b"", ""),
                ("POST", "/embed_video", b"not a video", "format=avi"),
                ("POST", "/embed_video", b"\0" * (2 ** 20 + 1), ""),
                ("GET", "/nope", b"", ""),
                ("POST", "/embed_video", clips["long"], "format=a.vi"),
                ("POST", "/embed_text", json.dumps({"texts": "not-a-list"}).encode(), ""),
                ("POST", "/embed_text", json.dumps({"texts": []}).encode(), ""),
                ("GET", "/search_videos", b"", "top_k=2"),
                ("GET", "/search_videos", b"", "q=cat")]
    statuses = []
    for request in refusals:
        got, want = _call(es, *request), _call(jax_es, *request)
        assert got == want, request
        statuses.append(got[0])
    assert statuses[:4] == ["400 Bad Request", "400 Bad Request", "413 Content Too Large",
                            "404 Not Found"]
    assert statuses[-1] == "503 Service Unavailable"

    monkeypatch.setenv("EMBED_INDEX", str(index))
    successes = [("POST", "/embed_text", json.dumps({"texts": ["a cat video", "dog"]}).encode(),
                  ""),
                 ("POST", "/embed_video", clips["long"], "format=avi"),
                 ("GET", "/search_videos", b"", "q=a+cat&top_k=2")]
    for request in successes:
        (got_line, got), (want_line, want) = _call(es, *request), _call(jax_es, *request)
        assert got_line == want_line == "200 OK" and sorted(got) == sorted(want)
        if "results" in got:
            assert [r["video_id"] for r in got["results"]] == \
                [r["video_id"] for r in want["results"]] == ["v0", "v1"]
            np.testing.assert_allclose([r["score"] for r in got["results"]],
                                       [r["score"] for r in want["results"]], **TOL)
        else:
            assert got["dim"] == want["dim"] == 32
            key = "embeddings" if "embeddings" in got else "embedding"
            np.testing.assert_allclose(got[key], want[key], **TOL)
    line, health = _call(es, "GET", "/health")
    assert line == "200 OK" and sorted(health) == sorted(_call(jax_es, "GET", "/health")[1])
    assert health["video"]["requests"] == services["port_video"].server.stats.requests


def test_int8_service_refuses_to_start_without_persisted_scales(tmp_path):
    """No EMBED_SCALES, or a file of the uncalibrated sentinel: refused. With
    scales calibrated offline, the served video embedding is the calibrated
    encoder's."""
    from fitclip_torch.models.clip.encoder import ClipVideoTextEncoder
    from fitclip_torch.models.clip.model import CLIPConfig, CLIPModel, init_float_params
    from fitclip_torch.convert.from_jax import params_from_jax, params_to_jax
    from fitclip_torch.ops.quant import quantize_clip_params, save_act_scales

    config = CLIPConfig.tiny_test()
    state = init_float_params(CLIPModel(config), 0).state_dict()
    encoder = ClipVideoTextEncoder(config, num_frames=2, dtype=torch.bfloat16, quantized=True)
    encoder.model.load_state_dict(params_from_jax(quantize_clip_params(
        params_to_jax(state, config)), config))
    with pytest.raises(SystemExit, match="EMBED_SCALES"):
        es.prepare_quantized_params(encoder, None)
    sentinel = tmp_path / "sentinel.npz"
    save_act_scales(str(sentinel), encoder.model)
    with pytest.raises(ValueError, match="uncalibrated"):
        es.prepare_quantized_params(encoder, str(sentinel))

    rng = np.random.default_rng(5)
    video = torch.from_numpy(rng.integers(0, 256, size=(2, 2, 32, 32, 3)).astype(np.uint8))
    text = torch.from_numpy(rng.integers(1, 60, size=(2, 16)).astype(np.int64))
    encoder.calibrate(video, text)
    scales = tmp_path / "scales.npz"
    save_act_scales(str(scales), encoder.model)
    with torch.no_grad():
        direct = encoder.encode_video(video[:1]).float().numpy()[0]
    served = ClipVideoTextEncoder(config, num_frames=2, dtype=torch.bfloat16, quantized=True)
    served.model.load_state_dict(params_from_jax(quantize_clip_params(
        params_to_jax(state, config)), config))
    es.prepare_quantized_params(served, str(scales))
    service = es.VideoEmbedService(served, bucket_sizes=(1,), max_wait_ms=0).start()
    try:
        out = service.server.submit(video[0].numpy()).result(timeout=60)
    finally:
        service.stop()
    np.testing.assert_array_equal(out, direct)


def test_export_dir_raises(encoders, monkeypatch):
    """EMBED_EXPORT_DIR serves the towers from its artifacts
    (tests/test_torch_export.py); a directory without them raises, as the JAX
    service's load_exported does."""
    monkeypatch.setattr(es, "_LOADED", encoders[1])
    monkeypatch.setattr(es, "_GRAPHS", None)
    monkeypatch.setenv("EMBED_EXPORT_DIR", "/nonexistent")
    for build, tower in ((es.build_service, "text"), (es.build_video_service, "video")):
        with pytest.raises(FileNotFoundError, match=f"{tower}.pt2"):
            build()


def test_service_from_environment_over_http_on_the_cpu(vocab, encoders, clips, tmp_path,
                                                       monkeypatch):
    """python -m fitclip_torch.serving.embed_service's path, on EMBED_DEVICE=cpu:
    the encoder composed from config/ with EMBED_OVERRIDES, the stdlib Handler
    on 127.0.0.1, and every endpoint over HTTP. The embeddings are the
    encoder's own."""
    merges, vocab_json = vocab
    for name in ("_SERVICE", "_VIDEO_SERVICE", "_INDEX", "_LOADED", "_GRAPHS"):
        monkeypatch.setattr(es, name, None)
    monkeypatch.setenv("EMBED_ENCODER", "clip_vit_b_16")
    monkeypatch.setenv("EMBED_OVERRIDES", " ".join([
        "encoder._target_=tests.test_torch_cli.tiny_encoder_from_jax", "~encoder.name",
        f"+encoder.bpe_path={merges}", f"+encoder.vocab_path={vocab_json}"]))
    monkeypatch.setenv("EMBED_DEVICE", "cpu")
    monkeypatch.setenv("EMBED_MAX_BATCH", "4")
    monkeypatch.setenv("EMBED_MAX_VIDEO_BATCH", "2")
    monkeypatch.setenv("EMBED_COMPILE_CACHE", str(tmp_path / "cache"))
    monkeypatch.delenv("EMBED_EXPORT_DIR", raising=False)
    server = es.EmbedHTTPServer(("127.0.0.1", 0), es.Handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"

    def request(path, body=None):
        req = urllib.request.Request(url + path, data=body,
                                     method="POST" if body is not None else "GET")
        try:
            with urllib.request.urlopen(req, timeout=60) as reply:
                return reply.status, json.loads(reply.read())
        except urllib.error.HTTPError as error:
            return error.code, json.loads(error.read())

    try:
        status, text = request("/embed_text", json.dumps({"texts": ["a cat", "a dog"]}).encode())
        assert status == 200 and np.asarray(text["embeddings"]).shape == (2, 32)
        assert es._LOADED.encoder.model.text.transformer.blocks[0].ln_1.weight.device.type == "cpu"
        status, video = request("/embed_video?format=avi", clips["long"])
        assert status == 200 and len(video["embedding"]) == video["dim"] == 32
        index = tmp_path / "index.npz"
        np.savez(index, encoded_videos=np.asarray([video["embedding"]], np.float32),
                 encoded_texts=np.asarray([video["embedding"]], np.float32),
                 video_ids=np.asarray(["clip"]))
        monkeypatch.setenv("EMBED_INDEX", str(index))
        status, found = request("/search_videos?q=a+cat&top_k=3")
        assert status == 200 and [r["video_id"] for r in found["results"]] == ["clip"]
        status, health = request("/health")
        assert status == 200 and health["requests"] == 3 and health["video"]["requests"] == 1
        assert [request(*r)[0] for r in (("/embed_video", b"not a video"), ("/nope",))] == \
            [400, 404]
    finally:
        server.shutdown()
        server.server_close()
        for service in (es._SERVICE, es._VIDEO_SERVICE):
            if service is not None:
                service.stop()
    loaded = es._LOADED.encoder
    ids = torch.from_numpy(loaded.get_tokenizer()(["a cat", "a dog"])).long()
    with torch.no_grad():
        direct = loaded.encode_text(ids).float().numpy()
    np.testing.assert_array_equal(np.asarray(text["embeddings"], np.float32), direct)
