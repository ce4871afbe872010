"""Online embedding service (port of ``demo/embed_service.py``): embeddings
computed per request on the card, through the dynamic batcher
(``batcher.py``) and one CUDA graph per bucket of each tower (``graphs.py``).

Endpoints (the JAX service's, with its status codes and JSON bodies):
- POST /embed_text   body {"texts": ["a cat", ...]}
      -> {"embeddings": [[...], ...], "dim": D}
      Each text is tokenized and submitted on its own; the batcher coalesces
      concurrent requests into one bucket-padded call.
- POST /embed_video[?format=mp4]   body = raw video container bytes
      -> {"embedding": [...], "dim": D}
      Decoded, eval-frame-sampled and transformed exactly as the eval data
      pipeline does (``build_pipeline(train=False)``), then batched through
      the video tower. Bytes that do not decode give 400.
- GET  /search_videos?q=<text>&top_k=10   (requires EMBED_INDEX)
      -> {"results": [{"video_id": ..., "score": ...}, ...]}
      The query embeds through the batched text tower; the ranking is cosine
      against a ``command=predict`` dump (.pt or .npz).
- GET  /health       -> stats JSON (requests, batches, mean batch fill)

Server surfaces:
- stdlib: ``EMBED_ENCODER=clip_vit_b_16 python -m fitclip_torch.serving.embed_service [port]``
  (``EmbedHTTPServer``: ThreadingHTTPServer with a listen backlog of 128)
- WSGI:   ``gunicorn "fitclip_torch.serving.embed_service"`` (module-level
  ``application``); one worker per card.

Env:
- EMBED_ENCODER     config/encoder/<name>.yaml to serve (required)
- EMBED_OVERRIDES   further config overrides, space separated (e.g.
                    "++encoder.dtype=int8 +encoder.bpe_path=merges.txt")
- EMBED_DEVICE      "cuda" (default) or "cpu"; the CPU only when set
- EMBED_CHECKPOINT  optional bare-params torch .pt for fine-tuned weights
- EMBED_SCALES      an int8 encoder's persisted activation scales (.npz)
- EMBED_MAX_WAIT_MS batching window after the first request (default 2)
- EMBED_MAX_BATCH   largest text bucket (default 32)
- EMBED_MAX_VIDEO_BATCH  largest video bucket (default 8)
- EMBED_MAX_VIDEO_MB     request-size cap for /embed_video (default 64)
- EMBED_INDEX       predictions .pt/.npz from ``command=predict`` to serve
                    /search_videos from
- EMBED_EXPORT_DIR  serve the towers from ``torch.export`` artifacts
                    (``python -m fitclip_torch.serving.export_serving``) in
                    place of the encoder's own; the buckets are the ones the
                    artifacts were exported at. The tokenizer and the video
                    preprocessing still come from EMBED_ENCODER
- EMBED_COMPILE_CACHE  no counterpart: the kernels build once into build/ by
                    their sources' hash; a line is logged if it is set

On the card every bucket of both towers (the encoder's, or the loaded
programs') is captured at start-up, before any dispatcher runs (a capture may
not overlap other CUDA work); the video tower's dispatcher starts on the
first /embed_video, as the JAX service's does. On the CPU the towers are
called directly.
"""

import json
import logging
import os
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from fitclip_torch.cli.runners import encoder_device
from fitclip_torch.serving.batcher import BatchServer, ServerOverloaded

LOGGER = logging.getLogger(__name__)


def _tower_fn(tower, device):
    """A tower's encode as the batcher calls it: a batch on any device -> fp32
    embeddings on ``device``, without an autograd graph."""
    def encode(batch: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            return tower(batch.to(device)).float()
    return encode


class TextEmbedService:
    """Tokenizer + dynamic-batched text tower of one encoder. ``encode_fn``
    (a batch of token ids -> embeddings, e.g. a ``BucketGraphs``) replaces
    the eager tower."""

    def __init__(self, encoder, bucket_sizes: Sequence[int], max_wait_ms: float,
                 encode_fn=None):
        self._tokenize = encoder.get_tokenizer()
        context_len = self._tokenize(["warmup"]).shape[-1]
        device = encoder_device(encoder)
        self.server = BatchServer(
            encode_fn or _tower_fn(encoder.encode_text, device), item_shape=(context_len,),
            dtype=np.int64, bucket_sizes=bucket_sizes, max_wait_ms=max_wait_ms, device=device)

    def start(self) -> "TextEmbedService":
        self.server.start()
        return self

    def stop(self) -> None:
        self.server.stop()

    def embed_texts(self, texts: Sequence[str]) -> np.ndarray:
        """(N texts) -> (N, D). Rows are submitted individually so distinct
        HTTP requests share batches."""
        ids = np.asarray(self._tokenize(list(texts)), np.int64)
        futures = [self.server.submit(row) for row in ids]
        return np.stack([f.result() for f in futures])


class VideoEmbedService:
    """Eval data pipeline (decode -> frame-sample -> transform) + the
    dynamic-batched video tower. Preprocessing is the eval loader's
    ``build_pipeline(train=False)``, so a served embedding is the offline eval
    path's."""

    def __init__(self, encoder, bucket_sizes: Sequence[int], max_wait_ms: float,
                 encode_fn=None):
        from fitclip_torch.data.data_module import build_pipeline

        spec = encoder.preprocess
        self._pipeline = build_pipeline(encoder, train=False)
        self._num_frames = spec.pad_to_min_frames or spec.num_frames
        size = spec.image_size
        device = encoder_device(encoder)
        self.server = BatchServer(
            encode_fn or _tower_fn(encoder.encode_video, device),
            item_shape=(self._num_frames, size, size, 3), dtype=np.uint8,
            bucket_sizes=bucket_sizes, max_wait_ms=max_wait_ms, device=device)

    def start(self, warmup: bool = True) -> "VideoEmbedService":
        self.server.start(warmup=warmup)
        return self

    def stop(self) -> None:
        self.server.stop()

    def preprocess_bytes(self, data: bytes, fmt: str = "mp4") -> np.ndarray:
        """Raw container bytes -> (F, S, S, 3) uint8 eval clip."""
        import tempfile

        from fitclip_torch.data.transforms import pad_to_min_frames
        from fitclip_torch.data.video_reader import VideoReader

        if not fmt.isalnum():
            raise ValueError(f"bad format {fmt!r}")
        with tempfile.NamedTemporaryFile(suffix=f".{fmt}") as handle:
            handle.write(data)
            handle.flush()
            try:
                reader = VideoReader.from_path(handle.name)
                # Batch eval zero-fills undecodable clips; an online API
                # rejects them instead.
                if not reader.ok or len(reader) == 0:
                    raise ValueError
                indices = self._pipeline.sampler(0, len(reader) - 1, fps=reader.get_avg_fps())
                frames = reader(indices)
            except ValueError:
                raise ValueError("could not decode any frames") from None
            except Exception as error:  # decoder backends raise their own
                raise ValueError(f"could not decode video: {error}") from None
        clip = self._pipeline.transform(frames, None)
        # Short clips right-pad with zero frames (the eval collate's padding).
        return pad_to_min_frames(clip, self._num_frames).astype(np.uint8)

    def embed_video_bytes(self, data: bytes, fmt: str = "mp4") -> np.ndarray:
        return self.server.submit(self.preprocess_bytes(data, fmt)).result()


class RetrievalIndex:
    """Precomputed video embeddings + ids from ``command=predict`` (the port's
    .pt, read with torch.load, or an .npz); query ranking is a host-side
    cosine (embeddings are re-normalized at load: CLIP's frame-mean-pooled
    clip embeddings have norm < 1)."""

    def __init__(self, path: str):
        if path.endswith(".npz"):
            data = np.load(path)
            videos, ids = data["encoded_videos"], data["video_ids"]
        else:
            data = torch.load(path, map_location="cpu", weights_only=True)
            videos = np.asarray(torch.as_tensor(data["encoded_videos"]).float().numpy())
            ids = data["video_ids"]
        norms = np.linalg.norm(videos, axis=-1, keepdims=True)
        self.videos = np.asarray(videos, np.float32) / np.maximum(norms, 1e-8)
        self.video_ids = [str(v) for v in ids]
        if len(self.video_ids) != self.videos.shape[0]:
            raise ValueError("index ids/embeddings length mismatch")

    def search(self, query_emb: np.ndarray, top_k: int):
        q = np.asarray(query_emb, np.float32)
        q = q / max(float(np.linalg.norm(q)), 1e-8)
        scores = self.videos @ q
        top = np.argsort(-scores)[: max(1, top_k)]
        return [{"video_id": self.video_ids[i], "score": round(float(scores[i]), 6)}
                for i in top]


_SERVICE: Optional[TextEmbedService] = None
_VIDEO_SERVICE: Optional[VideoEmbedService] = None
_INDEX: Optional[RetrievalIndex] = None
_LOADED = None
_GRAPHS: Optional[Dict[str, object]] = None
_SERVICE_LOCK = threading.Lock()


def _load_encoder():
    """Instantiate (once) the encoder named by EMBED_ENCODER, on EMBED_DEVICE."""
    if os.environ.get("EMBED_COMPILE_CACHE"):
        LOGGER.info("EMBED_COMPILE_CACHE is ignored: the port's kernels build once into "
                    "build/fitclip_torch/<hash>/ and later processes load them")
    name = os.environ.get("EMBED_ENCODER")
    if not name:
        raise SystemExit("Set EMBED_ENCODER to a config/encoder/ name")
    return load_encoder(name, os.environ.get("EMBED_OVERRIDES", "").split(),
                        os.environ.get("EMBED_DEVICE", "cuda"), os.environ.get("EMBED_CHECKPOINT"),
                        os.environ.get("EMBED_SCALES"))


def load_encoder(name: str, overrides: Sequence[str] = (), device: str = "cuda",
                 checkpoint: Optional[str] = None, scales: Optional[str] = None):
    """The encoder of config/encoder/<name>.yaml with config ``overrides``, on
    ``device``, with a bare-params ``checkpoint`` and an int8 encoder's
    persisted ``scales`` (required for int8) loaded."""
    from fitclip_torch.cli.main import DEFAULT_CONFIG_DIR, load_checkpoint
    from fitclip_torch.config_engine import compose, instantiate

    config_dir = os.environ.get("FITCLIP_CONFIG_DIR", DEFAULT_CONFIG_DIR)
    cfg = compose(config_dir, "trainer", ["command=evaluate", f"encoder={name}", "data=msrvtt",
                                          *overrides])
    loaded = instantiate(cfg["encoder"], device=device)
    if isinstance(loaded, dict):
        raise SystemExit(f"{name} is a {{student,teacher}} slot — serve one "
                         "tower's encoder config instead")
    if checkpoint:
        loaded = load_checkpoint(loaded, checkpoint)
    prepare_quantized_params(loaded.encoder, scales)
    return loaded


def prepare_quantized_params(encoder, scales_path: Optional[str]):
    """int8 encoders need calibrated activation scales before any encode is
    valid. Serving NEVER calibrates on live traffic (a skewed first request
    would set every scale): it requires scales persisted by an offline eval
    run (``command=evaluate ++encoder.dtype=int8 ++quant.scales_path=scales.npz``),
    loaded here via EMBED_SCALES, in place."""
    if not getattr(encoder, "quantized", False):
        return encoder
    if not scales_path or not os.path.exists(scales_path):
        raise SystemExit(
            "quantized encoder: set EMBED_SCALES to the .npz written by an "
            "offline eval with ++quant.scales_path=... (serving never "
            "calibrates on live traffic)")
    from fitclip_torch.ops.quant import load_act_scales, require_calibrated

    model = getattr(encoder, "model", encoder)
    load_act_scales(scales_path, model)
    # Fail closed even if the .npz itself holds the uncalibrated sentinel.
    require_calibrated(model, context="serving")
    return encoder


def _ensure_loaded():
    global _LOADED
    if _LOADED is None:
        _LOADED = _load_encoder()
    return _LOADED


def _text_buckets() -> List[int]:
    max_batch = int(os.environ.get("EMBED_MAX_BATCH", "32"))
    return [b for b in (1, 2, 4, 8, 16, 32, 64, 128) if b <= max_batch]


def _video_buckets() -> List[int]:
    max_batch = int(os.environ.get("EMBED_MAX_VIDEO_BATCH", "8"))
    return [b for b in (1, 2, 4, 8, 16, 32) if b <= max_batch]


def _tower(name: str):
    """(encode, buckets) of the "text" or "video" tower: EMBED_EXPORT_DIR's
    program of it with the buckets it was exported at (``export.py``), else
    the loaded encoder's own with EMBED_MAX_BATCH's or EMBED_MAX_VIDEO_BATCH's."""
    export_dir = os.environ.get("EMBED_EXPORT_DIR")
    if export_dir:
        from fitclip_torch.serving.export import load_exported

        encode, per_bucket = load_exported(export_dir, name)
        return encode, sorted(per_bucket)
    encoder = _ensure_loaded().encoder
    if name == "text":
        return encoder.encode_text, _text_buckets()
    return encoder.encode_video, _video_buckets()


def tower_graphs(encoder, towers: Dict[str, Tuple]):
    """{"text": BucketGraphs, "video": BucketGraphs} on the card over each
    tower's (encode, buckets), with the encoder's input shapes, neither warmed
    nor captured yet."""
    from fitclip_torch.serving.graphs import BucketGraphs

    device = encoder_device(encoder)
    spec = encoder.preprocess
    context_len = encoder.get_tokenizer()(["warmup"]).shape[-1]
    frames = spec.pad_to_min_frames or spec.num_frames
    inputs = {"text": ((context_len,), torch.int64),
              "video": ((frames, spec.image_size, spec.image_size, 3), torch.uint8)}
    return {name: BucketGraphs(_tower_fn(encode, device), *inputs[name], buckets, device,
                               name=f"encode_{name}")
            for name, (encode, buckets) in towers.items()}


def warm_graphs() -> Optional[Dict[str, object]]:
    """On the card: build both towers' bucket graphs and run each bucket once,
    eagerly (None on the CPU). Idempotent."""
    global _GRAPHS
    loaded = _ensure_loaded()
    if encoder_device(loaded.encoder).type != "cuda":
        return None
    if _GRAPHS is None:
        _GRAPHS = tower_graphs(loaded.encoder, {name: _tower(name) for name in ("text", "video")})
        for graphs in _GRAPHS.values():
            graphs.warm()
    return _GRAPHS


def _captured_graphs() -> Optional[Dict[str, object]]:
    """Every bucket of both towers captured (on the card), before the first
    dispatcher starts."""
    graphs = warm_graphs()
    if graphs is not None:
        for tower in graphs.values():
            tower.capture()
    return graphs


def _tower_service(name: str, service_cls):
    """The tower's service over its captured graphs on the card, or over its
    encode called directly on the CPU."""
    loaded = _ensure_loaded()
    graphs = _captured_graphs()
    if graphs is not None:
        encode_fn, buckets = graphs[name], graphs[name].bucket_sizes
    else:
        encode, buckets = _tower(name)
        encode_fn = _tower_fn(encode, encoder_device(loaded.encoder))
    service = service_cls(loaded.encoder, bucket_sizes=buckets,
                          max_wait_ms=float(os.environ.get("EMBED_MAX_WAIT_MS", "2")),
                          encode_fn=encode_fn)
    return service.start()


def build_service() -> TextEmbedService:
    return _tower_service("text", TextEmbedService)


def build_video_service() -> VideoEmbedService:
    return _tower_service("video", VideoEmbedService)


def _ensure_service() -> TextEmbedService:
    global _SERVICE
    with _SERVICE_LOCK:
        if _SERVICE is None:
            _SERVICE = build_service()
    return _SERVICE


def _ensure_video_service() -> VideoEmbedService:
    global _VIDEO_SERVICE
    with _SERVICE_LOCK:
        if _VIDEO_SERVICE is None:
            _VIDEO_SERVICE = build_video_service()
    return _VIDEO_SERVICE


def _ensure_index() -> RetrievalIndex:
    global _INDEX
    with _SERVICE_LOCK:
        if _INDEX is None:
            path = os.environ.get("EMBED_INDEX")
            if not path or not os.path.exists(path):
                raise FileNotFoundError(
                    "no retrieval index — set EMBED_INDEX to a "
                    "command=predict dump (.pt/.npz)")
            _INDEX = RetrievalIndex(path)
    return _INDEX


def _error(status: int, message) -> Tuple[int, bytes]:
    return status, json.dumps({"status": status, "message": message}).encode()


def _handle(method: str, path: str, body: bytes, query_string: str = "") -> Tuple[int, bytes]:
    """Shared request logic for both server surfaces -> (status, JSON)."""
    from urllib.parse import parse_qs

    if path == "/embed_video" and method == "POST":
        limit = int(os.environ.get("EMBED_MAX_VIDEO_MB", "64")) * 2 ** 20
        if len(body) > limit:
            return _error(413, f"video over {limit >> 20} MB")
        if not body:
            return _error(400, "body must be raw video bytes")
        fmt = parse_qs(query_string).get("format", ["mp4"])[0]
        try:
            embedding = _ensure_video_service().embed_video_bytes(body, fmt)
            return 200, json.dumps({"embedding": embedding.astype(float).tolist(),
                                    "dim": int(embedding.shape[-1])}).encode()
        except ServerOverloaded as error:
            return _error(503, str(error))
        except ValueError as error:
            return _error(400, str(error))
        except Exception as error:  # noqa: BLE001 - surfaced to the client
            return _error(500, repr(error))
    if path == "/search_videos" and method == "GET":
        try:
            query = parse_qs(query_string)
            text = query.get("q", [""])[0]
            if not text:
                return _error(400, "missing ?q=<text>")
            top_k = int(query.get("top_k", ["10"])[0])
            index = _ensure_index()
            query_emb = _ensure_service().embed_texts([text])[0]
            return 200, json.dumps({"results": index.search(query_emb, top_k)}).encode()
        except (FileNotFoundError, ServerOverloaded) as error:
            return _error(503, str(error))
        except Exception as error:  # noqa: BLE001 - surfaced to the client
            return _error(500, repr(error))
    if path == "/health":
        stats = _ensure_service().server.stats
        payload = {"status": "ok", "requests": stats.requests, "batches": stats.batches,
                   "mean_batch_fill": round(stats.mean_batch_fill, 4)}
        if _VIDEO_SERVICE is not None:
            vstats = _VIDEO_SERVICE.server.stats
            payload["video"] = {"requests": vstats.requests, "batches": vstats.batches,
                                "mean_batch_fill": round(vstats.mean_batch_fill, 4)}
        return 200, json.dumps(payload).encode()
    if path == "/embed_text" and method == "POST":
        try:
            texts = json.loads(body or b"{}").get("texts")
            if (not isinstance(texts, list) or not texts
                    or not all(isinstance(t, str) for t in texts)):
                return _error(400, 'body must be {"texts": [str, ...]}')
            embeddings = _ensure_service().embed_texts(texts)
            return 200, json.dumps({"embeddings": embeddings.astype(float).tolist(),
                                    "dim": int(embeddings.shape[-1])}).encode()
        except ServerOverloaded as error:
            return _error(503, str(error))
        except Exception as error:  # noqa: BLE001 - surfaced to the client
            return _error(500, repr(error))
    return 404, json.dumps({"status": 404}).encode()


class Handler(BaseHTTPRequestHandler):
    def _respond(self, method: str) -> None:
        from urllib.parse import urlparse

        length = int(self.headers.get("Content-Length") or 0)
        body = self.rfile.read(length) if length else b""
        parsed = urlparse(self.path)
        status, payload = _handle(method, parsed.path, body, parsed.query)
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Access-Control-Allow-Origin", "*")
        self.send_header("Content-Length", str(len(payload)))
        self.end_headers()
        self.wfile.write(payload)

    def do_GET(self):  # noqa: N802
        self._respond("GET")

    def do_POST(self):  # noqa: N802
        self._respond("POST")

    def log_message(self, *args):
        pass


class EmbedHTTPServer(ThreadingHTTPServer):
    """The stdlib server, one thread per connection, with a listen backlog for
    a burst of clients: past socketserver's default of 5 pending connections
    the kernel drops a client's SYN, and its retry waits a second."""
    request_queue_size = 128
    daemon_threads = True


_STATUS_LINES = {200: "200 OK", 400: "400 Bad Request", 404: "404 Not Found",
                 413: "413 Content Too Large", 500: "500 Internal Server Error",
                 503: "503 Service Unavailable"}


def application(environ, start_response) -> List[bytes]:
    """WSGI entry point (gunicorn 'fitclip_torch.serving.embed_service')."""
    length = int(environ.get("CONTENT_LENGTH") or 0)
    body = environ["wsgi.input"].read(length) if length else b""
    status, payload = _handle(environ.get("REQUEST_METHOD", "GET"),
                              environ.get("PATH_INFO", "/"), body,
                              environ.get("QUERY_STRING", ""))
    start_response(_STATUS_LINES.get(status, f"{status} "), [
        ("Content-Type", "application/json"),
        ("Access-Control-Allow-Origin", "*"),
        ("Content-Length", str(len(payload))),
    ])
    return [payload]


def main() -> None:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    _ensure_service()
    port = int(sys.argv[1]) if len(sys.argv) > 1 else 8081
    print(f"Embedding service ({os.environ.get('EMBED_ENCODER')}) on :{port}")
    EmbedHTTPServer(("0.0.0.0", port), Handler).serve_forever()


if __name__ == "__main__":
    main()
