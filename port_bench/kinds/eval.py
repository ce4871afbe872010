"""Zero-shot retrieval eval, device-resident: the loop that the evaluate
command's retrieval runs (``cli/runners.py:_retrieval_metrics``), on a corpus
made on the card, without decode.

One pass: every clip and caption of the corpus through ``make_eval_step`` in
batches, each batch fed to ``RetrievalEvaluator.update``, then
``RetrievalEvaluator.compute`` (R@1/5/10, median rank over the whole
corpus). Set-up makes the corpus and the weights from the seed, builds the
program's encoder, calibrates an int8 one on the first batches as the command
does, and runs one pass, which warms every shape the window uses. The window
runs passes back to back until ``seconds`` have passed; its rate is the clips
of the completed passes over the time to the end of the last. A ``--trace 1``
run profiles ``traced_passes`` more after it.

The comparison that decides ``correct``, once the window has closed and the
program is freed:
- ``video_gap``, ``text_gap``: the widest relative L2 gap, over every clip and
  caption of one pass drawn from the seed, between the program's embeddings
  and the float32 reference's on the same weights and inputs;
- ``rows_missing``: clips a pass of the window did not embed;
- ``ranking_gap``: the largest difference, over every pass, between the
  program's R@1/5/10 (as counts) and median rank and those of a plain ranking
  of the embeddings the eval step gave that pass.

Faults for the tests (``fault``): "altered" changes one clip's embedding where
the step produces it; "half" leaves out half of each batch's rows, so the
metrics are taken over the rest.
"""

import time
from typing import Dict, List, Optional

import torch

from port_bench import traffic
from port_bench.harness import Check, Reading
from port_bench.reference.common import full_float32
from port_bench.tracing import HostLoad, profiled, span

# The keys of a traffic mix and of a cell file that this kind reads ("about"
# describes the mix); the manifest's test refuses any other.
TRAFFIC_KEYS = {"kind", "about", "clips", "batch", "caption_tokens", "calibration_batches",
                "traced_passes"}
CELL_KEYS = {"precision", "control_bits", "limits"}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _faulty(step, fault: str):
    def altered(batch):
        video, text = step(batch)
        return torch.cat([-video[:1], video[1:]]), text

    def half(batch):
        video, text = step(batch)
        keep = max(1, video.shape[0] // 2)
        return video[:keep], text[:keep]

    return {"altered": altered, "half": half}[fault]


def corpus(cell, seed: int, device: torch.device):
    """The seed's clips and captions, on the device."""
    frames, size, context = cell.family.shapes(cell.config)
    mix = cell.traffic
    video = traffic.clips(mix["clips"], frames, size, traffic.generator(seed, "video", device),
                          device)
    ids = traffic.captions(mix["clips"], context, mix["caption_tokens"], cell.config["tokens"],
                           traffic.generator(seed, "captions", device), device)
    return video, ids


def batch_bounds(cell) -> List[tuple]:
    clips, batch = cell.traffic["clips"], cell.traffic["batch"]
    return [(a, min(a + batch, clips)) for a in range(0, clips, batch)]


def unit_calls(cell) -> list:
    family, precision = cell.family, cell.spec["precision"]
    return [c for a, b in batch_bounds(cell)
            for c in family.eval_calls(cell.config, precision, b - a, b - a)]


def run(cell, seed: int, seconds: float, trace: bool, started: float, device: str,
        fault: Optional[str] = None) -> Reading:
    from fitclip_torch.evaluation.retrieval import RetrievalEvaluator
    from fitclip_torch.training.steps import make_eval_step

    dev = torch.device(device)
    family, mix, spec = cell.family, cell.traffic, cell.spec
    stages = {"imports": time.perf_counter() - started}
    video, ids = corpus(cell, seed, dev)
    weights = family.make_weights(cell.config, seed, "weights", dev)
    _sync(dev)
    stages["inputs"] = time.perf_counter() - started
    encoder = family.load_program(cell.config, weights, dev, spec["precision"])
    del weights
    _sync(dev)
    stages["load"] = time.perf_counter() - started
    bounds = batch_bounds(cell)
    if spec["precision"] == "int8":
        family.calibrate(encoder, [(video[a:b], ids[a:b])
                                   for a, b in bounds[:mix["calibration_batches"]]])
    _sync(dev)
    stages["calibrate"] = time.perf_counter() - started
    step = make_eval_step(encoder)
    if fault:
        step = _faulty(step, fault)

    host = HostLoad()

    def one_pass():
        evaluator, outputs = RetrievalEvaluator(), []
        load, start = host.now(), time.perf_counter()
        with span("issue"):
            for a, b in bounds:
                video_emb, text_emb = step({"video": video[a:b], "text": ids[a:b]})
                evaluator.update(video_emb, text_emb)
                outputs.append((video_emb, text_emb))
        issued = time.perf_counter()
        with span("wait"):  # compute() would wait here for the batches anyway
            _sync(dev)
        waited = time.perf_counter()
        with span("score"):
            metrics = evaluator.compute()
        done = time.perf_counter()
        return outputs, metrics, {"issue": issued - start, "wait": waited - issued,
                                  "score": done - waited}, host.delta(load)

    one_pass()
    _sync(dev)
    reading = Reading(setup_s=time.perf_counter() - started, items_per_unit=mix["clips"],
                      unit_calls=unit_calls(cell))
    reading.notes["setup_s_by_stage_end"] = dict(stages, warm=reading.setup_s)
    passes = []
    start = time.perf_counter()
    while True:
        passes.append(one_pass())
        now = time.perf_counter()
        if now - start >= seconds:
            break
    reading.window_s = now - start
    reading.units = len(passes)
    timed = list(passes)
    if trace:  # after the window, which the profiler's after-effects would slow
        with profiled() as traced:
            with span("window"):
                for _ in range(mix["traced_passes"]):
                    passes.append(one_pass())
                _sync(dev)
        reading.trace, reading.traced_units = traced[0], mix["traced_passes"]
    reading.span_s = {name: [p[2][name] for p in timed] for name in ("issue", "wait", "score")}
    reading.notes["pass_s"] = [round(sum(p[2].values()), 4) for p in timed]
    reading.notes["pass_host"] = {name: [p[3][name] for p in timed] for name in HostLoad.FIELDS}
    host.close()
    if dev.type == "cuda":
        reading.memory_peak_bytes = torch.cuda.max_memory_allocated(dev)
    reading.attempted = mix["clips"] * len(passes)
    rows = [sum(v.shape[0] for v, _ in p[0]) for p in passes]
    reading.failed = sum(mix["clips"] - r for r in rows)

    outputs = [(torch.cat([v for v, _ in p[0]]), torch.cat([t for _, t in p[0]]), p[1])
               for p in passes]
    del encoder, step, passes
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    reading.checks = compare(cell, seed, dev, video, ids, outputs, rows)
    return reading


def _ranking_counts(videos: torch.Tensor, texts: torch.Tensor) -> torch.Tensor:
    """(R@1, R@5, R@10 as counts, median rank) of text->video retrieval with
    target i for caption i: a query's rank is its target's place when the row
    is sorted descending, earlier columns first among equal scores."""
    scores = texts.float().cpu() @ videos.float().cpu().T
    order = torch.argsort(scores, dim=1, descending=True, stable=True)
    ranks = (order == torch.arange(scores.shape[0])[:, None]).int().argmax(dim=1)
    counts = [int((ranks < k).sum()) for k in (1, 5, 10)]
    median = int(torch.sort(ranks).values[(ranks.shape[0] - 1) // 2]) + 1
    return torch.tensor(counts + [median], dtype=torch.float64)


def _program_counts(metrics: Dict[str, float], rows: int) -> torch.Tensor:
    return torch.tensor([round(metrics[k] * rows) for k in ("r1", "r5", "r10")] + [metrics["mr"]],
                        dtype=torch.float64)


def widest_gap(program: torch.Tensor, reference: torch.Tensor) -> float:
    """The largest ||p - r|| / ||r|| over rows."""
    gap = torch.linalg.vector_norm(program.double() - reference.double(), dim=-1)
    return float((gap / torch.linalg.vector_norm(reference.double(), dim=-1)).max())


def reference_embeddings(cell, seed: int, device: torch.device, video, ids,
                         bits: Optional[dict] = None):
    """The reference's embeddings of every clip and caption, in blocks of a batch."""
    family, cfg = cell.family, cell.config
    weights = family.make_weights(cfg, seed, "weights", device)
    videos, texts = [], []
    with torch.no_grad(), full_float32():
        for a, b in batch_bounds(cell):
            videos.append(family.reference_video(weights, video[a:b], cfg, bits))
            texts.append(family.reference_text(weights, ids[a:b], cfg, bits))
    return torch.cat(videos), torch.cat(texts)


def compare(cell, seed: int, device: torch.device, video, ids, outputs, rows) -> Dict[str, Check]:
    limits = cell.spec["limits"]
    clips = cell.traffic["clips"]
    checks = {"rows_missing": Check(float(max(clips - r for r in rows)), limits["rows_missing"])}
    ranking = 0.0
    for (videos, texts, metrics), count in zip(outputs, rows):
        if count == clips:
            gap = (_program_counts(metrics, count) - _ranking_counts(videos, texts)).abs().max()
            ranking = max(ranking, float(gap))
    checks["ranking_gap"] = Check(ranking, limits["ranking_gap"])
    pick = torch.Generator().manual_seed(traffic.derived_seed(seed, "compared pass"))
    index = int(torch.randint(len(outputs), (1,), generator=pick))
    program_video, program_text, _ = outputs[index]
    ref_video, ref_text = reference_embeddings(cell, seed, device, video, ids)
    if program_video.shape != ref_video.shape or program_text.shape != ref_text.shape:
        checks["video_gap"] = Check(float("inf"), limits["video_gap"])
        checks["text_gap"] = Check(float("inf"), limits["text_gap"])
    else:
        checks["video_gap"] = Check(widest_gap(program_video, ref_video), limits["video_gap"])
        checks["text_gap"] = Check(widest_gap(program_text, ref_text), limits["text_gap"])
    return checks


def control(cell, seed: int, device: str, worst: Optional[dict] = None) -> Dict[str, float]:
    """The control's readings: the reference at the precisions one step below
    what the cell states (``control_bits``) against the float32 reference, on
    the seed's weights and corpus."""
    dev = torch.device(device)
    video, ids = corpus(cell, seed, dev)
    ref_video, ref_text = reference_embeddings(cell, seed, dev, video, ids)
    low_video, low_text = reference_embeddings(cell, seed, dev, video, ids,
                                               cell.spec["control_bits"])
    return {"video_gap": widest_gap(low_video, ref_video),
            "text_gap": widest_gap(low_text, ref_text)}
