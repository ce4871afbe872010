"""Command runners (port of ``fitclip_tpu/cli/runners.py``): the device loop of
``evaluate``/``validate``/``test`` and ``predict``, on the encoder's device.

Each runner iterates a data module's loader (host decode in threads,
prefetched), moves each batch to the encoder's device and encodes it. A
grouped data module (``data_module_group.EvalDataModuleGroup``) runs each
member's loader in turn: eval gives each member its own evaluator and
suffixes its metrics ``{key}_{name}``, predict concatenates the members'
embeddings. Each member is scored by its own task: retrieval, or zero-shot
classification for a classification data module. Metrics come back as plain
dicts.

An int8 encoder is calibrated before its first encode: from the persisted
scales of ``quant.scales_path`` when that file exists, otherwise on the first
``quant.calibration_batches`` batches (default 4) of the first loader, the
running abs-max over them written once and saved to ``quant.scales_path`` if
one is named; later loaders of a group keep those scales. The head batches are
then encoded with the rest. ``predict`` takes the same route (the JAX
package's predict does not calibrate).

Under a process group the runners are data-parallel, as the JAX package's
over its mesh: every rank decodes each whole batch (the eval loaders are not
sliced), pads it to a multiple of the rank count
(``parallel/mesh.py:pad_batch_to_divisible``), encodes its own row block
(``multihost.process_local_rows``) on its device through the same kernels as
one device, and gathers the embeddings in rank order (``multihost.host_array``),
the pad rows dropped. Every rank computes the same metrics; only the main
process writes ``predictions.pt`` and the scales file. An int8 calibration
observes each rank's blocks, and each site's abs-max is reduced with MAX over
the ranks before the scales are set, so every rank holds the global batch's
scales.
"""

import itertools
import logging
import os
import time
from typing import Any, Dict, Iterator, List, Mapping, Optional, Tuple

import numpy as np
import torch

from fitclip_torch.data.data_module import VideoClassificationDataModule
from fitclip_torch.data.data_module_group import EvalDataModuleGroup, TrainAndEvalDataModules
from fitclip_torch.evaluation.classification import (ClassificationEvaluator,
                                                     encode_label_bank, tokenize_label_bank)
from fitclip_torch.evaluation.retrieval import RetrievalEvaluator
from fitclip_torch.ops.quant import (apply_act_scales, load_act_scales, merge_act_amax,
                                     save_act_scales)
from fitclip_torch.parallel import multihost
from fitclip_torch.parallel.mesh import pad_batch_to_divisible
from fitclip_torch.utils.profiling import span

LOGGER = logging.getLogger(__name__)

LABEL_BANK_BATCH = 32


def encoder_device(encoder) -> torch.device:
    return next(encoder.parameters()).device


def to_device(array: np.ndarray, device: torch.device) -> torch.Tensor:
    """uint8 video stays uint8 (normalized on the device); token ids become int64."""
    tensor = torch.from_numpy(np.ascontiguousarray(array))
    if tensor.dtype == torch.int32:
        tensor = tensor.long()
    return tensor.to(device, non_blocking=True)


def _members(data_module, split: str) -> List[Tuple[Optional[str], Any, Any]]:
    """(name, data module, loader) of each member of a group, in order, or
    [(None, data_module, its loader)]. split: "val", "test" or "predict". A
    train-and-eval module evaluates its eval module, a group's members under
    their own names."""
    if isinstance(data_module, TrainAndEvalDataModules):
        return _members(data_module.eval_data_module, split)
    loaders = getattr(data_module, f"{split}_dataloader")()
    if isinstance(data_module, EvalDataModuleGroup):
        return list(zip(data_module.names, data_module.data_modules, loaders))
    return [(None, data_module, loaders)]


def _load_persisted_scales(encoder, quant_cfg) -> bool:
    """Restore the persisted activation scales of quant.scales_path if the
    file exists; whether it did."""
    scales_path = (quant_cfg or {}).get("scales_path")
    if scales_path and os.path.exists(scales_path):
        LOGGER.info("Loading persisted int8 activation scales from %s", scales_path)
        load_act_scales(scales_path, encoder.model)
        return True
    return False


def _calibrate_on_batches(encoder, observations, quant_cfg) -> None:
    """Post-training quantization over the observed (video, text) batches:
    the running abs-max of each site, written once (and saved if
    quant.scales_path names a file)."""
    amax = None
    with span("calibrate"):
        for video, text in observations:
            amax = merge_act_amax(amax, encoder.collect_act_amax(video, text))
        apply_act_scales(encoder.model, multihost.all_reduce_max(amax))
    scales_path = (quant_cfg or {}).get("scales_path")
    if scales_path:
        if multihost.is_main_process():
            save_act_scales(scales_path, encoder.model)
            LOGGER.info("Persisted int8 activation scales to %s", scales_path)
        multihost.barrier()
    LOGGER.info("Calibrated int8 activation scales on %d batch(es)", len(observations))


def _needs_calibration(encoder, quant_cfg) -> bool:
    return bool(getattr(encoder, "quantized", False)) and not _load_persisted_scales(
        encoder, quant_cfg)


def _calibration_batches(quant_cfg) -> int:
    return max(1, int((quant_cfg or {}).get("calibration_batches", 4)))


def _rank_rows(arrays: Dict[str, np.ndarray]) -> Tuple[Dict[str, np.ndarray], Optional[int]]:
    """This rank's row block of a batch padded to the rank count, and the
    batch's real rows (None and the batch itself without a group)."""
    if not torch.distributed.is_initialized():
        return arrays, None
    padded, valid = pad_batch_to_divisible(arrays, multihost.process_count())
    block = multihost.process_local_rows(len(next(iter(padded.values()))))
    return {key: value[block] for key, value in padded.items()}, valid


def _gathered(rows: torch.Tensor, valid: Optional[int]) -> torch.Tensor:
    """Every rank's rows in rank order, the pad rows dropped; ``rows`` without a group."""
    return rows if valid is None else multihost.host_array(rows)[:valid]


def _video_text(batch, device):
    """This rank's rows of a batch's video and text on the device, its video
    ids and its real row count (None without a group). A dual-preprocessed
    (teacher-student) batch gives its student view, on which training
    validates (teacher_student.py:142-173 of the reference)."""
    rows, valid = _rank_rows({"video": batch.get("video", batch.get("video_student")),
                              "text": batch.get("text", batch.get("text_student"))})
    return (to_device(rows["video"], device), to_device(rows["text"], device),
            batch.get("video_id", []), valid)


def _log_rate(what: str, clips: int, start: float, calibrated: bool) -> None:
    seconds = time.perf_counter() - start
    LOGGER.info("%s %d clips in %.3f s (%.1f clips/s, decode%s included)", what, clips,
                seconds, clips / seconds, " and calibration" if calibrated else "")


def _calibrated_batches(encoder, batches: Iterator, quant_cfg, calibrate: bool) -> Iterator:
    """``batches`` of (video, text, ...) with the encoder calibrated on the head ones first."""
    if not calibrate:
        return batches
    head = list(itertools.islice(batches, _calibration_batches(quant_cfg)))
    _calibrate_on_batches(encoder, [(b[0], b[1]) for b in head], quant_cfg)
    return itertools.chain(head, batches)


def _retrieval_metrics(encoder, device, loader, quant_cfg, calibrate: bool) -> Dict[str, float]:
    evaluator = RetrievalEvaluator()
    start, clips = time.perf_counter(), 0
    batches = _calibrated_batches(encoder, (_video_text(b, device) for b in loader), quant_cfg,
                                  calibrate)
    for video, text, _, valid in batches:
        with span("encode_video"):
            video_emb = _gathered(encoder.encode_video(video), valid)
        with span("encode_text"):
            text_emb = _gathered(encoder.encode_text(text), valid)
        evaluator.update(video_emb, text_emb)
        clips += video.shape[0]
    metrics = evaluator.compute()  # waits for the device
    _log_rate("Evaluated", clips, start, calibrate)
    return metrics


def _label_bank(encoder, data_module):
    categories = data_module.categories
    labels = [name for name, _ in sorted(categories.items(), key=lambda kv: kv[1])]
    return labels, tokenize_label_bank(encoder, labels, data_module.templates)


def _classification_head(encoder, batches: Iterator, tokenized: np.ndarray, quant_cfg,
                         device, calibrate: bool) -> List[Any]:
    """Calibrate an int8 encoder on the head batches (the text tower on a
    slice of the real label bank each); return them for the eval loop."""
    if not calibrate:
        return []
    head = list(itertools.islice(batches, _calibration_batches(quant_cfg)))
    observations = []
    for i, batch in enumerate(head):
        rows = tokenized[i * LABEL_BANK_BATCH:(i + 1) * LABEL_BANK_BATCH]
        observations.append((to_device(_rank_rows({"video": batch["video"]})[0]["video"],
                                       device),
                             to_device(rows, device) if len(rows) else None))
    if observations:
        _calibrate_on_batches(encoder, observations, quant_cfg)
    return head


def _classification_metrics(encoder, device, loader, quant_cfg, calibrate: bool,
                            data_module) -> Dict[str, float]:
    """Zero-shot classification: videos scored against the encoded label bank."""
    labels, tokenized = _label_bank(encoder, data_module)
    batches = iter(loader)
    head = _classification_head(encoder, batches, tokenized, quant_cfg, device, calibrate)
    label_bank = encode_label_bank(encoder, tokenized, len(labels), device)
    evaluator = ClassificationEvaluator(label_bank=label_bank)
    for batch in itertools.chain(head, batches):
        evaluator.update(_encode_videos(encoder, batch, device), batch["label"])
    return evaluator.compute()


def _encode_videos(encoder, batch, device) -> torch.Tensor:
    """The batch's video embeddings, each rank encoding its block under a group."""
    rows, valid = _rank_rows({"video": batch["video"]})
    video = to_device(rows["video"], device)
    with span("encode_video"):
        return _gathered(encoder.encode_video(video), valid)


@torch.no_grad()
def run_eval(loaded, data_module, split: str = "val",
             quant_cfg: Optional[Mapping[str, Any]] = None) -> Dict[str, float]:
    """command=evaluate/validate/test (test routes to the test split): zero-shot
    text->video retrieval, or zero-shot classification for a classification
    data module; over a group, each member by its own task with its metrics
    suffixed by its name."""
    encoder = loaded.encoder
    device = encoder_device(encoder)
    calibrate = _needs_calibration(encoder, quant_cfg)
    results: Dict[str, float] = {}
    for name, member, loader in _members(data_module, split):
        if isinstance(member, VideoClassificationDataModule):
            metrics = _classification_metrics(encoder, device, loader, quant_cfg, calibrate,
                                              member)
        else:
            metrics = _retrieval_metrics(encoder, device, loader, quant_cfg, calibrate)
        calibrate = False
        suffix = f"_{name}" if name else ""
        results.update({f"{key}{suffix}": value for key, value in metrics.items()})
    return results


@torch.no_grad()
def run_predict(loaded, data_module, output_path: str = "predictions.pt",
                quant_cfg: Optional[Mapping[str, Any]] = None) -> Dict[str, Any]:
    """command=predict: the embeddings and video ids, saved with torch.save
    under the JAX package's keys, a group's members concatenated. Classification
    data modules get the argmax-prediction variant, each member against its own
    label bank."""
    members = [(member, loader) for _, member, loader in _members(data_module, "predict")]
    kinds = {isinstance(member, VideoClassificationDataModule) for member, _ in members}
    if len(kinds) > 1:
        raise ValueError("predict over a group that mixes classification and retrieval data "
                         "modules: their predictions have different keys")
    encoder = loaded.encoder
    device = encoder_device(encoder)
    calibrate = _needs_calibration(encoder, quant_cfg)
    if kinds == {True}:
        return _run_predict_classification(encoder, device, members, output_path, quant_cfg,
                                           calibrate)
    encoded_videos, encoded_texts, video_ids = [], [], []
    start, calibrated = time.perf_counter(), calibrate
    for _, loader in members:
        batches = _calibrated_batches(encoder, (_video_text(b, device) for b in loader),
                                      quant_cfg, calibrate)
        calibrate = False
        for video, text, ids, valid in batches:
            with span("encode_video"):
                encoded_videos.append(_gathered(encoder.encode_video(video).float(), valid))
            with span("encode_text"):
                encoded_texts.append(_gathered(encoder.encode_text(text).float(), valid))
            video_ids.extend(ids)
    predictions = {"encoded_videos": torch.cat(encoded_videos).cpu(),  # waits for the device
                   "encoded_texts": torch.cat(encoded_texts).cpu(),
                   "video_ids": video_ids}
    _log_rate("Encoded", predictions["encoded_videos"].shape[0], start, calibrated)
    return _save_predictions(predictions, output_path)


def _run_predict_classification(encoder, device, members, output_path, quant_cfg, calibrate):
    predicted, label_list, video_ids = [], [], []
    for member, loader in members:
        labels, tokenized = _label_bank(encoder, member)
        batches = iter(loader)
        head = _classification_head(encoder, batches, tokenized, quant_cfg, device, calibrate)
        calibrate = False
        label_bank = encode_label_bank(encoder, tokenized, len(labels), device)
        for batch in itertools.chain(head, batches):
            scores = _encode_videos(encoder, batch, device).float() @ label_bank.T
            predicted.append(scores.argmax(dim=-1))
            label_list.append(torch.as_tensor(np.asarray(batch["label"])))
            video_ids.extend(batch.get("video_id", []))
    predictions = {"predictions": torch.cat(predicted).cpu(), "labels": torch.cat(label_list),
                   "video_ids": video_ids}
    return _save_predictions(predictions, output_path)


def _save_predictions(predictions, output_path):
    if output_path and multihost.is_main_process():
        torch.save(predictions, output_path)
        LOGGER.info("Saved predictions to %s", output_path)
    return predictions
