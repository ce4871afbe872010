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
    for video, text in observations:
        amax = merge_act_amax(amax, encoder.collect_act_amax(video, text))
    apply_act_scales(encoder.model, amax)
    scales_path = (quant_cfg or {}).get("scales_path")
    if scales_path:
        save_act_scales(scales_path, encoder.model)
        LOGGER.info("Persisted int8 activation scales to %s", scales_path)
    LOGGER.info("Calibrated int8 activation scales on %d batch(es)", len(observations))


def _needs_calibration(encoder, quant_cfg) -> bool:
    return bool(getattr(encoder, "quantized", False)) and not _load_persisted_scales(
        encoder, quant_cfg)


def _calibration_batches(quant_cfg) -> int:
    return max(1, int((quant_cfg or {}).get("calibration_batches", 4)))


def _video_text(batch, device):
    """A batch's video and text on the device, and its video ids. A
    dual-preprocessed (teacher-student) batch gives its student view, on which
    training validates (teacher_student.py:142-173 of the reference)."""
    return (to_device(batch.get("video", batch.get("video_student")), device),
            to_device(batch.get("text", batch.get("text_student")), device),
            batch.get("video_id", []))


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
    for video, text, _ in batches:
        evaluator.update(encoder.encode_video(video), encoder.encode_text(text))
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
        observations.append((to_device(batch["video"], device),
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
        evaluator.update(encoder.encode_video(to_device(batch["video"], device)),
                         batch["label"])
    return evaluator.compute()


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
        for video, text, ids in batches:
            encoded_videos.append(encoder.encode_video(video).float())
            encoded_texts.append(encoder.encode_text(text).float())
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
            scores = (encoder.encode_video(to_device(batch["video"], device)).float()
                      @ label_bank.T)
            predicted.append(scores.argmax(dim=-1))
            label_list.append(torch.as_tensor(np.asarray(batch["label"])))
            video_ids.extend(batch.get("video_id", []))
    predictions = {"predictions": torch.cat(predicted).cpu(), "labels": torch.cat(label_list),
                   "video_ids": video_ids}
    return _save_predictions(predictions, output_path)


def _save_predictions(predictions, output_path):
    if output_path:
        torch.save(predictions, output_path)
        LOGGER.info("Saved predictions to %s", output_path)
    return predictions
