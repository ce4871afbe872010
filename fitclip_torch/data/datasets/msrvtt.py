"""MSR-VTT retrieval dataset, 1K-A jsfusion split by default (port of
``fitclip_tpu/data/datasets/msrvtt.py``).

Metadata layout matches the Frozen-in-Time MSRVTT distribution the reference
consumes (aligner/data/msrvtt.py:20-79): a videos folder, a split file list,
and ``annotation/MSR_VTT.json`` with per-video caption lists. Caption strategy
is "first" for eval and "random" for train.
"""

import json
import os
from typing import Literal

import numpy as np

from fitclip_torch.data.data_module import (VideoTextDataModule,
                                          get_sorted_videos_in_folder)
from fitclip_torch.data.video_dataset import VideoDataset

CaptionStrategy = Literal["first", "random"]


class MsrVtt(VideoDataset):
    def __init__(self, videos_folder, file_list_path, annotations_path,
                 caption_sampling_strategy: CaptionStrategy, **kwargs) -> None:
        with open(file_list_path) as file:
            video_ids = {line.strip() for line in file if line.strip()}
        video_paths = [path for path in get_sorted_videos_in_folder(videos_folder)
                       if os.path.basename(path).split(".", 1)[0] in video_ids]
        super().__init__(video_paths=video_paths, **kwargs)
        self.caption_sampling_strategy = caption_sampling_strategy

        with open(annotations_path) as file:
            metadata = json.load(file)
        self.captions_by_id = {}
        for annotation in metadata["annotations"]:
            self.captions_by_id.setdefault(annotation["image_id"], []).append(
                annotation["caption"])

    def _get_target(self, video_idx: int, rng=None) -> str:
        captions = self.captions_by_id[self._get_video_id(video_idx)]
        if self.caption_sampling_strategy == "first":
            return captions[0]
        if self.caption_sampling_strategy == "random":
            rng = rng or np.random.default_rng()
            return captions[int(rng.integers(0, len(captions)))]
        raise ValueError(
            f"Invalid caption sampling strategy: {self.caption_sampling_strategy}")


class MsrVttDataModule(VideoTextDataModule):
    def __init__(self, base_path,
                 train_file_list_rel_path="train_list_jsfusion.txt",
                 val_file_list_rel_path="val_list_jsfusion.txt",  # 1K-A split
                 **kwargs) -> None:
        super().__init__(**kwargs)
        self.videos_folder = os.path.join(base_path, "videos/all")
        self.annotation_path = os.path.join(base_path, "annotation/MSR_VTT.json")
        self.train_file_list_path = os.path.join(base_path, "structured-symlinks",
                                                 train_file_list_rel_path)
        self.val_file_list_path = os.path.join(base_path, "structured-symlinks",
                                               val_file_list_rel_path)

    def _dataset(self, file_list_path, strategy: CaptionStrategy, train: bool):
        return MsrVtt(videos_folder=self.videos_folder, file_list_path=file_list_path,
                      annotations_path=self.annotation_path,
                      caption_sampling_strategy=strategy,
                      **self._dataset_kwargs(train=train))

    def train_dataloader(self):
        return self._create_dataloader(
            self._dataset(self.train_file_list_path, "random", train=True), train=True)

    def val_dataloader(self):
        return self._create_dataloader(
            self._dataset(self.val_file_list_path, "first", train=False), train=False)
