"""Moments in Time classification (port of
``fitclip_tpu/data/datasets/moments_in_time.py``): a categories CSV of
``name,id`` and a headerless validation CSV of
path,category,agreement,disagreement indexed by path; video ids are
"<category_folder>/<filename>" (aligner/data/moments_in_time.py:20-65)."""

import os
from typing import Mapping, Tuple

from fitclip_torch.data.data_module import (VideoClassificationDataModule,
                                            get_sorted_videos_in_folder)
from fitclip_torch.data.datasets.table import read_table
from fitclip_torch.data.video_dataset import VideoDataset


class MomentsInTime(VideoDataset):
    def __init__(self, categories: Mapping[str, int], video_info_file_path,
                 videos_folder, **kwargs) -> None:
        super().__init__(video_paths=get_sorted_videos_in_folder(videos_folder), **kwargs)
        self.categories = categories
        info = read_table(video_info_file_path,
                          names=["path", "category", "agreement", "disagreement"])
        self.category_by_path = {}
        for path, category in zip(info["path"], info["category"]):
            self.category_by_path.setdefault(path, category)

    def _get_video_id(self, video_idx: int) -> str:
        folder_path, filename = os.path.split(self.video_paths[video_idx])
        return os.path.join(os.path.basename(folder_path), filename)

    def _get_target(self, video_idx: int) -> Tuple[str, int]:
        category = self.category_by_path[self._get_video_id(video_idx)]
        return category, self.categories[category]


class MomentsInTimeDataModule(VideoClassificationDataModule):
    def __init__(self, categories_file_path, val_video_info_file_path,
                 val_videos_folder, **kwargs) -> None:
        super().__init__(**kwargs)
        self.val_video_info_file_path = val_video_info_file_path
        self.val_videos_folder = val_videos_folder
        self._categories = {}
        with open(categories_file_path) as file:
            for line in file:
                if line.strip():
                    category, id_ = line.rstrip().split(",")
                    self._categories[category] = int(id_)

    @property
    def categories(self) -> Mapping[str, int]:
        return self._categories

    def val_dataloader(self):
        dataset = MomentsInTime(categories=self.categories,
                                video_info_file_path=self.val_video_info_file_path,
                                videos_folder=self.val_videos_folder,
                                **self._dataset_kwargs(train=False))
        return self._create_dataloader(dataset, train=False)
