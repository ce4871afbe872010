"""Kinetics classification (port of ``fitclip_tpu/data/datasets/kinetics.py``):
CSV with youtube_id/time_start/time_end/label, video ids
"{youtube_id}_{start:06}_{end:06}", 28 CLIP templates
(aligner/data/kinetics.py:15-121). The CSV is read with the standard
library's ``csv``, numbers as pandas types them (int, else float).
"""

import csv
import os
from typing import Mapping, Optional, Sequence, Tuple

from fitclip_torch.data.data_module import (VideoClassificationDataModule,
                                          get_sorted_videos_in_folder)
from fitclip_torch.data.video_dataset import VideoDataset

# The 28 OpenAI CLIP Kinetics700 templates
# (github.com/openai/CLIP/blob/main/data/prompts.md#kinetics700): media word
# outermost, then the bare form and six "a person <verb>" forms.
_MEDIA = ("photo", "video", "example", "demonstration")
_SUBJECTS = ("", "a person ", "a person using ", "a person doing ",
             "a person during ", "a person performing ", "a person practicing ")

KINETICS_TEMPLATES = [
    f"a {medium} of {subject}{{}}."
    for medium in _MEDIA
    for subject in _SUBJECTS
]


def _number(text: str):
    try:
        return int(text)
    except ValueError:
        return float(text)


class Kinetics(VideoDataset):
    def __init__(self, categories: Mapping[str, int], video_info_file_path,
                 videos_folder, filter_videos_from_info_file: bool = False,
                 **kwargs) -> None:
        self.categories = categories
        with open(video_info_file_path, newline="") as file:
            rows = list(csv.DictReader(file))
        self.labels = {}
        for row in rows:
            start, end = _number(row["time_start"]), _number(row["time_end"])
            self.labels.setdefault(f"{row['youtube_id']}_{start:06}_{end:06}", row["label"])

        if filter_videos_from_info_file:
            video_paths = [os.path.join(videos_folder, f"{video_id}.mp4")
                           for video_id in self.labels]
        else:
            video_paths = get_sorted_videos_in_folder(videos_folder)
        super().__init__(video_paths=video_paths, **kwargs)

    def _get_target(self, video_idx: int) -> Tuple[str, int]:
        category = self.labels[self._get_video_id(video_idx)]
        return category, self.categories[category]


class KineticsDataModule(VideoClassificationDataModule):
    def __init__(self, categories_file_path, train_video_info_file_path=None,
                 train_videos_folder=None, val_video_info_file_path=None,
                 val_videos_folder=None, test_video_info_file_path=None,
                 test_videos_folder=None, train_filter_videos_from_info_file=False,
                 val_filter_videos_from_info_file=False,
                 test_filter_videos_from_info_file=False, **kwargs) -> None:
        super().__init__(**kwargs)
        self.train_video_info_file_path = train_video_info_file_path
        self.train_videos_folder = train_videos_folder
        self.train_filter = train_filter_videos_from_info_file
        self.val_video_info_file_path = val_video_info_file_path
        self.val_videos_folder = val_videos_folder
        self.val_filter = val_filter_videos_from_info_file
        self.test_video_info_file_path = test_video_info_file_path
        self.test_videos_folder = test_videos_folder
        self.test_filter = test_filter_videos_from_info_file
        with open(categories_file_path) as file:
            self._categories = {line.strip(): i for i, line in enumerate(file)
                                if line.strip()}

    @property
    def categories(self) -> Mapping[str, int]:
        return self._categories

    @property
    def templates(self) -> Optional[Sequence[str]]:
        return KINETICS_TEMPLATES

    def _dataset(self, info_path, folder, filter_from_info: bool, train: bool):
        return Kinetics(self.categories, video_info_file_path=info_path,
                        videos_folder=folder,
                        filter_videos_from_info_file=filter_from_info,
                        **self._dataset_kwargs(train=train))

    def train_dataloader(self):
        return self._create_dataloader(
            self._dataset(self.train_video_info_file_path, self.train_videos_folder,
                          self.train_filter, train=True), train=True)

    def val_dataloader(self):
        return self._create_dataloader(
            self._dataset(self.val_video_info_file_path, self.val_videos_folder,
                          self.val_filter, train=False), train=False)

    def test_dataloader(self):
        return self._create_dataloader(
            self._dataset(self.test_video_info_file_path, self.test_videos_folder,
                          self.test_filter, train=False), train=False)
