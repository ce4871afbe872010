"""HMDB51 classification (port of ``fitclip_tpu/data/datasets/hmdb.py``):
per-category split files with train/test tags, underscore category names;
reuses the UCF templates (aligner/data/hmdb.py:19-85)."""

import glob
import os
from typing import Mapping, Optional, Sequence, Tuple

from fitclip_torch.data.data_module import VideoClassificationDataModule
from fitclip_torch.data.datasets.ucf import UCF_101_TEMPLATES
from fitclip_torch.data.video_dataset import VideoDataset

TRAIN_TAG = 1
TEST_TAG = 2


class Hmdb(VideoDataset):
    def __init__(self, categories: Mapping[str, int], splits_folder, split: int,
                 tag: int, videos_folder, **kwargs) -> None:
        self.categories = categories
        video_paths = []
        for path in sorted(glob.glob(os.path.join(splits_folder, f"*_test_split{split}.txt"))):
            category = os.path.basename(path).rsplit("_", maxsplit=2)[0]
            with open(path) as file:
                for line in file:
                    if not line.strip():
                        continue
                    filename, file_tag = line.strip().split(maxsplit=1)
                    if int(file_tag) == tag:
                        video_paths.append(os.path.join(videos_folder, category, filename))
        super().__init__(video_paths=video_paths, **kwargs)

    def _get_video_id(self, video_idx: int) -> str:
        folder_path, filename = os.path.split(self.video_paths[video_idx])
        return os.path.join(os.path.basename(folder_path), filename)

    def _get_target(self, video_idx: int) -> Tuple[str, int]:
        category = os.path.dirname(self._get_video_id(video_idx)).replace("_", " ")
        return category, self.categories[category]


class HmdbDataModule(VideoClassificationDataModule):
    def __init__(self, categories_file_path, splits_folder, split: int, videos_folder,
                 **kwargs) -> None:
        super().__init__(**kwargs)
        self.splits_folder = splits_folder
        self.split = split
        self.videos_folder = videos_folder
        with open(categories_file_path) as file:
            self._categories = {line.strip(): i for i, line in enumerate(file)
                                if line.strip()}

    @property
    def categories(self) -> Mapping[str, int]:
        return self._categories

    @property
    def templates(self) -> Optional[Sequence[str]]:
        return UCF_101_TEMPLATES

    def _dataset(self, tag: int, train: bool):
        return Hmdb(categories=self.categories, splits_folder=self.splits_folder,
                    split=self.split, tag=tag, videos_folder=self.videos_folder,
                    **self._dataset_kwargs(train=train))

    def train_dataloader(self):
        return self._create_dataloader(self._dataset(TRAIN_TAG, train=True), train=True)

    def val_dataloader(self):
        return self._create_dataloader(self._dataset(TEST_TAG, train=False), train=False)
