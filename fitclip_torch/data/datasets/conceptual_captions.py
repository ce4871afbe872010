"""Conceptual Captions (CC3M; port of
``fitclip_tpu/data/datasets/conceptual_captions.py``): images as 1-frame
videos (``ImageVideoReader``), captions from the download file of
name,url,video_id rows (read as ``pd.read_csv`` reads it: comma separated,
quoted, no header), every row of a repeated filename dropped
(aligner/data/conceptual_captions.py:17-65)."""

import os
from collections import Counter

from fitclip_torch.data.data_module import VideoTextDataModule, get_videos_in_folder
from fitclip_torch.data.datasets.table import read_table
from fitclip_torch.data.video_dataset import VideoDataset
from fitclip_torch.data.video_reader import IMAGE_EXTENSIONS


class ConceptualCaptions(VideoDataset):
    def __init__(self, video_info_file_path, videos_folder, **kwargs) -> None:
        info = read_table(video_info_file_path, names=["name", "url", "video_id"])
        # Drop *all* rows with repeated filenames: the on-disk copy is one of
        # them but the caption file doesn't say which.
        counts = Counter(info["video_id"])
        self.caption_by_id = {video_id: caption
                              for caption, video_id in zip(info["name"], info["video_id"])
                              if counts[video_id] == 1}
        video_paths = sorted(
            path for path in get_videos_in_folder(videos_folder, IMAGE_EXTENSIONS)
            if os.path.basename(path) in self.caption_by_id)
        super().__init__(video_paths=video_paths, **kwargs)

    def _get_video_id(self, video_idx: int) -> str:
        return os.path.basename(self.video_paths[video_idx])

    def _get_target(self, video_idx: int) -> str:
        return self.caption_by_id[self._get_video_id(video_idx)]


class ConceptualCaptionsDataModule(VideoTextDataModule):
    def __init__(self, train_video_info_file_path=None, train_videos_folder=None,
                 val_video_info_file_path=None, val_videos_folder=None, **kwargs) -> None:
        super().__init__(**kwargs)
        self.train_video_info_file_path = train_video_info_file_path
        self.train_videos_folder = train_videos_folder
        self.val_video_info_file_path = val_video_info_file_path
        self.val_videos_folder = val_videos_folder

    def _dataset(self, info_path, folder, train: bool):
        return ConceptualCaptions(video_info_file_path=info_path, videos_folder=folder,
                                  **self._dataset_kwargs(train=train))

    def train_dataloader(self):
        return self._create_dataloader(
            self._dataset(self.train_video_info_file_path, self.train_videos_folder,
                          train=True), train=True)

    def val_dataloader(self):
        return self._create_dataloader(
            self._dataset(self.val_video_info_file_path, self.val_videos_folder,
                          train=False), train=False)
