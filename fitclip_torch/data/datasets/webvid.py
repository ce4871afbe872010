"""WebVid video-text dataset (port of ``fitclip_tpu/data/datasets/webvid.py``):
a results CSV (``videoid`` read as str, the caption in ``name``) and a
videos folder (aligner/data/webvid.py:23-75 layout). The train loader is the
train command's; grouped eval (``data/drift_eval.yaml``) reads the val one."""

import os

from fitclip_torch.data.data_module import VideoTextDataModule, get_sorted_videos_in_folder
from fitclip_torch.data.datasets.table import read_table
from fitclip_torch.data.video_dataset import VideoDataset


class WebVid(VideoDataset):
    def __init__(self, video_info_file_path, videos_folder,
                 filter_videos_from_info_file: bool = False, **kwargs) -> None:
        info = read_table(video_info_file_path, str_columns=("videoid",))
        self.caption_by_id = {}
        for video_id, caption in zip(info["videoid"], info["name"]):
            self.caption_by_id.setdefault(video_id, caption)
        if filter_videos_from_info_file:
            video_paths = [os.path.join(videos_folder, f"{video_id}.mp4")
                           for video_id in info["videoid"]]
        else:
            video_paths = get_sorted_videos_in_folder(videos_folder)
        super().__init__(video_paths=video_paths, **kwargs)

    def _get_target(self, video_idx: int) -> str:
        return self.caption_by_id[self._get_video_id(video_idx)]


class WebVidDataModule(VideoTextDataModule):
    def __init__(self, train_video_info_file_path=None, train_videos_folder=None,
                 train_filter_videos_from_info_file: bool = False,
                 val_video_info_file_path=None, val_videos_folder=None,
                 val_filter_videos_from_info_file: bool = False, **kwargs) -> None:
        super().__init__(**kwargs)
        self.train_video_info_file_path = train_video_info_file_path
        self.train_videos_folder = train_videos_folder
        self.train_filter_videos_from_info_file = train_filter_videos_from_info_file
        self.val_video_info_file_path = val_video_info_file_path
        self.val_videos_folder = val_videos_folder
        self.val_filter_videos_from_info_file = val_filter_videos_from_info_file

    def _dataset(self, info_path, folder, filter_from_info: bool, train: bool):
        return WebVid(video_info_file_path=info_path, videos_folder=folder,
                      filter_videos_from_info_file=filter_from_info,
                      **self._dataset_kwargs(train=train))

    def train_dataloader(self):
        return self._create_dataloader(
            self._dataset(self.train_video_info_file_path, self.train_videos_folder,
                          self.train_filter_videos_from_info_file, train=True), train=True)

    def val_dataloader(self):
        return self._create_dataloader(
            self._dataset(self.val_video_info_file_path, self.val_videos_folder,
                          self.val_filter_videos_from_info_file, train=False), train=False)
