"""YouCook2 retrieval (port of ``fitclip_tpu/data/datasets/youcook2.py``): the
MIL-NCE validation CSV with clip start/end times (aligner/data/youcook2.py:
20-51), ``task`` read as str and the other columns typed as pandas types them
(``table.py``). Clip times seek through the reader's time_to_indices."""

import glob
import os
from typing import Optional, Tuple

from fitclip_torch.data.data_module import VideoTextDataModule
from fitclip_torch.data.datasets.table import read_table
from fitclip_torch.data.video_dataset import VideoDataset


class YouCook2(VideoDataset):
    def __init__(self, video_info_file_path, videos_folder, **kwargs) -> None:
        self.video_info = read_table(video_info_file_path, str_columns=("task",))
        video_paths = []
        for task, video_id in zip(self.video_info["task"], self.video_info["video_id"]):
            matches = glob.glob(os.path.join(videos_folder, task, f"{video_id}.*"))
            if not matches:
                raise FileNotFoundError(
                    f"No video for task={task} id={video_id} under {videos_folder}")
            video_paths.append(matches[0])
        super().__init__(video_paths=video_paths, **kwargs)

    def _get_target(self, video_idx: int) -> str:
        return self.video_info["text"][video_idx]

    def _get_times(self, video_idx: int) -> Tuple[Optional[float], Optional[float]]:
        return (float(self.video_info["start"][video_idx]),
                float(self.video_info["end"][video_idx]))


class YouCook2DataModule(VideoTextDataModule):
    def __init__(self, val_video_info_file_path, val_videos_folder, **kwargs) -> None:
        super().__init__(**kwargs)
        self.val_video_info_file_path = val_video_info_file_path
        self.val_videos_folder = val_videos_folder

    def val_dataloader(self):
        dataset = YouCook2(video_info_file_path=self.val_video_info_file_path,
                           videos_folder=self.val_videos_folder,
                           **self._dataset_kwargs(train=False))
        return self._create_dataloader(dataset, train=False)
