"""DiDeMo paragraph retrieval (port of ``fitclip_tpu/data/datasets/didemo.py``):
all descriptions of a video joined by spaces into one query paragraph
(aligner/data/didemo.py:18-67). Video files resolve via the tab-separated
YFCC100M hash list to <hash[:3]>/<hash[3:6]>/<hash>.mp4 under the videos
folder."""

import json
import os
from collections import defaultdict

from fitclip_torch.data.data_module import VideoTextDataModule
from fitclip_torch.data.video_dataset import VideoDataset


class Didemo(VideoDataset):
    def __init__(self, videos_folder, hash_list_path, annotations_path, **kwargs) -> None:
        with open(annotations_path) as file:
            descriptions_by_id = defaultdict(list)
            for annotation in json.load(file):
                descriptions_by_id[annotation["video"]].append(annotation["description"])
        self.paragraph_by_id = {video_id: " ".join(descriptions)
                                for video_id, descriptions in descriptions_by_id.items()}

        with open(hash_list_path) as file:
            hash_by_flickr_id = dict(line.strip().split("\t") for line in file if line.strip())

        self.video_ids_by_path = {}
        for video_id in self.paragraph_by_id:
            flickr_id = video_id.split("_")[1]
            hash_ = hash_by_flickr_id[flickr_id]
            path = os.path.join(videos_folder, hash_[:3], hash_[3:6], f"{hash_}.mp4")
            self.video_ids_by_path[path] = video_id
        super().__init__(video_paths=list(self.video_ids_by_path), **kwargs)

    def _get_target(self, video_idx: int) -> str:
        return self.paragraph_by_id[self.video_ids_by_path[self.video_paths[video_idx]]]


class DidemoDataModule(VideoTextDataModule):
    def __init__(self, videos_folder, hash_list_path, val_annotation_path, **kwargs) -> None:
        super().__init__(**kwargs)
        self.videos_folder = videos_folder
        self.hash_list_path = hash_list_path
        self.val_annotation_path = val_annotation_path

    def val_dataloader(self):
        dataset = Didemo(videos_folder=self.videos_folder,
                         hash_list_path=self.hash_list_path,
                         annotations_path=self.val_annotation_path,
                         **self._dataset_kwargs(train=False))
        return self._create_dataloader(dataset, train=False)
