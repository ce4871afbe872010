"""UCF101 zero-shot classification (port of ``fitclip_tpu/data/datasets/ucf.py``):
official split files, CamelCase folder names to space-separated categories,
48 CLIP prompt templates (aligner/data/ucf.py:22-130; templates from OpenAI
CLIP prompts.md)."""

import os
import re
from typing import Mapping, Optional, Sequence, Tuple

from fitclip_torch.data.data_module import VideoClassificationDataModule
from fitclip_torch.data.video_dataset import VideoDataset

RE_CAPITALIZED_WORDS = re.compile(r"[a-zA-Z][^A-Z]*")

# The 48 OpenAI CLIP UCF101 prompt templates
# (github.com/openai/CLIP/blob/main/data/prompts.md#ucf101) are a cartesian
# product; generate them in the canonical order: verb form outermost, then
# a/the, then the four media words.
_MEDIA = ("photo", "video", "example", "demonstration")
_VERB_FORMS = ("", "using ", "doing ", "during ", "performing ", "practicing ")

UCF_101_TEMPLATES = [
    f"a {medium} of {article} person {verb}{{}}."
    for verb in _VERB_FORMS
    for article in ("a", "the")
    for medium in _MEDIA
]


def folder_name_to_category(folder_name: str) -> str:
    return " ".join(RE_CAPITALIZED_WORDS.findall(folder_name))


class Ucf(VideoDataset):
    def __init__(self, categories: Mapping[str, int], file_list_path, videos_folder,
                 **kwargs) -> None:
        self.categories = categories
        with open(file_list_path) as file:
            relative_paths = [line.strip().split()[0] for line in file if line.strip()]
        super().__init__(video_paths=[os.path.join(videos_folder, p)
                                      for p in relative_paths], **kwargs)

    def _get_video_id(self, video_idx: int) -> str:
        folder_path, filename = os.path.split(self.video_paths[video_idx])
        return os.path.join(os.path.basename(folder_path), filename)

    def _get_target(self, video_idx: int) -> Tuple[str, int]:
        category = folder_name_to_category(os.path.dirname(self._get_video_id(video_idx)))
        return category, self.categories[category]


class UcfDataModule(VideoClassificationDataModule):
    def __init__(self, categories_file_path, val_file_list_path, val_videos_folder,
                 **kwargs) -> None:
        super().__init__(**kwargs)
        self.val_file_list_path = val_file_list_path
        self.val_videos_folder = val_videos_folder
        self._categories = {}
        with open(categories_file_path) as file:
            for line in file:
                if line.strip():
                    id_, folder_name = line.strip().split()
                    self._categories[folder_name_to_category(folder_name)] = int(id_) - 1

    @property
    def categories(self) -> Mapping[str, int]:
        return self._categories

    @property
    def templates(self) -> Optional[Sequence[str]]:
        return UCF_101_TEMPLATES

    def val_dataloader(self):
        dataset = Ucf(categories=self.categories, file_list_path=self.val_file_list_path,
                      videos_folder=self.val_videos_folder,
                      **self._dataset_kwargs(train=False))
        return self._create_dataloader(dataset, train=False)
