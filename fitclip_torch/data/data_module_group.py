"""Eval groups of data modules (port of ``EvalDataModuleGroup`` from
``fitclip_tpu/data/data_module_group.py``; data_module_group.py:61-72 of the
reference). The train-side combinators of that module (the structured group,
mixed batches, train-and-eval) come with the train command; until then
their config targets do not resolve in the port."""

from typing import List, Mapping, Union

from fitclip_torch.data.loader import DataLoader


class EvalDataModuleGroup:
    """Sequences the val/test/predict loaders of several data modules. The
    runners suffix each member's metrics with its name."""

    def __init__(self, data_modules: Union[Mapping[str, object], List[object]]) -> None:
        if isinstance(data_modules, Mapping):
            self.names = list(data_modules.keys())
            self.data_modules = list(data_modules.values())
        else:
            self.names = [str(i) for i in range(len(data_modules))]
            self.data_modules = list(data_modules)

    def val_dataloader(self) -> List[DataLoader]:
        return [dm.val_dataloader() for dm in self.data_modules]

    def test_dataloader(self) -> List[DataLoader]:
        return [dm.test_dataloader() for dm in self.data_modules]

    def predict_dataloader(self) -> List[DataLoader]:
        return [dm.predict_dataloader() for dm in self.data_modules]
