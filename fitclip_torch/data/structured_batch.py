"""Merging the batches of a structured group of datasets into one batch (port
of ``fitclip_tpu/data/structured_batch.py``; reference
util/structured_group_utils.py:15-41, ``_cat_collate`` and
``_merge_datasets_batch``).

The per-dataset batches concatenate; token arrays right-pad to the longest
sequence first so that the merged batch is rectangular, and the per-dataset
lengths are kept for splitting losses or metrics back out.
"""

from typing import Dict, List, Mapping, Sequence, Tuple

import numpy as np

from fitclip_torch.utils.tensor import pad_axis_to


def cat_collate(batches: Sequence[Mapping[str, object]]) -> Dict[str, object]:
    """Concatenate same-keyed batches: arrays of two or more dimensions pad
    their second axis to the longest first; lists extend; anything else is
    kept as the list of each batch's value."""
    merged: Dict[str, object] = {}
    for key in batches[0]:
        values = [batch[key] for batch in batches]
        if isinstance(values[0], np.ndarray):
            if values[0].ndim >= 2:
                common = max(v.shape[1] for v in values)
                values = [pad_axis_to(v, common, axis=1) for v in values]
            merged[key] = np.concatenate(values)
        elif isinstance(values[0], list):
            merged[key] = [item for value in values for item in value]
        else:
            merged[key] = values
    return merged


def merge_datasets_batch(batches_by_dataset: Mapping[str, Mapping[str, object]]
                         ) -> Tuple[Dict[str, object], List[int]]:
    """{"msrvtt": batch, "webvid": batch} -> (merged batch, per-dataset sizes)."""
    batches = [batches_by_dataset[name] for name in batches_by_dataset]
    lengths = [next(v for v in batch.values() if isinstance(v, np.ndarray)).shape[0]
               for batch in batches]
    return cat_collate(batches), lengths
