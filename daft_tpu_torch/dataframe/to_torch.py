"""Torch dataset views of a DataFrame (counterpart of
daft_tpu/dataframe/to_torch.py; torch is the port's own dependency)."""

from __future__ import annotations

import torch.utils.data


class DataFrameMapDataset(torch.utils.data.Dataset):
    """A map-style dataset over the materialized rows (each a dict)."""

    def __init__(self, df):
        self._rows = df.to_pylist()

    def __len__(self) -> int:
        return len(self._rows)

    def __getitem__(self, i: int) -> dict:
        return self._rows[i]


class DataFrameIterDataset(torch.utils.data.IterableDataset):
    """An iterable dataset streaming the rows partition by partition."""

    def __init__(self, df):
        self._df = df

    def __iter__(self):
        return self._df.iter_rows()
