"""Preprocessors: fit/transform feature pipelines over Datasets
(counterpart of ``ray_tpu/data/preprocessors.py``)
(reference: python/ray/data/preprocessors/ — StandardScaler, MinMaxScaler,
LabelEncoder, OneHotEncoder, Concatenator, Chain; fit computes dataset
statistics with the distributed aggregates, transform is a map_batches)."""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np


class Preprocessor:
    _fitted = False

    def fit(self, ds) -> "Preprocessor":
        self._fit(ds)
        self._fitted = True
        return self

    def transform(self, ds):
        if not self._fitted:
            raise RuntimeError(f"{type(self).__name__} not fitted")
        return self._transform(ds)

    def fit_transform(self, ds):
        return self.fit(ds).transform(ds)

    def _fit(self, ds):
        raise NotImplementedError

    def _transform(self, ds):
        raise NotImplementedError


class StandardScaler(Preprocessor):
    def __init__(self, columns: List[str]):
        self.columns = list(columns)
        self.stats: Dict[str, tuple] = {}

    def _fit(self, ds):
        for c in self.columns:
            self.stats[c] = (ds.mean(c), max(ds.std(c, ddof=0), 1e-12))

    def _transform(self, ds):
        stats = dict(self.stats)

        def scale(df):
            df = df.copy()
            for c, (mu, sd) in stats.items():
                df[c] = (df[c] - mu) / sd
            return df
        return ds.map_batches(scale, batch_format="pandas")


class MinMaxScaler(Preprocessor):
    def __init__(self, columns: List[str]):
        self.columns = list(columns)
        self.stats: Dict[str, tuple] = {}

    def _fit(self, ds):
        for c in self.columns:
            lo, hi = ds.min(c), ds.max(c)
            self.stats[c] = (lo, max(hi - lo, 1e-12))

    def _transform(self, ds):
        stats = dict(self.stats)

        def scale(df):
            df = df.copy()
            for c, (lo, rng) in stats.items():
                df[c] = (df[c] - lo) / rng
            return df
        return ds.map_batches(scale, batch_format="pandas")


class LabelEncoder(Preprocessor):
    def __init__(self, label_column: str):
        self.label_column = label_column
        self.mapping: Dict = {}

    def _fit(self, ds):
        self.mapping = {v: i for i, v in
                        enumerate(sorted(ds.unique(self.label_column)))}

    def _transform(self, ds):
        col, mapping = self.label_column, dict(self.mapping)

        def enc(df):
            df = df.copy()
            df[col] = df[col].map(mapping)
            return df
        return ds.map_batches(enc, batch_format="pandas")


class OneHotEncoder(Preprocessor):
    def __init__(self, columns: List[str]):
        self.columns = list(columns)
        self.categories: Dict[str, List] = {}

    def _fit(self, ds):
        for c in self.columns:
            self.categories[c] = sorted(ds.unique(c))

    def _transform(self, ds):
        cats = {c: list(v) for c, v in self.categories.items()}

        def enc(df):
            df = df.copy()
            for c, values in cats.items():
                for v in values:
                    df[f"{c}_{v}"] = (df[c] == v).astype(np.int64)
                df = df.drop(columns=[c])
            return df
        return ds.map_batches(enc, batch_format="pandas")


class Concatenator(Preprocessor):
    """Concatenate feature columns into one vector column."""

    def __init__(self, columns: List[str], output_column_name: str = "features"):
        self.columns = list(columns)
        self.output = output_column_name

    def _fit(self, ds):
        pass

    def _transform(self, ds):
        cols, out = list(self.columns), self.output

        def cat(batch):
            import pandas as pd
            stacked = np.stack([batch[c].to_numpy() for c in cols], axis=1)
            rest = batch.drop(columns=cols)
            rest[out] = list(stacked)
            return rest
        return ds.map_batches(cat, batch_format="pandas")


class Chain(Preprocessor):
    def __init__(self, *preprocessors: Preprocessor):
        self.preprocessors = list(preprocessors)

    def fit(self, ds):
        for p in self.preprocessors:
            ds = p.fit_transform(ds)
        self._fitted = True
        return self

    def _transform(self, ds):
        for p in self.preprocessors:
            ds = p.transform(ds)
        return ds
