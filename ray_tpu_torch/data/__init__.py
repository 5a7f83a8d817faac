"""Data: lazy, streaming datasets of pyarrow blocks in the object store
(counterpart of ``ray_tpu/data``; the device feed is
``Dataset.iter_torch_batches``)."""

from ray_tpu_torch.data import preprocessors
from ray_tpu_torch.data.dataset import Dataset, GroupedData
from ray_tpu_torch.data.read_api import (from_arrow, from_huggingface,
                                   from_items, from_numpy, from_pandas,
                                   range, read_bigquery, read_binary_files,
                                   read_csv, read_images, read_json,
                                   read_mongo, read_numpy, read_parquet,
                                   read_sql, read_text, read_tfrecords,
                                   read_webdataset)

__all__ = ["Dataset", "GroupedData", "range", "from_items", "from_numpy",
           "from_pandas", "from_arrow", "from_huggingface", "read_parquet",
           "read_csv", "read_json", "read_text", "read_numpy",
           "read_binary_files", "read_images", "read_tfrecords", "read_sql",
           "read_webdataset", "read_mongo", "read_bigquery",
           "preprocessors"]
