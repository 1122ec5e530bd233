"""Named dataset-path catalog (port of
``nerf_replication_tpu/datasets/catalog.py``): dataset names mapped to the
data_root/split arguments a ``Dataset.from_cfg`` would otherwise read from
YAML.
"""

from __future__ import annotations


class DatasetCatalog:
    dataset_attrs: dict[str, dict] = {
        "BlenderTrain": {
            "data_root": "data/nerf_synthetic",
            "split": "train",
        },
        "BlenderTest": {
            "data_root": "data/nerf_synthetic",
            "split": "test",
        },
    }

    @classmethod
    def get(cls, name: str) -> dict:
        return dict(cls.dataset_attrs[name])

    @classmethod
    def register(cls, name: str, attrs: dict) -> None:
        cls.dataset_attrs[name] = dict(attrs)
