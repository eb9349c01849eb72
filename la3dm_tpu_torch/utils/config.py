"""Typed configuration replacing the reference's ROS parameter server.

The reference composes a method YAML + dataset YAML into a ROS private
namespace (``launch/la3dm_static.launch:36-39``) and each node pulls ~19
typed params via ``nh.param<T>`` (``src/bgkoctomap/bgkoctomap_static_node.cpp:43-62``).
Here the same keys load into frozen dataclasses with identical defaults.
(The port's own copy of ``la3dm_tpu/utils/config.py``, with the YAMLs it
loads under ``la3dm_tpu_torch/configs/``.)
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import yaml

_CONFIG_ROOT = os.path.join(os.path.dirname(os.path.dirname(__file__)), "configs")


@dataclasses.dataclass(frozen=True)
class MapConfig:
    """Method hyperparameters (reference ``config/methods/*.yaml``)."""

    method: str = "bgk"  # bgk | bgkl | bgklv | gp
    resolution: float = 0.1
    block_depth: int = 4
    sf2: float = 1.0
    ell: float = 1.0
    free_resolution: float = 0.5
    ds_resolution: float = 0.1
    free_thresh: float = 0.3
    occupied_thresh: float = 0.7
    # BGK family (bgkoctomap.yaml:18-23)
    var_thresh: float = 1.0
    prior_A: float = 1.0
    prior_B: float = 1.0
    # LV only (bgklvoctomap.yaml:24)
    min_W: float = 0.1
    # GP only (gpoctomap.yaml:20-25); note min_ivar = 1/max_var etc.
    # (src/gpoctomap/gpoctomap.cpp:39-41)
    noise: float = 0.01
    l: float = 100.0
    min_var: float = 0.001
    max_var: float = 1000.0
    max_known_var: float = 0.02
    # Large-map options
    original_size: bool = False
    max_range: float = -1.0
    min_z: float = 0.0
    max_z: float = 0.0
    # 27-neighbor extended blocks (reference -DPREDICT, CMakeLists.txt:19)
    predict: bool = False
    # Scan ingestion placement for BGK and GP (geometry/device_ingest.py):
    # "on" builds the engine tables on the map's device (the plain versions
    # on a CPU map), "off" on the host, "auto" on the device for a map on a
    # CUDA device and on the host for a CPU map.  BGKLV reads no flag.
    device_ingest: str = "auto"

    @property
    def cells_per_edge(self) -> int:
        """Voxels per block edge: 2^(block_depth-1) (bgkblock.cpp:105)."""
        return 1 << (self.block_depth - 1)

    @property
    def block_size(self) -> float:
        """World size of one block (bgkoctomap.cpp:41)."""
        return self.cells_per_edge * self.resolution

    @property
    def voxels_per_block(self) -> int:
        return self.cells_per_edge ** 3


@dataclasses.dataclass(frozen=True)
class DatasetConfig:
    """Dataset parameters (reference ``config/datasets/*.yaml``)."""

    name: str = "sim_structured"
    dir: str = ""
    prefix: str = ""
    scan_num: int = 12
    max_range: float = 8.0
    min_z: float = 0.0
    max_z: float = 4.3
    original_size: bool = False
    predict: bool = False


def _load_yaml(path: str) -> dict:
    with open(path) as f:
        return yaml.safe_load(f) or {}


def _filter_fields(cls, raw: dict) -> dict:
    names = {f.name for f in dataclasses.fields(cls)}
    return {k: v for k, v in raw.items() if k in names}


def load_method_config(name_or_path: str, **overrides) -> MapConfig:
    """Load a method config by name (``bgk``, ``gpoctomap`` …) or YAML path."""
    path = name_or_path
    if not os.path.exists(path):
        candidates = [
            os.path.join(_CONFIG_ROOT, "methods", f"{name_or_path}.yaml"),
            os.path.join(_CONFIG_ROOT, "methods", f"{name_or_path}octomap.yaml"),
        ]
        for c in candidates:
            if os.path.exists(c):
                path = c
                break
        else:
            raise FileNotFoundError(f"no method config for {name_or_path!r}")
    raw = _load_yaml(path)
    raw.update(overrides)
    raw.setdefault("method", os.path.basename(path).replace("octomap", "").replace(".yaml", "").replace("_large_map", ""))
    return MapConfig(**_filter_fields(MapConfig, raw))


def load_dataset_config(name_or_path: str, **overrides) -> DatasetConfig:
    path = name_or_path
    if not os.path.exists(path):
        path = os.path.join(_CONFIG_ROOT, "datasets", f"{name_or_path}.yaml")
        if not os.path.exists(path):
            raise FileNotFoundError(f"no dataset config for {name_or_path!r}")
    raw = _load_yaml(path)
    raw.update(overrides)
    raw.setdefault("name", os.path.basename(path).replace(".yaml", ""))
    return DatasetConfig(**_filter_fields(DatasetConfig, raw))
