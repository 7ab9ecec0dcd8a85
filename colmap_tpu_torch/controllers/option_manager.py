"""Option management: dataclass option trees ↔ project.ini ↔ dotted flags.

Counterpart of colmap_tpu/controllers/option_manager.py over the port's
option dataclasses (the same sections and fields).

reference behavior: src/colmap/controllers/option_manager.h:92-117 and
base_option_manager.h:96-101 — every module contributes an options struct;
the full tree round-trips through a project.ini file and dotted CLI flags
(--Mapper.ba_global_frames_ratio style).
"""

from __future__ import annotations

import configparser
import dataclasses
from typing import Any, Dict

from colmap_tpu_torch.estimators.two_view_geometry import TwoViewGeometryOptions
from colmap_tpu_torch.feature.matcher import MatchingOptions
from colmap_tpu_torch.feature.sift import SiftOptions
from colmap_tpu_torch.sfm.incremental_pipeline import IncrementalPipelineOptions


@dataclasses.dataclass
class OptionManager:
    """Top-level option tree, mirroring the reference's section names."""

    database_path: str = ""
    image_path: str = ""
    sift: SiftOptions = dataclasses.field(default_factory=SiftOptions)
    matching: MatchingOptions = dataclasses.field(default_factory=MatchingOptions)
    verification: TwoViewGeometryOptions = dataclasses.field(
        default_factory=TwoViewGeometryOptions
    )
    mapper: IncrementalPipelineOptions = dataclasses.field(
        default_factory=IncrementalPipelineOptions
    )

    _SECTIONS = {
        "SiftExtraction": "sift",
        "SiftMatching": "matching",
        "TwoViewGeometry": "verification",
        "Mapper": "mapper",
    }

    def write(self, path: str):
        """Write project.ini (reference: BaseOptionManager::Write)."""
        cp = configparser.ConfigParser()
        cp["root"] = {
            "database_path": self.database_path,
            "image_path": self.image_path,
        }
        for section, attr in self._SECTIONS.items():
            obj = getattr(self, attr)
            cp[section] = {}
            for f in dataclasses.fields(obj):
                v = getattr(obj, f.name)
                if dataclasses.is_dataclass(v):
                    # Nested options flatten with a dotted prefix.
                    for g in dataclasses.fields(v):
                        gv = getattr(v, g.name)
                        if not dataclasses.is_dataclass(gv):
                            cp[section][f"{f.name}.{g.name}"] = str(gv)
                else:
                    cp[section][f.name] = str(v)
        with open(path, "w") as fh:
            cp.write(fh)

    @classmethod
    def read(cls, path: str) -> "OptionManager":
        cp = configparser.ConfigParser()
        cp.read(path)
        om = cls()
        if "root" in cp:
            om.database_path = cp["root"].get("database_path", "")
            om.image_path = cp["root"].get("image_path", "")
        for section, attr in cls._SECTIONS.items():
            if section not in cp:
                continue
            obj = getattr(om, attr)
            obj = _apply_values(obj, dict(cp[section]))
            setattr(om, attr, obj)
        return om

    def apply_flags(self, flags: Dict[str, str]):
        """Apply dotted CLI flags, e.g. {"Mapper.min_num_matches": "20"}."""
        for key, value in flags.items():
            if "." not in key:
                if hasattr(self, key):
                    setattr(self, key, value)
                continue
            section, field = key.split(".", 1)
            attr = self._SECTIONS.get(section)
            if attr is None:
                raise KeyError(f"unknown option section {section}")
            obj = getattr(self, attr)
            setattr(self, attr, _apply_values(obj, {field: value}))


def _coerce(value: str, target_type) -> Any:
    if target_type is bool:
        return value.strip().lower() in ("1", "true", "yes", "on")
    if target_type is int:
        return int(value)
    if target_type is float:
        return float(value)
    return value


def _apply_values(obj, values: Dict[str, str]):
    """Return a copy of dataclass obj with string values coerced+applied;
    supports one level of dotted nesting."""
    updates: Dict[str, Any] = {}
    nested: Dict[str, Dict[str, str]] = {}
    field_map = {f.name: f for f in dataclasses.fields(obj)}
    for key, value in values.items():
        if "." in key:
            parent, child = key.split(".", 1)
            nested.setdefault(parent, {})[child] = value
            continue
        f = field_map.get(key)
        if f is None:
            continue
        current = getattr(obj, key)
        updates[key] = _coerce(value, type(current))
    for parent, child_values in nested.items():
        f = field_map.get(parent)
        if f is None:
            continue
        child_obj = getattr(obj, parent)
        if dataclasses.is_dataclass(child_obj):
            updates[parent] = _apply_values(child_obj, child_values)
    return dataclasses.replace(obj, **updates)
