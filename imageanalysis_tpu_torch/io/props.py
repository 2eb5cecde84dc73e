"""Property tree: the reference's config/state store, as plain dicts.

Port of ``imageanalysis_tpu/io/props.py`` (pure Python, unchanged): the
same nested JSON documents as the reference's config.json and
meta/*.json, from a nested-dict tree with a path API.
"""

from __future__ import annotations

import json
from typing import Any


class PropertyNode:
    """A node in a nested-dict property tree (aura-props getNode equivalent)."""

    def __init__(self, data: dict | None = None):
        self._d: dict[str, Any] = data if data is not None else {}

    # -- path access ------------------------------------------------------
    def node(self, path: str, create: bool = True) -> "PropertyNode | None":
        cur = self._d
        for part in [p for p in path.strip("/").split("/") if p]:
            if part not in cur or not isinstance(cur[part], dict):
                if not create:
                    return None
                cur[part] = {}
            cur = cur[part]
        return PropertyNode.__wrap(cur)

    @classmethod
    def __wrap(cls, d: dict) -> "PropertyNode":
        n = cls.__new__(cls)
        n._d = d
        return n

    def has(self, key: str) -> bool:
        return key in self._d

    def get(self, key: str, default=None):
        return self._d.get(key, default)

    def set(self, key: str, value):
        self._d[key] = value

    def setlist(self, key: str, values):
        self._d[key] = [float(v) for v in values]

    def getlist(self, key: str):
        return list(self._d.get(key, []))

    def children(self):
        return list(self._d.keys())

    def as_dict(self) -> dict:
        return self._d

    def update(self, other: dict):
        """Deep-overlay ``other`` onto this node (camera-config overlay,
        reference process.py:141-156)."""
        def merge(dst, src):
            for k, v in src.items():
                if isinstance(v, dict) and isinstance(dst.get(k), dict):
                    merge(dst[k], v)
                else:
                    dst[k] = v
        merge(self._d, other)

    # -- JSON round trip --------------------------------------------------
    def save_json(self, path: str):
        with open(path, "w") as f:
            json.dump(self._d, f, indent=4, sort_keys=True)

    @classmethod
    def load_json(cls, path: str) -> "PropertyNode":
        with open(path) as f:
            return cls(json.load(f))
