"""ReconstructionManager: a set of sub-models persisted in numbered dirs.

A copy of colmap_tpu/scene/reconstruction_manager.py, so that the port
does not import the JAX package. No module of either package imports it.

reference behavior: src/colmap/scene/reconstruction_manager.{h,cc} —
Size/Get/Add/Delete/Clear plus Read (one numbered dir) and Write (all
models into sub-folders "0", "1", ...).
"""

from __future__ import annotations

import os
from typing import List

from colmap_tpu_torch.scene.reconstruction import Reconstruction
from colmap_tpu_torch.scene.reconstruction_io import read_model, write_model


class ReconstructionManager:
    def __init__(self):
        self._reconstructions: List[Reconstruction] = []

    def size(self) -> int:
        return len(self._reconstructions)

    def __len__(self) -> int:
        return len(self._reconstructions)

    def get(self, idx: int) -> Reconstruction:
        return self._reconstructions[idx]

    def add(self) -> int:
        """Add a new empty reconstruction; returns its index."""
        self._reconstructions.append(Reconstruction())
        return len(self._reconstructions) - 1

    def append(self, recon: Reconstruction) -> int:
        self._reconstructions.append(recon)
        return len(self._reconstructions) - 1

    def delete(self, idx: int):
        del self._reconstructions[idx]

    def clear(self):
        self._reconstructions.clear()

    def read(self, path: str) -> int:
        """Read one model dir and add it; returns its index."""
        self._reconstructions.append(read_model(path))
        return len(self._reconstructions) - 1

    def read_all(self, path: str) -> int:
        """Read every numbered sub-dir under path ("0", "1", ...)."""
        n = 0
        for name in sorted(os.listdir(path)):
            sub = os.path.join(path, name)
            if name.isdigit() and os.path.isdir(sub):
                self.read(sub)
                n += 1
        return n

    def write(self, path: str, fmt: str = "bin"):
        """Write all models into numbered sub-folders (reference:
        ReconstructionManager::Write)."""
        os.makedirs(path, exist_ok=True)
        for i, recon in enumerate(self._reconstructions):
            write_model(recon, os.path.join(path, str(i)), fmt=fmt)
