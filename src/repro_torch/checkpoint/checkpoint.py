"""Atomic, async-capable checkpoints: the port of
``repro/checkpoint/checkpoint.py``.

* every save is ATOMIC: written to ``step_XXXXXXXX.tmp/`` and renamed
  only after the directory is fsynced, so a crash mid-save never corrupts
  the latest checkpoint;
* ``keep`` checkpoints are retained; ``steps`` lists only complete ones
  (a torn directory, without its manifest, is skipped);
* with ``async_save`` the device-to-host copy is made at once and the
  file is written on a background thread, so the step loop is not held
  by the filesystem (§4.1 access extraction).

State trees are flattened by ``core.tree`` (dicts, lists, NamedTuples,
``QuantizedBlock``s); the leaves, tensors of any dtype, go into one
``torch.save`` file.

A manager given a mesh and the spec tree of the states it saves
(``runtime/sharding.tree_specs``) holds sharded states: ``save`` writes
whole leaves, as one process would (each gathered to host memory in
turn, written by rank 0 while the others wait at a barrier), and
``restore`` gives every rank its shards of the step rank 0 names.  So a
checkpoint written on a mesh restores in one process, and the reverse.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..core import tree
from ..runtime.sharding import gather_leaf, shard_leaf, spec_leaves


def _spread(mesh) -> bool:
    return mesh is not None and mesh.size > 1


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3,
                 async_save: bool = False, specs: Any = None,
                 mesh=None):
        """``specs`` and ``mesh``: the layout of the states this manager
        saves and restores (None: whole leaves in one process)."""
        if async_save and _spread(mesh):
            raise ValueError("a sharded save gathers and writes in turn; "
                             "async_save is for one process")
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.async_save = async_save
        self.specs, self.mesh = specs, mesh
        self._pending: Optional[threading.Thread] = None
        # size and host seconds of the last completed write
        self.last_bytes = 0
        self.last_seconds = 0.0

    # ------------------------------------------------------------------
    def save(self, step: int, state: Any,
             extra: Optional[Dict[str, Any]] = None) -> Path:
        self.wait()
        t0 = time.perf_counter()
        if _spread(self.mesh):
            return self._save_sharded(step, state, extra, t0)
        # a host copy of every leaf (also of CPU leaves: the optimizer
        # updates in place while an async write may still be running)
        host = [t.detach().to("cpu", copy=True)
                if isinstance(t, torch.Tensor) else t
                for t in tree.leaves(state)]
        if self.async_save:
            th = threading.Thread(target=self._write,
                                  args=(step, host, extra, t0), daemon=True)
            th.start()
            self._pending = th
            return self.dir / f"step_{step:08d}"
        return self._write(step, host, extra, t0)

    def _save_sharded(self, step: int, state: Any, extra, t0: float
                      ) -> Path:
        mesh = self.mesh
        host = []
        for t, spec in zip(tree.leaves(state), spec_leaves(self.specs)):
            whole = gather_leaf(t.detach(), spec, mesh, "cpu")
            if mesh.rank == 0:
                host.append(whole)
        path = self.dir / f"step_{step:08d}"
        if mesh.rank == 0:
            path = self._write(step, host, extra, t0)
        mesh.group(mesh.axes).barrier()
        return path

    def _write(self, step: int, host_leaves, extra, t0: float) -> Path:
        final = self.dir / f"step_{step:08d}"
        tmp = self.dir / f"step_{step:08d}.tmp"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        torch.save({f"leaf_{i}": leaf for i, leaf in enumerate(host_leaves)},
                   tmp / "leaves.pt")
        manifest = {"step": step, "n_leaves": len(host_leaves),
                    "time": time.time(), "extra": extra or {}}
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        # fsync the directory entry before the atomic rename
        fd = os.open(tmp, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)
        self.last_bytes = sum(f.stat().st_size for f in final.iterdir())
        self.last_seconds = time.perf_counter() - t0
        self._gc()
        return final

    def wait(self):
        if self._pending is not None:
            self._pending.join()
            self._pending = None

    # ------------------------------------------------------------------
    def steps(self) -> List[int]:
        out = []
        for p in self.dir.iterdir():
            m = re.fullmatch(r"step_(\d+)", p.name)
            if m and (p / "manifest.json").exists():
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def restore(self, state_like: Any, step: Optional[int] = None, *,
                specs: Any = None, mesh=None) -> Tuple[Any, int, Dict]:
        """Restore into the structure of ``state_like``: each leaf comes
        back with the dtype and on the device of its counterpart there,
        or, with a layout (``specs`` and ``mesh``, default the
        manager's), as this rank's shard on the mesh's device.  Returns
        (state, step, extra)."""
        self.wait()
        if specs is None:
            specs, mesh = self.specs, self.mesh
        if step is None:
            step = self.latest_step()
        if _spread(mesh):
            # every rank restores the step rank 0 sees
            step = mesh.group(mesh.axes).all_gather_object(step)[0]
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        path = self.dir / f"step_{step:08d}"
        manifest = json.loads((path / "manifest.json").read_text())
        like, rebuild = tree.flatten(state_like)
        if manifest["n_leaves"] != len(like):
            raise ValueError(
                f"checkpoint has {manifest['n_leaves']} leaves; "
                f"state expects {len(like)}")
        data = torch.load(path / "leaves.pt", weights_only=True)
        leaves = []
        flat_specs = spec_leaves(specs) if specs is not None else None
        for i, ref in enumerate(like):
            leaf = data.pop(f"leaf_{i}")
            if isinstance(ref, torch.Tensor) and flat_specs is not None:
                leaf = shard_leaf(leaf.to(dtype=ref.dtype), flat_specs[i],
                                  mesh)
            elif isinstance(ref, torch.Tensor):
                leaf = leaf.to(device=ref.device, dtype=ref.dtype)
            leaves.append(leaf)
        return rebuild(leaves), step, manifest.get("extra", {})

    def _gc(self):
        steps = self.steps()
        for s in steps[: max(0, len(steps) - self.keep)]:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)
