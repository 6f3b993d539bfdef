"""Sharded, atomic, resumable checkpoints with integrity (no external deps).

Port of ``repro.ckpt.checkpoint`` over the trees of :mod:`repro_torch.tree`:
each tensor is saved as a numpy array keyed by its path (``||``-joined),
and restore puts it back on the template leaf's device and dtype.

Layout:  <dir>/step_<N>/shard_<i>.npz + manifest.json
* **atomic**: shards + manifest land in a tmp dir, **fsync'd before the
  rename** (file contents, then the tmp dir, then the parent dir after the
  rename) so a crash — or a power cut — mid-write never corrupts the latest
  checkpoint (restore scans for the newest *complete* manifest).
* **integrity**: the manifest records a CRC32 per array; restore re-hashes
  every array it loads (``verify=True``) and raises
  :class:`CheckpointCorruptError` on any mismatch, unreadable shard, or
  truncated npz.  ``restore(..., fallback=True)`` (what
  :meth:`CheckpointManager.restore_latest` uses) then scans *backwards* to
  the newest checkpoint that verifies — a byte-flipped or torn latest
  checkpoint costs ``ckpt_every`` steps of recompute, never the run
  (DESIGN.md §4).
* **elastic**: arrays are saved logically (whole, one shard per host
  process) and restored onto any device.  Under a mesh
  (``CheckpointManager(mesh=)``) every rank's blocks are gathered into the
  logical arrays (``models/sharding.py::gather_params``), rank 0 writes
  them, and every rank waits for the write at a barrier; a restore reads
  the logical arrays on every rank and places them on the caller's mesh,
  which may differ from the one that saved them.
* **async**: ``save(..., background=True)`` hands the host copy to a worker
  thread so the train loop keeps stepping during I/O.  The writer CAPTURES
  any exception instead of letting it vanish in the daemon thread; it is
  re-raised from :meth:`CheckpointManager.wait` (and therefore from the
  next ``save()``, which waits first) — a failed background write is a
  loud failure, never a silently missing checkpoint.  The manager's GC
  never touches the directory an in-flight background write is about to
  rename into place (``_pending_step``).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
import warnings
import zlib
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.tree import flatten_with_path, tree_unflatten

__all__ = [
    "save",
    "restore",
    "latest_step",
    "complete_steps",
    "CheckpointCorruptError",
    "CheckpointManager",
    "BackgroundWriter",
]

_SEP = "||"


class CheckpointCorruptError(RuntimeError):
    """A checkpoint directory exists and looks complete but fails integrity:
    CRC mismatch, unreadable/truncated shard, or a key the manifest promised
    is missing.  Distinct from ``FileNotFoundError`` (nothing to restore)
    and ``ValueError`` (template/shape disagreement)."""


class BackgroundWriter(threading.Thread):
    """Daemon writer thread that captures its exception for join-time
    re-raise — a background checkpoint failure must surface, not vanish."""

    def __init__(self, fn):
        super().__init__(daemon=True)
        self._fn = fn
        self.exc: Optional[BaseException] = None

    def run(self):
        try:
            self._fn()
        except BaseException as e:  # noqa: BLE001 — captured, re-raised at wait()
            self.exc = e

    def check(self) -> None:
        """Re-raise the captured write failure, if any (idempotent)."""
        if self.exc is not None:
            exc, self.exc = self.exc, None
            raise RuntimeError("background checkpoint write failed") from exc


def _to_numpy(leaf: torch.Tensor) -> np.ndarray:
    t = leaf.detach().cpu()
    if t.dtype == torch.bfloat16:
        # npz can't store bfloat16 — upcast losslessly; restore re-casts
        t = t.to(torch.float32)
    return t.numpy()


def _key(path: tuple) -> str:
    return _SEP.join(path)


def _flatten(tree: Any) -> dict:
    return {_key(path): _to_numpy(leaf) for path, leaf in flatten_with_path(tree)}


def _crc(a: np.ndarray) -> int:
    """CRC32 over the array's raw bytes (C-order) — the manifest integrity
    record; cheap (~GB/s) next to the npz deflate that follows it."""
    return int(zlib.crc32(np.ascontiguousarray(a).tobytes()))


def _fsync_file(path: Path) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _fsync_dir(path: Path) -> None:
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:  # platforms without O_RDONLY dir opens — best effort
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def save(
    directory: str | Path,
    step: int,
    tree: Any,
    *,
    extra: Optional[dict] = None,
    background: bool = False,
) -> Optional["BackgroundWriter"]:
    """Write ``tree`` at ``step``.  Returns the writer thread if background
    (join it AND call ``check()`` — or use :class:`CheckpointManager`, whose
    ``wait()`` does both)."""
    directory = Path(directory)
    arrays = _flatten(tree)  # host copy happens here, synchronously

    def _write():
        tmp = directory / f".tmp_step_{step}_{time.monotonic_ns()}"
        tmp.mkdir(parents=True, exist_ok=True)
        np.savez(tmp / "shard_0.npz", **arrays)
        manifest = {
            "step": step,
            "n_shards": 1,
            "keys": sorted(arrays.keys()),
            "crc32": {k: _crc(a) for k, a in arrays.items()},
            "time": time.time(),
            "extra": extra or {},
        }
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        # durability before visibility: flush shard + manifest + the tmp dir
        # entries to stable storage, THEN rename, THEN flush the parent dir —
        # a crash at any point leaves either no step_<N> or a complete one
        _fsync_file(tmp / "shard_0.npz")
        _fsync_file(tmp / "manifest.json")
        _fsync_dir(tmp)
        final = directory / f"step_{step}"
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)
        _fsync_dir(directory)

    if background:
        t = BackgroundWriter(_write)
        t.start()
        return t
    _write()
    return None


def complete_steps(directory: str | Path) -> list:
    """All steps with a *complete* manifest, ascending (crash-safe restore
    candidates; validity is checked at restore time — see ``fallback``)."""
    directory = Path(directory)
    if not directory.exists():
        return []
    steps = []
    for p in directory.glob("step_*"):
        if (p / "manifest.json").exists():
            try:
                steps.append(int(p.name.split("_")[1]))
            except ValueError:
                continue
    return sorted(steps)


def latest_step(directory: str | Path) -> Optional[int]:
    """Newest step with a *complete* manifest (crash-safe restore point)."""
    steps = complete_steps(directory)
    return steps[-1] if steps else None


def _load_arrays(d: Path, manifest: dict, *, verify: bool) -> dict:
    arrays = {}
    for i in range(manifest["n_shards"]):
        shard = d / f"shard_{i}.npz"
        try:
            with np.load(shard) as z:
                arrays.update({k: z[k] for k in z.files})
        except FileNotFoundError as e:
            raise CheckpointCorruptError(f"{d.name}: missing {shard.name}") from e
        except Exception as e:  # zipfile.BadZipFile, truncated deflate, ...
            raise CheckpointCorruptError(
                f"{d.name}: unreadable {shard.name} ({type(e).__name__}: {e})"
            ) from e
    crcs = manifest.get("crc32")
    if verify and crcs is not None:
        for key, want in crcs.items():
            if key not in arrays:
                raise CheckpointCorruptError(f"{d.name}: manifest key {key} not in shards")
            got = _crc(arrays[key])
            if got != int(want):
                raise CheckpointCorruptError(
                    f"{d.name}: CRC mismatch on {key} "
                    f"(manifest {int(want)}, shard {got})"
                )
    return arrays


def _restore_one(directory: Path, template: Any, step: int, *, verify: bool,
                 layout=None):
    d = directory / f"step_{step}"
    try:
        manifest = json.loads((d / "manifest.json").read_text())
    except FileNotFoundError:
        raise FileNotFoundError(f"no checkpoint at {d}")
    except (json.JSONDecodeError, OSError) as e:
        raise CheckpointCorruptError(f"{d.name}: unreadable manifest ({e})") from e
    arrays = _load_arrays(d, manifest, verify=verify)
    placed = template
    if layout is not None:  # the logical arrays, then this mesh's blocks
        from repro_torch.models import sharding as sh

        mesh, specs = layout
        template = sh.global_like(placed, mesh, specs)

    out = []
    for path, leaf in flatten_with_path(template):
        key = _key(path)
        if key not in arrays:
            raise KeyError(f"checkpoint missing {key}")
        a = arrays[key]
        if tuple(a.shape) != tuple(leaf.shape):
            raise ValueError(f"{key}: checkpoint {a.shape} vs template {tuple(leaf.shape)}")
        if layout is not None:
            out.append(torch.from_numpy(np.array(a)).to(dtype=leaf.dtype))
        else:
            out.append(torch.from_numpy(np.array(a)).to(device=leaf.device,
                                                        dtype=leaf.dtype))
    tree = tree_unflatten(template, out)
    if layout is not None:
        tree = sh.place_tree(tree, specs, mesh, like=placed)
        for (key, got), (_, want) in zip(flatten_with_path(tree),
                                         flatten_with_path(placed)):
            if tuple(got.shape) != tuple(want.shape):
                raise ValueError(f"{_key(key)}: placed {tuple(got.shape)} vs template "
                                 f"{tuple(want.shape)}")
    return tree, manifest


def restore(
    directory: str | Path,
    template: Any,
    step: Optional[int] = None,
    *,
    verify: bool = True,
    fallback: bool = False,
    mesh=None,
    specs: Any = None,
) -> tuple[Any, dict]:
    """Restore into the structure of ``template`` (shapes/dtypes validated).

    ``mesh=``: ``template`` is a placed tree (a rank's blocks, placed by
    ``specs``; default ``models/sharding.py::placed_specs``, for the LM):
    the logical arrays are read on every rank and this rank's blocks of
    them come back on ``mesh.device``.

    ``verify=True`` re-hashes every array against the manifest CRC32s and
    raises :class:`CheckpointCorruptError` on mismatch or unreadable shards
    (manifests predating the CRC field skip verification).  With
    ``fallback=True`` and no explicit ``step``, a corrupt newest checkpoint
    is *warned about and skipped*: the scan walks backwards to the newest
    step that verifies, raising only when none does.

    The arrays land on the template leaves' devices and dtypes.
    """
    directory = Path(directory)
    layout = None
    if mesh is not None:
        from repro_torch.models import sharding as sh

        layout = (mesh, sh.placed_specs(template, mesh) if specs is None else specs)
    if step is not None:
        return _restore_one(directory, template, step, verify=verify, layout=layout)
    steps = complete_steps(directory)
    if not steps:
        raise FileNotFoundError(f"no complete checkpoint under {directory}")
    last_err: Optional[CheckpointCorruptError] = None
    for s in reversed(steps):
        try:
            return _restore_one(directory, template, s, verify=verify, layout=layout)
        except CheckpointCorruptError as e:
            if not fallback:
                raise
            warnings.warn(
                f"checkpoint step_{s} failed integrity, falling back to the "
                f"previous checkpoint: {e}",
                RuntimeWarning,
                stacklevel=2,
            )
            last_err = e
    raise CheckpointCorruptError(
        f"no checkpoint under {directory} passes integrity "
        f"(tried steps {list(reversed(steps))})"
    ) from last_err


class CheckpointManager:
    """Keep-last-k rotation + background writes + auto-resume with fallback.

    ``mesh=`` (SPMD, every rank builds the manager and calls it in step):
    :meth:`save` gathers the placed tree's logical arrays on every rank
    (``specs`` as in ``models/sharding.py::gather_params``) and rank 0
    writes them; :meth:`wait` joins the write and is a barrier, raising on
    every rank if rank 0's write failed; :meth:`restore_latest` places the
    logical arrays on the manager's mesh."""

    def __init__(self, directory: str | Path, keep: int = 3, *, mesh=None,
                 specs: Any = None):
        self.dir = Path(directory)
        self.keep = keep
        self.mesh, self.specs = mesh, specs
        self._pending: Optional[BackgroundWriter] = None
        self._pending_step: Optional[int] = None

    @property
    def writer(self) -> bool:
        """Whether this process writes (rank 0 of a mesh, or no mesh)."""
        import torch.distributed as dist

        return self.mesh is None or not dist.is_initialized() or dist.get_rank() == 0

    def save(self, step: int, tree: Any, extra: Optional[dict] = None):
        self.wait()  # surfaces the PREVIOUS write's failure before starting
        if self.mesh is not None:
            from repro_torch.models.sharding import gather_params

            tree = gather_params(tree, self.mesh, self.specs)
        if not self.writer:
            return
        self._pending_step = step
        self._pending = save(self.dir, step, tree, extra=extra, background=True)
        self._gc()

    def wait(self):
        """Join the in-flight write and RE-RAISE its failure, if any — a
        background checkpoint loss is never silent.  Under a mesh every rank
        waits here for rank 0's write, and every rank raises if it failed."""
        err = None
        if self._pending is not None:
            t, self._pending = self._pending, None
            t.join()
            self._pending_step = None
            try:
                t.check()
            except RuntimeError as e:
                err = e
        if self.mesh is not None:
            from repro_torch.launch.mesh import barrier

            if barrier(self.mesh, err is not None) and err is None:
                raise RuntimeError("background checkpoint write failed on rank 0")
        if err is not None:
            raise err

    def _gc(self):
        """Delete all but the newest ``keep`` complete checkpoints — but
        NEVER the directory the in-flight background write is about to
        rename into place (after a fallback-restore the loop re-saves an
        *older* step than stale on-disk ones, which the keep-last-k sort
        would otherwise select for deletion mid-write — a silently lost
        checkpoint; regression in tests/test_infra.py and tests/test_torch_train_faults.py)."""
        steps = complete_steps(self.dir)
        for s in steps[: -self.keep] if self.keep > 0 else steps:
            if s == self._pending_step:
                continue
            shutil.rmtree(self.dir / f"step_{s}", ignore_errors=True)

    def restore_latest(self, template: Any, *, fallback: bool = True):
        self.wait()
        return restore(self.dir, template, fallback=fallback, mesh=self.mesh,
                       specs=self.specs)
