"""Atomic, async checkpointing, the port of the reference's
``repro/checkpoint/manager.py``, in the reference's on-disk format:

  <dir>/step_000000123.tmp/     — written first
      manifest.json             — step, and each array's shape, dtype and
                                  crc32
      arrays.npz                — flat {path: ndarray}, keyed by the
                                  reference's paths (``params/embed``,
                                  ``opt/m/blocks/attn/wq/q``, ...)
  <dir>/step_000000123/         — atomic rename commit
  <dir>/LATEST                  — text file with the last committed step

so a checkpoint written by either package restores in the other.

Fault-tolerance contract:
  * a crash mid-save never corrupts an existing checkpoint (tmp + rename)
  * ``save(..., blocking=False)`` runs in a background thread (training
    continues; ``wait()`` joins before the next save or at exit); the
    device -> host copy stays on the caller's thread
  * integrity: the manifest carries a per-array crc32; restore verifies
    and raises ``IOError`` on a mismatch

A bfloat16 leaf is stored as the reference stores it (numpy has no
bfloat16 without ``ml_dtypes``, through which the reference writes it):
its raw 2-byte words under the npy descr ``<V2``, with ``"bfloat16"`` in
the manifest. Restore reads the manifest's dtype back.

On a mesh a tree of DTensors is saved as its full tensors (every rank
joins the gathers; rank 0 alone writes), so the bytes on disk are those
of a one-device save of the same state. ``restore(..., shardings=)``
places each leaf as a DTensor with the given placements (a tree of
them: ``params.shardings``, ``params.placements_of``), the counterpart
of the reference's ``jax.device_put`` onto NamedShardings.
"""
from __future__ import annotations

import json
import shutil
import threading
import zipfile
import zlib
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.compat import DTensor
from repro_torch.kernels.common import resolve_device
from repro_torch.models.params import place

#: the npy descr the reference's bfloat16 arrays carry (ml_dtypes')
BF16_DESCR = "<V2"


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = tree
    return out


def _unflatten(flat: Dict[str, Any], template):
    def build(tree, prefix=""):
        if isinstance(tree, dict):
            return {k: build(tree[k], f"{prefix}{k}/") for k in tree}
        if isinstance(tree, (list, tuple)):
            vals = [build(v, f"{prefix}{i}/") for i, v in enumerate(tree)]
            return type(tree)(vals)
        return flat[prefix[:-1]]
    return build(template)


def _to_host(v):
    """(numpy array, manifest dtype) of one leaf: a tensor copied to the
    host (a copy on the CPU too, so a later in-place change does not reach
    a save in flight; bfloat16 as its 2-byte words, viewed as ``V2``),
    anything else through ``np.array``."""
    if isinstance(v, DTensor):
        v = v.full_tensor()
    if isinstance(v, torch.Tensor):
        t = v.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.dtype("V2")), \
                "bfloat16"
        a = t.numpy()
    else:
        a = np.array(v)
    return a, str(a.dtype)


def _savez(path: Path, host: Dict[str, tuple]):
    """``np.savez``'s layout (one stored ``<key>.npy`` member a key), with
    bfloat16 members under the reference's descr."""
    with zipfile.ZipFile(path, "w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for k, (a, dtype) in host.items():
            with zf.open(k + ".npy", "w", force_zip64=True) as fid:
                if dtype == "bfloat16":
                    a = np.ascontiguousarray(a)
                    header = np.lib.format.header_data_from_array_1_0(a)
                    header["descr"] = BF16_DESCR
                    np.lib.format.write_array_header_1_0(fid, header)
                    fid.write(a.tobytes())
                else:
                    np.lib.format.write_array(fid, a, allow_pickle=False)


def save(ckpt_dir, step: int, tree, *, blocking: bool = True,
         keep: int = 3) -> Optional[threading.Thread]:
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    flat = _flatten(tree)
    # device -> host copy happens on the caller thread (consistent
    # snapshot); a DTensor's full tensor is gathered on every rank
    host = {k: _to_host(v) for k, v in flat.items()}
    if any(isinstance(v, DTensor) for v in flat.values()) and \
            dist.get_rank() != 0:
        return None                      # rank 0 writes the mesh's state

    def _write():
        tmp = ckpt_dir / f"step_{step:09d}.tmp"
        final = ckpt_dir / f"step_{step:09d}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir()
        _savez(tmp / "arrays.npz", host)
        manifest = {
            "step": step,
            "arrays": {k: {"shape": list(a.shape), "dtype": dtype,
                           "crc32": zlib.crc32(a.tobytes())}
                       for k, (a, dtype) in host.items()},
        }
        (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)                       # atomic commit
        (ckpt_dir / "LATEST.tmp").write_text(str(step))
        (ckpt_dir / "LATEST.tmp").rename(ckpt_dir / "LATEST")
        _gc(ckpt_dir, keep)

    if blocking:
        _write()
        return None
    t = threading.Thread(target=_write, daemon=False)
    t.start()
    return t


def _gc(ckpt_dir: Path, keep: int):
    steps = sorted(p for p in ckpt_dir.glob("step_*") if p.is_dir()
                   and not p.name.endswith(".tmp"))
    for p in steps[:-keep]:
        shutil.rmtree(p, ignore_errors=True)


def latest_step(ckpt_dir) -> Optional[int]:
    f = Path(ckpt_dir) / "LATEST"
    if not f.exists():
        return None
    return int(f.read_text().strip())


def _to_tensor(a: np.ndarray, dtype: str, device) -> torch.Tensor:
    if dtype == "bfloat16":
        bits = np.ascontiguousarray(a).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _mesh_of(tree):
    for v in _flatten(tree).values():
        if isinstance(v, DTensor):
            return v.device_mesh
    return None


def restore(ckpt_dir, template, *, step: Optional[int] = None,
            shardings=None, mesh=None, verify: bool = True, device=None):
    """Load into the structure of ``template`` as tensors on ``device``
    (the card unless ``"cpu"``), each in the manifest's dtype. Returns
    ``(tree, step)``.

    ``shardings`` (a tree of DTensor placements, ``None`` leaves for
    plain tensors) places each leaf on ``mesh`` (by default the mesh of
    ``template``'s DTensors): every rank reads the checkpoint and keeps
    its own blocks."""
    if shardings is not None:
        mesh = mesh if mesh is not None else _mesh_of(template)
        if mesh is None:
            raise ValueError("restore(shardings=) needs a mesh: pass mesh= "
                             "or a template of DTensors")
    dev = resolve_device(device)
    ckpt_dir = Path(ckpt_dir)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    d = ckpt_dir / f"step_{step:09d}"
    manifest = json.loads((d / "manifest.json").read_text())
    with np.load(d / "arrays.npz") as z:
        host = {k: z[k] for k in z.files}
    if verify:
        for k, meta in manifest["arrays"].items():
            crc = zlib.crc32(host[k].tobytes())
            if crc != meta["crc32"]:
                raise IOError(f"checksum mismatch for {k} in {d}")
    out = {k: _to_tensor(v, manifest["arrays"][k]["dtype"], dev)
           for k, v in host.items()}
    tree = _unflatten(out, template)
    if shardings is not None:
        tree = place(tree, shardings, mesh)
    return tree, step


class CheckpointManager:
    """Coordinates periodic async saves + preemption-triggered sync save."""

    def __init__(self, ckpt_dir, *, interval: int = 100, keep: int = 3):
        self.dir = Path(ckpt_dir)
        self.interval = interval
        self.keep = keep
        self._pending: Optional[threading.Thread] = None

    def maybe_save(self, step: int, tree, *, force: bool = False):
        if not force and (self.interval <= 0 or step % self.interval):
            return False
        self.wait()
        self._pending = save(self.dir, step, tree, blocking=False,
                             keep=self.keep)
        return True

    def wait(self):
        if self._pending is not None:
            self._pending.join()
            self._pending = None

    def restore_latest(self, template, shardings=None, device=None,
                       mesh=None):
        return restore(self.dir, template, shardings=shardings, mesh=mesh,
                       device=device)
