"""Atomic, async checkpointing — the counterpart of
``repro.checkpoint.store``, with its layout.

Layout: ``<dir>/step_<n>/arrays.npz`` (one array per leaf, its path's
``/`` written ``|``) + ``manifest.json`` (each leaf's shape and dtype, the
step, the device count at save time).  Writes go to a temporary directory
+ an atomic rename, so a job killed mid-save never corrupts the latest
checkpoint; ``latest_step`` scans only completed directories.  An async
mode hands the host-side write to a background thread (training goes on;
``wait()`` joins before the next save).

``save`` takes a tree (dicts and lists) of tensors or numpy arrays.  numpy
has no bfloat16 without ``ml_dtypes``, which the port does not use: a
bfloat16 leaf is written as its 16 bits with the descr ``'<V2'``, as the
reference's ``np.savez`` of an ``ml_dtypes`` leaf writes it, and the
manifest's ``"bfloat16"``; ``restore`` reinterprets such a leaf by that
dtype string (the reference's own restore gives it back as raw ``V2``).
``restore`` returns whole tensors, placed on ``device``; on a mesh each
rank then keeps its slice (``models.convert``), the counterpart of the
reference's ``shardings=``.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
import zipfile

import numpy as np
import torch


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = tree
    return out


def _unflatten(flat: dict):
    root: dict = {}
    for path, v in flat.items():
        keys = path.split("/")
        node = root
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = v
    return _fix_lists(root)


def _fix_lists(node):
    if isinstance(node, dict):
        node = {k: _fix_lists(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            return [node[str(i)] for i in range(len(node))]
    return node


def _host(leaf) -> np.ndarray:
    """A leaf as a host numpy array of its own (training goes on updating
    the tensor in place while an async write runs); a bfloat16 tensor as
    its bits (uint16), which ``_write`` stores as ``'<V2'``."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return np.array(leaf)


def _dtype_name(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).removeprefix("torch.")
    return str(np.asarray(leaf).dtype)


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3, async_mode: bool = False):
        self.dir = directory
        self.keep = keep
        self.async_mode = async_mode
        self._thread: threading.Thread | None = None
        os.makedirs(directory, exist_ok=True)

    # -- save ---------------------------------------------------------------
    def save(self, step: int, tree, extra: dict | None = None) -> None:
        flat = _flatten(tree)
        dtypes = {k: _dtype_name(v) for k, v in flat.items()}
        host = {k: _host(v) for k, v in flat.items()}
        if self.async_mode:
            self.wait()
            self._thread = threading.Thread(
                target=self._write, args=(step, host, dtypes, extra or {}))
            self._thread.start()
        else:
            self._write(step, host, dtypes, extra or {})

    def _write(self, step: int, flat: dict, dtypes: dict, extra: dict) -> None:
        final = os.path.join(self.dir, f"step_{step:08d}")
        tmp = final + f".tmp.{os.getpid()}.{int(time.time()*1e6)}"
        os.makedirs(tmp, exist_ok=True)
        # np.savez's archive, written leaf by leaf so that a bfloat16 leaf
        # gets the reference's '<V2' descr
        with zipfile.ZipFile(os.path.join(tmp, "arrays.npz"), "w",
                             zipfile.ZIP_STORED, allowZip64=True) as zf:
            for k, v in flat.items():
                with zf.open(k.replace("/", "|") + ".npy", "w",
                             force_zip64=True) as f:
                    if dtypes[k] == "bfloat16":
                        np.lib.format.write_array_header_1_0(f, {
                            "descr": "<V2", "fortran_order": False,
                            "shape": v.shape})
                        f.write(v.tobytes())
                    else:
                        np.lib.format.write_array(f, v, allow_pickle=False)
        manifest = {
            "step": step,
            "paths": {k: {"shape": list(v.shape), "dtype": dtypes[k]}
                      for k, v in flat.items()},
            "extra": extra,
            "n_devices_at_save": torch.cuda.device_count() or 1,
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)           # atomic publish
        self._gc()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    # -- restore ------------------------------------------------------------
    def all_steps(self) -> list[int]:
        out = []
        for d in os.listdir(self.dir):
            if d.startswith("step_") and ".tmp" not in d and \
                    os.path.exists(os.path.join(self.dir, d, "manifest.json")):
                out.append(int(d[5:]))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int | None = None, device=None):
        """Load a checkpoint as a tree of tensors on ``device`` (the CPU
        when None) -> (tree, manifest)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        path = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        flat = {}
        with np.load(os.path.join(path, "arrays.npz")) as data:
            for k in data.files:
                name = k.replace("|", "/")
                a = data[k]
                if manifest["paths"][name]["dtype"] == "bfloat16":
                    t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
                else:
                    t = torch.from_numpy(a)
                flat[name] = t.to(device) if device is not None else t
        return _unflatten(flat), manifest
