"""Checkpoints: atomic, manifest-based, asynchronous (port of
``repro/distributed/checkpoint.py``).

Layout, one directory per step::

    <dir>/step_00000123/
        manifest.json     # the tree: containers, scalars, tensor shapes and
                          # dtypes, CIM stores' shapes and configs
        tensors.pt        # torch.save of {key: tensor}, one entry per tensor
    <dir>/LATEST          # the last committed step, replaced atomically

A step is written into ``step_XXXXXXXX.tmp`` and renamed into place, then
``LATEST`` moves. ``tensors.pt`` holds nothing but tensors, so
``torch.load(weights_only=True)`` reads it; everything else (dicts, lists,
Python scalars, ``None``, a :class:`~repro_torch.core.cim.CIMStore`'s shape,
``CIMConfig`` and mesh ``ShardInfo``, a
:class:`~repro_torch.core.faultmodels.FaultProcess`)
goes into the manifest as plain fields, so a restore rebuilds the tree
without unpickling objects. Tensors are stored in their logical layout and
restored onto an explicit device.
"""
from __future__ import annotations

import dataclasses
import json
import os
import queue
import shutil
import threading
import time
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import faultmodels as fm_lib
from repro_torch.core.bitops import get_format
from repro_torch.core.cim import CIMConfig, CIMStore, ShardInfo

_SEP = "//"
_PLANES = ("man", "sign", "exp", "codewords", "cache")
# torch.save keeps these as same-width signed views (older torch releases
# cannot serialize unsigned tensors wider than a byte)
_SIGNED = {torch.uint16: torch.int16, torch.uint32: torch.int32,
           torch.uint64: torch.int64}
_DTYPES = {str(d): d for d in (
    torch.float16, torch.bfloat16, torch.float32, torch.float64, torch.int8,
    torch.uint8, torch.int16, torch.int32, torch.int64, torch.bool,
    torch.uint16, torch.uint32, torch.uint64)}


def _child(key: str, name) -> str:
    return f"{key}{_SEP}{name}" if key else str(name)


def _encode(node, key: str, tensors: dict):
    """Tree -> JSON-able manifest node; tensors land in ``tensors``."""
    if node is None:
        return {"none": True}
    if isinstance(node, torch.Tensor):
        t = node.detach()
        tensors[key] = t.view(_SIGNED[t.dtype]) if t.dtype in _SIGNED else t
        return {"tensor": key, "shape": list(t.shape), "dtype": str(t.dtype)}
    if isinstance(node, np.ndarray):
        return _encode(torch.from_numpy(np.ascontiguousarray(node)), key,
                       tensors)
    if isinstance(node, CIMStore):
        cfg = node.cfg
        return {"store": {
            "shape": list(node.shape),
            "cfg": {"n_group": cfg.n_group, "index": cfg.index,
                    "protect": cfg.protect, "fmt": cfg.fmt.name,
                    "row_weights": cfg.row_weights},
            "shard": None if node.shard is None else {
                f.name: getattr(node.shard, f.name)
                for f in dataclasses.fields(node.shard)},
            "planes": {n: _encode(getattr(node, n), _child(key, n),
                                  tensors) for n in _PLANES}}}
    if isinstance(node, fm_lib.FaultProcess):
        return {"fault_process": dataclasses.asdict(node)}
    if isinstance(node, dict):
        return {"dict": [[str(k), _encode(v, _child(key, k), tensors)]
                         for k, v in node.items()]}
    if isinstance(node, (list, tuple)):
        kind = "list" if isinstance(node, list) else "tuple"
        return {kind: [_encode(v, _child(key, i), tensors)
                       for i, v in enumerate(node)]}
    if isinstance(node, (bool, int, float, str, np.generic)):
        return {"scalar": node.item() if isinstance(node, np.generic)
                else node}
    raise TypeError(f"checkpoint: cannot store a {type(node).__name__} "
                    f"at {key!r}")


def _decode(node, tensors: dict, device):
    if "none" in node:
        return None
    if "tensor" in node:
        t = tensors[node["tensor"]]
        dtype = _DTYPES[node["dtype"]]
        if t.dtype != dtype:
            t = t.view(dtype)
        return t.to(device)
    if "store" in node:
        s = node["store"]
        c = s["cfg"]
        cfg = CIMConfig(n_group=c["n_group"], index=c["index"],
                        protect=c["protect"], fmt=get_format(c["fmt"]),
                        row_weights=c["row_weights"])
        planes = {n: _decode(p, tensors, device)
                  for n, p in s["planes"].items()}
        sh = s.get("shard")
        if sh is not None:
            sh = ShardInfo(**{**sh, "global_shape": tuple(sh["global_shape"]),
                              "global_pad": tuple(sh["global_pad"]),
                              "plane_shapes": tuple(
                                  (k, tuple(v)) for k, v in
                                  sh["plane_shapes"])})
        return CIMStore(shape=tuple(s["shape"]), cfg=cfg, shard=sh, **planes)
    if "fault_process" in node:
        return fm_lib.FaultProcess(**node["fault_process"])
    if "dict" in node:
        return {k: _decode(v, tensors, device) for k, v in node["dict"]}
    if "list" in node:
        return [_decode(v, tensors, device) for v in node["list"]]
    if "tuple" in node:
        return tuple(_decode(v, tensors, device) for v in node["tuple"])
    return node["scalar"]


def _leaf_paths(node, key: str = "") -> set:
    """The leaf paths of a manifest node (the restore's structure check)."""
    for kind in ("dict", "list", "tuple"):
        if kind in node:
            items = node[kind] if kind == "dict" else enumerate(node[kind])
            return set().union(*(_leaf_paths(v, _child(key, k))
                                 for k, v in items)) or {key}
    return {key}


def _own_storage(t: torch.Tensor) -> torch.Tensor:
    """``t`` as a tensor that owns exactly its storage: torch.save writes a
    view's whole storage."""
    if t.is_contiguous() and \
            t.untyped_storage().nbytes() == t.numel() * t.element_size():
        return t
    return t.contiguous().clone()


def save(state, step: int, directory: str) -> str:
    """Synchronous atomic save of ``state`` as step ``step``. Returns the
    committed step directory."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    tensors = {}
    manifest = {"step": int(step), "time": time.time(),
                "tree": _encode(state, "", tensors)}
    torch.save({k: _own_storage(v) for k, v in tensors.items()},
               os.path.join(tmp, "tensors.pt"))
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)                       # the atomic commit
    _write_latest(directory, step)
    return final


def _write_latest(directory: str, step: int) -> None:
    tmp = os.path.join(directory, "LATEST.tmp")
    with open(tmp, "w") as f:
        f.write(str(step))
    os.replace(tmp, os.path.join(directory, "LATEST"))


def latest_step(directory: str) -> Optional[int]:
    try:
        with open(os.path.join(directory, "LATEST")) as f:
            return int(f.read().strip())
    except (FileNotFoundError, ValueError):
        return None


def step_bytes(directory: str, step: Optional[int] = None) -> int:
    """Bytes on disk of one committed step (the latest by default)."""
    step = latest_step(directory) if step is None else step
    stepdir = os.path.join(directory, f"step_{step:08d}")
    return sum(os.path.getsize(os.path.join(stepdir, n))
               for n in os.listdir(stepdir))


def restore(target, directory: str, step: Optional[int] = None, *,
            device="cpu") -> Tuple[Any, int]:
    """Rebuild the tree saved at ``step`` (the latest by default), its
    tensors on ``device`` -> (tree, step). ``target``, when given, must have
    the saved tree's structure: its leaf paths (``None`` leaves included)
    must equal the manifest's."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {directory}")
    stepdir = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(stepdir, "manifest.json")) as f:
        manifest = json.load(f)
    if target is not None:
        want = _leaf_paths(_encode(target, "", {}))
        have = _leaf_paths(manifest["tree"])
        if want != have:
            raise ValueError(f"checkpoint step {step}: saved leaves "
                             f"{sorted(have - want)} and target leaves "
                             f"{sorted(want - have)} differ")
    # memory-mapped: a restore that keeps only blocks of the leaves (a
    # ZeRO-3 rank's, training.loop) pages in only those
    tensors = torch.load(os.path.join(stepdir, "tensors.pt"),
                         map_location="cpu", weights_only=True, mmap=True)
    return _decode(manifest["tree"], tensors, torch.device(device)), step


def _map_tensors(fn: Callable, node):
    if isinstance(node, torch.Tensor):
        return fn(node)
    if isinstance(node, CIMStore):
        return dataclasses.replace(node, **{
            n: None if getattr(node, n) is None else fn(getattr(node, n))
            for n in _PLANES})
    if isinstance(node, dict):
        return {k: _map_tensors(fn, v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_map_tensors(fn, v) for v in node)
    return node


def _host_copy(state):
    """``state`` with every tensor copied to host memory (a copy also where
    it already lies there: the caller may go on mutating its tensors)."""
    return _map_tensors(lambda t: t.detach().to("cpu", copy=True), state)


class AsyncCheckpointer:
    """A background writer thread: ``save_async`` takes a host copy and
    returns; the write and the garbage collection of all but the ``keep``
    newest steps happen behind it. An error in the writer surfaces on the
    next ``save_async``, ``wait`` or ``close``."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._q: "queue.Queue" = queue.Queue(maxsize=2)
        self._exc: Optional[BaseException] = None
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def save_async(self, state, step: int, copy: bool = True) -> None:
        """Queue ``state`` for step ``step``: a host copy of it, or (``copy
        False``) the tree itself, whose tensors the caller hands over."""
        if self._exc:
            raise self._exc
        self._q.put((_host_copy(state) if copy else state, step))

    def _run(self):
        while True:
            item = self._q.get()
            try:
                if item is None:
                    return
                state, step = item
                save(state, step, self.directory)
                self._gc()
            except Exception as e:      # noqa: BLE001 - raised by the caller
                self._exc = e
            finally:
                self._q.task_done()

    def _gc(self):
        steps = sorted(int(d.split("_")[1]) for d in os.listdir(self.directory)
                       if d.startswith("step_") and not d.endswith(".tmp"))
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)

    def wait(self):
        """Block until every queued save is committed."""
        self._q.join()
        if self._exc:
            raise self._exc

    def close(self):
        self._q.put(None)
        self._worker.join(timeout=30)
        if self._worker.is_alive():
            raise RuntimeError("checkpoint writer did not stop within 30 s")
        if self._exc:
            raise self._exc
