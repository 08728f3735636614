"""Atomic, async-capable checkpointing of nested trees and of a population
(``repro.checkpoint.ckpt``), in the JAX package's on-disk format.

A tree is nested dicts, lists and tuples whose leaves are tensors, numpy
arrays or numbers.  ``save`` writes one ``np.savez`` file whose keys are
JAX's tree paths joined by ``::`` (a dict key ``k`` as ``kk``, a sequence
index ``i`` as ``ii``; dict keys sorted, as ``jax.tree_util`` flattens
them), plus ``__dtypes__`` and ``__meta__`` as JSON; bf16 is stored as
its uint16 bits with a ``"bfloat16"`` marker.  The file is written to
``<path>.tmp``, fsynced and renamed, so a crash mid-write never leaves a
torn restore point.  Elastic restore: a population checkpoint of K
trainers loads into K' != K slots (cloning cyclically).

The format knows nothing of a model's layout: a trainer converts its
weights to the tree it saves (the CycleGAN's to JAX's ``(d_in, d_out)``
layout, :mod:`repro_torch.bridge`), so that either package restores what
the other saved.
"""
from __future__ import annotations

import json
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

_SEP = "::"


def _join(prefix: str, part: str) -> str:
    return prefix + _SEP + part if prefix else part


def _leaves(tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(key, leaf) of every leaf in JAX's flatten order (dict keys sorted);
    ``None`` is an empty subtree, as in JAX."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], _join(prefix, f"k{k}"))
    elif isinstance(tree, (list, tuple)):
        for i, child in enumerate(tree):
            yield from _leaves(child, _join(prefix, f"i{i}"))
    else:
        yield prefix, tree


def _to_numpy(leaf) -> Tuple[np.ndarray, str]:
    """(host array, stored dtype name) of a leaf; a tensor is copied off
    its device, bf16 is kept as its uint16 bits (numpy has no bf16)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        a = t.numpy()
        return a, str(a.dtype)
    a = np.asarray(leaf)
    if a.dtype.name == "bfloat16":
        return a.view(np.uint16), "bfloat16"
    return a, str(a.dtype)


def _flatten(tree) -> Tuple[Dict[str, np.ndarray], Dict[str, str]]:
    """Host arrays (tensors copied off their devices now) and stored dtype
    names by key."""
    store, dtypes = {}, {}
    for key, leaf in _leaves(tree):
        store[key], dtypes[key] = _to_numpy(leaf)
    return store, dtypes


def _write(path: str, store: Dict[str, np.ndarray], dtypes: Dict[str, str],
           metadata: Optional[dict]):
    tmp = path + ".tmp"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(tmp, __dtypes__=json.dumps(dtypes),
             __meta__=json.dumps(metadata or {}), **store)
    actual = tmp if os.path.exists(tmp) else tmp + ".npz"
    with open(actual, "rb+") as f:
        os.fsync(f.fileno())
    os.replace(actual, path)
    try:                  # best-effort: make the rename itself durable
        dfd = os.open(os.path.dirname(os.path.abspath(path)), os.O_RDONLY)
        os.fsync(dfd)
        os.close(dfd)
    except OSError:
        pass


def save(path: str, tree, metadata: Optional[dict] = None):
    """Atomic + durable checkpoint write: <path>.tmp, fsync, rename."""
    _write(path, *_flatten(tree), metadata)


def _restore_leaf(arr: np.ndarray, stored: Optional[str], like):
    if isinstance(like, torch.Tensor):
        if stored == "bfloat16":
            t = torch.from_numpy(arr.view(np.int16).copy()).view(
                torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(arr))
        return t.to(device=like.device, dtype=like.dtype)
    if stored == "bfloat16":
        raise TypeError("a bf16 leaf restores into a tensor template only")
    return np.asarray(arr, dtype=np.asarray(like).dtype)


def _rebuild(like, flat: Dict[str, np.ndarray], dtypes: Dict[str, str],
             prefix: str = ""):
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _rebuild(v, flat, dtypes, _join(prefix, f"k{k}"))
                for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(v, flat, dtypes, _join(prefix, f"i{i}"))
                          for i, v in enumerate(like))
    return _restore_leaf(flat[prefix], dtypes.get(prefix), like)


def restore(path: str, like) -> Tuple[Any, dict]:
    """Restore into the structure of ``like`` (a tree template): a tensor
    leaf comes back as a tensor of its dtype on its device, any other leaf
    as a numpy array of its dtype.  Only the template's leaves are read
    (a server restores a trainer's ``params`` without its optimizer
    state)."""
    with np.load(path, allow_pickle=False) as z:
        dtypes = json.loads(str(z["__dtypes__"]))
        meta = json.loads(str(z["__meta__"]))
        flat = {k: z[k] for k, _ in _leaves(like)}
    return _rebuild(like, flat, dtypes), meta


class AsyncCheckpointer:
    """Overlap checkpoint writes with training."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None

    def save(self, path: str, tree, metadata: Optional[dict] = None):
        """Copy every tensor of ``tree`` to the host now (a later step may
        change the device buffers), then write in the background."""
        self.wait()
        store, dtypes = _flatten(tree)
        self._thread = threading.Thread(
            target=_write, args=(path, store, dtypes, metadata), daemon=True)
        self._thread.start()

    def wait(self):
        """Block until the last background write has finished."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None


def latest_step_path(ckpt_dir: str) -> Optional[str]:
    """Find the newest step checkpoint in a directory."""
    if not os.path.isdir(ckpt_dir):
        return None
    cands = [f for f in os.listdir(ckpt_dir)
             if f.startswith("step_") and f.endswith(".ckpt")]
    if not cands:
        return None
    best = max(cands, key=lambda f: int(f.split("_")[1].split(".")[0]))
    return os.path.join(ckpt_dir, best)


def _each(fn, items) -> list:
    """``[fn(i, item) ...]``, the calls on a few threads at once."""
    with ThreadPoolExecutor(max_workers=max(1, min(len(items), 4))) as ex:
        return list(ex.map(fn, range(len(items)), items))


def save_population(ckpt_dir: str, step: int, pop_state: Dict[str, Any]):
    """Population checkpoint: one file per trainer + a manifest, so
    trainers can checkpoint independently (no global barrier)."""
    os.makedirs(ckpt_dir, exist_ok=True)
    manifest = {"step": step, "num_trainers": len(pop_state["trainers"]),
                "round": pop_state["round"], "time": time.time(),
                "seed": pop_state.get("seed", 0),
                "scope": pop_state.get("scope", "full")}

    def member(i: int, tr: dict) -> None:
        save(os.path.join(ckpt_dir, f"step_{step}_trainer_{i}.ckpt"),
             {"params": tr["params"], "opt_state": tr["opt_state"]},
             {"hparams": tr["hparams"], "steps": tr["steps"],
              "alive": tr["alive"], "wins": tr.get("wins", 0),
              "adoptions": tr.get("adoptions", 0)})

    # members are written side by side: a file's CRC, its writes and its
    # fsync run outside the GIL
    _each(member, pop_state["trainers"])
    with open(os.path.join(ckpt_dir, f"step_{step}.manifest.tmp"), "w") as f:
        json.dump(manifest, f)
    os.replace(os.path.join(ckpt_dir, f"step_{step}.manifest.tmp"),
               os.path.join(ckpt_dir, f"step_{step}.manifest"))


def latest_population_step(ckpt_dir: str) -> Optional[int]:
    """Newest population-checkpoint step in a directory (None if empty)."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(f[len("step_"):-len(".manifest")])
             for f in os.listdir(ckpt_dir)
             if f.startswith("step_") and f.endswith(".manifest")]
    return max(steps) if steps else None


def restore_population(ckpt_dir: str, step: int, like_trainer: dict,
                       num_trainers: Optional[int] = None
                       ) -> Dict[str, Any]:
    """Elastic restore: load <= stored trainers, cloning cyclically if
    the new population is larger."""
    with open(os.path.join(ckpt_dir, f"step_{step}.manifest")) as f:
        manifest = json.load(f)
    k_stored = manifest["num_trainers"]
    k = num_trainers or k_stored

    def member(i: int, _) -> dict:
        src = i % k_stored
        tree, meta = restore(
            os.path.join(ckpt_dir, f"step_{step}_trainer_{src}.ckpt"),
            like_trainer)
        return {"params": tree["params"], "opt_state": tree["opt_state"],
                "hparams": meta["hparams"], "steps": meta["steps"],
                "alive": meta["alive"], "wins": meta.get("wins", 0),
                "adoptions": meta.get("adoptions", 0)}

    trainers = _each(member, [None] * k)
    return {"round": manifest["round"],
            "seed": manifest.get("seed", 0),
            "scope": manifest.get("scope", "full"),
            "trainers": trainers}
