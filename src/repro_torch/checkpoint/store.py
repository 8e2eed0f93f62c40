"""Checkpointing in the JAX package's on-disk format: per-leaf ``.npy``
blobs and a msgpack index, so that a checkpoint written by either
package loads in the other.

Layout:  ``<dir>/step_<n>/index.msgpack`` + ``<dir>/step_<n>/leaf_<i>.npy``
(``i`` counts the leaves in the JAX tree order: dict keys sorted, a
NamedTuple's fields as ``.name``, a tuple's items by index, ``None``
holding none), each leaf keyed by its ``/``-joined path
(``.params/blocks/l0/mixer/wq``), bf16 stored as its uint16 bits.
Atomic via rename of a temp directory.  A training mesh's state is
gathered to rank 0 first (:func:`save_from_mesh`).  Leaves are written and read
by a pool of ``IO_THREADS`` threads (a device-to-host copy and a file
write overlap another leaf's).  The index is packed by ``msgpack``, as
the JAX package packs it.
"""
from __future__ import annotations

import os
import shutil
import tempfile
from concurrent.futures import ThreadPoolExecutor
from typing import Any, List, Optional, Tuple

import msgpack
import numpy as np
import torch

#: threads that write or read leaves at once
IO_THREADS = 8


# ---------------------------------------------------------------------------
# trees
# ---------------------------------------------------------------------------

def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten_with_paths(tree, prefix: Tuple[str, ...] = ()
                        ) -> List[Tuple[str, Any]]:
    """(the JAX ``/``-joined key path, leaf) in the JAX leaf order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif _is_namedtuple(tree):
        items = [(f".{f}", getattr(tree, f)) for f in tree._fields]
    elif isinstance(tree, (tuple, list)):
        items = [(str(i), x) for i, x in enumerate(tree)]
    else:
        return [("/".join(prefix), tree)]
    out = []
    for k, v in items:
        out += _flatten_with_paths(v, prefix + (k,))
    return out


def _rebuild(tree, leaves):
    """``tree`` with its leaves (in ``_flatten_with_paths`` order)
    replaced by ``leaves``, an iterator."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        out = {k: _rebuild(tree[k], leaves) for k in sorted(tree)}
        return {k: out[k] for k in tree}
    if _is_namedtuple(tree):
        return type(tree)(*(_rebuild(getattr(tree, f), leaves)
                            for f in tree._fields))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_rebuild(x, leaves) for x in tree)
    return next(leaves)


def _to_numpy(leaf) -> Tuple[np.ndarray, str]:
    """(the array np.save writes, the dtype name the index records)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return t.numpy(), str(t.numpy().dtype)
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _from_numpy(arr: np.ndarray, dtype_name: str, ref) -> torch.Tensor:
    arr = np.asarray(arr, order="C")          # keeps a 0-d leaf 0-d
    if dtype_name == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    if isinstance(ref, torch.Tensor):
        t = t.to(device=ref.device, dtype=ref.dtype)
    return t


# ---------------------------------------------------------------------------

def save_checkpoint(directory: str, step: int, tree: Any) -> str:
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = tempfile.mkdtemp(dir=directory, prefix=".tmp_ckpt_")
    def write(item):
        i, (key, leaf) = item
        arr, dtype_name = _to_numpy(leaf)
        fname = f"leaf_{i:05d}.npy"
        np.save(os.path.join(tmp, fname), arr)
        return {"key": key, "file": fname, "dtype": dtype_name,
                "shape": list(arr.shape)}

    with ThreadPoolExecutor(IO_THREADS) as pool:
        entries = list(pool.map(write,
                                enumerate(_flatten_with_paths(tree))))
    index = {"step": step, "leaves": entries}
    with open(os.path.join(tmp, "index.msgpack"), "wb") as f:
        f.write(msgpack.packb(index))
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def save_from_mesh(directory: str, step: int, trainer, state,
                   params_only: bool = False) -> str:
    """Save a training mesh's ``TrainState`` (``trainer``: the
    ``MeshTrainer`` of ``make_train_step(..., mesh=)``, ``state`` rank
    0's): every rank's slices are gathered to rank 0 and placed by their
    specs, and the whole state (or its params) is written as
    :func:`save_checkpoint` writes it: byte for byte the unsharded save
    of the same state."""
    whole = trainer.gather_state(state, params_only)
    return save_checkpoint(directory, step,
                           whole.params if params_only else whole)


def load_checkpoint(directory: str, step: Optional[int], like: Any) -> Any:
    """The tree of ``like`` with every leaf read from the checkpoint: a
    tensor of the ``like`` leaf's dtype on its device (a numpy ``like``
    leaf gives a CPU tensor of the stored dtype)."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "index.msgpack"), "rb") as f:
        index = msgpack.unpackb(f.read())
    by_key = {e["key"]: e for e in index["leaves"]}
    want = _flatten_with_paths(like)
    for key, _ in want:
        if key not in by_key:
            raise KeyError(f"checkpoint missing leaf {key!r}")

    def read(item):
        key, ref = item
        e = by_key[key]
        return _from_numpy(np.load(os.path.join(path, e["file"])),
                           e["dtype"], ref)

    with ThreadPoolExecutor(IO_THREADS) as pool:
        leaves = list(pool.map(read, want))
    return _rebuild(like, iter(leaves))


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(directory)
             if d.startswith("step_")]
    return max(steps) if steps else None
