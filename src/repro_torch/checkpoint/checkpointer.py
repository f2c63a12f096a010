"""Device-agnostic checkpointing with async save.

The port's counterpart of the JAX package's
``checkpoint/checkpointer.py``, with the same on-disk layout: one
``step_N/`` directory per checkpoint, one ``.npy`` per leaf of the
state tree (its name the leaf's dict path joined with ``__``, leaves in
sorted-key order), and a JSON manifest (step, time, leaf shapes and
dtypes, extra).  A checkpoint written by either package loads in the
other.  bfloat16 leaves are written as the JAX package writes them
(``descr '<V2'``, the raw bits; numpy has no bfloat16 of its own) and
read back through the manifest's dtype.

``save`` copies every leaf to host memory before it returns (the state
may be updated in place right after), then writes the files on a
background thread; ``wait()`` joins it (``save`` and ``load`` call it
first; a caller calls it before shutdown).  ``keep`` bounds the checkpoints kept on disk.

A ZeRO-3 state (``shards``: ``distributed.sharding.StateShards``) is
saved and loaded in the same one-device layout: every rank calls
``save``, each leaf in turn is gathered whole (a collective) and rank 0
copies it to host memory before the next leaf is gathered, so no rank
holds the whole state on the card; ``load`` reads each whole leaf and
keeps this rank's slice.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
import time
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike
from repro_torch.models.params import numpy_to_torch, torch_to_numpy

_BF16_DESCR = "<V2"      # how numpy writes the JAX package's bfloat16


def _flatten(tree: Any, path: Tuple[str, ...] = ()
             ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    """(path, leaf) of a tree of dicts in the order ``jax.tree_util``
    flattens it (sorted keys)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], path + (str(k),))
    else:
        yield path, tree


def _leaf_name(path: Tuple[str, ...]) -> str:
    return "__".join(path) or "leaf"


def _rebuild(tree: Any, leaves: Dict[str, Any],
             path: Tuple[str, ...] = ()) -> Any:
    """``tree``'s structure with each leaf replaced by ``leaves[name]``."""
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaves, path + (str(k),))
                for k, v in tree.items()}
    return leaves[_leaf_name(path)]


def _host(x: Any) -> Tuple[np.ndarray, str]:
    """A leaf as (numpy array, dtype name as the manifest writes it)."""
    if isinstance(x, torch.Tensor):     # a copy, also of a CPU tensor
        return (torch_to_numpy(x.detach().to("cpu", copy=True)),
                str(x.dtype).split(".")[-1])
    arr = np.asarray(x)
    return arr, str(arr.dtype)


def _save_npy(path: str, arr: np.ndarray, dtype: str) -> None:
    if dtype != "bfloat16":
        np.save(path, arr)
        return
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": _BF16_DESCR, "fortran_order": False,
                "shape": arr.shape})
        f.write(np.ascontiguousarray(arr).tobytes())


def _load_leaf(path: str, dtype: str, device) -> torch.Tensor:
    arr = np.load(path)
    if dtype == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)
                                ).view(torch.bfloat16).to(device)
    return numpy_to_torch(arr, device)


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None

    # ------------------------------ save ------------------------------- #

    def save(self, step: int, state: Any, *, blocking: bool = False,
             extra: Optional[Dict] = None, shards=None) -> None:
        """Write ``state`` as step ``step``.  With ``shards`` every rank
        calls this and rank 0 writes (see the module docstring)."""
        self.wait()
        # the host copy is synchronous (the caller may update the state
        # in place next); the files are written on a background thread
        if shards is None:
            host = [(_leaf_name(p), *_host(x)) for p, x in _flatten(state)]
        else:
            host = []
            for p, x in _flatten(state):
                whole = shards.whole("/".join(p), x)
                if shards.rank == 0:
                    host.append((_leaf_name(p), *_host(whole)))
                del whole
            if shards.rank != 0:
                return

        def _write():
            tmp = os.path.join(self.dir, f".tmp_step_{step}")
            os.makedirs(tmp, exist_ok=True)
            manifest = {"step": step, "time": time.time(),
                        "leaves": {}, "extra": extra or {}}
            for name, arr, dtype in host:
                _save_npy(os.path.join(tmp, name + ".npy"), arr, dtype)
                manifest["leaves"][name] = {"shape": list(arr.shape),
                                            "dtype": dtype}
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            final = os.path.join(self.dir, f"step_{step}")
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
            self._gc()

        if blocking:
            _write()
        else:
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        for s in self.all_steps()[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)

    # ------------------------------ load ------------------------------- #

    def all_steps(self) -> List[int]:
        out = []
        for d in os.listdir(self.dir):
            m = re.fullmatch(r"step_(\d+)", d)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def load(self, state_like: Any, step: Optional[int] = None,
             device: DeviceLike = None, shards=None) -> Tuple[Any, int]:
        """Restore into the structure of ``state_like`` (the latest step
        unless ``step`` is given).  Each leaf goes to ``device``, or,
        when None, to the device of its ``state_like`` leaf; it keeps
        the dtype it was saved with.  With ``shards`` ``state_like``
        holds this rank's slices, and each leaf read whole is cut to
        its slice."""
        self.wait()
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        d = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(d, "manifest.json")) as f:
            meta = json.load(f)["leaves"]
        leaves = {}
        for p, like in _flatten(state_like):
            name = _leaf_name(p)
            shape = tuple(like.shape) if shards is None else \
                shards.whole_shape("/".join(p), like.shape)
            if name not in meta or tuple(meta[name]["shape"]) != shape:
                raise ValueError(f"checkpoint step {step}: leaf {name} is "
                                 f"{meta.get(name)}, the state's {shape}")
            dev = device if device is not None else getattr(
                like, "device", "cpu")
            leaf = _load_leaf(os.path.join(d, name + ".npy"),
                              meta[name]["dtype"], "cpu" if shards else dev)
            if shards is not None:
                leaf = shards.part("/".join(p), leaf).to(dev)
            leaves[name] = leaf
        return _rebuild(state_like, leaves), step
