"""Checkpointing in the reference's on-disk format (``checkpoint/store.py``),
so either package restores the other's checkpoints.

Format: one ``state-%08d.npz`` of full arrays, keyed by the flat ``/``
paths of the state tree with ``/`` spelled ``|``, and a ``.manifest`` in
msgpack holding the step and each leaf's shape and dtype. Both files are
written under a temporary name and moved into place with ``os.replace``;
the oldest checkpoints past ``keep`` are removed.

The manager stores nested dicts of tensors or numpy arrays. The trainer
passes the reference's tree (``train.step.state_tree``: parameters and
moments restacked by ``weights.to_jax_params``). ``restore`` returns
nested dicts of numpy arrays.

Elastic restore: the files hold whole arrays, whatever the number of
ranks that trained. Under a data-parallel mesh ``train.step.state_tree``
gathers the sharded state whole on every rank and rank 0 saves it;
``restore`` returns the whole tree on every rank, and
``train.step.load_state_tree`` takes each rank's shard of it. So a
checkpoint saved on 2 ranks restores on 1 and the reverse, and either
package restores the other's.

The manifest comes from ``packb`` below, a msgpack writer for the types the
manifest holds (maps, strings, non-negative integers, lists); its bytes
equal ``msgpack.packb``'s, and the port does not depend on msgpack.

A background save (``blocking=False``) copies every leaf to host numpy
before its thread starts: the trainer updates its tensors in place, so a
thread that read them later could write a half-updated state.
"""
from __future__ import annotations

import os
import re
import struct
import threading

import numpy as np
import torch


def packb(obj) -> bytes:
    """msgpack encoding of ``obj`` (dict / str / non-negative int / list or
    tuple), in ``msgpack.packb``'s default form: the shortest header for
    each length or value, dicts in insertion order."""
    out = bytearray()

    def head(n, fix, fix_max, codes):
        if n <= fix_max:
            out.append(fix | n)
            return
        for code, fmt in codes:
            if n < 1 << (8 * struct.calcsize(fmt)):
                out.append(code)
                out.extend(struct.pack(fmt, n))
                return
        raise ValueError(f"msgpack: length {n} too large")

    def put(x):
        if isinstance(x, bool) or not isinstance(x, (dict, str, int, list,
                                                     tuple)):
            raise TypeError(f"packb: unsupported type {type(x).__name__}")
        if isinstance(x, dict):
            head(len(x), 0x80, 15, ((0xDE, ">H"), (0xDF, ">I")))
            for k, v in x.items():
                put(k)
                put(v)
        elif isinstance(x, str):
            b = x.encode("utf-8")
            head(len(b), 0xA0, 31,
                 ((0xD9, ">B"), (0xDA, ">H"), (0xDB, ">I")))
            out.extend(b)
        elif isinstance(x, int):
            if x < 0:
                raise ValueError("packb: negative integers are not needed")
            head(x, 0x00, 127, ((0xCC, ">B"), (0xCD, ">H"), (0xCE, ">I"),
                                (0xCF, ">Q")))
        else:
            head(len(x), 0x90, 15, ((0xDC, ">H"), (0xDD, ">I")))
            for v in x:
                put(v)

    put(obj)
    return bytes(out)


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}/"))
    else:
        out[prefix[:-1]] = tree
    return out


def _unflatten(flat):
    tree: dict = {}
    for path, v in flat.items():
        node = tree
        parts = path.split("/")
        for p_ in parts[:-1]:
            node = node.setdefault(p_, {})
        node[parts[-1]] = v
    return tree


def _host_copy(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().to("cpu", copy=True).numpy()
    return np.array(v)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None

    # ------------------------------------------------------------- save ----
    def save(self, state: dict, step: int, *, blocking: bool = True):
        # host snapshot first: the caller may update the tensors in place
        arrays = {k: _host_copy(v) for k, v in _flatten(state).items()}

        def write():
            tmp = os.path.join(self.dir, f".tmp-{step}")
            np.savez(tmp + ".npz", **{k.replace("/", "|"): v
                                      for k, v in arrays.items()})
            manifest = {
                "step": step,
                "leaves": {k: {"shape": list(v.shape), "dtype": str(v.dtype)}
                           for k, v in arrays.items()},
            }
            with open(tmp + ".manifest", "wb") as f:
                f.write(packb(manifest))
            os.replace(tmp + ".npz", self._path(step) + ".npz")
            os.replace(tmp + ".manifest", self._path(step) + ".manifest")
            self._gc()

        if blocking:
            write()
        else:
            self.wait()
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _path(self, step: int) -> str:
        return os.path.join(self.dir, f"state-{step:08d}")

    def _gc(self):
        steps = self.steps()
        for s in steps[:-self.keep]:
            for ext in (".npz", ".manifest"):
                try:
                    os.remove(self._path(s) + ext)
                except FileNotFoundError:
                    pass

    # ---------------------------------------------------------- restore ----
    def steps(self):
        out = []
        for f in os.listdir(self.dir):
            m = re.match(r"state-(\d+)\.npz$", f)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self):
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, step: int) -> dict:
        """The state tree saved at ``step``, as nested dicts of numpy
        arrays."""
        with np.load(self._path(step) + ".npz") as z:
            flat = {k.replace("|", "/"): z[k] for k in z.files}
        return _unflatten(flat)
