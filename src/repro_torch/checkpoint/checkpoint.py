"""Fault-tolerant tree checkpointing (the port of
`repro/checkpoint/checkpoint.py`): msgpack, atomic rename, a manifest with
an integrity hash, restore-latest, an async save thread.

The file format is the JAX package's, so each package reads the other's
checkpoints: a msgpack list of {"dtype", "shape", "data"} (raw bytes,
bf16 as its uint16 bits) in JAX's leaf order, which is the leaf order of
the tree in the JAX layout (`convert.stack_blocks`: every "blocks" list
of layers stacked; dict keys sorted), compressed. The port carries its own
msgpack (`msgpack_lite`) and writes zlib streams; the reader sniffs the
frame magic as the JAX one does, and reads zstd only where `zstandard`
imports. The port writes deflate's stored blocks (zlib level 0): float32
weights barely shrink at levels 1-6, which run far slower than a copy
(benchmarks/torch_checkpoint_io.py measures both on the host).

Minibatch-prox makes checkpointing cheap: training state is (params,
anchor/opt, step) ONLY — minibatches are redrawn from the seeded stream,
so no data-pipeline state needs recovery.
"""
from __future__ import annotations

import hashlib
import json
import os
import threading
import time
import zlib

import numpy as np
import torch

from repro_torch.checkpoint import msgpack_lite
from repro_torch.convert import stack_blocks, unstack_blocks
from repro_torch.tree import tree_map

_ZSTD_MAGIC = b"\x28\xb5\x2f\xfd"
ZLIB_LEVEL = 0

# numpy dtype names of the format <-> torch dtypes
_DTYPES = {"float32": torch.float32, "float64": torch.float64,
           "float16": torch.float16, "bfloat16": torch.bfloat16,
           "int8": torch.int8, "uint8": torch.uint8, "int16": torch.int16,
           "int32": torch.int32, "int64": torch.int64, "bool": torch.bool}
_NAMES = {v: k for k, v in _DTYPES.items()}


def _decompress(blob: bytes) -> bytes:
    # sniff the frame magic so checkpoints stay readable across installs
    if blob[:4] == _ZSTD_MAGIC:
        try:
            import zstandard
        except ImportError:
            raise RuntimeError("checkpoint is zstd-compressed but the "
                               "'zstandard' package is not installed")
        return zstandard.ZstdDecompressor().decompress(blob)
    return zlib.decompress(blob)


def _jax_leaves(tree):
    """The leaves of a tree in the JAX layout, in JAX's order: dict keys
    sorted, lists and tuples in order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _jax_leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _jax_leaves(v)
    elif tree is not None:
        yield tree


def _fill_jax(like, leaves):
    """`like` (JAX layout) with its leaves replaced, in JAX's order."""
    if isinstance(like, dict):
        return {k: _fill_jax(like[k], leaves) for k in sorted(like)}
    if isinstance(like, (list, tuple)):
        return [_fill_jax(v, leaves) for v in like]
    return None if like is None else next(leaves)


def _payload(leaves) -> list:
    payload = []
    for leaf in leaves:
        t = torch.as_tensor(leaf).detach().cpu().contiguous()
        # bf16 has no numpy dtype string; its bits as uint16
        data = (t.view(torch.int16) if t.dtype == torch.bfloat16
                else t).numpy().tobytes()
        payload.append({"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data": data})
    return payload


def _encode(leaves) -> bytes:
    return zlib.compress(msgpack_lite.packb(_payload(leaves)), ZLIB_LEVEL)


def _decode(blob: bytes):
    leaves = []
    for item in msgpack_lite.unpackb(_decompress(blob)):
        dt = _DTYPES[item["dtype"]]
        raw = np.frombuffer(item["data"], np.uint16 if dt == torch.bfloat16
                            else np.dtype(item["dtype"]))
        t = torch.from_numpy(raw.copy()).reshape(item["shape"])
        leaves.append(t.view(torch.bfloat16) if dt == torch.bfloat16 else t)
    return leaves


def save(ckpt_dir: str, step: int, tree, *, keep: int = 3) -> str:
    """Atomic checkpoint write; returns the final path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    jtree = stack_blocks(tree)
    blob = _encode(_jax_leaves(jtree))
    digest = hashlib.sha256(blob).hexdigest()
    name = f"ckpt_{step:010d}"
    tmp = os.path.join(ckpt_dir, name + ".tmp")
    final = os.path.join(ckpt_dir, name + ".ckpt")
    with open(tmp, "wb") as f:
        f.write(blob)
        f.flush()
        os.fsync(f.fileno())
    os.rename(tmp, final)  # atomic on POSIX
    manifest = {"step": step, "sha256": digest, "time": time.time(),
                "treedef": _structure(jtree), "file": name + ".ckpt"}
    mtmp = os.path.join(ckpt_dir, "manifest.tmp")
    with open(mtmp, "w") as f:
        json.dump(manifest, f)
    os.rename(mtmp, os.path.join(ckpt_dir, "manifest.json"))
    _gc(ckpt_dir, keep)
    return final


def _structure(tree) -> str:
    """A readable outline of the tree (the manifest's "treedef"; neither
    reader uses it)."""
    return str(tree_map(lambda t: "*", tree))


def _gc(ckpt_dir: str, keep: int):
    ckpts = sorted(f for f in os.listdir(ckpt_dir) if f.endswith(".ckpt"))
    for f in ckpts[:-keep]:
        try:
            os.remove(os.path.join(ckpt_dir, f))
        except OSError:
            pass


def latest_step(ckpt_dir: str) -> int | None:
    path = os.path.join(ckpt_dir, "manifest.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)["step"]


def restore(ckpt_dir: str, tree_like):
    """Restore the latest checkpoint into the structure of `tree_like` (a
    port tree), each leaf on the device of its `tree_like` leaf. Verifies
    the manifest hash. Returns (tree, step) or (None, None)."""
    path = os.path.join(ckpt_dir, "manifest.json")
    if not os.path.exists(path):
        return None, None
    with open(path) as f:
        manifest = json.load(f)
    blob_path = os.path.join(ckpt_dir, manifest["file"])
    with open(blob_path, "rb") as f:
        blob = f.read()
    if hashlib.sha256(blob).hexdigest() != manifest["sha256"]:
        raise IOError(f"checkpoint {blob_path} failed integrity check")
    leaves = _decode(blob)
    jlike = stack_blocks(tree_like)
    n = sum(1 for _ in _jax_leaves(jlike))
    if n != len(leaves):
        raise ValueError(f"checkpoint {blob_path} holds {len(leaves)} "
                         f"leaves, the tree to restore into {n}")
    tree = unstack_blocks(_fill_jax(jlike, iter(leaves)), tree_like)
    return _like(tree, tree_like), manifest["step"]


def _like(tree, like):
    """`tree` in the key order of `like` (JAX's layout sorts dict keys),
    each leaf on the device of its `like` leaf."""
    if isinstance(like, dict):
        return {k: _like(tree[k], v) for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return [_like(t, v) for t, v in zip(tree, like)]
    return tree.to(like.device)


class AsyncCheckpointer:
    """Overlaps checkpoint serialization with training (one in flight)."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread = None

    def save(self, step: int, tree):
        self.wait()
        # copy to the host before handing to the thread (training goes on
        # updating the device tensors)
        host_tree = tree_map(lambda t: t.detach().to("cpu", copy=True), tree)
        self._thread = threading.Thread(
            target=save, args=(self.ckpt_dir, step, host_tree),
            kwargs={"keep": self.keep}, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
