"""Atomic, digest-verified checkpointing (port of
``repro.train.checkpoint``), in the reference's on-disk format.

Layout: ``<dir>/step_<N>/`` holding ``arrays.npz`` (the tree's leaves as
``a0``, ``a1``, ... in the reference's leaf order: dict keys sorted) and
``meta.msgpack`` (the leaves' path strings such as
``['params']/['embed']/['table']``, the step, user metadata and a sha256
digest over the arrays).  Writes go to ``<dir>/.tmp_step_<N>`` and are
``os.rename``d into place, so a crashed writer never leaves a
half-checkpoint that restore would read.  ``restore_latest`` walks the
checkpoints newest-first and skips any that fail verification.

A checkpoint written by either package restores in the other with the
same digest.  Two details make that so:

  * ``meta.msgpack`` is written and read by a small encoder of its own
    (``packb`` / ``unpackb``) that covers what the meta holds (map,
    array, str, int, nil, bool) and gives the bytes ``msgpack.packb``
    gives; the port does not depend on ``msgpack``.
  * A bfloat16 leaf is stored as the reference stores it: numpy has no
    bfloat16, and ``np.asarray`` of a JAX bf16 array saves as void
    ``|V2`` of the same bytes.  On restore a leaf takes the template
    leaf's dtype and device, so a ``|V2`` leaf under a bfloat16 template
    comes back as a ``torch.bfloat16`` tensor.  The reference hands the
    ``|V2`` array back as it is, which JAX cannot take (ROADMAP queue C,
    C11).
"""

from __future__ import annotations

import hashlib
import os
import shutil
import struct
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.device import to_tensor

# --------------------------------------------------------------------------
# the msgpack subset of meta.msgpack
# --------------------------------------------------------------------------


def packb(obj) -> bytes:
    """``obj`` (dicts, lists / tuples, str, int, None, bool) in msgpack,
    byte for byte as ``msgpack.packb(obj)`` writes it (its defaults: str
    as the str family, the shortest int form)."""
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


def _header(out: bytearray, n: int, fix_base: int, fix_max: int,
            codes: tuple[tuple[int, int, str], ...]) -> None:
    if n <= fix_max:
        out.append(fix_base | n)
        return
    for limit, code, fmt in codes:
        if n <= limit:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"msgpack object too large: {n}")


def _pack(obj, out: bytearray) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True or obj is False:
        out.append(0xC3 if obj else 0xC2)
    elif isinstance(obj, int):
        _pack_int(int(obj), out)
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        _header(out, len(raw), 0xA0, 31, ((0xFF, 0xD9, ">B"),
                                          (0xFFFF, 0xDA, ">H"),
                                          (0xFFFFFFFF, 0xDB, ">I")))
        out += raw
    elif isinstance(obj, (list, tuple)):
        _header(out, len(obj), 0x90, 15, ((0xFFFF, 0xDC, ">H"),
                                          (0xFFFFFFFF, 0xDD, ">I")))
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        _header(out, len(obj), 0x80, 15, ((0xFFFF, 0xDE, ">H"),
                                          (0xFFFFFFFF, 0xDF, ">I")))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"meta.msgpack holds maps, arrays, str, int, nil "
                        f"and bool; got {type(obj).__name__}")


def _pack_int(n: int, out: bytearray) -> None:
    if 0 <= n < 0x80 or -32 <= n < 0:
        out += struct.pack(">b" if n < 0 else ">B", n)
        return
    forms = (((0xFF, 0xCC, ">B"), (0xFFFF, 0xCD, ">H"),
              (0xFFFFFFFF, 0xCE, ">I"), (2**64 - 1, 0xCF, ">Q"))
             if n >= 0 else
             ((-2**7, 0xD0, ">b"), (-2**15, 0xD1, ">h"),
              (-2**31, 0xD2, ">i"), (-2**63, 0xD3, ">q")))
    for limit, code, fmt in forms:
        if (n <= limit) if n >= 0 else (n >= limit):
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise OverflowError(f"int {n} does not fit msgpack's 64 bits")


def unpackb(data: bytes):
    """The object ``packb`` (or ``msgpack.packb``) wrote: maps as dicts,
    arrays as lists, str decoded.  Raises ``ValueError`` on any other
    type or on trailing bytes."""
    obj, end = _unpack(memoryview(data), 0)
    if end != len(data):
        raise ValueError(f"{len(data) - end} bytes after the msgpack object")
    return obj


_INTS = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
         0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
_LENS = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I", 0xDC: ">H", 0xDD: ">I",
         0xDE: ">H", 0xDF: ">I"}


def _unpack(buf: memoryview, i: int):
    b = buf[i]
    i += 1
    if b < 0x80:
        return b, i
    if b >= 0xE0:
        return b - 0x100, i
    if b == 0xC0:
        return None, i
    if b in (0xC2, 0xC3):
        return b == 0xC3, i
    if b in _INTS:
        fmt = _INTS[b]
        return struct.unpack_from(fmt, buf, i)[0], i + struct.calcsize(fmt)
    if 0xA0 <= b <= 0xBF or b in (0xD9, 0xDA, 0xDB):
        n, i = _length(buf, i, b, 0xA0)
        return bytes(buf[i:i + n]).decode("utf-8"), i + n
    if 0x90 <= b <= 0x9F or b in (0xDC, 0xDD):
        n, i = _length(buf, i, b, 0x90)
        out = []
        for _ in range(n):
            v, i = _unpack(buf, i)
            out.append(v)
        return out, i
    if 0x80 <= b <= 0x8F or b in (0xDE, 0xDF):
        n, i = _length(buf, i, b, 0x80)
        out = {}
        for _ in range(n):
            k, i = _unpack(buf, i)
            out[k], i = _unpack(buf, i)
        return out, i
    raise ValueError(f"msgpack type byte {b:#04x} is outside the meta's "
                     "subset (map, array, str, int, nil, bool)")


def _length(buf: memoryview, i: int, b: int, fix_base: int):
    if b in _LENS:
        fmt = _LENS[b]
        return struct.unpack_from(fmt, buf, i)[0], i + struct.calcsize(fmt)
    return b - fix_base, i


# --------------------------------------------------------------------------
# trees
# --------------------------------------------------------------------------

def _flatten_with_paths(tree, prefix: str = ""):
    """(paths, leaves) in the reference's order: dict keys sorted, lists
    and tuples in order, None an empty subtree; paths as ``jax.tree_util``
    prints them (``['key']``, ``[i]``) joined with "/"."""
    if tree is None:
        return [], []
    if isinstance(tree, dict):
        items = [(f"['{k}']", tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(f"[{i}]", v) for i, v in enumerate(tree)]
    else:
        return [prefix], [tree]
    paths, leaves = [], []
    for name, sub in items:
        p, l = _flatten_with_paths(sub, f"{prefix}/{name}" if prefix
                                   else name)
        paths += p
        leaves += l
    return paths, leaves


def _unflatten(template, leaves: list):
    """``template``'s structure with its leaves taken in order from
    ``leaves`` (consumed)."""
    if template is None:
        return None
    if isinstance(template, dict):
        return {k: _unflatten(template[k], leaves) for k in sorted(template)}
    if isinstance(template, (list, tuple)):
        return type(template)(_unflatten(v, leaves) for v in template)
    return leaves.pop(0)


def _to_numpy(leaf) -> np.ndarray:
    """A leaf as the reference saves it; bfloat16 as void ``|V2``."""
    if torch.is_tensor(leaf):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.dtype("V2"))
        return t.numpy()
    return np.asarray(leaf)


def _to_leaf(a: np.ndarray, template):
    """The saved array ``a`` as the template leaf's kind: a tensor of its
    dtype on its device (a ``|V2`` array as bfloat16 bits); numpy for a
    template that is not a tensor."""
    if not torch.is_tensor(template):
        return a
    if template.dtype == torch.bfloat16:
        if a.dtype.itemsize != 2:
            raise IOError(f"a bfloat16 leaf holds {a.dtype} data")
        bits = to_tensor(np.ascontiguousarray(a).view(np.int16))
        t = bits.view(torch.bfloat16)
    else:
        t = to_tensor(a)
    t = t.reshape(a.shape)       # ascontiguousarray makes a 0-dim array 1-dim
    if t.dtype != template.dtype:
        raise IOError(f"a {template.dtype} leaf holds {a.dtype} data")
    if tuple(t.shape) != tuple(template.shape):
        raise IOError(f"a leaf of shape {tuple(template.shape)} holds "
                      f"{tuple(t.shape)}")
    return t.to(template.device)


def _digest(arrays: dict[str, np.ndarray]) -> str:
    h = hashlib.sha256()
    for k in sorted(arrays):
        h.update(k.encode())
        h.update(np.ascontiguousarray(arrays[k]).tobytes())
    return h.hexdigest()


# --------------------------------------------------------------------------
# save / restore
# --------------------------------------------------------------------------

def save(directory: str, step: int, tree: Any,
         metadata: Optional[dict] = None) -> str:
    """Atomically write a checkpoint; returns its final path."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:010d}")
    tmp = os.path.join(directory, f".tmp_step_{step:010d}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    paths, leaves = _flatten_with_paths(tree)
    arrays = {f"a{i}": _to_numpy(leaf) for i, leaf in enumerate(leaves)}
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    meta = {
        "step": step,
        "paths": paths,
        "digest": _digest(arrays),
        "user": metadata or {},
    }
    with open(os.path.join(tmp, "meta.msgpack"), "wb") as f:
        f.write(packb(meta))

    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def _load_one(path: str, tree_template: Any):
    with open(os.path.join(path, "meta.msgpack"), "rb") as f:
        meta = unpackb(f.read())
    with np.load(os.path.join(path, "arrays.npz")) as z:
        arrays = {k: z[k] for k in z.files}
    if _digest(arrays) != meta["digest"]:
        raise IOError(f"digest mismatch in {path}")
    _paths, templates = _flatten_with_paths(tree_template)
    if len(arrays) != len(templates):
        raise IOError(f"{path} holds {len(arrays)} leaves, the template "
                      f"{len(templates)}")
    leaves = [_to_leaf(arrays[f"a{i}"], t) for i, t in enumerate(templates)]
    return _unflatten(tree_template, leaves), meta


def list_steps(directory: str) -> list[int]:
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        if name.startswith("step_"):
            out.append(int(name.split("_")[1]))
    return sorted(out)


def restore_latest(directory: str, tree_template: Any):
    """(tree, meta) from the newest verifiable checkpoint, or (None, None).

    Corrupt checkpoints are skipped (with a warning): restart resilience.
    """
    for step in reversed(list_steps(directory)):
        path = os.path.join(directory, f"step_{step:010d}")
        try:
            return _load_one(path, tree_template)
        except Exception as e:  # noqa: BLE001 (any corruption -> try older)
            print(f"[checkpoint] skipping corrupt {path}: {e}")
    return None, None


def retain(directory: str, keep: int = 3) -> None:
    """Delete all but the newest ``keep`` checkpoints."""
    steps = list_steps(directory)
    for step in steps[:-keep]:
        shutil.rmtree(os.path.join(directory, f"step_{step:010d}"),
                      ignore_errors=True)
