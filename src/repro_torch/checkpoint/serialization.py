"""Checkpoint files in the JAX package's on-disk format (``sharded-v2``).

Format (one directory per checkpoint step), as the JAX package's
``checkpoint/serialization.py`` writes it:

    step_000000123/
      manifest.json     step, treedef, paths, per-leaf file / shape / dtype
                        / spec / bytes / sha256, meta, mesh_axes, format
      leaf_00000.npy    one file per leaf
      _COMMITTED        commit marker, written inside the tmp dir before
                        the rename that publishes it

The write order is the JAX package's: a tmp dir, the leaf files, the
manifest, ``_COMMITTED``, then ``os.replace`` of the tmp dir as the
single commit point, with fsyncs between, so a kill anywhere mid-save
leaves the old step or nothing visible.

The leaves are those of the JAX package's state for the same run, in its
flatten order and under its key paths (``jax.tree_util.keystr``), so a
checkpoint of either package lists the same leaves under the same names:

  * dicts flatten in sorted key order; the port's flat parameter dicts
    (``"blocks/attn/wq"``) are nested dicts in JAX (``['blocks']['attn']
    ['wq']``); tuples index (``[0]``), dataclasses and named tuples by
    field (``.leaves``), ``None`` is no leaf, fields marked ``static`` in
    their metadata (partition labels, sketch seeds) are none either;
  * the port's Python-int counters (steps, the telemetry snapshot's
    counters, a dynamic cadence) are the JAX package's int32 scalars, and
    its Python floats (the snapshot's ``did_refresh``) its float32
    scalars;
  * a leaf the JAX state stores and the port derives, declared on a
    static field as ``derived_leaf=(name, after, fn)``: the leaf ``name``,
    placed after field ``after``, is ``fn`` of the field's value.  So
    ``AdapproxState.key``, JAX's PRNG key, which the port replaced by its
    ``(seed, t, i)`` generators, is written as ``PRNGKey(seed)``'s two
    uint32 words and, on restore, checked against the port's seed;
  * bf16 leaves are 16-bit words with the manifest dtype ``"bfloat16"``
    and the ``.npy`` descr ``'<V2'`` that numpy and ml_dtypes give them,
    read and written here without ml_dtypes.

A save under a mesh writes each leaf's spec string, exactly
``str(PartitionSpec(...))`` as JAX writes it (``"PartitionSpec()"`` for a
replicated leaf), and the saving mesh's ``mesh_axes``; without a mesh
``spec`` is null and ``mesh_axes`` empty, as JAX writes single-device
arrays.  The files always hold the whole (logical) arrays, gathered from
the ranks' blocks, so restore is mesh-independent: it reads each leaf
onto the device (and dtype) of the matching leaf of the target structure,
and the caller places the result under any mesh's shardings, or none.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
from pathlib import Path
from typing import Any, Callable, Optional

import numpy as np
import torch


COMMIT_MARKER = "_COMMITTED"
FORMAT = "sharded-v2"


class CheckpointCorruptError(RuntimeError):
    """A checkpoint directory failed integrity verification."""


def _fsync_path(path: Path) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _sha256(path: Path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


# ---------------------------------------------------------------------------
# The port's state <-> the JAX package's leaf list
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _Derived:
    """A leaf of the JAX state that the port derives instead of storing."""
    value: np.ndarray


def _dict_path(key: str) -> str:
    return "".join(f"[{part!r}]" for part in key.split("/"))


def _map(node, path: str, fn: Callable, is_leaf: Optional[Callable] = None):
    """Rebuild ``node`` with every leaf replaced by ``fn(path, leaf)``, in
    the JAX package's flatten order (see the module docstring); a leaf is
    a tensor, a Python int or float, anything ``is_leaf`` accepts, or a
    :class:`_Derived`, whose result is dropped."""
    if node is None:
        return None
    if isinstance(node, (torch.Tensor, float)) or (
            isinstance(node, int) and not isinstance(node, bool)) or (
            is_leaf is not None and is_leaf(node)):
        return fn(path, node)
    if isinstance(node, dict):
        out = {}
        for key in sorted(node, key=lambda k: str(k).split("/")):
            out[key] = _map(node[key], path + _dict_path(str(key)), fn,
                            is_leaf)
        return {key: out[key] for key in node}
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return type(node)(*(_map(getattr(node, f), f"{path}.{f}", fn,
                                 is_leaf) for f in node._fields))
    if isinstance(node, (tuple, list)):
        return type(node)(_map(x, f"{path}[{i}]", fn, is_leaf)
                          for i, x in enumerate(node))
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        fields = dataclasses.fields(node)
        derived = [(f, f.metadata["derived_leaf"]) for f in fields
                   if "derived_leaf" in f.metadata]
        new = {}
        for f in fields:
            if f.metadata.get("static"):
                continue
            new[f.name] = _map(getattr(node, f.name), f"{path}.{f.name}",
                               fn, is_leaf)
            for src, (name, after, derive) in derived:
                if after == f.name:
                    fn(f"{path}.{name}",
                       _Derived(derive(getattr(node, src.name))))
        return dataclasses.replace(node, **new)
    raise TypeError(f"{path}: no checkpoint layout for "
                    f"{type(node).__name__}")


def spec_leaves(shardings) -> list[tuple[str, Any]]:
    """``[(JAX key path, sharding)]`` of a tree of shardings that mirrors
    a state (``distributed.sharding.NamedSharding`` or spec leaves where
    the state has its leaves), in flatten order; a leaf the port derives
    (the PRNG key) is replicated, ``None`` in the list."""
    out = []

    def take(path, leaf):
        out.append((path, None if isinstance(leaf, _Derived) else leaf))
        return leaf

    _map(shardings, "", take, is_leaf=lambda n: hasattr(n, "spec") or (
        isinstance(n, tuple) and type(n).__name__ == "PartitionSpec"))
    return out


def leaf_spec_meta(shardings) -> tuple[list, dict]:
    """Per-leaf spec strings and the saving mesh's axis sizes, as the JAX
    package's ``leaf_spec_meta`` writes them for arrays placed by
    ``shardings`` (every leaf of a mesh run has a spec, ``"PartitionSpec()"``
    when replicated)."""
    specs, mesh_axes = [], {}
    for _, sh in spec_leaves(shardings):
        spec = getattr(sh, "spec", sh)
        specs.append(str(spec) if spec is not None else "PartitionSpec()")
        mesh = getattr(sh, "mesh", None)
        if mesh is not None and not mesh_axes:
            mesh_axes = {str(n): int(mesh.size(i))
                         for i, n in enumerate(mesh.mesh_dim_names)}
    return specs, mesh_axes


def leaves_with_paths(tree) -> list[tuple[str, Any]]:
    """``[(JAX key path, leaf)]`` of ``tree`` in flatten order; a leaf is a
    tensor, a Python int or float, or (the PRNG key) a numpy array the
    port derives."""
    out = []

    def take(path, leaf):
        out.append((path, getattr(leaf, "value", leaf)
                    if isinstance(leaf, _Derived) else leaf))
        return leaf

    _map(tree, "", take)
    return out



def _host_array(leaf) -> tuple[np.ndarray, str]:
    """A host copy of one leaf and its manifest dtype name."""
    if isinstance(leaf, _Derived):
        return leaf.value, str(leaf.value.dtype)
    if isinstance(leaf, int):
        return np.asarray(leaf, np.int32), "int32"
    if isinstance(leaf, float):
        return np.asarray(leaf, np.float32), "float32"
    if hasattr(leaf, "full_tensor"):     # a DTensor: its whole tensor
        leaf = leaf.full_tensor()
    t = leaf.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def host_leaves(tree) -> list[tuple[str, np.ndarray, str]]:
    """``[(path, host array, dtype name)]`` for every leaf of ``tree``:
    the synchronous device-to-host copy of a save.  The arrays are copies,
    so the caller may update the tensors in place as soon as it returns.
    A DTensor leaf is gathered whole, a collective: every rank of its
    mesh calls this together."""
    out = []

    def take(path, leaf):
        out.append((path, *_host_array(leaf)))
        return leaf

    _map(tree, "", take)
    return out


def describe(tree) -> str:
    """The ``treedef`` string of a manifest: the port's structure, each
    leaf ``*``.  Informational: restore matches leaves by ``paths``."""
    if tree is None:
        return "None"
    if isinstance(tree, (torch.Tensor, int, float)):
        return "*"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {describe(v)}"
                               for k, v in tree.items()) + "}"
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return (type(tree).__name__ + "("
                + ", ".join(describe(getattr(tree, f)) for f in tree._fields)
                + ")")
    if isinstance(tree, (tuple, list)):
        return "(" + ", ".join(describe(x) for x in tree) + ")"
    fields = [f for f in dataclasses.fields(tree)
              if not f.metadata.get("static")]
    return (type(tree).__name__ + "["
            + ", ".join(describe(getattr(tree, f.name)) for f in fields)
            + "]")


def _save_npy(path: Path, arr: np.ndarray, dtype: str) -> None:
    if dtype != "bfloat16":
        np.save(path, arr)
        return
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": "<V2", "fortran_order": False,
                "shape": tuple(arr.shape)})
        f.write(np.ascontiguousarray(arr).tobytes())


def _load_npy(path: Path, dtype: str) -> np.ndarray:
    arr = np.load(path)
    if dtype == "bfloat16":
        arr = arr.view(np.int16)       # |V2 (or 16-bit ints): the bf16 bits
    return arr


def write_checkpoint(host: list, directory: "str | Path", step: int,
                     extra_meta: Optional[dict] = None,
                     treedef: str = "", leaf_specs: Optional[list] = None,
                     mesh_axes: Optional[dict] = None) -> Path:
    """Write host leaves (:func:`host_leaves`) atomically: tmp dir ->
    files -> manifest -> commit marker -> rename (the commit point).
    ``leaf_specs`` / ``mesh_axes`` (:func:`leaf_spec_meta`) record how
    each leaf was placed when saved: metadata only, the files hold the
    whole arrays."""
    if leaf_specs is not None and len(leaf_specs) != len(host):
        raise ValueError(f"leaf_specs has {len(leaf_specs)} entries for "
                         f"{len(host)} leaves")
    directory = Path(directory)
    final = directory / f"step_{step:09d}"
    tmp = directory / f".tmp_step_{step:09d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    manifest = {
        "step": step,
        "treedef": treedef,
        "paths": [path for path, _, _ in host],
        "leaves": [],
        "meta": extra_meta or {},
        "mesh_axes": mesh_axes or {},
        "format": FORMAT,
    }
    for i, (_, arr, dtype) in enumerate(host):
        fname = f"leaf_{i:05d}.npy"
        _save_npy(tmp / fname, arr, dtype)
        manifest["leaves"].append({
            "file": fname, "shape": list(arr.shape), "dtype": dtype,
            "spec": leaf_specs[i] if leaf_specs is not None else None,
            "bytes": os.path.getsize(tmp / fname),
            "sha256": _sha256(tmp / fname),
        })
        _fsync_path(tmp / fname)
    mpath = tmp / "manifest.json"
    mpath.write_text(json.dumps(manifest, indent=1))
    _fsync_path(mpath)
    # the marker goes into the tmp dir BEFORE the rename: the rename is the
    # single commit point
    (tmp / COMMIT_MARKER).touch()
    _fsync_path(tmp)

    if final.exists():
        shutil.rmtree(final)
    os.replace(tmp, final)                   # commit point
    _fsync_path(directory)
    return final


def save_pytree(tree: Any, directory: "str | Path", step: int,
                extra_meta: Optional[dict] = None,
                shardings: Any = None) -> Path:
    """Copy ``tree`` to the host and write it (:func:`write_checkpoint`),
    with the spec of each leaf under ``shardings`` (a tree of the same
    structure, e.g. ``distributed.sharding.train_shardings``'s)."""
    specs, axes = (leaf_spec_meta(shardings) if shardings is not None
                   else (None, None))
    return write_checkpoint(host_leaves(tree), directory, step, extra_meta,
                            describe(tree), specs, axes)


def is_committed(ckpt_dir: "str | Path") -> bool:
    return (Path(ckpt_dir) / COMMIT_MARKER).exists()


def verify_checkpoint(ckpt_dir: "str | Path", deep: bool = False) -> bool:
    """Integrity check for one step directory.  Structural (always): the
    commit marker, a manifest that parses, every leaf file with the byte
    size the manifest recorded.  ``deep=True`` also re-hashes every leaf
    file against the manifest's sha256 (catches bit flips that keep the
    sizes)."""
    ckpt_dir = Path(ckpt_dir)
    if not is_committed(ckpt_dir):
        return False
    try:
        manifest = json.loads((ckpt_dir / "manifest.json").read_text())
    except (OSError, json.JSONDecodeError):
        return False
    for entry in manifest.get("leaves", []):
        fpath = ckpt_dir / entry["file"]
        if not fpath.exists():
            return False
        want = entry.get("bytes")
        if want is not None and os.path.getsize(fpath) != want:
            return False
        if deep:
            digest = entry.get("sha256")
            if digest is not None and _sha256(fpath) != digest:
                return False
    return True


def list_checkpoints(directory: "str | Path") -> list[Path]:
    """Committed, structurally valid step dirs, oldest first; incomplete
    or manifest-less directories are skipped, not raised on."""
    directory = Path(directory)
    if not directory.exists():
        return []
    return [p for p in sorted(directory.glob("step_*"))
            if p.is_dir() and verify_checkpoint(p)]


def latest_checkpoint(directory: "str | Path") -> Optional[Path]:
    cks = list_checkpoints(directory)
    return cks[-1] if cks else None


def _torch_dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def restore_pytree(ckpt_dir: "str | Path", like: Any,
                   verify: bool = True) -> Any:
    """Restore into the structure of ``like`` (a port ``TrainState`` or any
    tree :func:`leaves_with_paths` walks): each leaf on the device, and
    with the dtype, of ``like``'s leaf at the same path.  The checkpoint's
    paths, shapes and dtypes must match ``like``'s exactly (one written by the
    JAX package for the same run does), and a derived leaf (the PRNG key)
    must equal what the port derives.  ``verify=True`` deep-verifies the
    checksums first and raises :class:`CheckpointCorruptError` on a
    mismatch.  The arrays are read with numpy alone."""
    ckpt_dir = Path(ckpt_dir)
    if verify:
        if not verify_checkpoint(ckpt_dir, deep=True):
            raise CheckpointCorruptError(
                f"checkpoint failed integrity verification: {ckpt_dir}")
    elif not is_committed(ckpt_dir):
        raise CheckpointCorruptError(f"uncommitted checkpoint: {ckpt_dir}")
    manifest = json.loads((ckpt_dir / "manifest.json").read_text())
    entries = iter(zip(manifest["paths"], manifest["leaves"]))
    n_like = len(leaves_with_paths(like))
    if n_like != len(manifest["leaves"]):
        raise ValueError(
            f"checkpoint has {len(manifest['leaves'])} leaves, target "
            f"structure has {n_like}: structures diverged")

    def take(path, leaf):
        saved_path, entry = next(entries)
        if saved_path != path:
            raise ValueError(f"leaf {entry['file']}: checkpoint path "
                             f"{saved_path} vs target {path}")
        arr = _load_npy(ckpt_dir / entry["file"], entry["dtype"])
        want = (tuple(leaf.shape) if isinstance(leaf, torch.Tensor)
                else tuple(np.shape(getattr(leaf, "value", leaf))))
        if tuple(arr.shape) != want:
            raise ValueError(f"{path}: shape {arr.shape} in the checkpoint "
                             f"vs {want}")
        if isinstance(leaf, _Derived):
            if not np.array_equal(arr, leaf.value):
                raise ValueError(f"{path}: {arr.tolist()} in the checkpoint, "
                                 f"but the port derives "
                                 f"{leaf.value.tolist()}")
            return leaf
        if isinstance(leaf, (int, float)):
            want_dtype = "float32" if isinstance(leaf, float) else "int32"
            if entry["dtype"] != want_dtype:
                raise ValueError(f"{path}: dtype {entry['dtype']}, expected "
                                 f"{want_dtype}")
            return type(leaf)(arr)
        if entry["dtype"] != _torch_dtype_name(leaf):
            raise ValueError(f"{path}: dtype {entry['dtype']} in the "
                             f"checkpoint vs {_torch_dtype_name(leaf)}")
        t = torch.from_numpy(arr if arr.flags.c_contiguous else arr.copy())
        if leaf.dtype == torch.bfloat16:
            t = t.view(torch.bfloat16)
        return t.to(leaf.device).requires_grad_(leaf.requires_grad)

    return _map(like, "", take)


def checkpoint_step(ckpt_dir: "str | Path") -> int:
    manifest = json.loads((Path(ckpt_dir) / "manifest.json").read_text())
    return int(manifest["step"])


def read_meta(ckpt_dir: "str | Path") -> dict:
    """The ``extra_meta`` dict recorded in the manifest (empty if none)."""
    manifest = json.loads((Path(ckpt_dir) / "manifest.json").read_text())
    return dict(manifest.get("meta") or {})
