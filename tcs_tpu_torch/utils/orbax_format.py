"""``tcs_tpu``'s Orbax checkpoints, read and written without Orbax.

``tcs_tpu`` keeps its weights and its training state with Orbax
(``tcs_tpu/utils/checkpoint.py``): ``save_params`` writes an export
directory, ``CheckpointManager.save`` a step directory ``<dir>/<step>/`` whose
item is ``<dir>/<step>/default/``. Such an item directory holds:

- ``_METADATA``: JSON; ``tree_metadata`` maps each leaf's path, a tuple
  written as a string (``"('opt_state', '1', '0', 'count')"``), to its key
  types (2 a dict key, 1 a position in a tuple) and its value's type and
  shape; beside it ``use_ocdbt``, ``use_zarr3`` and
  ``store_array_data_equal_to_fill_value``;
- ``_sharding`` and ``array_metadatas/process_<n>``: each array's sharding,
  write shape and chunk shape;
- the arrays, in zarr v2 under the leaf's path joined with dots
  (``params.params.cnet.conv1.Conv_0.kernel/.zarray`` and its chunks
  ``.../0.0.0.0``): with ``use_ocdbt`` as keys of an OCDBT store
  (:mod:`tcs_tpu_torch.utils.ocdbt`), else as files in a directory per array.

:func:`read_tree` gives an item's tree as nested dicts (tuple positions as
the keys ``'0'``, ``'1'``, ...) of CPU tensors, each in its stored dtype
(``bfloat16`` included); an empty optimiser state (optax's ``EmptyState``)
is ``None``. Zarr v2 is read in full: the dtypes ``<f4``, ``<f2``,
``bfloat16``, ``<i4``, ``<i8`` and ``|b1``, order ``C`` or ``F``, chunks
uncompressed or zstd (:mod:`tcs_tpu_torch.utils.zstd`), the dimension
separator, missing chunks as the fill value, and an array in several chunks
(as a sharded array is written) assembled whole. What is not in that list —
zarr3 (``use_zarr3``), another compressor, filters, a value type other than
an array, a scalar or an empty node — raises :class:`UnsupportedCheckpoint`
(a ``NotImplementedError``) that names it.

:func:`save_tree` writes an item directory that ``tcs_tpu`` reads: the layout
without OCDBT, each array one uncompressed chunk, with the metadata files as
Orbax writes them. :func:`step_dirs` lists a ``CheckpointManager``
directory's committed steps.
"""

from __future__ import annotations

import ast
import base64
import hashlib
import json
import math
import os
import re
import shutil
import time
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from tcs_tpu_torch.utils import ocdbt, zstd

PathLike = Union[str, os.PathLike]

_DTYPES = {"<f4": torch.float32, "<f2": torch.float16, "bfloat16": torch.bfloat16,
           "<i4": torch.int32, "<i8": torch.int64, "|b1": torch.bool}
_NAMES = {v: k for k, v in _DTYPES.items()}
_STEP = re.compile(r"^\d+$")
_TMP = ".orbax-checkpoint-tmp-"
DICT_KEY, SEQUENCE_KEY = 2, 1


class UnsupportedCheckpoint(NotImplementedError):
    """An Orbax checkpoint this reader does not read, named."""


class CorruptCheckpoint(IOError):
    """A zarr chunk whose bytes do not fill its array's chunk."""


def step_dirs(directory: PathLike) -> Dict[int, str]:
    """step → path of each committed step directory of an Orbax
    ``CheckpointManager`` directory; uncommitted ones
    (``<step>.orbax-checkpoint-tmp-<n>``) are skipped, as Orbax skips them."""
    directory = os.fspath(directory)
    if not os.path.isdir(directory):
        return {}
    return {int(name): os.path.join(directory, name) for name in os.listdir(directory)
            if _STEP.match(name) and _TMP not in name
            and os.path.isdir(os.path.join(directory, name))}


def item_dir(path: PathLike) -> str:
    """The directory holding ``_METADATA``: ``path`` itself (a
    ``save_params`` export) or its ``default`` item (a manager's step)."""
    path = os.fspath(path)
    for candidate in (path, os.path.join(path, "default")):
        if os.path.isfile(os.path.join(candidate, "_METADATA")):
            return candidate
    raise FileNotFoundError(f"no Orbax checkpoint in {path} (no _METADATA)")


def is_orbax_dir(path: PathLike) -> bool:
    """Whether ``path`` is an Orbax item or step directory."""
    try:
        item_dir(path)
        return True
    except FileNotFoundError:
        return False


# ------------------------------------------------------------------ reading

class _Files:
    """Zarr keys as files under a directory (the layout without OCDBT)."""

    def __init__(self, directory: str):
        self.directory = directory

    def get(self, key: str) -> Optional[bytes]:
        path = os.path.join(self.directory, *key.split("/"))
        if not os.path.isfile(path):
            return None
        with open(path, "rb") as f:
            return f.read()


class _Ocdbt:
    """Zarr keys in the item's OCDBT store: the root manifest's, or where
    there is none, each process's store (``ocdbt.process_<n>/``)."""

    def __init__(self, directory: str):
        if os.path.isfile(os.path.join(directory, "manifest.ocdbt")):
            self.stores = [ocdbt.OcdbtStore(directory)]
        else:
            subs = sorted(d for d in os.listdir(directory) if d.startswith("ocdbt.process_"))
            if not subs:
                raise FileNotFoundError(f"{directory}: use_ocdbt is set but there is no "
                                        "manifest.ocdbt")
            self.stores = [ocdbt.OcdbtStore(os.path.join(directory, d)) for d in subs]

    def get(self, key: str) -> Optional[bytes]:
        for s in self.stores:
            if key in s:
                return s.read(key)
        return None


def _parse_path(text: str) -> Tuple[str, ...]:
    try:
        path = ast.literal_eval(text)
    except (ValueError, SyntaxError) as e:
        raise UnsupportedCheckpoint(f"tree path {text!r} is not a tuple literal") from e
    if not isinstance(path, tuple) or not all(isinstance(k, (str, int)) for k in path):
        raise UnsupportedCheckpoint(f"tree path {text!r} is not a tuple of keys")
    return tuple(str(k) for k in path)


def read_metadata(directory: PathLike) -> Dict[str, Any]:
    """An item directory's ``_METADATA``, refusing what is not read."""
    path = os.path.join(item_dir(directory), "_METADATA")
    with open(path) as f:
        meta = json.load(f)
    if meta.get("use_zarr3"):
        raise UnsupportedCheckpoint(f"{path}: use_zarr3 is set; zarr3 arrays are not read")
    if "tree_metadata" not in meta:
        raise UnsupportedCheckpoint(f"{path}: no tree_metadata")
    return meta


def _zarray(store, name: str) -> Dict[str, Any]:
    raw = store.get(f"{name}/.zarray")
    if raw is None:
        raise FileNotFoundError(f"array {name}: no .zarray")
    meta = json.loads(raw)
    if meta.get("zarr_format") != 2:
        raise UnsupportedCheckpoint(f"array {name}: zarr_format {meta.get('zarr_format')}")
    if meta.get("dtype") not in _DTYPES:
        raise UnsupportedCheckpoint(f"array {name}: dtype {meta.get('dtype')!r}")
    comp = meta.get("compressor")
    if comp is not None and comp.get("id") != "zstd":
        raise UnsupportedCheckpoint(f"array {name}: compressor {comp.get('id')!r}")
    if meta.get("filters"):
        raise UnsupportedCheckpoint(f"array {name}: filters {meta['filters']}")
    if meta.get("order", "C") not in ("C", "F"):
        raise UnsupportedCheckpoint(f"array {name}: order {meta.get('order')!r}")
    return meta


def _fill(meta: Dict[str, Any]) -> float:
    value = meta.get("fill_value")
    if value is None:
        return 0
    if isinstance(value, str):  # zarr writes NaN and the infinities as strings
        return {"NaN": math.nan, "Infinity": math.inf, "-Infinity": -math.inf}[value]
    return value


def _decode_chunk(raw: bytes, key: str, compressed: bool, into: np.ndarray) -> None:
    """A chunk's stored bytes into ``into`` (uint8, the chunk's size)."""
    if compressed:
        n = zstd.decompress_into(raw, into).size
    else:
        n = len(raw)
        if n == into.size:
            into[:] = np.frombuffer(raw, np.uint8)
    if n != into.size:
        raise CorruptCheckpoint(f"chunk {key}: {n} bytes, not {into.size}")


def read_array(store, name: str) -> torch.Tensor:
    """The zarr v2 array ``name`` of ``store``, whole, as a CPU tensor. An
    array of one C-order chunk (every array of an unsharded checkpoint) is
    decoded straight into the tensor."""
    meta = _zarray(store, name)
    shape, chunks = list(meta["shape"]), list(meta["chunks"])
    dtype = _DTYPES[meta["dtype"]]
    if len(chunks) != len(shape) or any(c < 1 for c in chunks):
        raise UnsupportedCheckpoint(f"array {name}: chunks {chunks} for shape {shape}")
    sep = meta.get("dimension_separator", ".")
    order = meta.get("order", "C")
    compressed = meta["compressor"] is not None
    grid = [-(-s // c) for s, c in zip(shape, chunks)]
    out = torch.empty(shape, dtype=dtype)
    if chunks == shape and order == "C":
        key = f"{name}/{sep.join('0' for _ in shape) or '0'}"
        raw = store.get(key)
        if raw is None:  # a chunk never written holds the fill value
            return out.fill_(_fill(meta))
        _decode_chunk(raw, key, compressed, out.reshape(-1).view(torch.uint8).numpy())
        return out
    out.fill_(_fill(meta))
    buf = np.empty(math.prod(chunks) * out.element_size(), np.uint8)
    for index in np.ndindex(*grid):
        key = f"{name}/{sep.join(map(str, index)) if index else '0'}"
        raw = store.get(key)
        if raw is None:
            continue
        _decode_chunk(raw, key, compressed, buf)
        flat = torch.from_numpy(buf).view(dtype)
        chunk = (flat.reshape(chunks) if order == "C"
                 else flat.reshape(chunks[::-1]).permute(*reversed(range(len(chunks)))))
        sl = tuple(slice(i * c, min((i + 1) * c, s)) for i, c, s in zip(index, chunks, shape))
        out[sl] = chunk[tuple(slice(0, s.stop - s.start) for s in sl)]
    return out


def read_tree(directory: PathLike, prefix: Tuple[str, ...] = ()) -> Dict[str, Any]:
    """The tree of an item directory (or of a manager's step directory), or
    only its subtree under ``prefix``: nested dicts of CPU tensors, ``None``
    for an empty node."""
    item = item_dir(directory)
    meta = read_metadata(item)
    store = _Ocdbt(item) if meta.get("use_ocdbt", True) else _Files(item)
    tree: Dict[str, Any] = {}
    for text, leaf in meta["tree_metadata"].items():
        path = _parse_path(text)
        if path[:len(prefix)] != prefix:
            continue
        kind = leaf.get("value_metadata", {}).get("value_type")
        if kind == "None":
            value = None
        elif kind in ("jax.Array", "np.ndarray", "scalar"):
            value = read_array(store, ".".join(path))
        else:
            raise UnsupportedCheckpoint(f"{item}: leaf {path} has value type {kind!r}")
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
            if not isinstance(node, dict):
                raise UnsupportedCheckpoint(f"{item}: leaf {path} lies under another leaf")
        node[path[-1]] = value
    if not tree:
        raise KeyError(f"{item}: no leaf under {prefix}")
    return tree


# ------------------------------------------------------------------ writing

def _leaves(tree, path=(), types=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (str(k),), types + (DICT_KEY,))
    elif isinstance(tree, (tuple, list)):
        for k, v in enumerate(tree):
            yield from _leaves(v, path + (str(k),), types + (SEQUENCE_KEY,))
    else:
        yield path, types, tree


def _write(path: str, data: bytes) -> None:
    """``data`` to ``path``, on disk before the directory holding it is
    renamed into place."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())


_HANDLER = "orbax.checkpoint._src.handlers.standard_checkpoint_handler.StandardCheckpointHandler"


def save_tree(directory: PathLike, tree, export: bool = True) -> None:
    """Writes ``tree`` as an Orbax item directory that ``tcs_tpu``'s Orbax
    restores: dicts are dict keys, tuples and lists positions, ``None`` an
    empty node, a Python int a scalar, a tensor or array an array (one
    uncompressed zarr v2 chunk, in the layout without OCDBT). An ``export``
    (``save_params``) carries its own ``_CHECKPOINT_METADATA``; a manager's
    item leaves it to its step (:func:`save_step`). The directory is written
    under a temporary name and renamed; an existing one is replaced."""
    directory = os.path.abspath(os.fspath(directory))
    tmp = f"{directory}{_TMP}{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    tree_meta, sharding, arrays = {}, {}, []
    for path, types, value in _leaves(tree):
        name = ".".join(path)
        keys = [{"key": k, "key_type": t} for k, t in zip(path, types)]
        if value is None:
            tree_meta[str(path)] = {"key_metadata": keys, "value_metadata": {
                "value_type": "None", "skip_deserialize": True}}
            continue
        scalar = isinstance(value, (int, np.integer)) and not isinstance(value, bool)
        t = torch.as_tensor(np.asarray(value, np.int64) if scalar else value).detach().cpu()
        if t.dtype not in _NAMES:
            raise UnsupportedCheckpoint(f"leaf {path}: dtype {t.dtype} is not written")
        shape = list(t.shape)
        tree_meta[str(path)] = {"key_metadata": keys, "value_metadata": {
            "value_type": "scalar" if scalar else "jax.Array", "skip_deserialize": False,
            **({} if scalar else {"write_shape": shape})}}
        zarray = {"chunks": shape, "compressor": None, "dimension_separator": ".",
                  "dtype": _NAMES[t.dtype], "fill_value": None, "filters": None,
                  "order": "C", "shape": shape, "zarr_format": 2}
        _write(os.path.join(tmp, name, ".zarray"), json.dumps(zarray).encode())
        chunk = ".".join("0" for _ in shape) or "0"
        _write(os.path.join(tmp, name, chunk),
               t.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes())
        sharding[base64.b64encode(name.encode()).decode()] = json.dumps(
            {"sharding_type": "SingleDeviceSharding", "device_str": "TFRT_CPU_0"})
        arrays.append({"array_metadata": {"param_name": name, "write_shape": shape,
                                          "chunk_shape": shape, "ext_metadata": None}})
    meta = {"tree_metadata": tree_meta, "use_ocdbt": False, "use_zarr3": False,
            "store_array_data_equal_to_fill_value": True, "custom_metadata": None}
    _write(os.path.join(tmp, "_METADATA"), json.dumps(meta).encode())
    _write(os.path.join(tmp, "_sharding"), json.dumps(sharding).encode())
    _write(os.path.join(tmp, "array_metadatas", "process_0"),
           json.dumps({"array_metadatas": arrays}).encode())
    if export:
        _write_checkpoint_metadata(tmp, _HANDLER)
    if os.path.isdir(directory):
        shutil.rmtree(directory)
    os.replace(tmp, directory)


def _write_checkpoint_metadata(directory: str, item_handlers) -> None:
    """``_CHECKPOINT_METADATA`` as Orbax writes it beside a checkpoint."""
    now = time.time_ns()
    _write(os.path.join(directory, "_CHECKPOINT_METADATA"), json.dumps({
        "item_handlers": item_handlers, "metrics": {}, "performance_metrics": {},
        "init_timestamp_nsecs": now, "commit_timestamp_nsecs": now,
        "custom_metadata": {}}).encode())


def save_step(directory: PathLike, step: int, tree) -> str:
    """Writes ``tree`` as step ``step`` of the Orbax ``CheckpointManager``
    directory ``directory`` (``<directory>/<step>/default``), as
    ``tcs_tpu``'s ``CheckpointManager.save`` does; returns the step's path.
    The step appears whole: it is built under a temporary name and
    renamed."""
    directory = os.path.abspath(os.fspath(directory))
    final = os.path.join(directory, str(int(step)))
    tmp = f"{final}{_TMP}{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    save_tree(os.path.join(tmp, "default"), tree, export=False)
    _write_checkpoint_metadata(tmp, {"default": _HANDLER})
    if os.path.isdir(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


def flatten(tree, prefix: Tuple[str, ...] = ()) -> List[Tuple[Tuple[str, ...], Any]]:
    """(path, leaf) of every leaf of a tree of dicts, in key order."""
    out = []
    for k, v in tree.items():
        if isinstance(v, dict):
            out.extend(flatten(v, prefix + (k,)))
        else:
            out.append((prefix + (k,), v))
    return out


def tree_digests(tree) -> Dict[str, Dict[str, Any]]:
    """path ('opt_state/1/0/count') → dtype, shape and SHA-256 of the bytes
    of each leaf that holds an array, as ``scripts/make_orbax_fixtures.py``
    records ``tcs_tpu``'s restore."""
    out = {}
    for path, t in flatten(tree):
        if t is None:
            continue
        raw = t.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
        out["/".join(path)] = {"dtype": str(t.dtype).replace("torch.", ""),
                               "shape": list(t.shape),
                               "sha256": hashlib.sha256(raw).hexdigest()}
    return out
