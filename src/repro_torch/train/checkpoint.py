"""Checkpointing in repro's on-disk format: atomic rename, content
hashing, resume from the latest, and placement on a slot mesh on load
(elastic restart).  The counterpart of ``repro.train.checkpoint``.

Format: one directory per step, written by either package and read by
either --
  ckpt_dir/step_000123/
    arrays.npz         # repro's tree leaves, keyed by their paths
    manifest.json      # step, sha256 of arrays.npz, keys, shapes, dtypes
  ckpt_dir/latest      # text file: name of the newest complete step dir

Keys and shapes are repro's: the state ``(model, opt_state)`` is written
as repro's ``(params, opt_state)`` tree (``0/layers/attn/wq``,
``1/mu/embed``, ``1/step``; per-layer leaves stacked, bf16 widened to
f32) through ``convert.jax_tree_from``, and :func:`restore` unstacks it
back into the port's model and optimizer state.  Writes go to
``<name>.tmp`` and are renamed only after fsync, so a crashed writer never
corrupts the latest checkpoint; where ``latest`` names a directory that
does not verify, the newest one that does is taken.  ``arrays.npz`` is
``np.savez``'s file (the same members in the same order), written member
by member while a thread hashes each finished member, and read back as
memory maps of its stored members once its hash verifies.  With ``shardings``
(``sharding.to_shardings`` of a slot mesh) :func:`restore` places the
leaves on that mesh's slots instead, whatever mesh wrote them.
"""
from __future__ import annotations

import functools
import hashlib
import json
import os
import queue
import shutil
import struct
import threading
import zipfile
from concurrent.futures import Future, ThreadPoolExecutor

import numpy as np
import torch

from repro_torch.models import convert
from repro_torch.models import model as M
from repro_torch.train import sharding as S


def _leaf_fns(params, cfg):
    """repro's tree of ``params`` (an ``Lm``, ``{name: tensor}`` or a
    ``Sharded`` tree), each leaf a function giving its host array (the
    stack and the copy happen when it is called)."""
    if isinstance(params, S.Sharded):
        return S.unflatten({k: functools.partial(_gathered, params, k)
                            for k in params.keys()})
    if cfg is None:
        raise TypeError("optimizer moments need their model beside them: "
                        "save((model, opt_state), step)")
    return convert.map_leaves(convert.jax_plan(cfg, params),
                              lambda e: lambda: convert.to_numpy(
                                  convert.stack_plan(e)))


def _gathered(sharded: S.Sharded, key: str) -> np.ndarray:
    return convert.to_numpy(sharded.gather(key, "cpu"))


def _is_opt(obj) -> bool:
    return isinstance(obj, dict) and set(obj) == set(convert.OPT_KEYS)


def _state_fns(state, cfg=None):
    """repro's tree of a port state (an ``Lm``, a ``Sharded`` parameter
    tree, an optimizer state, or a tuple of them) as leaf functions."""
    if isinstance(state, M.Lm):
        return _leaf_fns(state, state.cfg)
    if isinstance(state, S.Sharded):
        return _leaf_fns(state, None)
    if isinstance(state, tuple):
        cfg = next((s.cfg for s in state if isinstance(s, M.Lm)), cfg)
        return tuple(_state_fns(s, cfg) for s in state)
    if _is_opt(state):
        step = state["step"]
        return {"mu": _leaf_fns(state["mu"], cfg),
                "nu": _leaf_fns(state["nu"], cfg),
                "step": lambda: convert.to_numpy(step)}
    raise TypeError(f"cannot checkpoint a {type(state).__name__}")


def _flatten_with_paths(tree, prefix: str = "") -> dict:
    """repro's keys in repro's order (tuples by index, dicts by sorted
    key, as ``jax.tree_util`` flattens them)."""
    if isinstance(tree, tuple):
        items = enumerate(tree)
    elif isinstance(tree, dict):
        items = sorted(tree.items())
    else:
        return {prefix[:-1]: tree}
    out = {}
    for k, v in items:
        out.update(_flatten_with_paths(v, f"{prefix}{k}/"))
    return out


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


class _Hasher:
    """sha256 of a file as it is written: :meth:`final` marks the bytes up
    to an offset as final, and a thread reads them back and hashes them
    (hashlib releases the GIL), so hashing overlaps the writing."""

    def __init__(self, path: str):
        self.path, self.sha = path, hashlib.sha256()
        self.ends: queue.Queue = queue.Queue()
        self.error: BaseException | None = None
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self):
        try:
            pos = 0
            # unbuffered: a read-ahead would keep bytes past ``end`` that
            # the writer patches later (the next member's header)
            with open(self.path, "rb", buffering=0) as f:
                while (end := self.ends.get()) is not None:
                    while pos < end:
                        chunk = f.read(min(1 << 24, end - pos))
                        if not chunk:
                            raise OSError(f"{self.path}: short read")
                        self.sha.update(chunk)
                        pos += len(chunk)
        except BaseException as e:  # re-raised by hexdigest
            self.error = e

    def final(self, end: int) -> None:
        self.ends.put(end)

    def hexdigest(self) -> str:
        self.ends.put(None)
        self.thread.join()
        if self.error is not None:
            raise self.error
        return self.sha.hexdigest()


def _write_npz(path: str, arrays: dict) -> str:
    """``np.savez(path, **arrays)``'s file (stored members ``key.npy`` in
    order, zip64 headers, version 1.0 array headers); returns its sha256.
    A value may be a ``Future`` of its array."""
    with open(path, "wb") as raw:
        hasher = _Hasher(path)
        try:
            with zipfile.ZipFile(raw, "w", zipfile.ZIP_STORED,
                                 allowZip64=True) as zf:
                for key, arr in arrays.items():
                    if isinstance(arr, Future):
                        arr = arr.result()
                    arr = np.asarray(arr, order="C")  # 0-d stays 0-d
                    with zf.open(key + ".npy", "w", force_zip64=True) as f:
                        np.lib.format.write_array_header_1_0(
                            f, np.lib.format.header_data_from_array_1_0(arr))
                        f.write(memoryview(arr.reshape(-1)).cast("B"))
                    raw.flush()  # the member and its patched header
                    hasher.final(raw.tell())
            raw.flush()  # the central directory
            hasher.final(raw.tell())
        finally:
            digest = hasher.hexdigest()
    return digest


def _read_npz(path: str) -> dict:
    """``{key: array}`` of an npz of stored members, each a copy-on-write
    memory map of its payload (no read until used)."""
    out = {}
    with zipfile.ZipFile(path) as zf, open(path, "rb") as f:
        for info in zf.infolist():
            if info.compress_type != zipfile.ZIP_STORED:
                raise ValueError(f"{path}: {info.filename} is compressed")
            f.seek(info.header_offset + 26)
            name_len, extra_len = struct.unpack("<HH", f.read(4))
            f.seek(info.header_offset + 30 + name_len + extra_len)
            version = np.lib.format.read_magic(f)
            read_header = (np.lib.format.read_array_header_1_0
                           if version == (1, 0)
                           else np.lib.format.read_array_header_2_0)
            shape, fortran, dtype = read_header(f)
            key = info.filename[:-len(".npy")]
            if not shape:
                out[key] = np.frombuffer(f.read(dtype.itemsize),
                                         dtype).reshape(())
                continue
            out[key] = np.memmap(path, dtype=dtype, mode="c",
                                 offset=f.tell(), shape=shape,
                                 order="F" if fortran else "C")
    return out


def save(ckpt_dir: str, state, step: int) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    name = f"step_{step:08d}"
    tmp = os.path.join(ckpt_dir, name + ".tmp")
    final = os.path.join(ckpt_dir, name)
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    # one thread stacks and copies each leaf to the host while this one
    # writes the leaf before it and another hashes the file behind it
    with ThreadPoolExecutor(1) as pool:
        arrays = {k: pool.submit(fn) for k, fn in
                  _flatten_with_paths(_state_fns(state)).items()}
        digest = _write_npz(os.path.join(tmp, "arrays.npz"), arrays)
    arrays = {k: v.result() for k, v in arrays.items()}
    manifest = {
        "step": step,
        "hash": digest,
        "keys": sorted(arrays.keys()),
        "shapes": {k: list(v.shape) for k, v in arrays.items()},
        "dtypes": {k: str(v.dtype) for k, v in arrays.items()},
    }
    del arrays
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):  # idempotent re-save of the same step
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic publish
    latest_tmp = os.path.join(ckpt_dir, "latest.tmp")
    with open(latest_tmp, "w") as f:
        f.write(name)
        f.flush()
        os.fsync(f.fileno())
    os.replace(latest_tmp, os.path.join(ckpt_dir, "latest"))
    return final


def verify(path: str) -> bool:
    """Integrity check: content hash must match the manifest."""
    try:
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        return _sha256(os.path.join(path, "arrays.npz")) == manifest["hash"]
    except (OSError, json.JSONDecodeError, KeyError):
        return False


def _read(data, prefix: str, shapes: dict) -> dict:
    """``{path: array}`` of the leaves under ``prefix``, each checked
    against the template's shape."""
    out = {}
    for path, want in S.flatten(shapes).items():
        key = prefix + path
        arr = data[key]
        if list(arr.shape) != list(want.shape):
            raise ValueError(f"shape mismatch for {key}: "
                             f"{arr.shape} vs {tuple(want.shape)}")
        out[path] = arr
    return out


def _place(flat: dict, dtypes: dict, placement: S.Placement) -> S.Sharded:
    leaves = {k: torch.from_numpy(v).to(dtypes[k]) for k, v in flat.items()}
    return S.Sharded.place(placement.mesh, S.flatten(placement.specs), leaves)


def _restore_model(data, prefix, model: M.Lm, placement):
    shapes = convert.jax_shapes(model.cfg)
    flat = _read(data, prefix, shapes)
    if placement is not None:
        dtypes = {k: v.dtype for k, v in S.flatten(shapes).items()}
        return _place(flat, dtypes, placement)
    convert.load_flat(convert.named_params(model),
                      convert.flat_from_jax(model.cfg, _tensors(flat)),
                      cast=True)
    return model


def _tensors(flat: dict) -> dict:
    """repro's tree of ``flat``'s arrays as CPU tensors on their memory."""
    return S.unflatten({k: torch.from_numpy(v) for k, v in flat.items()})


def _restore_opt(data, prefix, opt: dict, cfg, placement):
    shapes = convert.jax_shapes(cfg)
    step = torch.from_numpy(np.array(data[prefix + "step"]))
    out = {}
    for key in ("mu", "nu"):
        flat = _read(data, f"{prefix}{key}/", shapes)
        if placement is not None:
            dt = next(iter(opt[key].values())).dtype
            out[key] = _place(flat, {k: dt for k in flat},
                              S.Placement(placement.mesh,
                                          placement.specs[key]))
        else:
            convert.load_flat(opt[key], convert.flat_from_jax(
                cfg, _tensors(flat)), what=key, cast=True)
            out[key] = opt[key]
    if placement is not None:
        out["step"] = step.to(placement.mesh.first(), torch.int32)
    else:
        opt["step"].copy_(step)
        out["step"] = opt["step"]
    return out


def _restore(path: str, template, shardings=None):
    data = _read_npz(os.path.join(path, "arrays.npz"))
    if isinstance(template, M.Lm):
        return _restore_model(data, "", template, shardings)
    if isinstance(template, tuple) and len(template) == 2:
        model, opt = template
        place_p, place_o = shardings or (None, None)
        return (_restore_model(data, "0/", model, place_p),
                _restore_opt(data, "1/", opt, model.cfg, place_o))
    raise TypeError("restore's template is a model or (model, opt_state)")


def restore(path: str, template, shardings=None):
    """Restore into ``template`` (an ``Lm``, or ``(model, opt_state)``),
    in place, and return it; with ``shardings`` (a ``Placement``, or one
    for the parameters and one for the optimizer state) return the leaves
    placed on that mesh instead (``Sharded`` trees, the step on the
    mesh's first slot), the template giving dtypes."""
    if not verify(path):
        raise IOError(f"corrupt or incomplete checkpoint: {path}")
    return _restore(path, template, shardings)


def latest_step_dir(ckpt_dir: str) -> str | None:
    latest = os.path.join(ckpt_dir, "latest")
    if os.path.exists(latest):
        with open(latest) as f:
            name = f.read().strip()
        path = os.path.join(ckpt_dir, name)
        if verify(path):
            return path
    # fall back: newest complete step dir (covers a crash between publish
    # and the 'latest' pointer update)
    if not os.path.isdir(ckpt_dir):
        return None
    cands = sorted(d for d in os.listdir(ckpt_dir)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    for name in reversed(cands):
        path = os.path.join(ckpt_dir, name)
        if verify(path):
            return path
    return None


def restore_latest(ckpt_dir: str, template, shardings=None):
    """Returns (state, step) or None.  The directory is hashed once
    (``latest_step_dir`` verified it)."""
    path = latest_step_dir(ckpt_dir)
    if path is None:
        return None
    with open(os.path.join(path, "manifest.json")) as f:
        step = json.load(f)["step"]
    return _restore(path, template, shardings), step
