"""Universal checkpoint reader (counterpart of the read side of
``deepspeed_tpu/runtime/checkpointing.py``).

The JAX package writes every param leaf as one full ``.npy`` file keyed by
its pytree path (``embed.wte``, ``layers.wq``, ...), or as shard files
``<key>.shard_<start>.npy`` named by each shard's start offsets, which a
reader reassembles whatever mesh wrote them::

    <save_dir>/<tag>/manifest.json       # counters, config, params_index
    <save_dir>/<tag>/params/<key>.npy    # or <key>.shard_<s0>-<s1>...npy
    <save_dir>/latest                     # tag pointer

Here those files fill the port's param tree (nested dicts of tensors, the
same keys), each leaf placed on the given device in the template's dtype.
:func:`load_params_for_model` is the serving entry (a tag directory or a
save directory with ``latest``); the template comes from ``CausalLM.init``
on the ``meta`` device, so no weights are allocated to build it.

Saving, and loading optimizer state into a training engine, are ROADMAP
queue 1 item 13: :func:`save_checkpoint` raises.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from .. import not_ported, resolve_device
from ..utils.logging import logger

# numpy reads, then a torch cast for the types numpy lacks (bfloat16)
_NP_DTYPE = {torch.float32: np.float32, torch.float16: np.float16,
             torch.float64: np.float64, torch.int32: np.int32,
             torch.int64: np.int64, torch.int8: np.int8,
             torch.uint8: np.uint8}


def _path_str(path: Tuple[str, ...]) -> str:
    """The dotted key of a leaf: the JAX pytree path's dict keys joined."""
    return ".".join(str(p) for p in path)


def _flatten(tree: Any, path: Tuple[str, ...] = ()) -> List[Tuple[str, Any]]:
    """(dotted key, leaf) pairs of a nested dict, keys sorted at each level
    as ``jax.tree_util`` orders a dict."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(_flatten(tree[k], path + (str(k),)))
        return out
    return [(_path_str(path), tree)]


def _unflatten_into(template: Any, leaves: Dict[str, Any],
                    path: Tuple[str, ...] = ()) -> Any:
    if isinstance(template, dict):
        return {k: _unflatten_into(v, leaves, path + (str(k),))
                for k, v in template.items()}
    return leaves[_path_str(path)]


def _read_leaf(in_dir: str, key: str, shape, dtype=None) -> np.ndarray:
    """One leaf from ``<key>.npy`` or from its shard files, reassembled.
    Shards are disjoint, so they must cover the leaf exactly: anything
    else raises ``IOError`` (a missing shard never loads as zeros)."""
    single = os.path.join(in_dir, key + ".npy")
    if os.path.exists(single):
        arr = np.load(single)
        return arr if dtype is None else arr.astype(dtype, copy=False)
    files = glob.glob(os.path.join(glob.escape(in_dir),
                                   glob.escape(key) + ".shard_*.npy"))
    if not files:
        raise FileNotFoundError(
            f"no checkpoint data for leaf {key} in {in_dir}")
    out = None
    covered = 0
    for f in files:
        coords = os.path.basename(f)[len(key) + len(".shard_"):-len(".npy")]
        start = tuple(int(c) for c in coords.split("-"))
        block = np.load(f)
        if out is None:
            out = np.zeros(shape, dtype if dtype is not None else block.dtype)
        idx = tuple(slice(s, s + b) for s, b in zip(start, block.shape))
        out[idx] = block
        covered += block.size
    expect = int(np.prod(shape)) if shape else 1
    if covered != expect:
        raise IOError(f"leaf {key}: shard files cover {covered} of {expect} "
                      f"elements — incomplete checkpoint in {in_dir}")
    return out


def _load_tree(template: Any, in_dir: str, device=None) -> Any:
    """Read every leaf of ``template`` (tensors, e.g. on ``meta``, giving
    shape and dtype) from ``in_dir`` onto ``device``. A shape mismatch
    raises ``ValueError``."""
    device = resolve_device(device)
    leaves = {}
    for key, leaf in _flatten(template):
        shape = tuple(leaf.shape)
        arr = _read_leaf(in_dir, key, shape, _NP_DTYPE.get(leaf.dtype))
        if tuple(arr.shape) != shape:
            raise ValueError(f"Checkpoint shape mismatch for {key}: "
                             f"{arr.shape} vs expected {shape}")
        t = torch.from_numpy(np.ascontiguousarray(arr))
        leaves[key] = t.to(device=device, dtype=leaf.dtype)
    return _unflatten_into(template, leaves)


def param_template(model, dtype=None) -> Any:
    """The model's param tree as ``meta`` tensors: shapes and dtypes (fp32,
    as the JAX package keeps params, unless ``dtype``), no storage."""
    return model.init(torch.Generator("cpu"), device="meta", dtype=dtype)


def load_params_for_model(model, checkpoint_dir: str, device=None,
                          dtype=None):
    """The serving weights of ``model`` from a universal checkpoint,
    without an engine or optimizer state, on ``device`` (``cuda`` unless
    ``"cpu"`` is passed), in ``dtype`` (default fp32, as written).

    ``checkpoint_dir`` is a tag directory (holding ``manifest.json``) or a
    save directory whose ``latest`` pointer is resolved first. Raises
    ``FileNotFoundError`` naming the manifest path when there is no
    checkpoint, and ``ValueError`` naming the leaves when the manifest's
    ``params_index`` does not match the model."""
    ckpt_dir = checkpoint_dir
    manifest_path = os.path.join(ckpt_dir, "manifest.json")
    if not os.path.exists(manifest_path):
        latest = os.path.join(checkpoint_dir, "latest")
        if os.path.exists(latest):
            with open(latest) as fh:
                tag = fh.read().strip()
            ckpt_dir = os.path.join(checkpoint_dir, tag)
            manifest_path = os.path.join(ckpt_dir, "manifest.json")
    if not os.path.exists(manifest_path):
        raise FileNotFoundError(
            f"no checkpoint manifest at {manifest_path} — expected a tag "
            f"directory containing manifest.json, or a save directory "
            f"with a 'latest' pointer, under {checkpoint_dir}")
    with open(manifest_path) as fh:
        manifest = json.load(fh)
    template = param_template(model, dtype)
    want = {key for key, _ in _flatten(template)}
    have = set(manifest.get("params_index", {}))
    if have and want != have:
        missing = sorted(want - have)
        extra = sorted(have - want)
        raise ValueError(
            f"checkpoint {ckpt_dir} (tag {manifest.get('tag')!r}) does "
            f"not match the model: "
            + (f"model leaves absent from checkpoint {missing}; "
               if missing else "")
            + (f"checkpoint leaves unknown to model {extra}"
               if extra else ""))
    params = _load_tree(template, os.path.join(ckpt_dir, "params"), device)
    logger.info(f"Loaded serving params from {ckpt_dir} "
                f"({len(want)} leaves)")
    return params


def save_checkpoint(*args, **kwargs):
    raise not_ported("checkpoint saving (runtime/checkpointing.py "
                     "save_checkpoint)", "queue 1 item 13")
