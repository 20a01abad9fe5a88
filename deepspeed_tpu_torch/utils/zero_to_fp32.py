"""Offline fp32 state-dict reconstruction from a universal checkpoint.

The port's own copy of ``deepspeed_tpu/utils/zero_to_fp32.py`` (the
reference's ``deepspeed/utils/zero_to_fp32.py``): rebuild the full fp32
weights from a checkpoint without an engine, a model or a device. Each
leaf is a whole ``<key>.npy`` or a set of shard files with their start
offsets in the name (``runtime/checkpointing.py``), so the work is numpy
alone, and it reads what either package wrote.

CLI::

    python -m deepspeed_tpu_torch.utils.zero_to_fp32 <checkpoint_dir> <output_file> [--tag TAG] [--torch]

writes a single ``.npz`` with dotted param names (loadable with
``np.load``), or with ``--torch`` a torch ``state_dict`` ``.pt``.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Dict, Optional

import numpy as np


def _resolve_tag(checkpoint_dir: str, tag: Optional[str]) -> str:
    if tag is None:
        latest = os.path.join(checkpoint_dir, "latest")
        if not os.path.exists(latest):
            raise FileNotFoundError(
                f"no 'latest' file in {checkpoint_dir}; pass tag explicitly")
        with open(latest) as fh:
            tag = fh.read().strip()
    return os.path.join(checkpoint_dir, tag)


def _assemble_leaf(params_dir: str, key: str) -> np.ndarray:
    """Rebuild one leaf from its shard files; shape is inferred from the
    shard coordinates + block shapes (no model needed)."""
    single = os.path.join(params_dir, key + ".npy")
    if os.path.exists(single):
        return np.load(single)
    files = sorted(glob.glob(os.path.join(params_dir, key + ".shard_*.npy")))
    if not files:
        raise FileNotFoundError(f"no data for leaf {key!r} in {params_dir}")
    blocks = []
    for f in files:
        coords = os.path.basename(f)[len(key) + len(".shard_"):-len(".npy")]
        start = tuple(int(c) for c in coords.split("-"))
        block = np.load(f)
        blocks.append((start, block))
    ndim = blocks[0][1].ndim
    shape = tuple(max(s[d] + b.shape[d] for s, b in blocks)
                  for d in range(ndim))
    out = np.zeros(shape, blocks[0][1].dtype)
    covered = 0
    for start, block in blocks:
        idx = tuple(slice(s, s + w) for s, w in zip(start, block.shape))
        out[idx] = block
        covered += block.size
    if covered != out.size:
        raise IOError(f"leaf {key!r}: shards cover {covered}/{out.size} "
                      "elements — incomplete checkpoint")
    return out


def get_fp32_state_dict_from_zero_checkpoint(
        checkpoint_dir: str, tag: Optional[str] = None
) -> Dict[str, np.ndarray]:
    """Reference ``get_fp32_state_dict_from_zero_checkpoint``: dotted param
    name → full fp32 numpy array."""
    ckpt = _resolve_tag(checkpoint_dir, tag)
    with open(os.path.join(ckpt, "manifest.json")) as fh:
        manifest = json.load(fh)
    params_dir = os.path.join(ckpt, "params")
    out = {}
    for key in manifest["params_index"]:
        out[key] = _assemble_leaf(params_dir, key).astype(np.float32)
    return out


def convert_zero_checkpoint_to_fp32_state_dict(
        checkpoint_dir: str, output_file: str, tag: Optional[str] = None,
        as_torch: bool = False) -> str:
    """Reference ``convert_zero_checkpoint_to_fp32_state_dict``: write the
    consolidated weights to ``output_file`` (.npz, or torch .pt)."""
    state = get_fp32_state_dict_from_zero_checkpoint(checkpoint_dir, tag)
    if as_torch:
        import torch

        torch.save({k: torch.from_numpy(np.ascontiguousarray(v))
                    for k, v in state.items()}, output_file)
    else:
        np.savez(output_file, **state)
        if not output_file.endswith(".npz"):
            os.replace(output_file + ".npz", output_file)
    total = sum(v.size for v in state.values())
    print(f"saved {len(state)} tensors ({total:,} elements) → {output_file}")
    return output_file


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Reconstruct full fp32 weights from a universal "
                    "checkpoint")
    ap.add_argument("checkpoint_dir")
    ap.add_argument("output_file")
    ap.add_argument("--tag", default=None)
    ap.add_argument("--torch", action="store_true", dest="as_torch",
                    help="write a torch state_dict .pt instead of .npz")
    args = ap.parse_args(argv)
    convert_zero_checkpoint_to_fp32_state_dict(
        args.checkpoint_dir, args.output_file, tag=args.tag,
        as_torch=args.as_torch)


if __name__ == "__main__":
    main()
