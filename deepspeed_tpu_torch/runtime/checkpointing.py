"""Universal checkpoints: save and load, counterpart of
``deepspeed_tpu/runtime/checkpointing.py``.

The layout is the JAX package's, file for file, so a checkpoint either
package writes resumes in the other::

    <save_dir>/<tag>/manifest.json       # counters, config, client state
    <save_dir>/<tag>/params/<key>.npy    # or <key>.shard_<s0>-<s1>...npy
    <save_dir>/<tag>/opt/<m|v>.<key>.npy # optimizer moments
    <save_dir>/<tag>/offload/master_<i>.npy, state_<i>_<m|v|step>.npy
                                          # ZeRO-Offload's host state
    <save_dir>/latest                     # tag pointer, the commit marker

Each leaf is keyed by its dotted pytree path (``embed.wte``,
``layers.wq``, ...). Under ZeRO-Offload the ``opt/`` tree holds the device
optimizer's kept leaves, keyed by leaf index (``m.3``) as the JAX package
keys them, and ``offload/`` the host masters and moments of the offloaded
leaves, ``<i>`` the leaf's index in the JAX flatten order. The JAX package
writes no ``state_*`` files when its moments live on NVMe; the port writes
them either way, and each package's loader reads whatever files are
there. One process writes each leaf whole as ``<key>.npy``. Over a mesh
every rank writes the blocks it is the first holder of as
``<key>.shard_<starts>.npy`` (a replicated leaf whole, from rank 0), no
leaf is gathered, and after a barrier rank 0 commits the manifest and
``latest``: the JAX package's file set on the same mesh. The reader
reassembles shard files, whatever mesh wrote them, and cuts each rank's
block.

Saving copies every leaf to host memory before it returns: the engine
updates its masters and moments in place, so a write must never read a
tensor that the next step overwrites. With ``async_save`` the ``np.save``
calls run on a :class:`CheckpointWriter` thread, which touches host arrays
only. The manifest and then ``latest`` are written through an atomic temp
file, ``os.replace`` and a directory fsync, and only after every leaf's
bytes are written: a crash at any point leaves the previous ``latest``
loadable. Loading copies each leaf into the engine's existing tensors
(``copy_``), so no second state tree is built on the device and the
masters stay the autograd leaves whose ``.grad`` is the accumulator.

:func:`load_params_for_model` is the serving entry (a tag directory or a
save directory with ``latest``); its template comes from ``CausalLM.init``
on the ``meta`` device, so no weights are allocated to build it.
"""

from __future__ import annotations

import glob
import json
import os
import queue
import threading
import time
import zipfile
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import comm, not_ported, resolve_device
from ..parallel import topology as topo
from ..parallel.sharding import is_replica_zero, is_sharded, local_slice
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


class CheckpointWriter:
    """Background disk writer: the caller snapshots each leaf to a host
    array (so the step loop may overwrite the device tensors at once), and
    the ``np.save`` calls, the dominant cost, run on this thread."""

    def __init__(self):
        self._q = queue.Queue()
        self._errors = []
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="checkpoint-writer")
        self._thread.start()

    def _run(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            fname, arr = item
            try:
                np.save(fname, arr)
            except Exception as e:  # surfaced by finalize()
                self._errors.append((fname, e))
            finally:
                self._q.task_done()

    def submit(self, fname: str, arr: np.ndarray):
        self._q.put((fname, arr))

    def finalize(self):
        """Join the queued writes, stop the worker, raise any collected
        error. The worker is always joined before the error surfaces (a
        failed save leaks no thread), and a raised ``IOError`` means the
        commit marker was never written: the previous ``latest`` stays
        loadable."""
        self._q.join()
        self._q.put(None)
        self._thread.join()
        if self._errors:
            errs, self._errors = self._errors, []
            raise IOError(f"checkpoint writes failed: {errs}")

    wait = finalize


def _fsync_dir(path: str) -> None:
    """fsync a directory so that a rename into it is durable (the rename
    lives in the directory's metadata). Best effort: some filesystems
    refuse an fsync of a directory opened read-only."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _atomic_write_text(path: str, text: str) -> None:
    """Crash-safe replace: write a temp file, fsync it, ``os.replace`` it
    over ``path`` and fsync the directory. A reader, or a restart after a
    crash at any point in here, sees the whole old content or the whole
    new content, which makes ``latest`` a commit marker."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as fh:
        fh.write(text)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)
    _fsync_dir(os.path.dirname(path) or ".")


def _shard_fname(key: str, start) -> str:
    """A shard file's name: the leaf's key and the shard's start offsets,
    so that shard files describe themselves (``start=("*",)`` gives the
    glob of a leaf's shards)."""
    return f"{key}.shard_{'-'.join(str(s) for s in start)}.npy"


def _host_copy(t: torch.Tensor) -> np.ndarray:
    """A host array that shares no memory with ``t`` (on the CPU ``.cpu()``
    would return ``t`` itself, which the next step updates in place)."""
    return t.detach().to("cpu", copy=True).numpy()


def _save_tree(tree: Any, out_dir: str,
               writer: Optional[CheckpointWriter] = None,
               layout: Optional[Dict[str, tuple]] = None) -> Dict[str, str]:
    """Write the leaves of ``tree`` in ``out_dir``, through ``writer`` when
    one is given; returns the index key -> file name. Each written leaf is
    copied to host memory before this returns.

    In one process every leaf is written whole as ``<key>.npy``. Over a
    mesh, ``layout`` gives each key its (whole shape, spec) and the leaf is
    this rank's block: a sharded leaf's block is written as
    ``<key>.shard_<starts>.npy`` by its first holder only (the JAX
    ``replica_id == 0``), and nothing is gathered; a replicated leaf is
    written whole by rank 0."""
    os.makedirs(out_dir, exist_ok=True)
    index = {}
    t = rank = None
    if layout is not None:
        t, rank = topo.get_topology(), comm.get_rank()
    for key, leaf in _flatten(tree):
        shape, spec = layout[key] if layout is not None else (None, ())
        if layout is not None and is_sharded(spec, t):
            index[key] = key + ".shard_*"
            if not is_replica_zero(spec, t, rank):
                continue
            start = [s.start for s in local_slice(shape, spec, t, rank)]
            fname = os.path.join(out_dir, _shard_fname(key, start))
        else:
            index[key] = key + ".npy"
            if rank:
                continue
            fname = os.path.join(out_dir, index[key])
        arr = _host_copy(leaf)
        if writer is not None:
            writer.submit(fname, arr)
        else:
            np.save(fname, arr)
    return index


def _leaf_files(in_dir: str, key: str) -> Tuple[Optional[str], List[str]]:
    """(``<key>.npy`` if it exists, else None; the leaf's shard files)."""
    single = os.path.join(in_dir, key + ".npy")
    if os.path.exists(single):
        return single, []
    return None, glob.glob(os.path.join(
        glob.escape(in_dir), _shard_fname(glob.escape(key), ("*",))))


def _read_leaf(in_dir: str, key: str, shape, dtype=None) -> np.ndarray:
    """One leaf from ``<key>.npy`` or from its shard files, reassembled.
    Shards are disjoint, so they must cover the leaf exactly: anything
    else raises ``IOError`` (a missing shard never loads as zeros)."""
    single, files = _leaf_files(in_dir, key)
    if single is not None:
        arr = np.load(single)
        return arr if dtype is None else arr.astype(dtype, copy=False)
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
    shape and dtype) from ``in_dir`` into new tensors on ``device``. A
    shape mismatch raises ``ValueError``."""
    device = resolve_device(device)
    tree = _unflatten_into(template, {
        key: torch.empty(leaf.shape, dtype=leaf.dtype, device=device)
        for key, leaf in _flatten(template)})
    _copy_tree_into(tree, in_dir)
    return tree


def _whole_shape(key, leaf, layout) -> tuple:
    return tuple(layout[key][0]) if layout is not None else tuple(leaf.shape)


def _check_tree_files(tree: Any, in_dir: str,
                      layout: Optional[Dict[str, tuple]] = None) -> None:
    """Before any leaf is overwritten: every leaf of ``tree`` has data in
    ``in_dir``, and a whole ``<key>.npy`` has the leaf's shape (read from
    its header), so that a checkpoint of another model fails before it
    has changed the engine."""
    for key, leaf in _flatten(tree):
        single, files = _leaf_files(in_dir, key)
        if single is None and not files:
            raise FileNotFoundError(
                f"no checkpoint data for leaf {key} in {in_dir}")
        if single is not None:
            shape = np.load(single, mmap_mode="r").shape
            want = _whole_shape(key, leaf, layout)
            if tuple(shape) != want:
                raise ValueError(f"Checkpoint shape mismatch for {key}: "
                                 f"{tuple(shape)} vs expected {want}")


@torch.no_grad()
def _copy_tree_into(tree: Any, in_dir: str,
                    layout: Optional[Dict[str, tuple]] = None) -> None:
    """Read every leaf of ``tree`` from ``in_dir`` and ``copy_`` it into
    the leaf, one leaf at a time (host memory holds one leaf). Over a mesh
    (``layout``, as :func:`_save_tree` takes it) the whole leaf is
    reassembled, whatever mesh wrote it, and this rank's block is cut
    from it."""
    for key, leaf in _flatten(tree):
        want = _whole_shape(key, leaf, layout)
        arr = _read_leaf(in_dir, key, want, _NP_DTYPE.get(leaf.dtype))
        if tuple(arr.shape) != want:
            raise ValueError(f"Checkpoint shape mismatch for {key}: "
                             f"{arr.shape} vs expected {want}")
        if layout is not None:
            arr = arr[local_slice(want, layout[key][1], topo.get_topology(),
                                  comm.get_rank())]
        leaf.copy_(torch.from_numpy(np.ascontiguousarray(arr)))


def save_checkpoint(engine, save_dir: str, tag: Optional[str] = None,
                    client_state: Optional[dict] = None,
                    save_latest: bool = True, async_save: bool = False,
                    urgent: bool = False) -> str:
    """Write the engine's train state as the tag ``tag`` (default
    ``global_step<N>``) under ``save_dir``; returns the tag directory.
    With ``async_save`` the disk writes run on a background thread and
    :func:`wait_pending_save` joins them and commits.

    ``urgent=True`` is the preemption path: an in-flight async save is
    joined first (its failure is logged, not raised: a broken earlier save
    must not abort this one), the write completes synchronously, and the
    wall time lands on ``engine.last_urgent_save_s``."""
    t_urgent = time.perf_counter() if urgent else None
    if urgent:
        async_save = False
    try:
        wait_pending_save(engine)
    except Exception as e:
        if not urgent:
            raise
        # the failed save's pending commit was already dropped, so its
        # 'latest' can never publish
        logger.warning(f"urgent save: prior async save failed ({e!r}); "
                       "continuing with the urgent checkpoint")
    tag = tag if tag is not None else f"global_step{engine.global_steps}"
    ckpt_dir = os.path.join(save_dir, str(tag))
    os.makedirs(ckpt_dir, exist_ok=True)

    state = engine.state
    layout = _layout(engine)
    writer = CheckpointWriter() if async_save else None
    try:
        p_index = _save_tree(state.params, os.path.join(ckpt_dir, "params"),
                             writer, layout and layout[0])
        o_index = _save_tree(state.opt_state.moments,
                             os.path.join(ckpt_dir, "opt"), writer,
                             layout and layout[1])
    except BaseException:
        if writer is not None:
            try:
                writer.finalize()
            except IOError:
                pass
        raise
    plan = getattr(engine, "_offload_plan", None)
    if plan is not None:
        _save_offload(plan, os.path.join(ckpt_dir, "offload"), writer)
    engine._pending_ckpt_writer = writer
    # the manifest is taken now (the state may advance during async
    # writes) and written, with 'latest', only once every leaf is on disk
    manifest = {
        "tag": str(tag),
        "global_step": int(state.global_step),
        # the host counter also counts overflow-skipped steps: both must
        # round-trip, or a resume after a skipped step replays one more
        "host_global_steps": int(engine.global_steps),
        "skipped_steps": int(state.skipped_steps),
        "micro_steps": engine.micro_steps,
        "opt_step": int(state.opt_state.step),
        "loss_scale": float(state.scale_state.scale),
        "good_steps": int(state.scale_state.good_steps),
        "hysteresis": int(state.scale_state.hysteresis),
        "lr_scheduler": engine.lr_scheduler.state_dict(),
        "client_state": client_state or {},
        "params_index": p_index,
        "opt_index": o_index,
        "config": engine.config.to_dict(),
        "format_version": 1,
    }

    def commit():
        if layout is not None and comm.get_rank() != 0:
            return
        _atomic_write_text(os.path.join(ckpt_dir, "manifest.json"),
                           json.dumps(manifest, indent=2, default=str))
        if save_latest:
            _atomic_write_text(os.path.join(save_dir, "latest"), str(tag))

    engine._pending_ckpt_commit = commit
    if not async_save:
        wait_pending_save(engine)
    if urgent:
        engine.last_urgent_save_s = time.perf_counter() - t_urgent
        logger.info(f"Urgent checkpoint {ckpt_dir} committed in "
                    f"{engine.last_urgent_save_s:.2f}s")
    else:
        logger.info(f"Saved checkpoint {ckpt_dir}"
                    + (" (async writes in flight)" if async_save else ""))
    return ckpt_dir


def _save_offload(plan, off_dir: str,
                  writer: Optional[CheckpointWriter]) -> None:
    """The offloaded leaves' host masters and optimizer state (paged in
    from their files under NVMe). An async save snapshots each array,
    since the next step updates them in place."""
    os.makedirs(off_dir, exist_ok=True)

    def put(name, arr):
        fname = os.path.join(off_dir, name)
        if writer is not None:
            writer.submit(fname, np.array(arr, copy=True))
        else:
            np.save(fname, arr)

    for i in plan.offloaded:
        put(f"master_{i}.npy", plan.masters[i])
        for mk, arr in plan.leaf_state(i).items():
            put(f"state_{i}_{mk}.npy", arr)


def _load_offload(plan, off_dir: str) -> None:
    """Read the masters and optimizer state that ``off_dir`` holds into
    the plan, in place (a missing file leaves its array as it is, as the
    JAX loader does)."""
    for i in plan.offloaded:
        mpath = os.path.join(off_dir, f"master_{i}.npy")
        if os.path.exists(mpath):
            plan.masters[i][...] = np.load(mpath)
        state = plan.leaf_state(i)
        found = False
        for mk, arr in state.items():
            spath = os.path.join(off_dir, f"state_{i}_{mk}.npy")
            if os.path.exists(spath):
                arr[...] = np.load(spath).reshape(arr.shape)
                found = True
        if found:
            plan.store_leaf_state(i, state)


def _layout(engine):
    """The engine's (params, moments) layouts over a mesh, else None."""
    fn = getattr(engine, "_ckpt_layout", None)
    return fn() if fn is not None else None


def wait_pending_save(engine) -> None:
    """Join the async writer (if any), wait for every rank's writes (a
    barrier over a mesh), then write the manifest and the ``latest``
    commit marker (rank 0)."""
    writer = getattr(engine, "_pending_ckpt_writer", None)
    if writer is not None:
        try:
            writer.finalize()
        except BaseException:
            # failed writes: drop the pending commit too, or the next
            # save's join would point 'latest' at this incomplete tag
            engine._pending_ckpt_commit = None
            raise
        finally:
            engine._pending_ckpt_writer = None
    if _layout(engine) is not None:
        comm.barrier()
    commit = getattr(engine, "_pending_ckpt_commit", None)
    if commit is not None:
        engine._pending_ckpt_commit = None
        commit()


def load_checkpoint(engine, load_dir: str, tag: Optional[str] = None,
                    load_optimizer_states: bool = True,
                    load_module_only: bool = False):
    """Load the tag ``tag`` (default: the one ``latest`` names) into the
    engine, in place. Returns ``(tag directory, client_state)``, or
    ``(None, {})`` when ``load_dir`` has no ``latest``. With the optimizer
    states (the default) the moments, ``opt_state.step``, the loss-scale
    state, both step counters, ``micro_steps`` and the LR scheduler come
    back too."""
    if tag is None:
        latest = os.path.join(load_dir, "latest")
        if not os.path.exists(latest):
            logger.warning(f"No 'latest' file in {load_dir}; nothing loaded")
            return None, {}
        with open(latest) as fh:
            tag = fh.read().strip()
    ckpt_dir = os.path.join(load_dir, str(tag))
    with open(os.path.join(ckpt_dir, "manifest.json")) as fh:
        manifest = json.load(fh)

    state = engine.state
    p_lay, o_lay = _layout(engine) or (None, None)
    with_opt = load_optimizer_states and not load_module_only
    _check_tree_files(state.params, os.path.join(ckpt_dir, "params"), p_lay)
    if with_opt:
        _check_tree_files(state.opt_state.moments,
                          os.path.join(ckpt_dir, "opt"), o_lay)
    _copy_tree_into(state.params, os.path.join(ckpt_dir, "params"), p_lay)
    if with_opt:
        _copy_tree_into(state.opt_state.moments,
                        os.path.join(ckpt_dir, "opt"), o_lay)

        def like(old, value):
            return torch.tensor(value, dtype=old.dtype, device=old.device)

        ss = state.scale_state
        engine.state = state._replace(
            opt_state=state.opt_state._replace(
                step=like(state.opt_state.step, manifest["opt_step"])),
            scale_state=ss._replace(
                scale=like(ss.scale, manifest["loss_scale"]),
                good_steps=like(ss.good_steps, manifest["good_steps"]),
                hysteresis=like(ss.hysteresis, manifest["hysteresis"])),
            global_step=like(state.global_step, manifest["global_step"]),
            skipped_steps=like(state.skipped_steps,
                               manifest["skipped_steps"]))
        # older manifests lack the host counter: the device counter is
        # then the best value there is
        engine.global_steps = manifest.get("host_global_steps",
                                           manifest["global_step"])
        engine.micro_steps = manifest.get("micro_steps", 0)
        engine.lr_scheduler.load_state_dict(manifest["lr_scheduler"])
    plan = getattr(engine, "_offload_plan", None)
    off_dir = os.path.join(ckpt_dir, "offload")
    if plan is not None and os.path.isdir(off_dir) and not load_module_only:
        _load_offload(plan, off_dir)
    logger.info(f"Loaded checkpoint {ckpt_dir} (step {manifest['global_step']})")
    return ckpt_dir, manifest.get("client_state", {})


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


def save_16bit_model(engine, save_dir: str,
                     save_filename: str = "model.npz") -> str:
    """The params in the compute precision, one ``.npz`` (as ``np.savez``
    writes it): fp16 under fp16, bf16 under bf16, else fp32. A bf16
    member carries the header numpy gives an ``ml_dtypes.bfloat16`` array
    (``'descr': '<V2'``) and the tensor's 16-bit patterns as its data,
    written without a numpy bf16 type."""
    if _layout(engine) is not None:
        raise not_ported("save_16bit_model over a mesh (a consolidated "
                         "gather of the sharded leaves)", "queue 1 item 14")
    os.makedirs(save_dir, exist_ok=True)
    path = os.path.join(save_dir, save_filename)
    # np.savez's container: an uncompressed zip, one "<key>.npy" a member
    with zipfile.ZipFile(path, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, leaf in _flatten(engine.state.params):
            with zf.open(key + ".npy", "w", force_zip64=True) as fid:
                if engine.bf16_enabled:
                    bits = leaf.detach().to(torch.bfloat16).view(
                        torch.int16).cpu().numpy()
                    np.lib.format.write_array_header_1_0(fid, {
                        "descr": "<V2", "fortran_order": False,
                        "shape": tuple(bits.shape)})
                    fid.write(bits.astype("<i2", copy=False).tobytes())
                else:
                    dtype = torch.float16 if engine.fp16_enabled \
                        else torch.float32
                    np.lib.format.write_array(
                        fid, leaf.detach().to(dtype).cpu().numpy())
    logger.info(f"Saved 16-bit model to {path}")
    return path
