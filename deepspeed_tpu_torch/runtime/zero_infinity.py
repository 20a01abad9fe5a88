"""ZeRO-Infinity: parameter streaming for a model larger than the device.

Counterpart of ``deepspeed_tpu/runtime/zero_infinity.py`` (reference
``runtime/swap_tensor/partitioned_param_swapper.py:36`` and the stage-3
prefetch of ``partitioned_param_coordinator.py:503``), on one device. The
fp32 masters and Adam moments live in host RAM or in files; only a sliding
window of layer groups is ever on the device:

- the stacked-layer ``CausalLM`` is cut into contiguous layer groups, and
  the edge leaves (``embed``, ``final_norm``, ``lm_head``) stream through
  the same store;
- the forward sweep walks the groups under ``torch.no_grad()`` while a
  host thread pages group g+1 off the store, keeping only the group
  boundaries' activations;
- the head's loss gives ``dy``; the backward sweep recomputes each group
  under autograd from its boundary, in reverse (rematerialization, through
  the flash kernels' ``autograd.Function`` on the card), and each group's
  gradients feed the C++ host Adam (``ops/cpu_adam.py``) on the prefetch
  thread while the device computes the next group;
- gradient accumulation adds into store-backed ``acc.*`` buffers.

The device therefore holds about two groups, the edges and the boundary
activations, whatever the depth. As in the JAX engine, the scheduler,
``gradient_clipping``, loss scaling and the precision block are not
applied: the lr is the optimizer's, constant, and the model computes in its
config's ``dtype``.
"""

from __future__ import annotations

import collections
import concurrent.futures
import math
import os
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .. import not_ported, resolve_device
from ..models.transformer import CausalLM, _norm, _weight
from ..ops.cpu_adam import DeepSpeedCPUAdam
from ..utils.logging import logger
from .checkpointing import param_template
from .swap_tensor.async_swapper import AsyncTensorSwapper


class _HostStore:
    """Per-group param and moment store: files through the aio swapper
    (``device == "nvme"``), or host arrays. Its counters show the
    streaming: reads, writes, flushes and bytes read."""

    def __init__(self, device: str, nvme_path: Optional[str], n_threads: int):
        self.device = device
        self.reads = 0
        self.writes = 0
        self.flushes = 0
        self.bytes_read = 0
        self.read_keys: set = set()
        self._mem: Dict[str, np.ndarray] = {}
        self._shapes: Dict[str, tuple] = {}
        # in-flight writes: (key, buffer) pairs kept alive until flush(),
        # since the aio engine writes from the caller's memory
        self._pending: List[tuple] = []
        self.swapper = None
        self._read_swapper = None
        if device == "nvme":
            if not nvme_path:
                raise ValueError("offload_param.nvme_path required for NVMe")
            self.swapper = AsyncTensorSwapper(nvme_path)
            # reads get a handle of their own: a read's wait() on the
            # shared handle would also drain every in-flight write
            self._read_swapper = AsyncTensorSwapper(nvme_path)

    def put(self, key: str, arr: np.ndarray, owned: bool = False):
        """Queue one array for its file (async; the one wait is at the next
        :meth:`flush`), or keep it in host RAM: a copy, unless the caller
        hands the array over (``owned``) or ``arr`` is the memory the store
        already holds for ``key`` (a master or moment updated in place),
        where a copy would change nothing. ``arr`` must not change until
        the next flush."""
        self.writes += 1
        if self.swapper is not None:
            self._shapes[key] = (arr.shape, arr.dtype)
            buf = np.ascontiguousarray(arr)
            self.swapper.swap_out(key, buf)
            self._pending.append((key, buf))
            return
        held = self._mem.get(key)
        if held is not None and arr.flags.c_contiguous \
                and arr.shape == held.shape and arr.dtype == held.dtype \
                and arr.ctypes.data == held.ctypes.data:
            return
        self._mem[key] = arr if owned else np.array(arr, copy=True)

    def flush(self):
        """Group-boundary barrier: one ``wait()`` for every queued write,
        then the kept-alive buffers go."""
        self.flushes += 1
        if self.swapper is not None and self._pending:
            self.swapper.wait()
        self._pending.clear()

    def get(self, key: str, out: Optional[np.ndarray] = None) -> np.ndarray:
        self.reads += 1
        self.read_keys.add(key)
        if self.swapper is not None:
            if any(k == key for k, _ in self._pending):
                # read after write: the file must be whole before the read
                self.flush()
            shape, dtype = self._shapes[key]
            buf = out if out is not None and out.shape == shape \
                else np.empty(shape, dtype)
            self._read_swapper.swap_in(key, buf)
            self._read_swapper.wait()
            self.bytes_read += buf.nbytes
            return buf
        arr = self._mem[key]
        self.bytes_read += arr.nbytes
        return arr

    def close(self):
        if self.swapper is not None:
            self.flush()
            self.swapper.close()
        if self._read_swapper is not None:
            self._read_swapper.close()


def _init_leaf(name: str, shape, seed: np.random.SeedSequence) -> np.ndarray:
    """The JAX engine's host init families: norm weights 1, biases 0,
    everything else (``lm_head.w`` too) N(0, 0.02) from the leaf's own
    child seed."""
    rng = np.random.default_rng(seed)
    if name.endswith("norm_w") or name == "final_norm.w":
        return np.ones(shape, np.float32)
    if name.endswith("_b") or name == "final_norm.b":
        return np.zeros(shape, np.float32)
    return (0.02 * rng.standard_normal(shape)).astype(np.float32)


def _mean(g: np.ndarray, gas: int) -> np.ndarray:
    """The accumulated gradient over ``gas`` micro steps (``g / 1`` is
    ``g`` to the bit, so one micro step allocates nothing)."""
    return g if gas == 1 else g / gas


def _draw_leaves(specs, workers: int):
    """``_init_leaf`` over ``specs`` ((name, shape, seed) each) on
    ``workers`` threads, yielded in order, at most ``workers`` ahead (numpy
    draws without the GIL; each leaf has its own seed, so the order of the
    draws does not change their bits)."""
    with concurrent.futures.ThreadPoolExecutor(workers) as ex:
        ahead = collections.deque()
        for spec in specs:
            ahead.append(ex.submit(_init_leaf, *spec))
            if len(ahead) > workers:
                yield ahead.popleft().result()
        while ahead:
            yield ahead.popleft().result()


class ZeroInfinityEngine:
    """Streaming trainer for a ``CausalLM`` whose params exceed device
    memory, on one device.

    ``train_batch(batch_or_iterator) -> float`` takes
    ``gradient_accumulation_steps`` micro batches (an iterator when there
    is more than one) and one host Adam update of their mean gradient;
    ``get_lr``, ``gather_edges``, ``streaming_report``, ``close``. The
    model must have untied embeddings, one sliding window for every layer,
    no ``lm_head`` bias and no embedding LayerNorm. Runs on ``cuda`` unless
    ``device="cpu"``.
    """

    def __init__(self, model: CausalLM, config, rng=None,
                 group_layers: Optional[int] = None, mesh=None,
                 device=None):
        if model.cfg.moe_num_experts > 0:
            raise not_ported("MoE under ZeRO-Infinity streaming (its group "
                             "program carries no aux loss)",
                             "queue 1 item 14d-ii")
        if model.cfg.tie_embeddings:
            raise ValueError("ZeRO-Infinity streaming requires "
                             "tie_embeddings=False (wte would need to be "
                             "resident for both embed and head groups)")
        if len(model.cfg.window_segments()) > 1:
            raise ValueError(
                "ZeRO-Infinity streaming requires a uniform sliding_window: "
                "every layer group runs the one group program, so a mixed "
                "per-layer window schedule cannot be followed")
        if model.cfg.embedding_layernorm:
            raise ValueError(
                "ZeRO-Infinity streaming does not apply embedding_layernorm "
                "(BLOOM family); loading such a model would silently skip "
                "the norm")
        if model.cfg.lm_head_bias:
            raise ValueError(
                "ZeRO-Infinity streaming's head program carries no lm_head "
                "bias; rejecting rather than silently dropping it")
        if mesh is not None:
            raise not_ported("ZeRO-Infinity streaming over a device mesh",
                             "queue 1 item 14")
        config.raise_if_not_ported()
        self.device = resolve_device(device)
        self.module = model
        self.cfg = model.cfg
        self.config = config
        oc = config.zero_optimization.offload_param
        opt_cfg = config.optimizer
        kwargs = dict(opt_cfg.params if opt_cfg else {"lr": 1e-3})
        kwargs.pop("torch_adam", None)
        self.cpu_opt = DeepSpeedCPUAdam(adamw_mode=True, **kwargs)
        self.lr = float(kwargs.get("lr", 1e-3))
        self.store = _HostStore(oc.device.value, oc.nvme_path,
                                config.aio.thread_count)

        L = self.cfg.num_layers
        self.group_layers = group_layers or max(1, math.ceil(L / 4))
        self.groups: List[slice] = [
            slice(lo, min(lo + self.group_layers, L))
            for lo in range(0, L, self.group_layers)]

        # host init, leaf by leaf, in the JAX engine's order (groups x
        # sorted layer keys, then the edges), each leaf from the next child
        # of the config seed's SeedSequence: the same bits as that engine
        shapes = param_template(model)
        seedseq = np.random.SeedSequence(int(config.seed))
        self._layer_keys = sorted(shapes["layers"].keys())
        specs = []      # (store base key, init name, shape)
        for gi, sl in enumerate(self.groups):
            for k in self._layer_keys:
                shape = (sl.stop - sl.start,) + tuple(
                    shapes["layers"][k].shape[1:])
                specs.append((f"layers.{k}.g{gi}", f"layers.{k}", shape))
        self._edge_keys: Dict[str, List[str]] = {}
        for grp in ("embed", "final_norm", "lm_head"):
            if grp not in shapes:
                continue
            self._edge_keys[grp] = sorted(shapes[grp].keys())
            for k in self._edge_keys[grp]:
                specs.append((self._edge_key(grp, k), f"{grp}.{k}",
                              tuple(shapes[grp][k].shape)))
        self.param_bytes = 0
        self._edge_bytes = 0
        draws = _draw_leaves(
            [(name, shape, seedseq.spawn(1)[0]) for _, name, shape in specs],
            max(1, min(8, os.cpu_count() or 1)))
        for (key, name, _), arr in zip(specs, draws):
            self.store.put(key, arr, owned=True)
            self.store.put(f"opt_m.{key}", np.zeros_like(arr), owned=True)
            self.store.put(f"opt_v.{key}", np.zeros_like(arr), owned=True)
            self.param_bytes += arr.nbytes
            if not name.startswith("layers."):
                self._edge_bytes += arr.nbytes
            # a flush a leaf: the queued writes must not pin the params and
            # both moments of every leaf in host RAM at once
            self.store.flush()
            del arr
        self.store.flush()
        self.opt_step = 0
        self.global_steps = 0
        self._prefetch = concurrent.futures.ThreadPoolExecutor(
            1, thread_name_prefix="zero-infinity-prefetch")
        logger.info(
            f"ZeRO-Infinity: {len(self.groups)} groups x {self.group_layers} "
            f"layers, params {self.param_bytes / 1e6:.1f} MB on "
            f"{self.store.device}")

    # ------------------------------------------------------------ programs
    def _group_fwd(self, gp, x, cos, sin):
        """One layer group: ``model._block`` over its layers in order."""
        window = self.cfg.layer_windows()[0]
        layers = {k: v.unbind(0) for k, v in gp.items()}
        for j in range(len(next(iter(layers.values())))):
            x, _ = self.module._block(
                x, {k: v[j] for k, v in layers.items()}, cos, sin, window)
        return x

    def _embed_fwd(self, ep, tokens, positions):
        x = ep["wte"][tokens].to(self.cfg.dtype)
        if self.cfg.position == "learned":
            x = x + ep["wpe"][positions].to(self.cfg.dtype)
        return x

    def _head_loss(self, hp, x, labels):
        cfg = self.cfg
        h = _norm(x, hp["w"], hp.get("b"), cfg.norm, cfg.norm_eps)
        logits = (h @ _weight(hp["lm_head_w"], cfg.dtype)).float()
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels[..., None])[..., 0]
        return torch.mean(logz - gold)

    @staticmethod
    def _grads_of(fn, leaves: Dict[str, torch.Tensor], *args, seed=None):
        """``fn(leaves, *args)`` under autograd with fresh grad-requiring
        copies of ``leaves`` (views, no data copies); returns its output and
        the gradients of ``seed``-weighted output (the output's own when
        ``seed`` is None) in the leaves' order, zeros for unused leaves."""
        live = {k: v.detach().requires_grad_() for k, v in leaves.items()}
        with torch.enable_grad():
            out = fn(live, *args)
            grads = torch.autograd.grad(out, list(live.values()),
                                        grad_outputs=seed, allow_unused=True)
        return out.detach(), [torch.zeros_like(v) if g is None else g
                              for v, g in zip(live.values(), grads)]

    def _group_bwd(self, gp, x, cos, sin, dy):
        """(gradients of the group's leaves, gradient of its input): the
        group recomputed from its boundary ``x`` under autograd."""
        leaves = dict(gp, __x__=x)
        _, grads = self._grads_of(
            lambda lv: self._group_fwd(
                {k: v for k, v in lv.items() if k != "__x__"}, lv["__x__"],
                cos, sin),
            leaves, seed=dy)
        return dict(zip(gp, grads[:-1])), grads[-1]

    def _head_grad(self, hp, x, labels):
        loss, grads = self._grads_of(
            lambda lv: self._head_loss(lv, lv["__x__"], labels),
            dict(hp, __x__=x))
        return loss, dict(zip(hp, grads[:-1])), grads[-1]

    def _embed_bwd(self, ep, tokens, positions, dy):
        _, grads = self._grads_of(
            lambda lv: self._embed_fwd(lv, tokens, positions), ep, seed=dy)
        return dict(zip(ep, grads))

    # ------------------------------------------------------------- streaming
    def _key(self, k: str, gi: int) -> str:
        return f"layers.{k}.g{gi}"

    @staticmethod
    def _edge_key(grp: str, k: str) -> str:
        return f"edge.{grp}.{k}"

    def _load_group(self, gi: int) -> Dict[str, np.ndarray]:
        """Page one group's masters off the store."""
        return {k: self.store.get(self._key(k, gi)) for k in self._layer_keys}

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        # a copy even on the CPU: the host arrays are updated in place
        return torch.from_numpy(arr).to(self.device, copy=True)

    def _load_edges(self) -> Dict[str, Dict[str, np.ndarray]]:
        return {grp: {k: self.store.get(self._edge_key(grp, k)) for k in ks}
                for grp, ks in self._edge_keys.items()}

    @staticmethod
    def _to_host(grads: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
        return {k: g.detach().to("cpu", torch.float32).numpy()
                for k, g in grads.items()}

    def _acc_shard(self, key: str, g: np.ndarray, micro: int,
                   last: bool) -> Optional[np.ndarray]:
        """Gradient accumulation for one leaf: add into the store-backed
        ``acc.{key}`` on a non-final micro step (it pages through the same
        store as the masters, so host RAM holds no second model copy);
        the summed gradient on the final one."""
        if micro > 0:
            g = g + self.store.get(f"acc.{key}")
        if not last:
            self.store.put(f"acc.{key}", g)
            return None
        return g

    def _opt_shard(self, key: str, master_arr: np.ndarray, g: np.ndarray):
        """The C++ host Adam on one master leaf; page it back out."""
        master = master_arr.reshape(-1)
        m = self.store.get(f"opt_m.{key}").reshape(-1)
        v = self.store.get(f"opt_v.{key}").reshape(-1)
        # the bias-correction counter comes from the engine's step: every
        # leaf advances once a step
        st = {"m": m, "v": v,
              "step": np.asarray([self.opt_step - 1], np.float32)}
        self.cpu_opt.step(master, np.ascontiguousarray(g.reshape(-1)), st,
                          lr=self.lr)
        self.store.put(key, master_arr)
        self.store.put(f"opt_m.{key}", m.reshape(master_arr.shape))
        self.store.put(f"opt_v.{key}", v.reshape(master_arr.shape))

    def _update_group(self, gi: int, host_group, grads, micro: int,
                      gas: int):
        """Accumulate or apply one group's gradients (the final micro step
        feeds the mean over ``gas`` micro batches to the host Adam)."""
        last = micro == gas - 1
        for k in self._layer_keys:
            key = self._key(k, gi)
            g = self._acc_shard(key, grads[k], micro, last)
            if g is not None:
                self._opt_shard(key, host_group[k], _mean(g, gas))
        # group boundary: one wait for the group's queued writes
        self.store.flush()

    def _update_edges(self, host_edges, edge_grads, micro: int, gas: int):
        last = micro == gas - 1
        for grp, per_leaf in edge_grads.items():
            for k, g in per_leaf.items():
                key = self._edge_key(grp, k)
                g = self._acc_shard(key, g, micro, last)
                if g is not None:
                    self._opt_shard(key, host_edges[grp][k], _mean(g, gas))
        self.store.flush()

    # ------------------------------------------------------------------ step
    def train_batch(self, batch) -> float:
        """One effective batch: ``gradient_accumulation_steps`` micro steps
        (each a streamed forward and backward sweep, gradients accumulating
        in the store) and one host Adam update on their mean gradient.
        Returns the mean micro loss."""
        gas = int(getattr(self.config, "gradient_accumulation_steps", 1)
                  or 1)
        it = batch if hasattr(batch, "__next__") else None
        if it is None and not isinstance(batch, dict):
            # a fresh iter() each call would replay element 0
            raise TypeError(
                "train_batch expects a batch dict or an iterator; wrap "
                "lists/datasets in iter(...) so consumption is stateful")
        if gas > 1 and it is None:
            raise TypeError(
                f"gradient_accumulation_steps={gas} needs an iterator of "
                "micro batches, not a single batch dict")
        micro_batches = []
        for _ in range(gas):
            if it is None:
                micro_batches.append(batch)
                continue
            try:
                micro_batches.append(next(it))
            except StopIteration:
                # fail before any state changes
                raise ValueError(
                    f"micro-batch iterator exhausted after "
                    f"{len(micro_batches)} of {gas} accumulation steps"
                    ) from None
        self.opt_step += 1
        # the edges are read once an effective batch: they change only at
        # the final micro step's update
        host_edges = self._load_edges()
        edges_dev = {grp: {k: self._to_device(a) for k, a in d.items()}
                     for grp, d in host_edges.items()}
        losses = [self._micro_step(mb, host_edges, edges_dev, micro, gas)
                  for micro, mb in enumerate(micro_batches)]
        self.global_steps += 1
        return float(np.mean(losses))

    def _micro_step(self, data, host_edges, edges_dev, micro: int,
                    gas: int) -> float:
        host_tokens = np.asarray(data["input_ids"])
        tokens = torch.as_tensor(host_tokens[:, :-1].astype(np.int64),
                                 device=self.device)
        labels = torch.as_tensor(host_tokens[:, 1:].astype(np.int64),
                                 device=self.device)
        T = tokens.shape[1]
        positions = torch.arange(T, device=self.device)
        cos, sin = self.module._pos_tables(T, None, self.device)
        n = len(self.groups)

        # forward sweep: group g+1 pages in while group g runs
        with torch.no_grad():
            x = self._embed_fwd(edges_dev["embed"], tokens, positions)
            boundary = [x]
            fut = self._prefetch.submit(self._load_group, 0)
            for gi in range(n):
                host_group = fut.result()
                if gi + 1 < n:
                    fut = self._prefetch.submit(self._load_group, gi + 1)
                gp = {k: self._to_device(a) for k, a in host_group.items()}
                x = self._group_fwd(gp, x, cos, sin)
                boundary.append(x)
                del gp

        # head loss and the backward seed
        hp = dict(edges_dev["final_norm"],
                  lm_head_w=edges_dev["lm_head"]["w"])
        loss, dhp, dx = self._head_grad(hp, boundary[-1], labels)

        # backward sweep: each group recomputed; its host update overlaps
        # the next group's compute
        fut = self._prefetch.submit(self._load_group, n - 1)
        pending = None
        for gi in reversed(range(n)):
            host_group = fut.result()
            if gi - 1 >= 0:
                fut = self._prefetch.submit(self._load_group, gi - 1)
            gp = {k: self._to_device(a) for k, a in host_group.items()}
            dgp, dx = self._group_bwd(gp, boundary[gi], cos, sin, dx)
            dgp_host = self._to_host(dgp)
            if pending is not None:
                pending.result()
            pending = self._prefetch.submit(
                self._update_group, gi, host_group, dgp_host, micro, gas)
            del gp, dgp
        if pending is not None:
            pending.result()

        # the edges' gradients: accumulate, or the host update
        d_embed = self._embed_bwd(edges_dev["embed"], tokens, positions, dx)
        edge_grads = {
            "embed": self._to_host(d_embed),
            "final_norm": self._to_host(
                {k: v for k, v in dhp.items() if k != "lm_head_w"}),
            "lm_head": self._to_host({"w": dhp["lm_head_w"]}),
        }
        self._update_edges(host_edges, edge_grads, micro, gas)
        return float(loss)

    def get_lr(self):
        return [self.lr]

    def gather_edges(self) -> Dict[str, Dict[str, np.ndarray]]:
        """The edge leaves as the store holds them (paged like a step's
        reads)."""
        return {grp: {k: self.store.get(self._edge_key(grp, k)) for k in ks}
                for grp, ks in self._edge_keys.items()}

    def gather_params(self) -> Dict[str, Any]:
        """The whole param tree from the store as host arrays: the layer
        groups concatenated along the layer axis, and the edges."""
        layers = {k: np.concatenate([self.store.get(self._key(k, gi))
                                     for gi in range(len(self.groups))])
                  for k in self._layer_keys}
        return dict(self.gather_edges(), layers=layers)

    def streaming_report(self) -> Dict[str, Any]:
        """Paging volume and I/O counters beside the expected bytes a step,
        and the recompute factor of the grouped backward."""
        steps = max(self.global_steps, 1)
        gas = int(getattr(self.config, "gradient_accumulation_steps", 1)
                  or 1)
        layer_bytes = self.param_bytes - self._edge_bytes
        # layer groups: params forward and backward each micro step (2
        # gas), moments at the update (2), accumulator reads on micro steps
        # after the first (gas - 1); edges: params once a batch (1),
        # moments (2), accumulator reads (gas - 1)
        expected = (layer_bytes * (3 * gas + 1)
                    + self._edge_bytes * (gas + 2))
        return {
            "param_bytes": self.param_bytes,
            "edge_bytes": self._edge_bytes,
            "gradient_accumulation_steps": gas,
            "groups": len(self.groups),
            "fsdp": 1,
            "data": 1,
            "store_device": self.store.device,
            "bytes_read_total": self.store.bytes_read,
            "bytes_read_per_step": self.store.bytes_read // steps,
            "expected_bytes_per_step": expected,
            "reads_per_step": self.store.reads // steps,
            # each group's forward runs twice: about 8ND a step, not 6ND
            "recompute_flops_factor": 8 / 6,
        }

    def close(self):
        self._prefetch.shutdown(wait=True)
        self.store.close()
