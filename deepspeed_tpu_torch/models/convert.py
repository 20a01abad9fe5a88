"""HF checkpoint import: pretrained weights -> the port's param tree.

Counterpart of ``deepspeed_tpu/models/convert.py``. Each target leaf of a
``CausalLM`` (or ``EncoderLM``) param tree gets a *leaf plan*: a function
from an index (a tuple of slices of the target leaf) to the block of the HF
tensor(s) that belongs there. The families, the leaf plans, the config
mapping and every refusal are the JAX package's, leaf for leaf.

What differs is below the plans:

- The readers return host **torch tensors** and need neither the
  ``safetensors`` package nor ``ml_dtypes``: a ``*.safetensors`` file is an
  8-byte little-endian header length, a JSON header (``dtype``, ``shape``,
  ``data_offsets``, ``__metadata__``) and raw little-endian data, parsed
  here with the standard library and read with ``os.preadv``. A read with
  an index pulls only the byte range of the rows its dim-0 slice covers and
  slices the other dims in memory. ``pytorch_model*.bin`` shards go through
  ``torch.load(mmap=True, weights_only=True)``. Each reader counts the
  bytes it pulls off disk (``bytes_read``, ``bytes_by_name``).
- :func:`load_hf_checkpoint` writes each leaf straight into a tensor of
  ``param_dtype`` on ``device`` (a stacked leaf one layer at a time), so
  the whole model is never held on the host. With a ``topology`` a rank
  reads only its block (``parallel/sharding.py::local_slice``), the
  counterpart of the JAX package's ``jax.make_array_from_callback`` per
  addressable shard; ``cut`` lets a caller read a wider block and make the
  leaf from it (v1's quantized cut, ``inference/quantization.py``).
- Target shapes come from ``model.init(..., device="meta")``, the
  counterpart of ``jax.eval_shape``.

Supported families: Llama/Llama-2, Mistral, InternLM (Llama + biased
attention), Qwen2 (qkv bias, mixed full/SWA schedules), StableLM, GPT-2,
GPT-Neo, OPT, GPT-NeoX, GPT-J, Phi, BLOOM and Falcon (7B MQA, 40B grouped
QKV, RW per-head QKV with ALiBi); BERT, RoBERTa and DistilBERT load as
``EncoderLM`` (``models/encoder.py``).
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch

from .. import resolve_device
from ..parallel.sharding import ZeroShardingPlan, local_slice
from .transformer import CausalLM, TransformerConfig

Index = Tuple[slice, ...]


# ------------------------------------------------------------------- readers

# safetensors dtype names -> torch dtypes (every one that torch has)
SAFETENSORS_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool, "F8_E4M3": torch.float8_e4m3fn,
    "F8_E5M2": torch.float8_e5m2,
}


class CheckpointReader:
    """name -> lazily sliceable tensor, across sharded checkpoint files.
    ``bytes_read`` counts the bytes pulled off disk (``bytes_by_name`` by
    tensor)."""

    def __init__(self):
        self.bytes_read = 0
        self.bytes_by_name: Dict[str, int] = {}

    def _count(self, name: str, n: int) -> None:
        self.bytes_read += n
        self.bytes_by_name[name] = self.bytes_by_name.get(name, 0) + n

    def names(self) -> Sequence[str]:
        raise NotImplementedError

    def read(self, name: str, index: Optional[Index] = None) -> torch.Tensor:
        raise NotImplementedError

    def shape(self, name: str) -> Tuple[int, ...]:
        raise NotImplementedError

    def close(self) -> None:
        pass


def _rows(index: Optional[Index], shape: Tuple[int, ...]) -> Tuple[int, int]:
    """The dim-0 span [a, b) an index covers."""
    if index is None or not index or not shape:
        return 0, (shape[0] if shape else 1)
    a, b, step = index[0].indices(shape[0])
    if step != 1:
        raise ValueError(f"strided checkpoint slice unsupported: {index[0]}")
    return a, max(a, b)


def _weight_map(path: str, index_name: str) -> Optional[Dict[str, str]]:
    index_file = os.path.join(path, index_name)
    if not os.path.exists(index_file):
        return None
    with open(index_file) as f:
        return {name: os.path.join(path, fname)
                for name, fname in json.load(f)["weight_map"].items()}


def read_safetensors_header(fname: str) -> Tuple[int, Dict[str, Any]]:
    """(offset of the data section, the JSON header) of one file."""
    with open(fname, "rb") as f:
        raw = f.read(8)
        if len(raw) != 8:
            raise ValueError(f"{fname}: not a safetensors file (no header)")
        n = int.from_bytes(raw, "little")
        header = json.loads(f.read(n))
    return 8 + n, header


class SafetensorsReader(CheckpointReader):
    """Reads ``*.safetensors`` (single file or index-sharded) with the
    standard library and torch. ``read`` with an index reads only the bytes
    of the rows its dim-0 slice covers."""

    def __init__(self, path: str):
        super().__init__()
        self._entries: Dict[str, Tuple[str, int, str, Tuple[int, ...],
                                       int, int]] = {}
        self._fds: Dict[str, int] = {}
        weight_map = _weight_map(path, "model.safetensors.index.json")
        if weight_map is not None:
            files = sorted(set(weight_map.values()))
        else:
            files = sorted(os.path.join(path, f) for f in os.listdir(path)
                           if f.endswith(".safetensors"))
            if not files:
                raise FileNotFoundError(f"no .safetensors under {path}")
        for fname in files:
            start, header = read_safetensors_header(fname)
            for name, e in header.items():
                if name == "__metadata__":
                    continue
                if weight_map is not None and weight_map.get(name) != fname:
                    continue
                if e["dtype"] not in SAFETENSORS_DTYPES:
                    raise ValueError(f"{fname}: {name} has dtype "
                                     f"{e['dtype']!r}, which torch lacks")
                shape = tuple(int(d) for d in e["shape"])
                begin, end = (int(o) for o in e["data_offsets"])
                item = torch.empty((), dtype=SAFETENSORS_DTYPES[e["dtype"]]
                                   ).element_size()
                if end - begin != math.prod(shape) * item:
                    raise ValueError(
                        f"{fname}: {name} holds {end - begin} bytes for "
                        f"shape {shape} of {e['dtype']}")
                self._entries[name] = (fname, start, e["dtype"], shape,
                                       begin, end)
        if weight_map is not None:
            lost = sorted(set(weight_map) - set(self._entries))
            if lost:
                raise ValueError(f"index names tensors its files lack: "
                                 f"{lost[:8]}")

    def _fd(self, fname: str) -> int:
        if fname not in self._fds:
            self._fds[fname] = os.open(fname, os.O_RDONLY)
        return self._fds[fname]

    def _entry(self, name: str):
        try:
            return self._entries[name]
        except KeyError:
            raise KeyError(f"tensor {name!r} is not in the checkpoint") \
                from None

    def names(self):
        return list(self._entries)

    def shape(self, name):
        return self._entry(name)[3]

    def read(self, name, index=None):
        fname, start, dt, shape, begin, _ = self._entry(name)
        dtype = SAFETENSORS_DTYPES[dt]
        a, b = _rows(index, shape)
        row = math.prod(shape[1:]) * torch.empty((), dtype=dtype
                                                 ).element_size()
        n = (b - a) * row
        out_shape = ((b - a),) + shape[1:] if shape else ()
        raw = torch.empty(n, dtype=torch.uint8)
        view, fd, off, got = memoryview(raw.numpy()), self._fd(fname), \
            start + begin + a * row, 0
        while got < n:              # preadv may return fewer bytes
            k = os.preadv(fd, [view[got:]], off + got)
            if k <= 0:
                raise OSError(f"{fname}: short read of {name}")
            got += k
        self._count(name, n)
        t = raw.view(dtype).reshape(out_shape)
        if index is not None and len(index) > 1:
            t = t[(slice(None),) + tuple(index[1:])]
        return t

    def close(self):
        for fd in self._fds.values():
            os.close(fd)
        self._fds.clear()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class TorchShardReader(CheckpointReader):
    """Reads ``pytorch_model*.bin`` torch shards via ``torch.load(mmap=True,
    weights_only=True)``: tensors stay memory-mapped until sliced, so only
    touched pages are read. ``bytes_read`` counts the bytes of the rows a
    read touches."""

    def __init__(self, path: str):
        super().__init__()
        weight_map = _weight_map(path, "pytorch_model.bin.index.json")
        if weight_map is not None:
            self._name_to_file = weight_map
        else:
            files = sorted(f for f in os.listdir(path)
                           if f.startswith("pytorch_model")
                           and f.endswith(".bin"))
            if not files:
                raise FileNotFoundError(f"no pytorch_model*.bin under {path}")
            self._name_to_file = {}
            for fname in files:
                full = os.path.join(path, fname)
                for name in self._load(full):
                    self._name_to_file[name] = full
        self._shards: Dict[str, Dict[str, Any]] = {}

    @staticmethod
    def _load(fname):
        return torch.load(fname, map_location="cpu", mmap=True,
                          weights_only=True)

    def _tensor(self, name: str):
        try:
            fname = self._name_to_file[name]
        except KeyError:
            raise KeyError(f"tensor {name!r} is not in the checkpoint") \
                from None
        if fname not in self._shards:
            self._shards[fname] = self._load(fname)
        return self._shards[fname][name]

    def names(self):
        return list(self._name_to_file)

    def shape(self, name):
        return tuple(self._tensor(name).shape)

    def read(self, name, index=None):
        t = self._tensor(name)
        a, b = _rows(index, tuple(t.shape))
        self._count(name, (b - a) * math.prod(t.shape[1:]) * t.element_size())
        return t if index is None else t[tuple(index)]

    def close(self):
        self._shards.clear()


def open_checkpoint(path: str) -> CheckpointReader:
    entries = os.listdir(path)
    if any(e.endswith(".safetensors") for e in entries):
        return SafetensorsReader(path)
    return TorchShardReader(path)


# ----------------------------------------------------------------- leaf plans
# A leaf plan answers "give me target_leaf[index]" by reading (a slice of)
# the HF tensor(s) that feed the leaf.

@dataclasses.dataclass(frozen=True)
class Src:
    """One HF tensor feeding (part of) a target leaf.

    ``transpose``: torch ``nn.Linear`` stores [out, in]; the params are
    [in, out] (GPT-2's Conv1D is already [in, out]: no transpose there).
    ``offset``: per-target-dim offset into the source, for fused source
    tensors split across several leaves (GPT-2 ``c_attn`` -> wq/wk/wv).
    """
    name: str
    transpose: bool = False
    offset: Tuple[int, ...] = ()

    def read(self, reader: CheckpointReader, index: Index) -> torch.Tensor:
        if self.offset:
            index = tuple(slice(s.start + o, s.stop + o)
                          for s, o in zip(index, self.offset))
        if self.transpose:
            index = (index[1], index[0])
        block = reader.read(self.name, index)
        return block.T if self.transpose else block

    def source_shape(self, shape: Tuple[int, ...]
                     ) -> Optional[Tuple[int, ...]]:
        """The HF tensor's shape a target of ``shape`` implies (None where
        an offset makes the source larger than the target)."""
        if self.offset:
            return None
        return tuple(reversed(shape)) if self.transpose else tuple(shape)


def _concrete(index: Index, shape: Tuple[int, ...]) -> Index:
    out = []
    for s, dim in zip(index, shape):
        start, stop, step = s.indices(dim)
        assert step == 1, f"strided checkpoint slice unsupported: {s}"
        out.append(slice(start, stop))
    return tuple(out)


def _check_source(src, reader: CheckpointReader, shape, key: str) -> None:
    want = src.source_shape(shape) if isinstance(src, Src) else None
    if want is None:
        return
    got = tuple(reader.shape(src.name))
    if got != want:
        raise ValueError(f"shape mismatch at {key}: model wants "
                         f"{tuple(shape)}, checkpoint provides "
                         f"{tuple(reversed(got)) if src.transpose else got} "
                         f"({src.name})")


def _to_device(block: torch.Tensor, device) -> torch.Tensor:
    """A host block on ``device``; a transposed view crosses as its
    contiguous base and is transposed there."""
    if block.device == torch.device(device):
        return block
    if block.dim() == 2 and not block.is_contiguous() \
            and block.T.is_contiguous():
        return block.T.to(device).T
    return block.to(device)


def _fill(out: torch.Tensor, block: torch.Tensor, key: str) -> None:
    if tuple(block.shape) != tuple(out.shape):
        raise ValueError(f"shape mismatch at {key}: model wants "
                         f"{tuple(out.shape)}, checkpoint provides "
                         f"{tuple(block.shape)}")
    out.copy_(_to_device(block, out.device))


class LeafPlan:
    """Plain (non-stacked) leaf backed by one Src."""

    def __init__(self, src: Src, shape: Tuple[int, ...]):
        self.src, self.shape = src, tuple(shape)

    def read(self, reader: CheckpointReader, index: Index) -> torch.Tensor:
        return self.src.read(reader, _concrete(index, self.shape))

    def check(self, reader: CheckpointReader, key: str) -> None:
        _check_source(self.src, reader, self.shape, key)

    def read_into(self, reader: CheckpointReader, index: Index,
                  out: torch.Tensor, key: str = "") -> None:
        _fill(out, self.read(reader, index), key)


class StackedLeafPlan:
    """Stacked-layers leaf [L, ...]: dim 0 indexes the layer, each layer
    slice comes from a per-layer Src (``make(i)``)."""

    def __init__(self, make: Callable[[int], Any], shape: Tuple[int, ...]):
        self.make, self.shape = make, tuple(shape)

    def check(self, reader: CheckpointReader, key: str) -> None:
        for i in range(self.shape[0]):
            _check_source(self.make(i), reader, self.shape[1:], key)

    def read_into(self, reader: CheckpointReader, index: Index,
                  out: torch.Tensor, key: str = "") -> None:
        """One layer at a time into ``out``: the host holds one layer's
        block at most."""
        index = _concrete(index, self.shape)
        lsl, rest = index[0], index[1:]
        if out.shape[0] != lsl.stop - lsl.start:
            raise ValueError(f"shape mismatch at {key}: model wants "
                             f"{tuple(out.shape)} layers")
        for j, i in enumerate(range(lsl.start, lsl.stop)):
            _fill(out[j], self.make(i).read(reader, rest), key)


@dataclasses.dataclass(frozen=True)
class FusedQKVSrc:
    """q/k/v extracted from an *interleaved* fused QKV tensor: GPT-NeoX/
    BLOOM pack [heads, 3, head_dim] in dim 0, Falcon-40B packs per KV group
    [groups, q_per_group+2, head_dim]. Target slices are piecewise-affine
    in source rows, so each target block maps to a short list of contiguous
    source row ranges: only those bytes are read."""
    name: str
    which: str            # "q" | "k" | "v"
    groups: int
    q_per_group: int
    hd: int

    def _src_ranges(self, a: int, b: int):
        """Source row ranges covering target out-rows [a, b)."""
        sel_off = {"q": 0, "k": self.q_per_group,
                   "v": self.q_per_group + 1}[self.which]
        sel_w = (self.q_per_group if self.which == "q" else 1) * self.hd
        P = self.q_per_group + 2
        out = []
        o = a
        while o < b:
            g, within = divmod(o, sel_w)
            take = min(b - o, sel_w - within)
            src0 = g * P * self.hd + sel_off * self.hd + within
            out.append((src0, src0 + take))
            o += take
        return out

    def read(self, reader: CheckpointReader, index: Index) -> torch.Tensor:
        if len(index) == 1:    # bias: target [heads·hd]
            (osl,) = index
            parts = [reader.read(self.name, (slice(s, e),))
                     for s, e in self._src_ranges(osl.start, osl.stop)]
            return torch.cat(parts, dim=0)
        # weight: target [h_in, heads·hd]; source stores [rows, h_in]
        in_sl, out_sl = index
        parts = [reader.read(self.name, (slice(s, e), in_sl))
                 for s, e in self._src_ranges(out_sl.start, out_sl.stop)]
        return torch.cat(parts, dim=0).T


# ------------------------------------------------------------ family mappings

def _llama_plans(cfg: TransformerConfig, shapes,
                 hf_config=None) -> Dict[str, Any]:
    """HF LlamaForCausalLM / MistralForCausalLM naming -> CausalLM leaves."""
    L = "model.layers.{}."

    def lsrc(fmt: str, transpose=True):
        return lambda i: Src((L + fmt).format(i), transpose=transpose)

    layers = {
        "attn_norm_w": lsrc("input_layernorm.weight", transpose=False),
        "wq": lsrc("self_attn.q_proj.weight"),
        "wk": lsrc("self_attn.k_proj.weight"),
        "wv": lsrc("self_attn.v_proj.weight"),
        "wo": lsrc("self_attn.o_proj.weight"),
        "w_gate": lsrc("mlp.gate_proj.weight"),
        "w_in": lsrc("mlp.up_proj.weight"),
        "w_out": lsrc("mlp.down_proj.weight"),
    }
    if not cfg.shared_layernorm:   # StableLM parallel residual drops ln_2
        layers["mlp_norm_w"] = lsrc("post_attention_layernorm.weight",
                                    transpose=False)
    if cfg.use_bias or cfg.qkv_bias:
        # Qwen2 qkv_bias / Llama attention_bias / InternLM "bias"
        layers["wq_b"] = lsrc("self_attn.q_proj.bias", transpose=False)
        layers["wk_b"] = lsrc("self_attn.k_proj.bias", transpose=False)
        layers["wv_b"] = lsrc("self_attn.v_proj.bias", transpose=False)
    if cfg.resolved_o_bias:
        layers["wo_b"] = lsrc("self_attn.o_proj.bias", transpose=False)
    if cfg.mlp_bias:
        layers["w_gate_b"] = lsrc("mlp.gate_proj.bias", transpose=False)
        layers["w_in_b"] = lsrc("mlp.up_proj.bias", transpose=False)
        layers["w_out_b"] = lsrc("mlp.down_proj.bias", transpose=False)
    plans = {
        "embed": {"wte": LeafPlan(Src("model.embed_tokens.weight"),
                                  shapes["embed"]["wte"].shape)},
        "layers": {k: StackedLeafPlan(mk, shapes["layers"][k].shape)
                   for k, mk in layers.items()},
        "final_norm": {"w": LeafPlan(Src("model.norm.weight"),
                                     shapes["final_norm"]["w"].shape)},
    }
    if not cfg.tie_embeddings:
        plans["lm_head"] = {"w": LeafPlan(Src("lm_head.weight",
                                              transpose=True),
                                          shapes["lm_head"]["w"].shape)}
    return plans


def _stablelm_plans(cfg: TransformerConfig, shapes,
                    hf_config=None) -> Dict[str, Any]:
    """HF StableLmForCausalLM = the Llama layout + LayerNorm biases
    (+ final-norm bias), optional qkv biases, and, under parallel residual,
    no post_attention_layernorm at all (the GPT-J shared-LN pattern)."""
    L = "model.layers.{}."

    def lsrc(fmt: str, transpose=False):
        return lambda i: Src((L + fmt).format(i), transpose=transpose)

    plans = _llama_plans(cfg, shapes, hf_config)
    layers = dict(plans["layers"])
    raw = {"attn_norm_b": lsrc("input_layernorm.bias")}
    if not cfg.shared_layernorm:
        raw["mlp_norm_b"] = lsrc("post_attention_layernorm.bias")
    if cfg.qkv_bias:
        raw["wq_b"] = lsrc("self_attn.q_proj.bias")
        raw["wk_b"] = lsrc("self_attn.k_proj.bias")
        raw["wv_b"] = lsrc("self_attn.v_proj.bias")
    layers.update({k: StackedLeafPlan(mk, shapes["layers"][k].shape)
                   for k, mk in raw.items()})
    plans["layers"] = layers
    plans["final_norm"] = dict(
        plans["final_norm"],
        b=LeafPlan(Src("model.norm.bias"), shapes["final_norm"]["b"].shape))
    return plans


def _gpt2_plans(cfg: TransformerConfig, shapes,
                hf_config=None) -> Dict[str, Any]:
    """HF GPT2LMHeadModel naming -> CausalLM leaves. GPT-2 uses Conv1D
    ([in, out]: no transpose) and a fused c_attn split by column offset."""
    h = cfg.hidden_size
    kv = cfg.kv_heads * cfg.head_dim
    L = "transformer.h.{}."

    def lsrc(fmt, transpose=False, offset=()):
        return lambda i: Src((L + fmt).format(i), transpose=transpose,
                             offset=offset)

    layers = {
        "attn_norm_w": lsrc("ln_1.weight"),
        "attn_norm_b": lsrc("ln_1.bias"),
        "wq": lsrc("attn.c_attn.weight", offset=(0, 0)),
        "wk": lsrc("attn.c_attn.weight", offset=(0, h)),
        "wv": lsrc("attn.c_attn.weight", offset=(0, h + kv)),
        "wq_b": lsrc("attn.c_attn.bias", offset=(0,)),
        "wk_b": lsrc("attn.c_attn.bias", offset=(h,)),
        "wv_b": lsrc("attn.c_attn.bias", offset=(h + kv,)),
        "wo": lsrc("attn.c_proj.weight"),
        "wo_b": lsrc("attn.c_proj.bias"),
        "mlp_norm_w": lsrc("ln_2.weight"),
        "mlp_norm_b": lsrc("ln_2.bias"),
        "w_in": lsrc("mlp.c_fc.weight"),
        "w_in_b": lsrc("mlp.c_fc.bias"),
        "w_out": lsrc("mlp.c_proj.weight"),
        "w_out_b": lsrc("mlp.c_proj.bias"),
    }
    return {
        "embed": {"wte": LeafPlan(Src("transformer.wte.weight"),
                                  shapes["embed"]["wte"].shape),
                  "wpe": LeafPlan(Src("transformer.wpe.weight"),
                                  shapes["embed"]["wpe"].shape)},
        "layers": {k: StackedLeafPlan(mk, shapes["layers"][k].shape)
                   for k, mk in layers.items()},
        "final_norm": {"w": LeafPlan(Src("transformer.ln_f.weight"),
                                     shapes["final_norm"]["w"].shape),
                       "b": LeafPlan(Src("transformer.ln_f.bias"),
                                     shapes["final_norm"]["b"].shape)},
    }


def _gptneo_plans(cfg: TransformerConfig, shapes,
                  hf_config=None) -> Dict[str, Any]:
    """HF GPTNeoForCausalLM naming -> CausalLM leaves: the GPT-2 layout but
    with separate unbiased q/k/v ``nn.Linear``s ([out, in] -> transpose;
    the only attention bias is out_proj's)."""
    L = "transformer.h.{}."

    def lsrc(fmt, transpose=True):
        return lambda i: Src((L + fmt).format(i), transpose=transpose)

    layers = {
        "attn_norm_w": lsrc("ln_1.weight", False),
        "attn_norm_b": lsrc("ln_1.bias", False),
        "wq": lsrc("attn.attention.q_proj.weight"),
        "wk": lsrc("attn.attention.k_proj.weight"),
        "wv": lsrc("attn.attention.v_proj.weight"),
        "wo": lsrc("attn.attention.out_proj.weight"),
        "wo_b": lsrc("attn.attention.out_proj.bias", False),
        "mlp_norm_w": lsrc("ln_2.weight", False),
        "mlp_norm_b": lsrc("ln_2.bias", False),
        "w_in": lsrc("mlp.c_fc.weight"),
        "w_in_b": lsrc("mlp.c_fc.bias", False),
        "w_out": lsrc("mlp.c_proj.weight"),
        "w_out_b": lsrc("mlp.c_proj.bias", False),
    }
    return {
        "embed": {"wte": LeafPlan(Src("transformer.wte.weight"),
                                  shapes["embed"]["wte"].shape),
                  "wpe": LeafPlan(Src("transformer.wpe.weight"),
                                  shapes["embed"]["wpe"].shape)},
        "layers": {k: StackedLeafPlan(mk, shapes["layers"][k].shape)
                   for k, mk in layers.items()},
        "final_norm": {"w": LeafPlan(Src("transformer.ln_f.weight"),
                                     shapes["final_norm"]["w"].shape),
                       "b": LeafPlan(Src("transformer.ln_f.bias"),
                                     shapes["final_norm"]["b"].shape)},
    }


def _opt_plans(cfg: TransformerConfig, shapes,
               hf_config=None) -> Dict[str, Any]:
    """HF OPTForCausalLM: decoder stack, the per-layer final_layer_norm is
    the MLP norm, learned positions carry HF's +2 offset."""
    L = "model.decoder.layers.{}."

    def lsrc(fmt, transpose=False, offset=()):
        return lambda i: Src((L + fmt).format(i), transpose=transpose,
                             offset=offset)

    layers = {
        "attn_norm_w": lsrc("self_attn_layer_norm.weight"),
        "attn_norm_b": lsrc("self_attn_layer_norm.bias"),
        "wq": lsrc("self_attn.q_proj.weight", transpose=True),
        "wk": lsrc("self_attn.k_proj.weight", transpose=True),
        "wv": lsrc("self_attn.v_proj.weight", transpose=True),
        "wo": lsrc("self_attn.out_proj.weight", transpose=True),
        "wq_b": lsrc("self_attn.q_proj.bias"),
        "wk_b": lsrc("self_attn.k_proj.bias"),
        "wv_b": lsrc("self_attn.v_proj.bias"),
        "wo_b": lsrc("self_attn.out_proj.bias"),
        "mlp_norm_w": lsrc("final_layer_norm.weight"),
        "mlp_norm_b": lsrc("final_layer_norm.bias"),
        "w_in": lsrc("fc1.weight", transpose=True),
        "w_in_b": lsrc("fc1.bias"),
        "w_out": lsrc("fc2.weight", transpose=True),
        "w_out_b": lsrc("fc2.bias"),
    }
    plans = {
        "embed": {
            "wte": LeafPlan(Src("model.decoder.embed_tokens.weight"),
                            shapes["embed"]["wte"].shape),
            # OPTLearnedPositionalEmbedding rows are shifted by 2
            "wpe": LeafPlan(Src("model.decoder.embed_positions.weight",
                                offset=(2, 0)),
                            shapes["embed"]["wpe"].shape)},
        "layers": {k: StackedLeafPlan(mk, shapes["layers"][k].shape)
                   for k, mk in layers.items()},
        "final_norm": {
            "w": LeafPlan(Src("model.decoder.final_layer_norm.weight"),
                          shapes["final_norm"]["w"].shape),
            "b": LeafPlan(Src("model.decoder.final_layer_norm.bias"),
                          shapes["final_norm"]["b"].shape)},
    }
    if not cfg.tie_embeddings:
        plans["lm_head"] = {"w": LeafPlan(Src("lm_head.weight",
                                              transpose=True),
                                          shapes["lm_head"]["w"].shape)}
    return plans


def _neox_plans(cfg: TransformerConfig, shapes,
                hf_config=None) -> Dict[str, Any]:
    """HF GPTNeoXForCausalLM: interleaved fused QKV, parallel residual,
    separate embed_out head."""
    L = "gpt_neox.layers.{}."
    nh, hd = cfg.num_heads, cfg.head_dim

    def lsrc(fmt, transpose=False):
        return lambda i: Src((L + fmt).format(i), transpose=transpose)

    def qkv(which, suffix):
        return lambda i: FusedQKVSrc(
            (L + f"attention.query_key_value.{suffix}").format(i),
            which, nh, 1, hd)

    layers = {
        "attn_norm_w": lsrc("input_layernorm.weight"),
        "attn_norm_b": lsrc("input_layernorm.bias"),
        "mlp_norm_w": lsrc("post_attention_layernorm.weight"),
        "mlp_norm_b": lsrc("post_attention_layernorm.bias"),
        "wq": qkv("q", "weight"), "wk": qkv("k", "weight"),
        "wv": qkv("v", "weight"),
        "wq_b": qkv("q", "bias"), "wk_b": qkv("k", "bias"),
        "wv_b": qkv("v", "bias"),
        "wo": lsrc("attention.dense.weight", transpose=True),
        "wo_b": lsrc("attention.dense.bias"),
        "w_in": lsrc("mlp.dense_h_to_4h.weight", transpose=True),
        "w_in_b": lsrc("mlp.dense_h_to_4h.bias"),
        "w_out": lsrc("mlp.dense_4h_to_h.weight", transpose=True),
        "w_out_b": lsrc("mlp.dense_4h_to_h.bias"),
    }
    plans = {
        "embed": {"wte": LeafPlan(Src("gpt_neox.embed_in.weight"),
                                  shapes["embed"]["wte"].shape)},
        "layers": {k: StackedLeafPlan(mk, shapes["layers"][k].shape)
                   for k, mk in layers.items()},
        "final_norm": {
            "w": LeafPlan(Src("gpt_neox.final_layer_norm.weight"),
                          shapes["final_norm"]["w"].shape),
            "b": LeafPlan(Src("gpt_neox.final_layer_norm.bias"),
                          shapes["final_norm"]["b"].shape)},
    }
    if not cfg.tie_embeddings:
        plans["lm_head"] = {"w": LeafPlan(Src("embed_out.weight",
                                              transpose=True),
                                          shapes["lm_head"]["w"].shape)}
    return plans


def _gptj_plans(cfg: TransformerConfig, shapes,
                hf_config=None) -> Dict[str, Any]:
    """HF GPTJForCausalLM: separate bias-free q/k/v/out projections, ONE
    shared LayerNorm per block (ln_1 feeds both branches), biased MLP
    (fc_in/fc_out), interleaved partial rotary, biased lm_head."""
    L = "transformer.h.{}."

    def lsrc(fmt, transpose=False):
        return lambda i: Src((L + fmt).format(i), transpose=transpose)

    layers = {
        "attn_norm_w": lsrc("ln_1.weight"),
        "attn_norm_b": lsrc("ln_1.bias"),
        "wq": lsrc("attn.q_proj.weight", transpose=True),
        "wk": lsrc("attn.k_proj.weight", transpose=True),
        "wv": lsrc("attn.v_proj.weight", transpose=True),
        "wo": lsrc("attn.out_proj.weight", transpose=True),
        "w_in": lsrc("mlp.fc_in.weight", transpose=True),
        "w_in_b": lsrc("mlp.fc_in.bias"),
        "w_out": lsrc("mlp.fc_out.weight", transpose=True),
        "w_out_b": lsrc("mlp.fc_out.bias"),
    }
    return {
        "embed": {"wte": LeafPlan(Src("transformer.wte.weight"),
                                  shapes["embed"]["wte"].shape)},
        "layers": {k: StackedLeafPlan(mk, shapes["layers"][k].shape)
                   for k, mk in layers.items()},
        "final_norm": {
            "w": LeafPlan(Src("transformer.ln_f.weight"),
                          shapes["final_norm"]["w"].shape),
            "b": LeafPlan(Src("transformer.ln_f.bias"),
                          shapes["final_norm"]["b"].shape)},
        "lm_head": {
            "w": LeafPlan(Src("lm_head.weight", transpose=True),
                          shapes["lm_head"]["w"].shape),
            "b": LeafPlan(Src("lm_head.bias"),
                          shapes["lm_head"]["b"].shape)},
    }


def _phi_plans(cfg: TransformerConfig, shapes,
               hf_config=None) -> Dict[str, Any]:
    """HF PhiForCausalLM: GPT-J-style single input_layernorm per block
    feeding both parallel branches, but with biases everywhere and
    rotate_half partial rotary."""
    L = "model.layers.{}."

    def lsrc(fmt, transpose=False):
        return lambda i: Src((L + fmt).format(i), transpose=transpose)

    layers = {
        "attn_norm_w": lsrc("input_layernorm.weight"),
        "attn_norm_b": lsrc("input_layernorm.bias"),
        "wq": lsrc("self_attn.q_proj.weight", transpose=True),
        "wq_b": lsrc("self_attn.q_proj.bias"),
        "wk": lsrc("self_attn.k_proj.weight", transpose=True),
        "wk_b": lsrc("self_attn.k_proj.bias"),
        "wv": lsrc("self_attn.v_proj.weight", transpose=True),
        "wv_b": lsrc("self_attn.v_proj.bias"),
        "wo": lsrc("self_attn.dense.weight", transpose=True),
        "wo_b": lsrc("self_attn.dense.bias"),
        "w_in": lsrc("mlp.fc1.weight", transpose=True),
        "w_in_b": lsrc("mlp.fc1.bias"),
        "w_out": lsrc("mlp.fc2.weight", transpose=True),
        "w_out_b": lsrc("mlp.fc2.bias"),
    }
    plans = {
        "embed": {"wte": LeafPlan(Src("model.embed_tokens.weight"),
                                  shapes["embed"]["wte"].shape)},
        "layers": {k: StackedLeafPlan(mk, shapes["layers"][k].shape)
                   for k, mk in layers.items()},
        "final_norm": {
            "w": LeafPlan(Src("model.final_layernorm.weight"),
                          shapes["final_norm"]["w"].shape),
            "b": LeafPlan(Src("model.final_layernorm.bias"),
                          shapes["final_norm"]["b"].shape)},
    }
    if not cfg.tie_embeddings:
        plans["lm_head"] = {
            "w": LeafPlan(Src("lm_head.weight", transpose=True),
                          shapes["lm_head"]["w"].shape),
            "b": LeafPlan(Src("lm_head.bias"),
                          shapes["lm_head"]["b"].shape)}
    return plans


def _bloom_plans(cfg: TransformerConfig, shapes,
                 hf_config=None) -> Dict[str, Any]:
    """HF BloomForCausalLM: ALiBi, embedding LayerNorm, interleaved fused
    QKV, tied embeddings."""
    L = "transformer.h.{}."
    nh, hd = cfg.num_heads, cfg.head_dim

    def lsrc(fmt, transpose=False):
        return lambda i: Src((L + fmt).format(i), transpose=transpose)

    def qkv(which, suffix):
        return lambda i: FusedQKVSrc(
            (L + f"self_attention.query_key_value.{suffix}").format(i),
            which, nh, 1, hd)

    layers = {
        "attn_norm_w": lsrc("input_layernorm.weight"),
        "attn_norm_b": lsrc("input_layernorm.bias"),
        "mlp_norm_w": lsrc("post_attention_layernorm.weight"),
        "mlp_norm_b": lsrc("post_attention_layernorm.bias"),
        "wq": qkv("q", "weight"), "wk": qkv("k", "weight"),
        "wv": qkv("v", "weight"),
        "wq_b": qkv("q", "bias"), "wk_b": qkv("k", "bias"),
        "wv_b": qkv("v", "bias"),
        "wo": lsrc("self_attention.dense.weight", transpose=True),
        "wo_b": lsrc("self_attention.dense.bias"),
        "w_in": lsrc("mlp.dense_h_to_4h.weight", transpose=True),
        "w_in_b": lsrc("mlp.dense_h_to_4h.bias"),
        "w_out": lsrc("mlp.dense_4h_to_h.weight", transpose=True),
        "w_out_b": lsrc("mlp.dense_4h_to_h.bias"),
    }
    return {
        "embed": {
            "wte": LeafPlan(Src("transformer.word_embeddings.weight"),
                            shapes["embed"]["wte"].shape),
            "ln_w": LeafPlan(
                Src("transformer.word_embeddings_layernorm.weight"),
                shapes["embed"]["ln_w"].shape),
            "ln_b": LeafPlan(
                Src("transformer.word_embeddings_layernorm.bias"),
                shapes["embed"]["ln_b"].shape)},
        "layers": {k: StackedLeafPlan(mk, shapes["layers"][k].shape)
                   for k, mk in layers.items()},
        "final_norm": {"w": LeafPlan(Src("transformer.ln_f.weight"),
                                     shapes["final_norm"]["w"].shape),
                       "b": LeafPlan(Src("transformer.ln_f.bias"),
                                     shapes["final_norm"]["b"].shape)},
    }


def _falcon_plans(cfg: TransformerConfig, shapes,
                  hf_config=None) -> Dict[str, Any]:
    """HF FalconForCausalLM. Old decoder architecture (7B): one shared
    input_layernorm feeds BOTH parallel branches, mapped by pointing
    attn_norm and mlp_norm at the same tensor. New architecture (40B):
    ln_attn/ln_mlp + per-KV-group interleaved QKV."""
    L = "transformer.h.{}."
    nh, kvh, hd = cfg.num_heads, cfg.kv_heads, cfg.head_dim
    if hf_config is not None:
        new_arch = hf_config.get("new_decoder_architecture", False)
        multi_query = hf_config.get("multi_query", True)
    else:   # no config.json available: infer from the head layout
        new_arch = kvh not in (1, nh)
        multi_query = kvh == 1

    def lsrc(fmt, transpose=False, offset=()):
        return lambda i: Src((L + fmt).format(i), transpose=transpose,
                             offset=offset)

    if new_arch:
        q_per_group = nh // kvh

        def qkv(which):
            return lambda i: FusedQKVSrc(
                (L + "self_attention.query_key_value.weight").format(i),
                which, kvh, q_per_group, hd)

        wq, wk, wv = qkv("q"), qkv("k"), qkv("v")
        attn_norm_w = lsrc("ln_attn.weight")
        attn_norm_b = lsrc("ln_attn.bias")
        mlp_norm_w = lsrc("ln_mlp.weight")
        mlp_norm_b = lsrc("ln_mlp.bias")
    else:
        if multi_query:
            # affine fused layout: q rows, then one K head, then one V head
            wq = lsrc("self_attention.query_key_value.weight",
                      transpose=True, offset=(0, 0))
            wk = lsrc("self_attention.query_key_value.weight",
                      transpose=True, offset=(0, nh * hd))
            wv = lsrc("self_attention.query_key_value.weight",
                      transpose=True, offset=(0, (nh + 1) * hd))
        else:
            # falcon-rw family: per-head interleaved [nh, 3, hd] packing
            def qkv(which):
                return lambda i: FusedQKVSrc(
                    (L + "self_attention.query_key_value.weight").format(i),
                    which, nh, 1, hd)

            wq, wk, wv = qkv("q"), qkv("k"), qkv("v")
        attn_norm_w = lsrc("input_layernorm.weight")
        attn_norm_b = lsrc("input_layernorm.bias")
        if cfg.parallel_residual:
            # shared LN feeds both parallel branches: same source tensor
            mlp_norm_w, mlp_norm_b = attn_norm_w, attn_norm_b
        else:   # falcon-rw sequential blocks keep a separate post-attn LN
            mlp_norm_w = lsrc("post_attention_layernorm.weight")
            mlp_norm_b = lsrc("post_attention_layernorm.bias")

    layers = {
        "attn_norm_w": attn_norm_w, "attn_norm_b": attn_norm_b,
        "mlp_norm_w": mlp_norm_w, "mlp_norm_b": mlp_norm_b,
        "wq": wq, "wk": wk, "wv": wv,
        "wo": lsrc("self_attention.dense.weight", transpose=True),
        "w_in": lsrc("mlp.dense_h_to_4h.weight", transpose=True),
        "w_out": lsrc("mlp.dense_4h_to_h.weight", transpose=True),
    }
    if cfg.use_bias:
        if new_arch or not multi_query:
            groups = kvh if new_arch else nh
            qpg = (nh // kvh) if new_arch else 1

            def qkv_b(which):
                return lambda i: FusedQKVSrc(
                    (L + "self_attention.query_key_value.bias").format(i),
                    which, groups, qpg, hd)

            wq_b, wk_b, wv_b = qkv_b("q"), qkv_b("k"), qkv_b("v")
        else:
            wq_b = lsrc("self_attention.query_key_value.bias", offset=(0,))
            wk_b = lsrc("self_attention.query_key_value.bias",
                        offset=(nh * hd,))
            wv_b = lsrc("self_attention.query_key_value.bias",
                        offset=((nh + 1) * hd,))
        layers.update({
            "wq_b": wq_b, "wk_b": wk_b, "wv_b": wv_b,
            "wo_b": lsrc("self_attention.dense.bias"),
            "w_in_b": lsrc("mlp.dense_h_to_4h.bias"),
            "w_out_b": lsrc("mlp.dense_4h_to_h.bias"),
        })
    plans = {
        "embed": {"wte": LeafPlan(Src("transformer.word_embeddings.weight"),
                                  shapes["embed"]["wte"].shape)},
        "layers": {k: StackedLeafPlan(mk, shapes["layers"][k].shape)
                   for k, mk in layers.items()},
        "final_norm": {"w": LeafPlan(Src("transformer.ln_f.weight"),
                                     shapes["final_norm"]["w"].shape),
                       "b": LeafPlan(Src("transformer.ln_f.bias"),
                                     shapes["final_norm"]["b"].shape)},
    }
    if not cfg.tie_embeddings:
        plans["lm_head"] = {"w": LeafPlan(Src("lm_head.weight",
                                              transpose=True),
                                          shapes["lm_head"]["w"].shape)}
    return plans


_FAMILIES = {"llama": _llama_plans, "mistral": _llama_plans,
             "internlm": _llama_plans,
             "gpt2": _gpt2_plans, "gpt_neo": _gptneo_plans,
             "qwen2": _llama_plans, "opt": _opt_plans,
             "gpt_neox": _neox_plans, "bloom": _bloom_plans,
             "falcon": _falcon_plans, "gptj": _gptj_plans,
             "phi": _phi_plans, "stablelm": _stablelm_plans}


def _qwen2_window(hf_config: Dict[str, Any]):
    """Qwen2 applies SWA only to layers >= max_window_layers (HF
    configuration_qwen2.py: "the first max_window_layers layers will use
    full attention"); an explicit ``layer_types`` list, HF's general form,
    overrides. Returns None (no SWA anywhere), an int (uniform window), or
    a per-layer tuple for mixed schedules."""
    if not hf_config.get("use_sliding_window"):
        return None
    w = hf_config.get("sliding_window")
    if not w:
        return None
    n_layers = hf_config["num_hidden_layers"]
    lt = hf_config.get("layer_types")
    if lt:
        wins = tuple(w if t == "sliding_attention" else None for t in lt)
    else:
        mwl = hf_config.get("max_window_layers", n_layers)
        wins = tuple(None if i < mwl else w for i in range(n_layers))
    if not any(wins):
        return None                       # no layer is windowed
    if all(wins):
        return w                          # uniform SWA
    return wins


def config_from_hf(hf_config: Dict[str, Any],
                   dtype=torch.bfloat16) -> TransformerConfig:
    """HF ``config.json`` dict -> TransformerConfig (reference: the
    per-model policy classes, module_inject/policy.py)."""
    mt = hf_config.get("model_type", "")
    if mt in ("llama", "mistral", "internlm"):
        # InternLM is the Llama layout + biased attention projections
        # ("bias": true); HF Llama exposes the same via attention_bias
        biased = bool(hf_config.get("attention_bias",
                                    hf_config.get("bias", False)))
        return TransformerConfig(
            vocab_size=hf_config["vocab_size"],
            hidden_size=hf_config["hidden_size"],
            intermediate_size=hf_config["intermediate_size"],
            num_layers=hf_config["num_hidden_layers"],
            num_heads=hf_config["num_attention_heads"],
            num_kv_heads=hf_config.get("num_key_value_heads",
                                       hf_config["num_attention_heads"]),
            max_seq_len=hf_config.get("max_position_embeddings", 4096),
            sliding_window=(hf_config.get("sliding_window")
                            if mt == "mistral" else None),
            norm="rmsnorm", activation="silu", position="rope",
            rope_theta=hf_config.get("rope_theta", 10000.0),
            tie_embeddings=hf_config.get("tie_word_embeddings", False),
            use_bias=biased, o_bias=biased,
            mlp_bias=bool(hf_config.get("mlp_bias", False)),
            norm_eps=hf_config.get("rms_norm_eps", 1e-5),
            dtype=dtype)
    if mt == "gpt_neo":
        # alternating global/local attention maps onto the per-layer window
        # tuple; attention is UNSCALED (HF GPTNeoSelfAttention) -> 1.0
        h = hf_config["hidden_size"]
        att = hf_config.get("attention_layers")
        if att is None:
            # expand attention_types [[["global","local"], 12]] form
            att = []
            for kinds, n in hf_config.get("attention_types",
                                          [[["global"], 1]]):
                att += list(kinds) * n
        win = hf_config.get("window_size", 256)
        windows = tuple(win if t == "local" else None for t in att)
        return TransformerConfig(
            vocab_size=hf_config["vocab_size"],
            hidden_size=h,
            intermediate_size=hf_config.get("intermediate_size") or 4 * h,
            num_layers=hf_config["num_layers"],
            num_heads=hf_config["num_heads"],
            max_seq_len=hf_config.get("max_position_embeddings", 2048),
            sliding_window=(None if not any(windows) else windows),
            norm="layernorm", activation="gelu", position="learned",
            tie_embeddings=True, use_bias=False, o_bias=True,
            mlp_bias=True, attn_scale=1.0,
            norm_eps=hf_config.get("layer_norm_epsilon", 1e-5),
            dtype=dtype)
    if mt == "gpt2":
        h = hf_config["n_embd"]
        return TransformerConfig(
            vocab_size=hf_config["vocab_size"],
            hidden_size=h,
            intermediate_size=hf_config.get("n_inner") or 4 * h,
            num_layers=hf_config["n_layer"],
            num_heads=hf_config["n_head"],
            max_seq_len=hf_config.get("n_positions", 1024),
            norm="layernorm", activation="gelu", position="learned",
            tie_embeddings=True, use_bias=True,
            norm_eps=hf_config.get("layer_norm_epsilon", 1e-5),
            dtype=dtype)
    if mt == "stablelm":
        if hf_config.get("qk_layernorm"):
            raise ValueError(
                "StableLM with qk_layernorm=true is unsupported (per-head "
                "q/k LayerNorms have no TransformerConfig mapping); loading "
                "it silently would diverge from HF")
        h = hf_config["hidden_size"]
        par = bool(hf_config.get("use_parallel_residual", False))
        return TransformerConfig(
            vocab_size=hf_config["vocab_size"],
            hidden_size=h,
            intermediate_size=hf_config["intermediate_size"],
            num_layers=hf_config["num_hidden_layers"],
            num_heads=hf_config["num_attention_heads"],
            num_kv_heads=hf_config.get("num_key_value_heads"),
            max_seq_len=hf_config.get("max_position_embeddings", 4096),
            norm="layernorm", activation="silu", position="rope",
            rope_theta=hf_config.get("rope_theta", 10000.0),
            rope_pct=hf_config.get("partial_rotary_factor", 0.25),
            parallel_residual=par, shared_layernorm=par,
            qkv_bias=bool(hf_config.get("use_qkv_bias", False)),
            tie_embeddings=hf_config.get("tie_word_embeddings", False),
            norm_eps=hf_config.get("layer_norm_eps", 1e-5),
            dtype=dtype)
    if mt == "phi":
        if hf_config.get("qk_layernorm"):
            raise ValueError(
                "Phi with qk_layernorm=true is unsupported (per-head q/k "
                "LayerNorms have no TransformerConfig mapping); loading it "
                "silently would diverge from HF")
        h = hf_config["hidden_size"]
        nh = hf_config["num_attention_heads"]
        return TransformerConfig(
            vocab_size=hf_config["vocab_size"],
            hidden_size=h,
            intermediate_size=hf_config["intermediate_size"],
            num_layers=hf_config["num_hidden_layers"],
            num_heads=nh,
            num_kv_heads=hf_config.get("num_key_value_heads") or nh,
            max_seq_len=hf_config.get("max_position_embeddings", 2048),
            norm="layernorm", activation="gelu", position="rope",
            rope_theta=hf_config.get("rope_theta", 10000.0),
            rope_pct=hf_config.get("partial_rotary_factor", 0.5),
            parallel_residual=True, shared_layernorm=True,
            tie_embeddings=hf_config.get("tie_word_embeddings", False),
            use_bias=True, mlp_bias=True, lm_head_bias=True,
            norm_eps=hf_config.get("layer_norm_eps", 1e-5),
            dtype=dtype)
    if mt == "gptj":
        h = hf_config["n_embd"]
        nh = hf_config["n_head"]
        return TransformerConfig(
            vocab_size=hf_config["vocab_size"],
            hidden_size=h,
            intermediate_size=hf_config.get("n_inner") or 4 * h,
            num_layers=hf_config["n_layer"],
            num_heads=nh,
            max_seq_len=hf_config.get("n_positions", 2048),
            norm="layernorm", activation="gelu", position="rope",
            rope_pct=(hf_config.get("rotary_dim") or h // nh) / (h // nh),
            rope_interleaved=True, parallel_residual=True,
            shared_layernorm=True, tie_embeddings=False,
            use_bias=False, mlp_bias=True, lm_head_bias=True,
            norm_eps=hf_config.get("layer_norm_epsilon", 1e-5),
            dtype=dtype)
    if mt == "qwen2":
        return TransformerConfig(
            vocab_size=hf_config["vocab_size"],
            hidden_size=hf_config["hidden_size"],
            intermediate_size=hf_config["intermediate_size"],
            num_layers=hf_config["num_hidden_layers"],
            num_heads=hf_config["num_attention_heads"],
            num_kv_heads=hf_config.get("num_key_value_heads"),
            max_seq_len=hf_config.get("max_position_embeddings", 4096),
            sliding_window=_qwen2_window(hf_config),
            norm="rmsnorm", activation="silu", position="rope",
            rope_theta=hf_config.get("rope_theta", 10000.0),
            tie_embeddings=hf_config.get("tie_word_embeddings", False),
            norm_eps=hf_config.get("rms_norm_eps", 1e-6),
            qkv_bias=True, dtype=dtype)
    if mt == "opt":
        if not hf_config.get("do_layer_norm_before", True):
            raise ValueError("OPT with do_layer_norm_before=false (350m) "
                             "uses post-norm blocks, which this model "
                             "family does not implement")
        h = hf_config["hidden_size"]
        if hf_config.get("word_embed_proj_dim", h) != h:
            raise ValueError("OPT word_embed_proj_dim != hidden_size "
                             "(projected embeddings) is unsupported")
        act = hf_config.get("activation_function", "relu")
        return TransformerConfig(
            vocab_size=hf_config["vocab_size"],
            hidden_size=h,
            intermediate_size=hf_config["ffn_dim"],
            num_layers=hf_config["num_hidden_layers"],
            num_heads=hf_config["num_attention_heads"],
            max_seq_len=hf_config.get("max_position_embeddings", 2048),
            norm="layernorm", activation=act, position="learned",
            tie_embeddings=hf_config.get("tie_word_embeddings", True),
            use_bias=True, dtype=dtype)
    if mt == "gpt_neox":
        return TransformerConfig(
            vocab_size=hf_config["vocab_size"],
            hidden_size=hf_config["hidden_size"],
            intermediate_size=hf_config["intermediate_size"],
            num_layers=hf_config["num_hidden_layers"],
            num_heads=hf_config["num_attention_heads"],
            max_seq_len=hf_config.get("max_position_embeddings", 2048),
            norm="layernorm",
            activation=("gelu_exact" if hf_config.get("hidden_act", "gelu")
                        == "gelu" else hf_config.get("hidden_act", "gelu")),
            position="rope",
            rope_theta=hf_config.get("rotary_emb_base", 10000.0),
            rope_pct=hf_config.get("rotary_pct", 1.0),
            parallel_residual=hf_config.get("use_parallel_residual", True),
            tie_embeddings=hf_config.get("tie_word_embeddings", False),
            norm_eps=hf_config.get("layer_norm_eps", 1e-5),
            use_bias=True, dtype=dtype)
    if mt == "bloom":
        h = hf_config.get("hidden_size", hf_config.get("n_embed"))
        return TransformerConfig(
            vocab_size=hf_config["vocab_size"],
            hidden_size=h,
            intermediate_size=4 * h,
            num_layers=hf_config["n_layer"],
            num_heads=hf_config["n_head"],
            max_seq_len=hf_config.get("seq_length", 2048),
            norm="layernorm", activation="gelu", position="alibi",
            embedding_layernorm=True, tie_embeddings=True, use_bias=True,
            norm_eps=hf_config.get("layer_norm_epsilon", 1e-5), dtype=dtype)
    if mt == "falcon":
        nh = hf_config.get("num_attention_heads", hf_config.get("n_head"))
        new_arch = hf_config.get("new_decoder_architecture", False)
        if new_arch:
            kv = hf_config.get("num_kv_heads", nh)
        else:
            kv = 1 if hf_config.get("multi_query", True) else nh
        h = hf_config["hidden_size"]
        return TransformerConfig(
            vocab_size=hf_config["vocab_size"],
            hidden_size=h,
            intermediate_size=hf_config.get("ffn_hidden_size", 4 * h),
            num_layers=hf_config.get("num_hidden_layers",
                                     hf_config.get("n_layer")),
            num_heads=nh, num_kv_heads=kv,
            max_seq_len=hf_config.get("max_position_embeddings", 2048),
            norm="layernorm", activation="gelu_exact",
            position="alibi" if hf_config.get("alibi", False) else "rope",
            rope_theta=hf_config.get("rope_theta", 10000.0),
            parallel_residual=hf_config.get("parallel_attn", True),
            tie_embeddings=hf_config.get("tie_word_embeddings", True),
            use_bias=hf_config.get("bias", False),
            norm_eps=hf_config.get("layer_norm_epsilon", 1e-5), dtype=dtype)
    raise ValueError(f"unsupported model_type {mt!r} "
                     f"(supported: {sorted(_FAMILIES)})")


# ----------------------------------------------------- encoder (BERT) family

def _encoder_arch(hf_config) -> str:
    archs = hf_config.get("architectures") or [""]
    return archs[0] if archs else ""


def _encoder_prefix_and_heads(hf_config):
    """(prefix, with_pooler, with_mlm_head) from the checkpoint's saved
    architecture: ``BertModel``/``RobertaModel`` save unprefixed weights
    with a pooler; the task models prefix with the model_type and the MLM
    variants carry the prediction head instead of (BERT) or alongside
    (RoBERTa has no pooler at all in ForMaskedLM) the pooler."""
    mt = hf_config.get("model_type")
    arch = _encoder_arch(hf_config)
    if mt is None:
        raise ValueError(
            "encoder checkpoint config has no 'model_type' (missing or "
            "minimal config.json); pass model_type= to load_hf_checkpoint "
            f"(supported encoders: {sorted(_ENCODER_FAMILIES)})")
    if mt == "distilbert":
        # DistilBERT has no pooler in any architecture
        if arch == "DistilBertModel":
            return "", False, False
        return mt + ".", False, "ForMaskedLM" in arch
    if arch in ("BertModel", "RobertaModel"):
        return "", True, False
    if "ForMaskedLM" in arch:
        return mt + ".", False, True
    if "ForPreTraining" in arch:
        return mt + ".", True, True
    # Only these BERT task heads keep the pooler; BertForQuestionAnswering/
    # TokenClassification and every RobertaFor* task model save with
    # add_pooling_layer=False
    pooled = arch in ("BertForSequenceClassification",
                      "BertForNextSentencePrediction",
                      "BertForMultipleChoice")
    return mt + ".", pooled, False


def encoder_config_from_hf(hf_config: Dict[str, Any], dtype=torch.float32):
    """HF BERT/RoBERTa/DistilBERT ``config.json`` -> EncoderConfig
    (reference policy: module_inject/containers/bert.py)."""
    from .encoder import EncoderConfig

    mt = hf_config.get("model_type")
    if mt not in _ENCODER_FAMILIES:
        raise ValueError(f"not an encoder model_type: {mt!r}")
    # RoBERTa offsets position ids by pad_token_id+1 (fairseq legacy);
    # its max_position_embeddings already includes the offset
    offset = (hf_config.get("pad_token_id", 1) + 1) if mt == "roberta" else 0
    _, pooler, mlm = _encoder_prefix_and_heads(hf_config)
    raw_act = hf_config.get("hidden_act",
                            hf_config.get("activation", "gelu"))
    act = {"gelu": "gelu_exact", "gelu_new": "gelu_new",
           "gelu_pytorch_tanh": "gelu_new", "relu": "relu",
           "silu": "silu", "swish": "silu"}.get(raw_act)
    if act is None:
        raise ValueError(
            f"unsupported encoder activation {raw_act!r} — loading it as "
            "gelu would silently diverge from HF")
    n_labels, head_style = 0, "pooled"
    arch = _encoder_arch(hf_config)
    cfg_labels = int(hf_config.get("num_labels")
                     or len(hf_config.get("id2label") or ()) or 2)
    if arch.endswith("ForSequenceClassification"):
        n_labels = cfg_labels
        head_style = mt if mt in ("roberta", "distilbert") else "pooled"
    elif arch.endswith("ForTokenClassification"):
        n_labels, head_style = cfg_labels, "token"
    elif arch.endswith("ForQuestionAnswering"):
        n_labels, head_style = 2, "qa"
    if mt == "distilbert":
        # DistilBertConfig naming: dim/hidden_dim/n_layers/n_heads; no
        # token types, no pooler
        return EncoderConfig(
            vocab_size=hf_config["vocab_size"],
            hidden_size=hf_config["dim"],
            intermediate_size=hf_config["hidden_dim"],
            num_layers=hf_config["n_layers"],
            num_heads=hf_config["n_heads"],
            max_seq_len=hf_config.get("max_position_embeddings", 512),
            type_vocab_size=0,
            num_labels=n_labels, cls_head=head_style,
            activation=act, with_pooler=False, with_mlm_head=mlm,
            # modern transformers ties via tie_word_embeddings; legacy
            # hub configs carry tie_weights_ (always true there)
            tie_mlm_decoder=hf_config.get(
                "tie_word_embeddings", hf_config.get("tie_weights_", True)),
            dtype=dtype)
    return EncoderConfig(
        vocab_size=hf_config["vocab_size"],
        hidden_size=hf_config["hidden_size"],
        intermediate_size=hf_config["intermediate_size"],
        num_layers=hf_config["num_hidden_layers"],
        num_heads=hf_config["num_attention_heads"],
        max_seq_len=hf_config.get("max_position_embeddings", 512) - offset,
        type_vocab_size=hf_config.get("type_vocab_size", 2),
        norm_eps=hf_config.get("layer_norm_eps", 1e-12),
        activation=act, with_pooler=pooler, with_mlm_head=mlm,
        tie_mlm_decoder=hf_config.get("tie_word_embeddings", True),
        num_labels=n_labels, cls_head=head_style,
        position_offset=offset, dtype=dtype)


def _encoder_plans(cfg, shapes, hf_config) -> Dict[str, Any]:
    """HF BertModel/BertForMaskedLM (and the name-identical RoBERTa
    encoder, and DistilBERT's own naming) -> EncoderLM leaves."""
    p, _, _ = _encoder_prefix_and_heads(hf_config)
    mt = hf_config.get("model_type")
    distil = mt == "distilbert"
    L = p + ("transformer.layer.{}." if distil else "encoder.layer.{}.")

    def lsrc(fmt: str, transpose=True):
        return lambda i: Src((L + fmt).format(i), transpose=transpose)

    def stacked(name, make):
        return StackedLeafPlan(make, shapes["layers"][name].shape)

    if distil:
        names = {"wq": "attention.q_lin", "wk": "attention.k_lin",
                 "wv": "attention.v_lin", "wo": "attention.out_lin",
                 "attn_ln": "sa_layer_norm", "w_in": "ffn.lin1",
                 "w_out": "ffn.lin2", "mlp_ln": "output_layer_norm"}
    else:
        names = {"wq": "attention.self.query", "wk": "attention.self.key",
                 "wv": "attention.self.value",
                 "wo": "attention.output.dense",
                 "attn_ln": "attention.output.LayerNorm",
                 "w_in": "intermediate.dense", "w_out": "output.dense",
                 "mlp_ln": "output.LayerNorm"}
    layers = {}
    for k in ("wq", "wk", "wv", "wo", "w_in", "w_out"):
        layers[k] = stacked(k, lsrc(names[k] + ".weight"))
        layers[k + "_b"] = stacked(k + "_b",
                                   lsrc(names[k] + ".bias", False))
    for k in ("attn_ln", "mlp_ln"):
        layers[k + "_w"] = stacked(k + "_w",
                                   lsrc(names[k] + ".weight", False))
        layers[k + "_b"] = stacked(k + "_b",
                                   lsrc(names[k] + ".bias", False))
    E = p + "embeddings."
    plans = {
        "embed": {
            "wte": LeafPlan(Src(E + "word_embeddings.weight"),
                            shapes["embed"]["wte"].shape),
            "wpe": LeafPlan(Src(E + "position_embeddings.weight"),
                            shapes["embed"]["wpe"].shape),
            "ln_w": LeafPlan(Src(E + "LayerNorm.weight"),
                             shapes["embed"]["ln_w"].shape),
            "ln_b": LeafPlan(Src(E + "LayerNorm.bias"),
                             shapes["embed"]["ln_b"].shape),
        },
        "layers": layers,
    }
    if cfg.type_vocab_size > 0:
        plans["embed"]["tte"] = LeafPlan(
            Src(E + "token_type_embeddings.weight"),
            shapes["embed"]["tte"].shape)
    if cfg.with_pooler:
        plans["pooler"] = {
            "w": LeafPlan(Src(p + "pooler.dense.weight", transpose=True),
                          shapes["pooler"]["w"].shape),
            "b": LeafPlan(Src(p + "pooler.dense.bias"),
                          shapes["pooler"]["b"].shape),
        }
    if cfg.with_mlm_head:
        if distil:
            head = {"w": "vocab_transform.weight",
                    "b": "vocab_transform.bias",
                    "ln_w": "vocab_layer_norm.weight",
                    "ln_b": "vocab_layer_norm.bias",
                    "bias": "vocab_projector.bias"}
        elif mt == "roberta":
            head = {"w": "lm_head.dense.weight", "b": "lm_head.dense.bias",
                    "ln_w": "lm_head.layer_norm.weight",
                    "ln_b": "lm_head.layer_norm.bias",
                    "bias": "lm_head.bias"}
        else:
            head = {"w": "cls.predictions.transform.dense.weight",
                    "b": "cls.predictions.transform.dense.bias",
                    "ln_w": "cls.predictions.transform.LayerNorm.weight",
                    "ln_b": "cls.predictions.transform.LayerNorm.bias",
                    "bias": "cls.predictions.bias"}
        if not cfg.tie_mlm_decoder:
            # untied decoder stores its own [V, H] weight (ours is [H, V])
            head["decoder"] = {
                "roberta": "lm_head.decoder.weight",
                "distilbert": "vocab_projector.weight",
            }.get(mt, "cls.predictions.decoder.weight")
        plans["mlm"] = {
            k: LeafPlan(Src(v, transpose=(k in ("w", "decoder"))),
                        shapes["mlm"][k].shape)
            for k, v in head.items()}
    if cfg.num_labels:
        heads = {
            "pooled": {"w": "classifier.weight", "b": "classifier.bias"},
            "roberta": {"w": "classifier.out_proj.weight",
                        "b": "classifier.out_proj.bias",
                        "dense_w": "classifier.dense.weight",
                        "dense_b": "classifier.dense.bias"},
            "distilbert": {"w": "classifier.weight",
                           "b": "classifier.bias",
                           "dense_w": "pre_classifier.weight",
                           "dense_b": "pre_classifier.bias"},
            "token": {"w": "classifier.weight", "b": "classifier.bias"},
            "qa": {"w": "qa_outputs.weight", "b": "qa_outputs.bias"},
        }[cfg.cls_head]
        plans["classifier"] = {
            k: LeafPlan(Src(v, transpose=k.endswith("w")),
                        shapes["classifier"][k].shape)
            for k, v in heads.items()}
    return plans


_ENCODER_FAMILIES = {"bert": _encoder_plans, "roberta": _encoder_plans,
                     "distilbert": _encoder_plans}


# ------------------------------------------------------------------ top level

def param_shapes(model) -> Dict[str, Any]:
    """The model's param tree as meta tensors (shapes and dtypes, no
    storage): the counterpart of ``jax.eval_shape(model.init, key)``."""
    return model.init(torch.Generator(), device="meta")


def _keystr(path: Tuple[str, ...]) -> str:
    """A leaf's path as ``jax.tree_util.keystr`` writes it."""
    return "".join(f"[{k!r}]" for k in path)


def _flat(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, path + (k,))
    else:
        yield path, tree


def _unflat(items):
    out: Dict[str, Any] = {}
    for path, leaf in items:
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out


def build_leaf_plans(model, model_type: str,
                     hf_config=None) -> Dict[str, Any]:
    shapes = param_shapes(model)
    # an explicit model_type wins over an absent/minimal config.json, so
    # the family builders (which read hf_config["model_type"]) see it
    if model_type is not None and not (hf_config or {}).get("model_type"):
        hf_config = dict(hf_config or {}, model_type=model_type)
    if model_type in _ENCODER_FAMILIES:
        return _ENCODER_FAMILIES[model_type](model.cfg, shapes, hf_config)
    if model_type not in _FAMILIES:
        raise ValueError(f"unsupported model_type {model_type!r}")
    return _FAMILIES[model_type](model.cfg, shapes, hf_config)


def _read_hf_config(path: str) -> Dict[str, Any]:
    cfg_file = os.path.join(path, "config.json")
    if not os.path.exists(cfg_file):
        return {}
    with open(cfg_file) as f:
        return json.load(f)


def _new_model(hf_cfg: Dict[str, Any], **overrides):
    if hf_cfg.get("model_type") in _ENCODER_FAMILIES:
        from .encoder import EncoderLM

        cfg = encoder_config_from_hf(hf_cfg)
        return EncoderLM(dataclasses.replace(cfg, **overrides)
                         if overrides else cfg)
    cfg = config_from_hf(hf_cfg)
    return CausalLM(dataclasses.replace(cfg, **overrides)
                    if overrides else cfg)


def load_hf_checkpoint(path: str, model=None, param_dtype=None,
                       model_type: Optional[str] = None, device=None,
                       topology=None, rank: Optional[int] = None,
                       cut: Optional[Callable] = None,
                       reader: Optional[CheckpointReader] = None,
                       rules=None):
    """Load an HF-format checkpoint directory -> ``(model, params)``.

    - ``model`` None: built from the directory's ``config.json``.
    - ``param_dtype``: the stored leaves' dtype; None (default) is the
      model's compute dtype (right for serving); training callers wanting
      fp32 masters pass ``torch.float32``.
    - ``device``: where each leaf goes as soon as it is read (``cuda``
      unless ``"cpu"`` is passed).
    - ``topology`` (a ``MeshTopology``) and ``rank`` (default: this
      process's rank): each leaf is rank ``rank``'s block of the whole
      leaf as ``model.param_specs()`` lays it out over the topology at
      ZeRO stage 0 (``place_blocks``'s cut), and only that block is read.
    - ``cut(read, shape, sl)``: makes a leaf from ``read(index)`` (the
      ``index`` block of the whole leaf, contiguous on ``device`` in
      ``param_dtype``), given the whole leaf's ``shape`` and the rank's
      slice ``sl`` (the whole leaf without a topology); default
      ``read(sl)``.
    - ``reader``: an opened :class:`CheckpointReader` of ``path`` (its
      ``bytes_read`` then tells what the load read); default
      ``open_checkpoint(path)``.
    - ``rules``: the logical-axis rules of that layout (default
      ``parallel/sharding.DEFAULT_RULES``; the serving engines pass
      ``SERVING_RULES``, which keep every layer on every rank).
    """
    hf_cfg = _read_hf_config(path)
    model_type = model_type or hf_cfg.get("model_type")
    if model_type is None:
        raise ValueError(f"{path} has no config.json; pass model_type=")
    if model is None:
        model = _new_model(hf_cfg)
    if param_dtype is None:
        param_dtype = model.cfg.dtype
    device = resolve_device(device)

    plans = build_leaf_plans(model, model_type, hf_cfg)
    shapes = param_shapes(model)

    # validate leaf coverage: every model leaf must have a plan
    flat_shapes = list(_flat(shapes))
    flat_plans = {_keystr(p): v for p, v in _flat(plans)}
    missing = [_keystr(p) for p, _ in flat_shapes
               if _keystr(p) not in flat_plans]
    if missing:
        raise ValueError(
            f"no checkpoint mapping for leaves: {missing} "
            f"(model config doesn't match the checkpoint family?)")

    specs = None
    if topology is not None:
        specs = dict(_flat(ZeroShardingPlan(topology, 0, model.param_specs(),
                                            rules=rules).params(shapes)))
        if rank is None:
            rank = torch.distributed.get_rank()
    own_reader = reader is None
    reader = open_checkpoint(path) if own_reader else reader
    try:
        out = []
        for p, meta in flat_shapes:
            key = _keystr(p)
            plan = flat_plans[key]
            shape = tuple(meta.shape)
            plan.check(reader, key)
            sl = (tuple(slice(0, d) for d in shape) if specs is None
                  else local_slice(shape, specs[p], topology, rank))

            def read(index, plan=plan, key=key):
                index = _concrete(index, plan.shape)
                block = torch.empty(tuple(s.stop - s.start for s in index),
                                    dtype=param_dtype, device=device)
                plan.read_into(reader, index, block, key)
                return block

            out.append((p, read(sl) if cut is None else cut(read, shape, sl)))
    finally:
        if own_reader:
            reader.close()
    return model, _unflat(out)


def from_pretrained(path: str, param_dtype=None, device=None,
                    **config_overrides):
    """``(model, params)`` from an HF checkpoint directory, with optional
    config overrides (e.g. ``dtype=torch.float32``,
    ``attention_impl='reference'``)."""
    hf_cfg = _read_hf_config(path)
    if not hf_cfg:
        raise FileNotFoundError(os.path.join(path, "config.json"))
    model = _new_model(hf_cfg, **config_overrides)
    return load_hf_checkpoint(path, model=model, param_dtype=param_dtype,
                              model_type=hf_cfg.get("model_type"),
                              device=device)


def model_from_checkpoint(path: str, dtype=None):
    """Build (only) the model described by a checkpoint dir's config.json
    (CausalLM, or EncoderLM for the BERT family)."""
    cfg_file = os.path.join(path, "config.json")
    if not os.path.exists(cfg_file):
        raise ValueError(f"{path} has no config.json")
    hf_cfg = _read_hf_config(path)
    return _new_model(hf_cfg, **({} if dtype is None else {"dtype": dtype}))


def is_hf_checkpoint(path: str) -> bool:
    """True if ``path`` looks like an HF checkpoint directory (weights in
    ``*.safetensors`` or ``pytorch_model*.bin`` beside a ``config.json``),
    as against the port's universal checkpoints
    (``runtime/checkpointing.py``)."""
    if not os.path.isdir(path):
        return False
    entries = os.listdir(path)
    has_weights = any(e.endswith(".safetensors") or
                      (e.startswith("pytorch_model") and e.endswith(".bin"))
                      for e in entries)
    return has_weights and "config.json" in entries
