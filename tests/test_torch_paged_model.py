"""Port parity: ``deepspeed_tpu_torch``'s ``PagedCausalLM.forward`` against
the JAX package's ``PagedCausalLM.forward`` on the CPU.

Weights come from the JAX ``CausalLM.init(PRNGKey(0))`` through
``params_from_numpy``; tokens and tables are fixed numpy arrays. Two ragged
steps run on both: a prefill step, then a mixed step (a decode row, a
prompt chunk, a row whose padded columns pass ``max_seq_len - 1``, and a
padded row). The logits and the whole updated KV pools must agree. Float32;
tolerance atol = rtol = 1e-4 for logits (matmul chains summed in different
orders by two BLAS libraries) and atol = rtol = 1e-5 for the pools (one
projection each).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.v2.paged_model import PagedCausalLM as JPaged
from deepspeed_tpu.models import transformer as jtf
from deepspeed_tpu_torch.inference.v2.paged_model import PagedCausalLM
from deepspeed_tpu_torch.models import transformer as ttf
from deepspeed_tpu_torch.models.weights import params_from_numpy

SMALL = dict(num_layers=2, hidden_size=64, intermediate_size=96,
             vocab_size=256, max_seq_len=64, num_heads=4,
             use_flash_attention=False)
BS, MB, NB = 8, 8, 24

CONFIGS = {
    "tiny": (jtf.TINY_TEST, {}),
    "gpt2": (jtf.GPT2_125M, {}),
    "bloom": (jtf.BLOOM_560M, {}),
    "neox": (jtf.PYTHIA_1B4, {}),
    "gptj": (jtf.GPTJ_6B, {}),
    "mistral-window": (jtf.MISTRAL_7B, {"num_kv_heads": 2,
                                        "sliding_window": 6}),
    "mixed-window": (jtf.TINY_TEST, {"sliding_window": (None, 5)}),
}

# step 1: prefill 13 and 6 tokens; step 2: a decode row at 13, a 5-token
# chunk at 6, 3 tokens at 58 (padded columns reach position 65 > 63), a
# padded row (n_tokens 0, tables -1)
TABLES = np.full((4, MB), -1, np.int32)
TABLES[0, :2] = [3, 7]
TABLES[1, :2] = [5, 9]
TABLES[2, :8] = np.arange(10, 18)
STEPS = [
    # start_pos, n_tokens, chunk width
    (np.asarray([0, 0, 0, 0]), np.asarray([13, 6, 0, 0]), 16),
    (np.asarray([13, 6, 58, 0]), np.asarray([1, 5, 3, 0]), 8),
]


def _configs(name):
    base, extra = CONFIGS[name]
    jcfg = dataclasses.replace(base, **SMALL, **extra, dtype=jnp.float32)
    tcfg = ttf.TransformerConfig(**{**dataclasses.asdict(jcfg),
                                    "dtype": torch.float32})
    return jcfg, tcfg


def _run(name, verify_width=0):
    jcfg, tcfg = _configs(name)
    jm = jtf.CausalLM(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    jpaged = JPaged(jm, BS, MB)
    tpaged = PagedCausalLM(ttf.CausalLM(tcfg), BS)
    shape = (jcfg.num_layers, NB, jcfg.kv_heads, BS, jcfg.head_dim)
    jcache = {"k": jnp.zeros(shape), "v": jnp.zeros(shape)}
    tcache = {"k": torch.zeros(shape), "v": torch.zeros(shape)}
    rng = np.random.default_rng(0)
    for i, (start, ntok, C) in enumerate(STEPS):
        tokens = rng.integers(0, jcfg.vocab_size, (4, C)).astype(np.int32)
        args = (tokens, start.astype(np.int32), ntok.astype(np.int32), TABLES)
        vw = verify_width if i == len(STEPS) - 1 else 0
        if vw:
            jl, jcache = jpaged.forward_verify(jp, jcache,
                                               *map(jnp.asarray, args),
                                               verify_width=vw)
        else:
            jl, jcache = jpaged.forward(jp, jcache, *map(jnp.asarray, args))
        tl = tpaged.forward(tp, tcache, *map(torch.from_numpy, args),
                            verify_width=vw)
        valid = ntok > 0            # the padded row's logits are unspecified
        np.testing.assert_allclose(tl.numpy()[valid], np.asarray(jl)[valid],
                                   atol=1e-4, rtol=1e-4)
        for k in ("k", "v"):
            np.testing.assert_allclose(tcache[k].numpy(),
                                       np.asarray(jcache[k]), atol=1e-5,
                                       rtol=1e-5)
    return tl


@pytest.mark.parametrize("name", list(CONFIGS))
def test_forward_matches_jax(name):
    logits = _run(name)
    assert logits.shape == (4, SMALL["vocab_size"])


def test_forward_verify_width_matches_jax():
    logits = _run("tiny", verify_width=4)
    assert logits.shape == (4, 4, SMALL["vocab_size"])


def test_padded_rows_never_write_pool():
    """Rows past n_tokens and padded batch rows write nothing (the JAX
    forward drops them with a sentinel block; here they are selected out)."""
    _, tcfg = _configs("tiny")
    model = ttf.CausalLM(tcfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    paged = PagedCausalLM(model, BS)
    shape = (tcfg.num_layers, NB, tcfg.kv_heads, BS, tcfg.head_dim)
    cache = {"k": torch.zeros(shape), "v": torch.zeros(shape)}
    tokens = torch.ones((2, 8), dtype=torch.int32)
    tables = torch.full((2, MB), -1, dtype=torch.int32)
    tables[0, 0] = 4
    paged.forward(params, cache, tokens, torch.tensor([0, 0]),
                  torch.tensor([3, 0]), tables)
    written = cache["k"].abs().sum(dim=(0, 2, 4)) != 0          # [NB, bs]
    assert written[4, :3].all() and int(written.sum()) == 3
