"""Port parity: ``deepspeed_tpu_torch.inference.v2.kv_quant`` and the
quantized branch of ``ops/paged_attention.py`` against the JAX package on
the CPU.

Inputs come from numpy with a fixed seed and go to both packages.

- ``touched_block_plan`` is integer and boolean bookkeeping: equal arrays.
- ``quantized_block_write`` repeats the JAX arithmetic step for step
  (dequantize, zero stale slots, merge, monotone scale, divide, round half
  to even or cast to e4m3): codes bit-identical and scales exactly equal,
  over two consecutive writes, with a reused block whose stale scale the
  fresh-block rule must ignore. The port writes in place; JAX returns new
  arrays.
- Quantized ``paged_attention_torch`` against ``paged_attention_xla`` in
  fp32: atol = rtol = 2e-5, the tolerance of the unquantized comparison
  (``tests/test_torch_paged_attention.py``). Not against the Pallas
  interpret path, which fails on this jax (ROADMAP queue 3).
- The byte accounting is integer arithmetic: equal.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.v2 import kv_quant as JK
from deepspeed_tpu.models import transformer as jtf
from deepspeed_tpu.ops import paged_attention as jpa
from deepspeed_tpu_torch.inference.v2 import kv_quant as TK
from deepspeed_tpu_torch.models import transformer as ttf
from deepspeed_tpu_torch.ops import paged_attention as tpa
import torch_cpu  # noqa: F401  (one torch thread: see the module)

BS, MB, NB, KH, D = 4, 6, 20, 2, 8

# row 0: a decode token at an unaligned position (its block holds earlier
# tokens: the monotone rule); row 1: an 8-token chunk from position 2
# across three blocks; row 2: a prefill from 0 into reused blocks 0 and 1
# whose stale codes and scales must be ignored; row 3: a padded row
TABLES = np.full((4, MB), -1, np.int32)
TABLES[0, :2] = [3, 7]
TABLES[1, :3] = [2, 5, 9]
TABLES[2, :2] = [0, 1]
STEPS = [
    (np.asarray([5, 2, 0, 0], np.int32), np.asarray([1, 8, 6, 0], np.int32),
     8),
    (np.asarray([6, 10, 6, 0], np.int32), np.asarray([1, 1, 1, 0], np.int32),
     1),
]
PLAN_KEYS = ("gather_ids", "live_slots", "has_prior",
             "n_flat", "t_flat", "slot_flat")


def _plans(start, ntok, chunk):
    jp = JK.touched_block_plan(jnp.asarray(TABLES), jnp.asarray(start),
                               jnp.asarray(ntok), chunk, BS, NB)
    tp = TK.touched_block_plan(torch.from_numpy(TABLES),
                               torch.from_numpy(start),
                               torch.from_numpy(ntok), chunk, BS, NB)
    return jp, tp


@pytest.mark.parametrize("step", [0, 1])
def test_touched_block_plan_matches_jax(step):
    jp, tp = _plans(*STEPS[step])
    for k in PLAN_KEYS:
        np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]),
                                      err_msg=k)
    scatter = np.asarray(jp["scatter_ids"])
    np.testing.assert_array_equal(tp["touched"].numpy(), scatter < NB)
    np.testing.assert_array_equal(tp["sel_ids"].numpy(), scatter[scatter < NB])


def _bytes(a):
    if isinstance(a, torch.Tensor):
        return a.view(torch.uint8).numpy()
    return np.asarray(a).view(np.uint8)


@pytest.mark.parametrize("dtype", ["int8", "fp8_e4m3"])
def test_quantized_block_write_matches_jax(dtype):
    rng = np.random.default_rng(0)
    qmax = TK.qmax_of(dtype)
    # stale pool content everywhere: old codes, large old scales
    codes = rng.uniform(-qmax, qmax, (NB, KH, BS, D)).astype(np.float32)
    jpool = jnp.asarray(codes).astype(JK.pool_dtype(dtype))
    if dtype == "int8":
        jpool = jnp.asarray(np.round(codes).astype(np.int8))
    jscale = jnp.asarray(rng.uniform(0.5, 2.0, (NB, KH)).astype(np.float32))
    tpool = torch.from_numpy(np.array(_bytes(jpool))).view(
        TK.pool_dtype(dtype)).reshape(NB, KH, BS, D)
    tscale = torch.from_numpy(np.array(jscale))
    for start, ntok, chunk in STEPS:
        vals = (rng.standard_normal((len(ntok) * chunk, KH, D))
                * 0.3).astype(np.float32)
        jp, tp = _plans(start, ntok, chunk)
        jpool, jscale = JK.quantized_block_write(jpool, jscale,
                                                 jnp.asarray(vals), jp)
        TK.quantized_block_write(tpool, tscale, torch.from_numpy(vals), tp)
        np.testing.assert_array_equal(_bytes(tpool), _bytes(jpool))
        np.testing.assert_array_equal(tscale.numpy(), np.asarray(jscale))
    # the reused blocks took fresh scales well below their stale 0.5-2.0
    assert float(tscale[0].max()) < 0.5 and float(tscale[1].max()) < 0.5


def _quant_case(seed, dtype, H, C, ctx_lens, n_pad=1):
    rng = np.random.default_rng(seed)
    NBc = sum(-(-c // BS) for c in ctx_lens) + 3
    rows = len(ctx_lens) + n_pad
    q = rng.standard_normal((rows, C, H, D)).astype(np.float32)
    kd = rng.standard_normal((NBc, KH, BS, D)).astype(np.float32)
    vd = rng.standard_normal((NBc, KH, BS, D)).astype(np.float32)
    # quantize each (block, kv head) slab with the JAX package's writer
    # arithmetic: scale = amax / qmax
    qmax = JK.qmax_of(dtype)
    ks = np.abs(kd).max(axis=(2, 3)) / qmax
    vs = np.abs(vd).max(axis=(2, 3)) / qmax
    kq = np.clip(kd / ks[:, :, None, None], -qmax, qmax)
    vq = np.clip(vd / vs[:, :, None, None], -qmax, qmax)
    if dtype == "int8":
        kq, vq = np.round(kq).astype(np.int8), np.round(vq).astype(np.int8)
    else:
        kq = np.asarray(jnp.asarray(kq).astype(jnp.float8_e4m3fn))
        vq = np.asarray(jnp.asarray(vq).astype(jnp.float8_e4m3fn))
    perm = rng.permutation(NBc)
    tables = np.full((rows, MB * 3), -1, np.int32)
    start = np.zeros(rows, np.int32)
    ntok = np.zeros(rows, np.int32)
    pos = 0
    for i, ctx in enumerate(ctx_lens):
        nblk = -(-ctx // BS)
        tables[i, :nblk] = perm[pos:pos + nblk]
        pos += nblk
        n = min(C, ctx)
        start[i], ntok[i] = ctx - n, n
    return (q, kq, vq, tables, start, ntok, ks.astype(np.float32),
            vs.astype(np.float32))


def _to_torch(a):
    if a.dtype.name == "float8_e4m3fn":
        return torch.from_numpy(np.array(a.view(np.uint8))).view(
            torch.float8_e4m3fn)
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("dtype", ["int8", "fp8_e4m3"])
@pytest.mark.parametrize("H,C,ctx_lens,alibi,window", [
    pytest.param(2, 1, [1, 9, 30], False, 0, id="decode-G1"),
    pytest.param(8, 1, [5, 17, 40], True, 0, id="decode-G4-alibi"),
    pytest.param(8, 5, [5, 23, 50], False, 0, id="chunk5-G4"),
    pytest.param(4, 5, [7, 38, 64], True, 11, id="chunk5-G2-alibi-window"),
])
def test_quantized_paged_attention_matches_xla(dtype, H, C, ctx_lens, alibi,
                                               window):
    arrs = _quant_case(len(ctx_lens) + C, dtype, H, C, ctx_lens)
    q, kq, vq, tables, start, ntok, ks, vs = arrs
    slopes = (np.asarray([2.0 ** (-8.0 * (i + 1) / H) for i in range(H)],
                         np.float32) if alibi else None)
    ref = jpa.paged_attention_xla(
        jnp.asarray(q), jnp.asarray(kq), jnp.asarray(vq), jnp.asarray(tables),
        jnp.asarray(start), jnp.asarray(ntok),
        alibi_slopes=None if slopes is None else jnp.asarray(slopes),
        window=window, k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
    out = tpa.paged_attention(
        *(_to_torch(a) for a in (q, kq, vq, tables, start, ntok)),
        alibi_slopes=None if slopes is None else torch.from_numpy(slopes),
        window=window, k_scale=_to_torch(ks), v_scale=_to_torch(vs))
    ref = np.asarray(ref)
    for i in range(len(ntok)):
        v = int(ntok[i])       # valid rows only: padded rows are unspecified
        np.testing.assert_allclose(out[i, :v].numpy(), ref[i, :v], atol=2e-5,
                                   rtol=2e-5)


def test_kernel_wrapper_refuses_cpu_tensors_with_quant_pools():
    arrs = [_to_torch(a) for a in _quant_case(5, "int8", 4, 1, [5, 9])]
    q, kq, vq, tables, start, ntok, ks, vs = arrs
    with pytest.raises(ValueError, match="CUDA tensors"):
        tpa.paged_attention_cuda(q, kq, vq, tables, start, ntok,
                                 k_scale=ks, v_scale=vs)


@pytest.mark.parametrize("cfg_name", ["TINY_TEST", "MISTRAL_7B",
                                      "LLAMA2_70B"])
def test_kv_bytes_and_budget_match_jax(cfg_name):
    jcfg = getattr(jtf, cfg_name)
    tcfg = getattr(ttf, cfg_name)
    for bs in (8, 16):
        assert (TK.kv_bytes_per_block(tcfg, bs, True)
                == JK.kv_bytes_per_block(jcfg, bs, True))
        for jdt, tdt in ((jnp.float32, torch.float32),
                         (jnp.bfloat16, torch.bfloat16)):
            assert (TK.kv_bytes_per_block(tcfg, bs, False, tdt)
                    == JK.kv_bytes_per_block(jcfg, bs, False, jdt))
            for budget in (1, 10 ** 6, 8 * 2 ** 30):
                assert (TK.blocks_for_budget(budget, tcfg, bs, False, tdt)
                        == JK.blocks_for_budget(budget, jcfg, bs, False, jdt))
        for budget in (1, 10 ** 6, 8 * 2 ** 30):
            assert (TK.blocks_for_budget(budget, tcfg, bs, True)
                    == JK.blocks_for_budget(budget, jcfg, bs, True))


def test_validation_and_helpers_match_jax():
    assert TK.SUPPORTED_DTYPES == JK.SUPPORTED_DTYPES
    assert TK.SUPPORTED_GRANULARITIES == JK.SUPPORTED_GRANULARITIES
    assert (TK.Q_MAX, TK.SCALE_EPS) == (JK.Q_MAX, JK.SCALE_EPS)
    assert TK.pool_dtype("int8") == torch.int8
    assert TK.pool_dtype("fp8_e4m3") == torch.float8_e4m3fn
    for d in ("int8", "fp8_e4m3"):
        assert TK.qmax_of(d) == JK.qmax_of(d)
        assert TK.qmax_of(TK.pool_dtype(d)) == JK.qmax_of(JK.pool_dtype(d))
        TK.validate_kv_quant(d, "block")
    for bad in [("int4", "block"), ("fp8", "block"), ("int8", "head")]:
        with pytest.raises(ValueError):
            TK.validate_kv_quant(*bad)
        with pytest.raises(ValueError):
            JK.validate_kv_quant(*bad)


def test_manager_allocates_quantized_pools():
    from deepspeed_tpu_torch.inference.v2.ragged import DSStateManager

    cfg = dataclasses.replace(ttf.TINY_TEST)
    for d, dt in (("int8", torch.int8), ("fp8_e4m3", torch.float8_e4m3fn)):
        sm = DSStateManager(cfg, num_blocks=6, block_size=4, device="cpu",
                            kv_quant=True, kv_quant_dtype=d)
        kc = sm.kv_cache
        assert set(kc) == {"k", "v", "k_scale", "v_scale"}
        assert kc["k"].dtype == dt and tuple(kc["k"].shape) == (2, 6, 2, 4, 16)
        assert kc["k_scale"].dtype == torch.float32
        assert tuple(kc["k_scale"].shape) == (2, 6, 2)
        assert kc["k"].data_ptr() != kc["v"].data_ptr()
        assert kc["k_scale"].data_ptr() != kc["v_scale"].data_ptr()
        assert (sm.occupancy()["bytes_per_block"]
                == JK.kv_bytes_per_block(jtf.TINY_TEST, 4, True))


@pytest.mark.parametrize("dtype", ["int8", "fp8_e4m3"])
def test_quantized_block_write_after_trim_matches_jax(dtype):
    """Speculative rollback under kv_quant: a block takes 1 token, then a
    certain token and 2 large drafts (its scale rises), the 2 drafts are
    trimmed (start_pos falls back to 2), and the next token lands inside
    it. Every token kept is small, yet the write keeps the inflated scale
    (the monotone rule: the block holds earlier tokens), zeroes the
    trimmed slot past the context, and gives the JAX package's codes and
    scales bit for bit."""
    rng = np.random.default_rng(1)
    tables = np.full((1, MB), -1, np.int32)
    tables[0, 0] = 4
    jpool = jnp.zeros((NB, KH, BS, D), JK.pool_dtype(dtype))
    jscale = jnp.zeros((NB, KH), jnp.float32)
    tpool = torch.zeros((NB, KH, BS, D), dtype=TK.pool_dtype(dtype))
    tscale = torch.zeros((NB, KH), dtype=torch.float32)
    # start, magnitude of each token written
    steps = [(0, [0.1]), (1, [0.1, 3.0, 3.0]), (2, [0.1])]
    for i, (start, mags) in enumerate(steps):
        n = len(mags)
        vals = (rng.standard_normal((n, KH, D))
                * np.asarray(mags)[:, None, None]).astype(np.float32)
        args = (np.asarray([start], np.int32), np.asarray([n], np.int32))
        jp = JK.touched_block_plan(jnp.asarray(tables), jnp.asarray(args[0]),
                                   jnp.asarray(args[1]), n, BS, NB)
        tp = TK.touched_block_plan(torch.from_numpy(tables),
                                   torch.from_numpy(args[0]),
                                   torch.from_numpy(args[1]), n, BS, NB)
        jpool, jscale = JK.quantized_block_write(jpool, jscale,
                                                 jnp.asarray(vals), jp)
        TK.quantized_block_write(tpool, tscale, torch.from_numpy(vals), tp)
        np.testing.assert_array_equal(_bytes(tpool), _bytes(jpool))
        np.testing.assert_array_equal(tscale.numpy(), np.asarray(jscale))
        if i == 1:
            inflated = tscale[4].clone()
    assert torch.equal(tscale[4], inflated)          # kept, not lowered
    live = tpool[4, :, :3].float().abs().amax(dim=(1, 2)) * inflated
    assert (live < inflated * TK.qmax_of(dtype) / 4).all()   # small now
    assert not tpool[4, :, 3].float().abs().any()    # the trimmed slot
