"""Port parity: the KV tier (host-RAM and disk spill of the prefix cache)
of ``deepspeed_tpu_torch`` against the JAX package's on the CPU.

The cases of ``tests/test_kv_tier.py`` that reach the store, the manager or
the engine (vocab 128, hidden 64, 2 layers, blocks of 8, 14-block pools),
with the JAX ``init(PRNGKey(0))`` weights x3 so that greedy streams vary:

- ``TieredKVStore``: every store case runs the same calls on the JAX store
  (numpy slabs) and on the port's (torch slabs made from the same arrays)
  and both must observe the same counters, LRU order and byte occupancy;
  the port's slabs come back bit for bit (host and disk, fp32, bf16 and
  fp8 bytes), a CRC fault or a truncated file reads as a miss, the host and
  disk bounds hold, files are namespaced per store, dead owners' files are
  swept and ``close`` removes a store's own; the native aio library and the
  numpy fallback read back the same bytes.
- The manager and engine: spilled and restored slabs equal the pre-eviction
  bytes (fp32, int8 and fp8 pools, scale planes included) and re-enter the
  index under their original keys; referenced and partial blocks never
  spill; the lookahead stops at the pool's budget; a restore under a full
  pool evicts or degrades to a miss; a tier configured off is the tier-less
  engine; the configuration surface (``configure_kv_tier``,
  ``configure_prefix_cache``) behaves as the JAX engine's.
- Against the JAX engine on identical traffic: greedy streams with the tier
  on (host and disk, fp32, int8 and fp8 pools) are byte-identical and
  ``tier_stats()``, ``prefix_stats()`` and ``prefix_digest()`` equal the
  JAX engine's key for key; a bf16 model's tier-on streams equal its
  tier-off ones; corrupting every spill file re-prefills with the same
  streams; preemption parks its payload in the tier, and a payload the tier
  dropped resumes by re-prefill with the same streams as the JAX engine.
"""

import os

import jax
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.v2 import InferenceEngineV2 as JEngine
from deepspeed_tpu.inference.v2 import RaggedInferenceEngineConfig as JConfig
from deepspeed_tpu.inference.v2.kv_tier import TieredKVStore as JStore
from deepspeed_tpu.inference.v2.scheduler import \
    ContinuousBatchingScheduler as JScheduler
from deepspeed_tpu.inference.v2.testing import greedy_generate as j_greedy
from deepspeed_tpu.models import transformer as jtf
from deepspeed_tpu_torch.inference.v2 import (ContinuousBatchingScheduler,
                                              InferenceEngineV2,
                                              RaggedInferenceEngineConfig)
from deepspeed_tpu_torch.inference.v2 import kv_tier
from deepspeed_tpu_torch.inference.v2.kv_tier import TieredKVStore
from deepspeed_tpu_torch.inference.v2.testing import (assert_greedy_parity,
                                                      greedy_generate)
from deepspeed_tpu_torch.models import transformer as ttf
from deepspeed_tpu_torch.models.weights import params_from_numpy
from deepspeed_tpu_torch.ops import op_builder
import torch_cpu  # noqa: F401  (one torch thread: see the module)

VOCAB = 128
BS = 8
KV = {"fp32": {}, "int8": dict(kv_quant_enabled=True),
      "fp8": dict(kv_quant_enabled=True, kv_quant_dtype="fp8_e4m3")}


def _cfg(mod, **kw):
    return mod.TransformerConfig(vocab_size=VOCAB, hidden_size=64,
                                 intermediate_size=128, num_layers=2,
                                 num_heads=2, max_seq_len=128, norm="rmsnorm",
                                 activation="silu", position="rope", **kw)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's tiny CPU ops run on one thread here: beside other test
    workers, torch's default of a thread per core oversubscribes the
    machine and every small op waits on the others."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def weights():
    jp = jtf.CausalLM(_cfg(jtf)).init(jax.random.PRNGKey(0))
    return jax.tree.map(lambda a: np.asarray(a) * (3 if a.ndim >= 2 else 1),
                        jp)


def _ecfg(config_cls, kv_blocks=14, max_seqs=4, prefix=True, kv="fp32",
          **kw):
    return config_cls(
        max_ragged_batch_size=128, max_ragged_sequence_count=max_seqs,
        max_chunk_tokens=32, kv_blocks=kv_blocks, kv_block_size=BS,
        max_tracked_sequences=64, enable_prefix_cache=prefix, **KV[kv], **kw)


def _port(weights, tier=True, host_bytes=64 << 20, disk_path=None,
          disk_bytes=0, model_kw=None, **kw):
    model_kw = model_kw or {}
    eng = InferenceEngineV2(ttf.CausalLM(_cfg(ttf, **model_kw)),
                            params_from_numpy(weights, device="cpu"),
                            _ecfg(RaggedInferenceEngineConfig, **kw),
                            device="cpu")
    if tier:
        eng.configure_kv_tier(True, host_bytes=host_bytes,
                              disk_path=disk_path, disk_bytes=disk_bytes)
    return eng


def _jax(weights, tier=True, host_bytes=64 << 20, disk_path=None,
         disk_bytes=0, **kw):
    eng = JEngine(jtf.CausalLM(_cfg(jtf)),
                  jax.tree.map(jax.numpy.asarray, weights),
                  _ecfg(JConfig, **kw))
    if tier:
        eng.configure_kv_tier(True, host_bytes=host_bytes,
                              disk_path=disk_path, disk_bytes=disk_bytes)
    return eng


def rand_prompt(rng, n):
    return rng.integers(0, VOCAB, size=n).tolist()


def shared_prefix_reqs(rng, k_prompts=4, n_req=12, sys_len=32, tail=6):
    sys_prompts = [rand_prompt(rng, sys_len) for _ in range(k_prompts)]
    return [sys_prompts[i % k_prompts] + rand_prompt(rng, tail)
            for i in range(n_req)]


def block_slabs(eng, block):
    """One block's slabs from every pool, as byte tensors (fp8 included)."""
    out = {}
    for name, pool in eng.state_manager.kv_cache.items():
        t = pool[:, block].clone()
        out[name] = t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn \
            else t
    return out


# ------------------------------------------------------- store, both packages
def np_entry(rng, nbytes=1024):
    n = nbytes // 4
    return {"k": rng.normal(size=n).astype(np.float32),
            "v": rng.normal(size=n).astype(np.float32)}


def as_torch(e):
    return {k: torch.from_numpy(v.copy()) for k, v in e.items()}


NBYTES = 2048        # one np_entry


def _observe(st):
    host, disk = st.lru_keys()
    return {"stats": dict(st.stats), "occ": st.occupancy(), "host": host,
            "disk": disk}


def both_stores(tmp_path, scenario, **store_kw):
    """Run ``scenario(store, to_slabs, disk_dir)`` on the JAX store and the
    port's with the same seeded entries; every observation must match.
    Returns the port's scenario result."""
    outs = []
    for pkg, cls, conv in (("jax", JStore, lambda e: e),
                           ("port", TieredKVStore, as_torch)):
        d = None
        if "disk_max_bytes" in store_kw:
            d = os.path.join(tmp_path, pkg)
            os.makedirs(d, exist_ok=True)
        st = cls(disk_path=d, **store_kw) if d else cls(**store_kw)
        rng = np.random.default_rng(0)
        res = scenario(st, lambda: conv(np_entry(rng)), d)
        outs.append((_observe(st), res))
        st.close()
    assert outs[0][0] == outs[1][0]
    return outs[1][1]


def test_store_put_get_roundtrip_and_pop(tmp_path):
    def scenario(st, mk, d):
        e = mk()
        assert st.put(("h", (1, 2)), e)
        got = st.get(("h", (1, 2)))
        for name in e:
            assert np.array_equal(np.asarray(got[name]), np.asarray(e[name]))
        assert st.get(("h", (1, 2))) is None       # get pops
        assert st.stats["hits"] == 1 and st.stats["misses"] == 1
        assert st.host_bytes == 0
    both_stores(tmp_path, scenario, host_max_bytes=1 << 20)


def test_store_host_lru_drops_oldest_without_disk(tmp_path):
    def scenario(st, mk, d):
        for i in range(3):
            assert st.put((i,), mk())
        assert st.lru_keys() == ([(1,), (2,)], [])
        assert st.stats["dropped"] == 1
        assert st.get((0,)) is None
    both_stores(tmp_path, scenario, host_max_bytes=2 * NBYTES)


def test_store_lru_touch_on_overwrite(tmp_path):
    def scenario(st, mk, d):
        st.put((0,), mk())
        st.put((1,), mk())
        st.put((0,), mk())            # an overwrite refreshes recency
        st.put((2,), mk())            # so (1,) is the LRU victim
        assert st.lru_keys()[0] == [(0,), (2,)]
    both_stores(tmp_path, scenario, host_max_bytes=2 * NBYTES)


def test_store_demotes_to_disk_and_restores(tmp_path):
    def scenario(st, mk, d):
        e0, e1 = mk(), mk()
        st.put((0,), e0)
        st.put((1,), e1)              # (0,) demotes to disk
        assert st.lru_keys() == ([(1,)], [(0,)])
        assert st.stats["demoted"] == 1 and st.disk_bytes > 0
        got = st.get((0,))            # disk round trip, CRC-checked
        for name in e0:
            assert np.array_equal(np.asarray(got[name]),
                                  np.asarray(e0[name]))
        assert st.disk_bytes == 0
    both_stores(tmp_path, scenario, host_max_bytes=NBYTES,
                disk_max_bytes=10 * NBYTES)


def test_store_disk_lru_bound_drops_oldest(tmp_path):
    def scenario(st, mk, d):
        for i in range(4):            # 1 host + 2 disk fit; 1 drops
            st.put((i,), mk())
        assert st.lru_keys() == ([(3,)], [(1,), (2,)])
        assert st.stats["dropped"] == 1
        assert st.get((0,)) is None
    both_stores(tmp_path, scenario, host_max_bytes=NBYTES,
                disk_max_bytes=2 * NBYTES)


def test_store_failed_demotion_leaves_no_partial_file(tmp_path):
    def scenario(st, mk, d):
        def boom(key, arr):
            with open(os.path.join(d, f"{key}.swp"), "wb") as fh:
                fh.write(b"partial")          # a torn write, then failure
            raise IOError("ENOSPC")

        st._swapper.swap_out = boom
        st.put((0,), mk())
        st.put((1,), mk())                    # (0,) demotes; the write fails
        assert st.stats["dropped"] == 1
        assert not [f for f in os.listdir(d) if f.endswith(".swp")]
    both_stores(tmp_path, scenario, host_max_bytes=NBYTES,
                disk_max_bytes=1 << 20)


def _first_swp(d):
    swp = [f for f in os.listdir(d) if f.endswith(".swp")]
    assert swp
    return os.path.join(d, swp[0])


@pytest.mark.parametrize("fault", ["crc", "truncate"])
def test_store_disk_fault_is_miss(tmp_path, fault):
    def scenario(st, mk, d):
        st.put((0,), mk())
        st.put((1,), mk())                    # (0,) on disk now
        path = _first_swp(d)
        with open(path, "r+b") as fh:
            if fault == "crc":                # same size, wrong bytes
                fh.seek(10)
                fh.write(b"\xff" * 32)
            else:                             # a torn write: half the file
                fh.truncate(os.path.getsize(path) // 2)
        assert st.get((0,)) is None           # a miss, not a crash
        assert st.stats["corrupt"] == 1
        assert not os.path.exists(path)
    both_stores(tmp_path, scenario, host_max_bytes=NBYTES,
                disk_max_bytes=10 * NBYTES)


def test_store_disk_files_namespaced_per_store(tmp_path):
    rng = np.random.default_rng(60)
    a = TieredKVStore(host_max_bytes=NBYTES, disk_path=str(tmp_path),
                      disk_max_bytes=10 * NBYTES)
    b = TieredKVStore(host_max_bytes=NBYTES, disk_path=str(tmp_path),
                      disk_max_bytes=10 * NBYTES)
    ea, eb = as_torch(np_entry(rng)), as_torch(np_entry(rng))
    a.put((0,), ea)
    a.put((1,), as_torch(np_entry(rng)))      # a's (0,) demotes
    b.put((0,), eb)
    b.put((1,), as_torch(np_entry(rng)))      # b's (0,) demotes
    got_a, got_b = a.get((0,)), b.get((0,))
    assert torch.equal(got_a["k"], ea["k"]) and torch.equal(got_b["k"],
                                                            eb["k"])
    assert a.stats["corrupt"] == 0 and b.stats["corrupt"] == 0
    a.close()
    b.close()


def test_store_counters_stay_monotonic_through_readmit(tmp_path):
    def scenario(st, mk, d):
        st.put((0,), mk())
        got = st.get((0,))
        st.readmit((0,), got)
        assert st.stats["spilled"] == 1       # a re-insert is no new spill
        assert st.stats["hits"] == 0 and st.stats["misses"] == 1
        assert (0,) in st
    both_stores(tmp_path, scenario, host_max_bytes=1 << 20)


def test_store_sweeps_dead_owner_files_keeps_live_ones(tmp_path):
    stale = os.path.join(tmp_path, "kvtier_999999999_0_0.swp")
    mine = os.path.join(tmp_path, f"kvtier_{os.getpid()}_77_0.swp")
    other = os.path.join(tmp_path, "unrelated.swp")
    for path in (stale, mine, other):
        with open(path, "wb") as fh:
            fh.write(b"x" * 64)
    st = TieredKVStore(host_max_bytes=NBYTES, disk_path=str(tmp_path),
                       disk_max_bytes=10 * NBYTES)
    assert not os.path.exists(stale)          # a dead owner's: swept
    assert os.path.exists(mine) and os.path.exists(other)
    st.close()


def test_store_close_removes_own_disk_files(tmp_path):
    def scenario(st, mk, d):
        st.put((0,), mk())
        st.put((1,), mk())                    # (0,) demoted to disk
        assert [f for f in os.listdir(d) if f.endswith(".swp")]
        st.close()
        assert not [f for f in os.listdir(d) if f.endswith(".swp")]
    both_stores(tmp_path, scenario, host_max_bytes=NBYTES,
                disk_max_bytes=10 * NBYTES)


def test_store_disk_only_configuration_demotes_directly(tmp_path):
    def scenario(st, mk, d):
        e = mk()
        assert st.put((0,), e)                # too big for the host bound
        assert st.occupancy()["host_blocks"] == 0
        assert st.occupancy()["disk_blocks"] == 1
        assert st.stats["spilled"] == 1 and st.stats["dropped"] == 0
        got = st.get((0,))
        assert np.array_equal(np.asarray(got["k"]), np.asarray(e["k"]))
    both_stores(tmp_path, scenario, host_max_bytes=16,
                disk_max_bytes=1 << 20)
    no_disk = TieredKVStore(host_max_bytes=16)
    assert not no_disk.put((0,), as_torch(np_entry(np.random.default_rng(1))))
    assert no_disk.stats["dropped"] == 1


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float8_e4m3fn,
                                   torch.int8],
                         ids=["bf16", "fp8", "int8"])
def test_store_disk_roundtrip_keeps_torch_dtypes(tmp_path, dtype):
    """A disk entry is written as bytes and viewed back as each slab's
    recorded torch dtype: no ml_dtypes, and the bytes are the slab's."""
    g = torch.Generator().manual_seed(3)
    raw = torch.randint(0, 256, (2, 2, 8, 16), dtype=torch.uint8,
                        generator=g)
    if dtype == torch.bfloat16:
        k = torch.randn(2, 2, 8, 16, generator=g).to(dtype)
    else:
        k = raw.view(dtype)
    e = {"k": k, "k_scale": torch.rand(2, 2, generator=g), "v": k.flip(0)}
    st = TieredKVStore(host_max_bytes=16, disk_path=str(tmp_path),
                       disk_max_bytes=1 << 20)
    st.put((0,), e)
    got = st.get((0,))
    for name, t in e.items():
        assert got[name].dtype == t.dtype and got[name].shape == t.shape
        assert torch.equal(got[name].view(torch.uint8), t.view(torch.uint8))
    st.close()


def test_store_owns_a_copy_of_each_slab():
    """The store copies each slab out of the caller's batch: ``host_bytes``
    is then the memory it really holds, and a later write to the batch
    cannot reach the entry."""
    batch = torch.arange(64, dtype=torch.float32).reshape(2, 4, 8)
    st = TieredKVStore(host_max_bytes=1 << 20)
    st.put((0,), {"k": batch[:, 1], "v": batch[:, 2]})
    batch.zero_()
    got = st.get((0,))
    assert got["k"].is_contiguous()
    assert got["k"].untyped_storage().nbytes() == got["k"].numel() * 4
    assert torch.equal(got["k"], torch.arange(64.).reshape(2, 4, 8)[:, 1])


def test_native_and_fallback_swappers_agree(tmp_path, monkeypatch):
    """g++ builds csrc/aio.cpp into build/host_ops/ and the swapper uses
    it; with no compiler the numpy fallback reads back the same bytes."""
    from deepspeed_tpu_torch.runtime.swap_tensor import AsyncTensorSwapper

    native = AsyncTensorSwapper(str(tmp_path / "native"))
    assert native.has_native
    so = op_builder.AsyncIOBuilder().so_path()
    assert so.exists() and so.parent == op_builder.BUILD_DIR
    assert so.parent.parts[-2:] == ("build", "host_ops")
    monkeypatch.setattr(op_builder.OpBuilder, "_lib_cache", {})
    monkeypatch.setattr(op_builder.OpBuilder, "compiler", lambda self: None)
    fallback = AsyncTensorSwapper(str(tmp_path / "fallback"))
    assert not fallback.has_native
    arr = np.random.default_rng(8).integers(0, 256, 4099).astype(np.uint8)
    with pytest.raises(ValueError, match="C-contiguous"):
        native.swap_out("y", np.zeros((4, 4), np.uint8)[:, 1])
    for sw in (native, fallback):
        sw.swap_out("x", arr)
        sw.wait()
    for sw in (native, fallback):
        for other in (native, fallback):         # each reads either's file
            buf = np.empty_like(arr)
            with open(other._path("x"), "rb") as fh:
                assert fh.read() == arr.tobytes()
            sw.swap_in("x", buf)
            sw.wait()
            np.testing.assert_array_equal(buf, arr)
    st = TieredKVStore(host_max_bytes=16, disk_path=str(tmp_path / "st"),
                       disk_max_bytes=1 << 20)
    assert not st.has_native
    e = as_torch(np_entry(np.random.default_rng(9)))
    st.put((0,), e)
    assert torch.equal(st.get((0,))["v"], e["v"])
    native.close()
    fallback.close()
    st.close()


def test_optimizer_state_swapper_matches_jax(tmp_path):
    """``OptimizerStateSwapper`` (carried with the swapper) pages moments
    through the same files as the JAX package's: either side reads what
    the other wrote."""
    from deepspeed_tpu.runtime.swap_tensor.async_swapper import \
        OptimizerStateSwapper as JSwapper
    from deepspeed_tpu_torch.runtime.swap_tensor import OptimizerStateSwapper

    port = OptimizerStateSwapper(str(tmp_path))
    ref = JSwapper(str(tmp_path))
    m = np.random.default_rng(4).normal(size=(3, 5)).astype(np.float32)
    for sw in (port, ref):
        sw.register("m", m.shape)
        np.testing.assert_array_equal(sw.load("m"), np.zeros_like(m))
    port.store("m", m)
    np.testing.assert_array_equal(ref.load("m"), m)
    ref.store("m", 2 * m)
    got = port.load("m")
    np.testing.assert_array_equal(got, 2 * m)
    assert got is port.load("m")             # the buffer is reused
    port.close()
    ref.close()


# ------------------------------------------------ manager and engine, port
@pytest.mark.parametrize("kv", sorted(KV))
def test_spill_restore_byte_roundtrip(weights, kv):
    rng = np.random.default_rng(7)
    eng = _port(weights, kv=kv, kv_blocks=16)
    prompt = rand_prompt(rng, 3 * BS + 2)
    eng.put([1], [prompt])
    sm = eng.state_manager
    indexed = list(sm.get_sequence(1).kv_blocks[:3])   # 3 full blocks
    before = {b: block_slabs(eng, b) for b in indexed}
    keys = [sm._block_hash[b] for b in indexed]
    eng.flush(1)
    assert sm._evict(3) == 3                  # spill all three
    t = eng.tier_stats()
    assert t["spilled"] == 3 and t["host_blocks"] == 3
    # the freed blocks are rewritten before the restore: the tier holds
    # copies, not the pool's bytes
    hold = sm.allocator.allocate(sm.allocator.free_blocks)
    for pool in sm.kv_cache.values():
        pool.view(torch.uint8)[:, hold].fill_(0x5A)
    sm.allocator.release(hold)
    assert eng.match_prefix(2, prompt) == 3 * BS
    assert eng.tier_stats()["restored"] == 3
    assert len(eng.drain_restore_times()) == 1       # one restored run
    for i, b_new in enumerate(sm.get_sequence(2).kv_blocks):
        after = block_slabs(eng, b_new)
        assert set(after) == set(before[indexed[i]]) and (
            kv == "fp32" or {"k_scale", "v_scale"} <= set(after))
        for name in after:
            assert torch.equal(after[name], before[indexed[i]][name]), name
        assert sm._block_hash[b_new] == keys[i]   # the original key
        assert sm._index[keys[i]] == b_new


def test_referenced_block_never_spilled(weights):
    rng = np.random.default_rng(9)
    eng = _port(weights, kv_blocks=16)
    eng.put([1], [rand_prompt(rng, 2 * BS + 1)])   # seq 1 holds its blocks
    sm = eng.state_manager
    held = list(sm.get_sequence(1).kv_blocks[:2])
    assert sm._evict(10) == 0
    assert eng.tier_stats()["spilled"] == 0
    assert all(b in sm._block_hash for b in held)


def test_partial_block_never_spilled(weights):
    rng = np.random.default_rng(10)
    eng = _port(weights, kv_blocks=16)
    eng.put([1], [rand_prompt(rng, BS + 3)])       # 1 full + 1 partial
    eng.flush(1)
    assert eng.state_manager._evict(10) == 1
    assert eng.tier_stats()["spilled"] == 1


def test_restore_shares_lru_with_device_hits(weights):
    rng = np.random.default_rng(11)
    eng = _port(weights, kv_blocks=16)
    prompt = rand_prompt(rng, 2 * BS + 2)
    eng.put([1], [prompt])
    eng.flush(1)
    eng.state_manager._evict(2)
    assert eng.match_prefix(2, prompt) == 2 * BS
    hits0 = eng.tier_stats()["hits"]
    assert eng.match_prefix(3, prompt) == 2 * BS   # pure device hits
    assert eng.tier_stats()["hits"] == hits0
    eng.flush(2)
    eng.flush(3)


def _lookahead_and_full_pool(eng):
    """The JAX cases at :175 and :475 on one engine: a spilled chain longer
    than the pool can take pops only what fits, and a restore into a pool
    held whole by a live sequence degrades to a miss and readmits."""
    rng = np.random.default_rng(66)
    sm = eng.state_manager
    out = []
    prompt = rand_prompt(rng, 6 * BS + 2)          # 6 full blocks
    eng.put([1], [prompt[:4 * BS]])
    eng.put([1], [prompt[4 * BS:]])
    eng.flush(1)
    out.append(sm._evict(6))
    p_b = rand_prompt(rng, 5 * BS)
    eng.put([2], [p_b[:32]])
    eng.put([2], [p_b[32:]])
    free = sm.allocator.free_blocks
    hits0 = eng.tier_stats()["hits"]
    out.append((free, eng.match_prefix(3, prompt),
                eng.tier_stats()["hits"] - hits0, len(sm._tier)))
    eng.flush(2)
    eng.flush(3)
    # fill the pool with a live sequence: nothing free, nothing evictable
    p_c = rand_prompt(rng, 7 * BS + 3)
    for s in range(0, len(p_c), 32):
        eng.put([4], [p_c[s:s + 32]])
    out.append((sm.allocator.free_blocks, sm.evictable_blocks,
                eng.match_prefix(5, prompt), dict(eng.tier_stats())))
    eng.flush(4)
    eng.flush(5)
    out.append((eng.match_prefix(6, prompt), dict(eng.tier_stats())))
    eng.flush(6)
    return out


def test_restore_lookahead_and_full_pool_match_jax(weights):
    got = _lookahead_and_full_pool(_port(weights, kv_blocks=8))
    assert got == _lookahead_and_full_pool(_jax(weights, kv_blocks=8))
    evicted, (free, matched, popped, left), full, again = got
    assert evicted == 6 and 0 < free < 6
    assert matched == free * BS and popped == free and left == 6 - free
    n_free, n_evictable, matched, st = full
    assert (n_free, n_evictable, matched) == (0, 0, 0)
    assert st["restored"] == free and st["misses"] >= 1
    assert again[0] == 6 * BS and again[1]["restored"] > free


def test_disabled_path_byte_identical(weights):
    rng = np.random.default_rng(14)
    reqs = shared_prefix_reqs(rng)
    plain = greedy_generate(_port(weights, tier=False), reqs, uid_base=500,
                            max_new_tokens=4)
    off = InferenceEngineV2(ttf.CausalLM(_cfg(ttf)),
                            params_from_numpy(weights, device="cpu"),
                            _ecfg(RaggedInferenceEngineConfig,
                                  kv_tier_enabled=False), device="cpu")
    assert greedy_generate(off, reqs, uid_base=500,
                           max_new_tokens=4) == plain
    assert off.tier_stats() == kv_tier.empty_tier_stats()
    assert not off.state_manager.kv_tier_enabled


def test_configure_host_bytes_preserves_disk_tier(weights, tmp_path):
    eng = _port(weights, disk_path=str(tmp_path), disk_bytes=1 << 20)
    eng.configure_kv_tier(True, host_bytes=128 << 20)
    assert eng.config.kv_tier_host_bytes == 128 << 20
    assert eng.config.kv_tier_disk_path == str(tmp_path)
    assert eng.config.kv_tier_disk_bytes == 1 << 20
    assert eng.state_manager._tier._swapper is not None
    eng.configure_kv_tier(True, disk_bytes=0)      # an explicit drop
    assert eng.state_manager._tier._swapper is None


def test_tier_requires_prefix_cache(weights):
    eng = _port(weights, tier=False, prefix=False)
    with pytest.raises(ValueError, match="prefix cache"):
        eng.configure_kv_tier(True)
    assert not eng.config.kv_tier_enabled
    assert not eng.state_manager.kv_tier_enabled
    with pytest.raises(ValueError, match="prefix cache"):
        InferenceEngineV2(ttf.CausalLM(_cfg(ttf)), device="cpu",
                          config=_ecfg(RaggedInferenceEngineConfig,
                                       prefix=False, kv_tier_enabled=True))


def test_disabling_prefix_cache_tears_down_tier(weights, tmp_path):
    eng = _port(weights, host_bytes=9000, disk_path=str(tmp_path),
                disk_bytes=1 << 20)
    greedy_generate(eng, shared_prefix_reqs(np.random.default_rng(3)),
                    max_new_tokens=2)
    assert eng.tier_stats()["disk_blocks"] > 0
    eng.configure_prefix_cache(False)
    assert not eng.state_manager.kv_tier_enabled
    assert not eng.config.kv_tier_enabled
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".swp")]
    assert eng.free_blocks == 14


def test_occupancy_carries_tier_fields(weights):
    rng = np.random.default_rng(15)
    fields = ("kv_blocks_host_tier", "kv_bytes_host_tier",
              "kv_blocks_disk_tier", "kv_bytes_disk_tier")
    for tier in (False, True):
        occ = _port(weights, tier=tier).occupancy()
        assert all(isinstance(occ[k], int) and occ[k] == 0 for k in fields)
    eng = _port(weights)
    sched = ContinuousBatchingScheduler(eng)
    for i, p in enumerate(shared_prefix_reqs(rng)):
        sched.submit(600 + i, p, max_new_tokens=3)
        sched.run_to_completion()
    occ = eng.occupancy()
    assert occ["kv_blocks_host_tier"] > 0 and occ["kv_bytes_host_tier"] > 0
    st = eng.tier_stats()
    assert (occ["kv_blocks_host_tier"], occ["kv_bytes_host_tier"]) == (
        st["host_blocks"], st["host_bytes"])


# ------------------------------------------------- against the JAX engine
# (KV representation, tier): host = a 64 MiB host tier; disk = a host tier
# of about one block over a 1 MiB disk tier, so spills demote at once
TIER_CASES = [("fp32", "host"), ("fp32", "disk"), ("int8", "host"),
              ("int8", "disk"), ("fp8", "disk")]


@pytest.mark.parametrize("kv,where", TIER_CASES,
                         ids=[f"{k}-{w}" for k, w in TIER_CASES])
def test_tier_streams_and_stats_match_jax(weights, tmp_path, kv, where):
    rng = np.random.default_rng(20)
    reqs = shared_prefix_reqs(rng)
    tier_kw = ({} if where == "host" else
               dict(host_bytes=9000, disk_bytes=1 << 20))
    engines = []
    for pkg, make in (("jax", _jax), ("port", _port)):
        if where == "disk":
            tier_kw["disk_path"] = str(tmp_path / pkg)
        engines.append(make(weights, kv=kv, **tier_kw))
    jeng, eng = engines
    for uid_base in (0, 100):            # a cold and a warm pass
        ref = j_greedy(jeng, reqs, uid_base=uid_base, max_new_tokens=4)
        got = greedy_generate(eng, reqs, uid_base=uid_base, max_new_tokens=4)
        assert_greedy_parity(ref, got, f"KV tier ({kv} KV, {where})")
        assert eng.tier_stats() == jeng.tier_stats()
        assert eng.prefix_stats() == jeng.prefix_stats()
        assert eng.prefix_digest() == jeng.prefix_digest()
        assert eng.occupancy() == jeng.occupancy()
    st = eng.tier_stats()
    assert st["restored"] > 0 and st["corrupt"] == 0
    assert (st["demoted"] > 0 and st["disk_blocks"] > 0) == (where == "disk")
    assert len({tuple(s) for s in got}) > 1        # not degenerate
    if kv == "fp32":
        off = greedy_generate(_port(weights, tier=False), reqs,
                              max_new_tokens=4)
        assert_greedy_parity(off, got, "KV tier on vs off")


def test_bf16_tier_on_equals_off(weights, tmp_path):
    """bf16 pools spill and restore as bytes: a bf16 model's streams with
    the tier on (host and disk) equal its streams with the tier off."""
    rng = np.random.default_rng(8)
    reqs = shared_prefix_reqs(rng)
    bf16 = dict(model_kw=dict(dtype=torch.bfloat16))
    off = greedy_generate(_port(weights, tier=False, **bf16), reqs,
                          uid_base=100, max_new_tokens=4)
    for tier_kw in ({}, dict(host_bytes=5000, disk_path=str(tmp_path),
                             disk_bytes=1 << 20)):
        eng = _port(weights, **tier_kw, **bf16)
        assert eng.state_manager.kv_cache["k"].dtype == torch.bfloat16
        on = greedy_generate(eng, reqs, uid_base=100, max_new_tokens=4)
        assert eng.tier_stats()["restored"] > 0
        assert bool(tier_kw) == (eng.tier_stats()["demoted"] > 0)
        assert_greedy_parity(off, on, "bf16 KV tier on vs off")


def _corrupt_run(eng, reqs, d):
    sched = (ContinuousBatchingScheduler if isinstance(eng, InferenceEngineV2)
             else JScheduler)(eng)
    for i, p in enumerate(reqs[:6]):
        sched.submit(300 + i, p, max_new_tokens=4)
        sched.run_to_completion()
    assert eng.tier_stats()["disk_blocks"] > 0
    for f in os.listdir(d):                  # corrupt every spill file
        if f.endswith(".swp"):
            with open(os.path.join(d, f), "r+b") as fh:
                fh.seek(0)
                fh.write(b"\xde\xad\xbe\xef" * 4)
    gens = []
    for i, p in enumerate(reqs[6:]):
        sched.submit(400 + i, p, max_new_tokens=4)
        sched.run_to_completion()
        gens.append(sched.finished[400 + i].generated)
    return gens, eng.tier_stats()


def test_disk_corrupt_entry_reprefills_end_to_end(weights, tmp_path):
    rng = np.random.default_rng(13)
    reqs = shared_prefix_reqs(rng)
    ref = greedy_generate(_port(weights, tier=False), reqs, uid_base=300,
                          max_new_tokens=4)
    out = []
    for pkg, make in (("jax", _jax), ("port", _port)):
        d = str(tmp_path / pkg)
        out.append(_corrupt_run(make(weights, host_bytes=9000, disk_path=d,
                                     disk_bytes=1 << 20), reqs, d))
    (j_gens, j_st), (gens, st) = out
    assert_greedy_parity(ref[6:], gens, "corrupt spill files re-prefill")
    assert gens == j_gens and st == j_st
    assert st["corrupt"] > 0


def test_preemption_parks_payload_in_tier(weights):
    """With a tier, a preempted sequence's payload is a tier entry (no new
    spill counted); a payload the tier lost resumes by re-prefill; both
    give the JAX engine's streams and counters."""
    rng = np.random.default_rng(6)
    prompts = [rand_prompt(rng, 60), rand_prompt(rng, 60)]
    runs = []
    for make, sched_cls in ((_jax, JScheduler),
                            (_port, ContinuousBatchingScheduler)):
        for lose in (False, True):
            eng = make(weights, admission_reservation=True,
                       admission_preemption_enabled=True,
                       admission_oversubscription_factor=3.0)
            sched = sched_cls(eng)
            sched.submit(510, prompts[0], max_new_tokens=16, shed_rank=1)
            for _ in range(4):
                sched.step()
            sched.submit(511, prompts[1], max_new_tokens=4, shed_rank=0)
            sched.step()
            assert 510 in sched.preempted
            sm = eng.state_manager
            assert ("__preempt__", 510) in sm._tier
            assert eng.tier_stats()["spilled"] == 0
            if lose:
                sm._tier.discard(("__preempt__", 510))
            fin = sched.run_to_completion(max_steps=2000)
            assert sched.preempt_stats() == {"preempted": 1, "resumed": 1}
            runs.append(([fin[510].generated, fin[511].generated],
                         eng.tier_stats(), sched.preempt_stats()))
    for j, p in zip(runs[:2], runs[2:]):
        assert_greedy_parity(j[0], p[0], "preemption through the tier")
        assert j[1:] == p[1:]
    assert_greedy_parity(runs[2][0], runs[3][0], "lost payload re-prefill")
