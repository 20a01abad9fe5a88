"""Port parity: the ragged serving path of ``deepspeed_tpu_torch`` end to end
against the JAX engine on the CPU, plus the port's hygiene rules.

- Greedy token streams through ``InferenceEngineV2`` and the Dynamic
  SplitFuse scheduler must be byte-identical to the JAX engine's on fp32
  ``TINY_TEST`` with the same weights (the JAX ``init(PRNGKey(0))``, x4 so
  the streams are not one repeated token), for prompts that span several
  KV blocks and several prompt chunks, run sequentially and concurrently.
- The pool's blocks all come back after the run.
- The port imports neither ``jax`` nor ``deepspeed_tpu``, and its entry
  points refuse to run without CUDA unless ``device="cpu"`` is given.
- Options this slice has not ported raise ``NotImplementedError``.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.v2 import InferenceEngineV2 as JEngine
from deepspeed_tpu.inference.v2 import RaggedInferenceEngineConfig as JConfig
from deepspeed_tpu.inference.v2.testing import greedy_generate as j_greedy
from deepspeed_tpu.models import transformer as jtf
from deepspeed_tpu_torch.inference.v2 import (InferenceEngineV2,
                                              RaggedInferenceEngineConfig)
from deepspeed_tpu_torch.inference.v2.testing import (assert_greedy_parity,
                                                      greedy_generate)
from deepspeed_tpu_torch.models import transformer as ttf
from deepspeed_tpu_torch.models.weights import params_from_numpy

ENGINE_KW = dict(kv_blocks=48, kv_block_size=16, max_chunk_tokens=16,
                 max_ragged_batch_size=40, max_ragged_sequence_count=4)
PROMPT_LENS = (5, 40, 17, 33, 3)     # up to 3 blocks, 3 chunks; 5 requests
NEW_TOKENS = 10


@pytest.fixture(scope="module")
def weights():
    jp = jtf.CausalLM(jtf.TINY_TEST).init(jax.random.PRNGKey(0))
    return jax.tree.map(lambda a: np.asarray(a) * (4 if a.ndim >= 2 else 1),
                        jp)


def _prompts():
    rng = np.random.default_rng(0)
    return [rng.integers(0, 256, n).tolist() for n in PROMPT_LENS]


def _port_engine(weights):
    return InferenceEngineV2(ttf.CausalLM(ttf.TINY_TEST),
                             params_from_numpy(weights, device="cpu"),
                             RaggedInferenceEngineConfig(**ENGINE_KW),
                             device="cpu")


@pytest.mark.parametrize("sequential", [True, False])
def test_greedy_streams_match_jax(weights, sequential):
    jeng = JEngine(jtf.CausalLM(jtf.TINY_TEST),
                   jax.tree.map(jax.numpy.asarray, weights),
                   JConfig(**ENGINE_KW))
    ref = j_greedy(jeng, _prompts(), max_new_tokens=NEW_TOKENS,
                   sequential=sequential)
    assert len({tuple(s) for s in ref}) == len(ref)   # not degenerate
    got = greedy_generate(_port_engine(weights), _prompts(),
                          max_new_tokens=NEW_TOKENS, sequential=sequential)
    assert_greedy_parity(ref, got, "the torch port")


def test_free_blocks_restored(weights):
    eng = _port_engine(weights)
    streams = greedy_generate(eng, _prompts(), max_new_tokens=NEW_TOKENS,
                              sequential=False)
    assert [len(s) for s in streams] == [NEW_TOKENS] * len(PROMPT_LENS)
    assert eng.free_blocks == ENGINE_KW["kv_blocks"]
    assert eng.state_manager.tracked_sequences == []
    occ = eng.occupancy()
    assert occ["in_use_blocks"] == 0 and occ["free_blocks"] == 48
    # bytes per block: K and V, 2 layers x 2 kv-heads x 16 slots x 16 dims
    assert occ["bytes_per_block"] == 2 * 2 * 2 * 16 * 16 * 4


HYGIENE = r"""
import importlib, pkgutil, sys
import numpy as np
import torch
import deepspeed_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
bad = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
       or m == "deepspeed_tpu" or m.startswith("deepspeed_tpu.")]
assert not bad, bad
assert not torch.cuda.is_available()
from deepspeed_tpu_torch.inference.v2 import (InferenceEngineV2,
                                              RaggedInferenceEngineConfig)
from deepspeed_tpu_torch.inference.v2 import kv_quant, weight_quant
from deepspeed_tpu_torch.inference.v2.ragged import DSStateManager
from deepspeed_tpu_torch.models.transformer import CausalLM, TINY_TEST
from deepspeed_tpu_torch.models.weights import params_from_numpy
from deepspeed_tpu_torch.ops import quantizer
quant = RaggedInferenceEngineConfig(kv_quant_enabled=True,
                                    weight_quant_enabled=True)
calls = [lambda: InferenceEngineV2(CausalLM(TINY_TEST)),
         lambda: InferenceEngineV2(CausalLM(TINY_TEST), config=quant),
         lambda: CausalLM(TINY_TEST).init(),
         lambda: DSStateManager(TINY_TEST, num_blocks=4),
         lambda: DSStateManager(TINY_TEST, num_blocks=4, kv_quant=True),
         lambda: params_from_numpy({"w": np.ones(2)})]
for call in calls:
    try:
        call()
    except RuntimeError as e:
        assert "device='cpu'" in str(e), e
    else:
        raise AssertionError("an entry point ran without CUDA or device='cpu'")
print("ok")
"""


def test_port_imports_no_jax_and_needs_cuda_by_default():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=os.pathsep.join(sys.path))
    out = subprocess.run([sys.executable, "-c", HYGIENE], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


@pytest.mark.parametrize("field", [
    "enable_prefix_cache", "kv_tier_enabled", "admission_reservation",
    "admission_preemption_enabled"])
def test_unported_engine_options_raise(field):
    cfg = RaggedInferenceEngineConfig(**{field: True})
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        InferenceEngineV2(ttf.CausalLM(ttf.TINY_TEST), config=cfg,
                          device="cpu")


def test_unported_model_paths_raise():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        InferenceEngineV2(ttf.CausalLM(ttf.TINY_TEST), device="cpu",
                          mesh=object())
    # CausalLM.apply is ported; the model paths that still wait raise
    moe = ttf.CausalLM(ttf.TransformerConfig(moe_num_experts=2))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        moe.apply({}, torch.zeros((1, 2), dtype=torch.int64))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        moe.init(device="cpu")
