"""The BERT-family encoder in the port (``deepspeed_tpu_torch/models/
encoder.py``) and its HF import, on the CPU: every case of
``tests/test_encoder.py`` against ``transformers`` at the same tolerances
(hidden states, pooler, masked-LM logits, padding masks, RoBERTa position
offsets, the task heads, v1 ``encode``/``mlm``/``classify`` serving), plus
the loaded trees bit-equal to the JAX package's, ``encoder_config_from_hf``
field for field, and ``EncoderLM.apply`` against the JAX one on the same
weights. Encoder serving over a tensor mesh is refused, naming ROADMAP
queue 1 item 16b-ii (the JAX package's ``test_encoder_tp_serving``)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu.models import convert as jconv
from deepspeed_tpu.models import encoder as jenc
from deepspeed_tpu_torch.inference.engine import InferenceEngine
from deepspeed_tpu_torch.models import convert as tconv
from deepspeed_tpu_torch.models.encoder import EncoderConfig, EncoderLM
from deepspeed_tpu_torch.models.weights import params_to_numpy
import torch_cpu  # noqa: F401  (one torch thread: see the module)

transformers = pytest.importorskip("transformers")

TOL = dict(atol=4e-4, rtol=4e-4)


def _save(model, tmp_path_factory, name):
    path = tmp_path_factory.mktemp(name)
    model.save_pretrained(path, safe_serialization=True)
    return str(path)


def _bert_cfg(**kw):
    base = dict(vocab_size=99, hidden_size=32, intermediate_size=64,
                num_hidden_layers=3, num_attention_heads=4,
                max_position_embeddings=48, type_vocab_size=2,
                hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    base.update(kw)
    return transformers.BertConfig(**base)


def _roberta_cfg(**kw):
    base = dict(vocab_size=120, hidden_size=32, intermediate_size=64,
                num_hidden_layers=2, num_attention_heads=4,
                max_position_embeddings=50, type_vocab_size=1,
                pad_token_id=1, hidden_dropout_prob=0.0,
                attention_probs_dropout_prob=0.0)
    base.update(kw)
    return transformers.RobertaConfig(**base)


def _distil_cfg(**kw):
    base = dict(vocab_size=110, dim=32, hidden_dim=64, n_layers=2,
                n_heads=4, max_position_embeddings=48, dropout=0.0,
                attention_dropout=0.0)
    base.update(kw)
    return transformers.DistilBertConfig(**base)


def _load(path):
    return tconv.from_pretrained(path, dtype=torch.float32, device="cpu")


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _engine(model, params):
    return InferenceEngine(model, params=params, config={"dtype": "fp32"},
                           device="cpu")


def test_bert_model_parity(tmp_path_factory):
    """BertModel: last_hidden_state AND pooler_output match HF, with a
    ragged padding mask and nonzero token types."""
    torch.manual_seed(0)
    hf = transformers.BertModel(_bert_cfg()).eval()
    model, params = _load(_save(hf, tmp_path_factory, "bert_model"))
    assert isinstance(model, EncoderLM)
    assert model.cfg.with_pooler and not model.cfg.with_mlm_head
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, 99, (2, 12))
    mask = np.ones((2, 12), np.int64)
    mask[0, 9:] = 0
    mask[1, 5:] = 0
    types = (rng.integers(0, 2, (2, 12)) * mask).astype(np.int64)
    with torch.no_grad():
        out = hf(_t(tokens), attention_mask=_t(mask),
                 token_type_ids=_t(types))
        hidden, pooled = model.apply(params, _t(tokens), _t(mask),
                                     _t(types))
    theirs = out.last_hidden_state.numpy()
    for b in range(2):
        live = int(mask[b].sum())
        np.testing.assert_allclose(hidden[b, :live].numpy(),
                                   theirs[b, :live], **TOL)
    np.testing.assert_allclose(pooled.numpy(), out.pooler_output.numpy(),
                               **TOL)


def test_bert_mlm_parity(tmp_path_factory):
    """BertForMaskedLM logits match HF (prediction-head transform + tied
    decoder + output bias)."""
    torch.manual_seed(1)
    hf = transformers.BertForMaskedLM(_bert_cfg()).eval()
    model, params = _load(_save(hf, tmp_path_factory, "bert_mlm"))
    assert model.cfg.with_mlm_head and not model.cfg.with_pooler
    tokens = np.random.default_rng(1).integers(0, 99, (2, 10))
    with torch.no_grad():
        theirs = hf(_t(tokens)).logits.numpy()
        hidden, _ = model.apply(params, _t(tokens))
        ours = model.mlm_logits(params, hidden).numpy()
    np.testing.assert_allclose(ours, theirs, **TOL)


def test_roberta_mlm_parity(tmp_path_factory):
    """RoBERTa: fairseq position offset (pad_token_id+1) + lm_head naming."""
    torch.manual_seed(2)
    hf = transformers.RobertaForMaskedLM(_roberta_cfg()).eval()
    model, params = _load(_save(hf, tmp_path_factory, "roberta_mlm"))
    assert model.cfg.position_offset == 2
    assert model.cfg.max_seq_len == 48
    tokens = np.random.default_rng(2).integers(2, 120, (2, 11))
    with torch.no_grad():
        theirs = hf(_t(tokens)).logits.numpy()
        hidden, _ = model.apply(params, _t(tokens))
        ours = model.mlm_logits(params, hidden).numpy()
    np.testing.assert_allclose(ours, theirs, **TOL)


def test_encoder_serving_engine(tmp_path_factory):
    """v1 InferenceEngine serves an encoder: encode() + mlm(); generate()
    refused with the JAX engine's ValueError."""
    torch.manual_seed(3)
    hf = transformers.BertForMaskedLM(_bert_cfg()).eval()
    model, params = _load(_save(hf, tmp_path_factory, "bert_serve"))
    engine = _engine(model, params)
    tokens = np.random.default_rng(3).integers(0, 99, (2, 8))
    with torch.no_grad():
        theirs = hf(_t(tokens)).logits.numpy()
    np.testing.assert_allclose(engine.mlm(tokens).numpy(), theirs, **TOL)
    hidden, pooled = engine.forward(tokens)      # forward is encode
    assert pooled is None and tuple(hidden.shape) == (2, 8, 32)
    with pytest.raises(ValueError, match="causal"):
        engine.generate(tokens)
    with pytest.raises(ValueError, match="no classification head"):
        engine.classify(tokens)


def test_encoder_init_matches_hf_shapes():
    """Fresh-init param tree covers exactly the HF-mapped leaves,
    num_params matches the true leaf count, the spec tree mirrors it, and
    the shapes are the JAX init's."""
    cfg = EncoderConfig(vocab_size=99, hidden_size=32,
                        intermediate_size=64, num_layers=2, num_heads=4,
                        max_seq_len=48, with_pooler=True,
                        with_mlm_head=True, tie_mlm_decoder=False,
                        num_labels=3, cls_head="roberta")
    model = EncoderLM(cfg)
    params = model.init(device="cpu")
    leaves = dict(tconv._flat(params))
    assert sum(v.numel() for v in leaves.values()) == cfg.num_params()
    assert set(leaves) == set(dict(tconv._flat(model.param_specs())))
    jcfg = jenc.EncoderConfig(**{**dataclasses.asdict(cfg),
                                 "dtype": jnp.float32})
    jshapes = jax.eval_shape(jenc.EncoderLM(jcfg).init,
                             jax.random.PRNGKey(0))
    want = {p: tuple(v.shape) for p, v in tconv._flat(jshapes)}
    assert {p: tuple(v.shape) for p, v in leaves.items()} == want


def test_encoder_tensor_mesh_is_refused(tmp_path_factory):
    """Encoder serving over a tensor mesh (the JAX package's
    test_encoder_tp_serving) is not ported: it raises naming 16b-ii,
    before any mesh is built."""
    torch.manual_seed(4)
    hf = transformers.BertModel(_bert_cfg()).eval()
    path = _save(hf, tmp_path_factory, "bert_tp")
    model, params = _load(path)
    with pytest.raises(NotImplementedError, match="item 16b-ii"):
        InferenceEngine(model, params=params, device="cpu",
                        config={"dtype": "fp32",
                                "tensor_parallel": {"tp_size": 2}})
    with pytest.raises(NotImplementedError, match="item 16b-ii"):
        deepspeed_tpu_torch.init_inference(
            None, config={"checkpoint": path}, mesh={"tensor": 2},
            device="cpu")
    # one device serves it
    tokens = np.random.default_rng(4).integers(0, 99, (2, 8))
    hidden, pooled = _engine(model, params).encode(tokens)
    with torch.no_grad():
        out = hf(_t(tokens))
    np.testing.assert_allclose(hidden.numpy(),
                               out.last_hidden_state.numpy(), **TOL)
    np.testing.assert_allclose(pooled.numpy(), out.pooler_output.numpy(),
                               **TOL)


def test_encoder_task_checkpoint_no_pooler(tmp_path_factory):
    """Task checkpoints saved with add_pooling_layer=False load as
    pooler-less encoders instead of chasing a missing pooler tensor."""
    torch.manual_seed(5)
    hf = transformers.BertForQuestionAnswering(_bert_cfg()).eval()
    model, params = _load(_save(hf, tmp_path_factory, "bert_qa"))
    assert not model.cfg.with_pooler and not model.cfg.with_mlm_head
    tokens = np.random.default_rng(5).integers(0, 99, (1, 7))
    with torch.no_grad():
        hidden, pooled = model.apply(params, _t(tokens))
        theirs = hf.bert(_t(tokens)).last_hidden_state.numpy()
    assert pooled is None
    np.testing.assert_allclose(hidden.numpy(), theirs, **TOL)


def test_init_inference_encoder_from_checkpoint(tmp_path_factory):
    """init_inference(None, checkpoint=<bert dir>) infers the EncoderLM
    from config.json and serves encode()."""
    torch.manual_seed(6)
    hf = transformers.BertModel(_bert_cfg()).eval()
    path = _save(hf, tmp_path_factory, "bert_init_inf")
    engine = deepspeed_tpu_torch.init_inference(
        None, config={"dtype": "fp32", "checkpoint": path}, device="cpu")
    assert isinstance(engine.module, EncoderLM)
    tokens = np.random.default_rng(6).integers(0, 99, (2, 6))
    hidden, _ = engine.encode(tokens)
    with torch.no_grad():
        out = hf(_t(tokens))
    np.testing.assert_allclose(hidden.numpy(),
                               out.last_hidden_state.numpy(), **TOL)


def test_bert_untied_mlm_decoder(tmp_path_factory):
    """tie_word_embeddings=False: the distinct cls.predictions.decoder
    weight is loaded (not silently replaced by wte^T)."""
    torch.manual_seed(7)
    hf = transformers.BertForMaskedLM(
        _bert_cfg(tie_word_embeddings=False)).eval()
    with torch.no_grad():   # untie for real
        hf.cls.predictions.decoder.weight = torch.nn.Parameter(
            torch.randn_like(hf.cls.predictions.decoder.weight) * 0.1)
    model, params = _load(_save(hf, tmp_path_factory, "bert_untied"))
    assert not model.cfg.tie_mlm_decoder and "decoder" in params["mlm"]
    tokens = np.random.default_rng(7).integers(0, 99, (2, 9))
    with torch.no_grad():
        theirs = hf(_t(tokens)).logits.numpy()
        hidden, _ = model.apply(params, _t(tokens))
        ours = model.mlm_logits(params, hidden).numpy()
    np.testing.assert_allclose(ours, theirs, **TOL)


def test_roberta_padded_positions(tmp_path_factory):
    """RoBERTa position ids follow the pad-aware HF rule (cumsum of live
    tokens + padding_idx), so right-padded batches match HF exactly."""
    torch.manual_seed(8)
    hf = transformers.RobertaForMaskedLM(_roberta_cfg()).eval()
    model, params = _load(_save(hf, tmp_path_factory, "roberta_pad"))
    tokens = np.random.default_rng(8).integers(2, 120, (2, 10))
    mask = np.ones((2, 10), np.int64)
    mask[0, 7:] = 0
    tokens[0, 7:] = 1                            # the pad id
    with torch.no_grad():
        theirs = hf(_t(tokens), attention_mask=_t(mask)).logits.numpy()
        hidden, _ = model.apply(params, _t(tokens), _t(mask))
        ours = model.mlm_logits(params, hidden).numpy()
    for b in range(2):
        live = int(mask[b].sum())
        np.testing.assert_allclose(ours[b, :live], theirs[b, :live], **TOL)


def test_encoder_rejects_overlong_and_unknown_act():
    cfg = EncoderConfig(vocab_size=50, hidden_size=16,
                        intermediate_size=32, num_layers=1, num_heads=2,
                        max_seq_len=8)
    model = EncoderLM(cfg)
    params = model.init(device="cpu")
    with pytest.raises(ValueError, match="max_seq_len"):
        model.apply(params, torch.zeros((1, 9), dtype=torch.long))
    hf = {"model_type": "bert", "vocab_size": 10, "hidden_size": 16,
          "intermediate_size": 32, "num_hidden_layers": 1,
          "num_attention_heads": 2, "hidden_act": "tanh"}
    with pytest.raises(ValueError, match="activation") as te:
        tconv.encoder_config_from_hf(hf)
    with pytest.raises(ValueError) as je:
        jconv.encoder_config_from_hf(hf)
    assert str(te.value) == str(je.value)
    with pytest.raises(ValueError, match="token-type"):
        EncoderLM(dataclasses.replace(cfg, type_vocab_size=0)).apply(
            params, torch.zeros((1, 4), dtype=torch.long),
            token_type_ids=torch.zeros((1, 4), dtype=torch.long))


def test_distilbert_mlm_parity(tmp_path_factory):
    """DistilBERT (no token types, no pooler, its own layer naming): MLM
    logits match HF, with a padding mask."""
    torch.manual_seed(9)
    hf = transformers.DistilBertForMaskedLM(_distil_cfg()).eval()
    model, params = _load(_save(hf, tmp_path_factory, "distilbert_mlm"))
    assert model.cfg.type_vocab_size == 0
    assert not model.cfg.with_pooler and model.cfg.with_mlm_head
    assert "tte" not in params["embed"]
    tokens = np.random.default_rng(9).integers(0, 110, (2, 10))
    mask = np.ones((2, 10), np.int64)
    mask[1, 6:] = 0
    with torch.no_grad():
        theirs = hf(_t(tokens), attention_mask=_t(mask)).logits.numpy()
        hidden, pooled = model.apply(params, _t(tokens), _t(mask))
        ours = model.mlm_logits(params, hidden).numpy()
    assert pooled is None
    for b in range(2):
        live = int(mask[b].sum())
        np.testing.assert_allclose(ours[b, :live], theirs[b, :live], **TOL)


def test_distilbert_model_parity(tmp_path_factory):
    """Bare DistilBertModel (unprefixed weights): hidden states match."""
    torch.manual_seed(10)
    hf = transformers.DistilBertModel(_distil_cfg()).eval()
    model, params = _load(_save(hf, tmp_path_factory, "distilbert_model"))
    tokens = np.random.default_rng(10).integers(0, 110, (1, 9))
    with torch.no_grad():
        theirs = hf(_t(tokens)).last_hidden_state.numpy()
        hidden, _ = model.apply(params, _t(tokens))
    np.testing.assert_allclose(hidden.numpy(), theirs, **TOL)


# task checkpoints served through engine.classify: (HF class, config,
# cls_head, num_labels, mask row/start or None, token ids from)
CLS_CASES = {
    "bert_seq": ("BertForSequenceClassification",
                 lambda: _bert_cfg(num_labels=3), "pooled", 3, (1, 5), 0),
    "roberta_seq": ("RobertaForSequenceClassification",
                    lambda: _roberta_cfg(num_labels=4,
                                         classifier_dropout=0.0),
                    "roberta", 4, None, 2),
    "distilbert_seq": ("DistilBertForSequenceClassification",
                       lambda: _distil_cfg(seq_classif_dropout=0.0,
                                           num_labels=5),
                       "distilbert", 5, None, 0),
    "bert_token": ("BertForTokenClassification",
                   lambda: _bert_cfg(num_labels=7), "token", 7, (0, 6), 0),
}


@pytest.mark.parametrize("case", sorted(CLS_CASES))
def test_classification_heads_parity(tmp_path_factory, case):
    """Sequence- and token-classification checkpoints serve end to end:
    the head loads and engine.classify() matches HF logits (at live
    positions for the per-token head)."""
    cls_name, cfg_fn, head, n, masked, lo = CLS_CASES[case]
    torch.manual_seed(11 + sorted(CLS_CASES).index(case))
    hf = getattr(transformers, cls_name)(cfg_fn()).eval()
    model, params = _load(_save(hf, tmp_path_factory, case))
    assert model.cfg.cls_head == head and model.cfg.num_labels == n
    assert model.cfg.with_pooler == (head == "pooled")
    vocab = model.cfg.vocab_size
    tokens = np.random.default_rng(11).integers(lo, vocab, (2, 9))
    mask = np.ones((2, 9), np.int64)
    if masked is not None:
        mask[masked[0], masked[1]:] = 0
    ours = _engine(model, params).classify(tokens, mask).numpy()
    with torch.no_grad():
        theirs = hf(_t(tokens), attention_mask=_t(mask)).logits.numpy()
    if head == "token":
        assert ours.shape == (2, 9, n)
        for b in range(2):
            live = int(mask[b].sum())
            np.testing.assert_allclose(ours[b, :live], theirs[b, :live],
                                       **TOL)
    else:
        assert ours.shape == (2, n)
        np.testing.assert_allclose(ours, theirs, **TOL)


def test_bert_question_answering_parity(tmp_path_factory):
    """BertForQuestionAnswering: qa_outputs span head loads; classify()
    returns [B, T, 2] whose split matches HF start/end logits."""
    torch.manual_seed(15)
    hf = transformers.BertForQuestionAnswering(_bert_cfg()).eval()
    model, params = _load(_save(hf, tmp_path_factory, "bert_qa_head"))
    assert model.cfg.cls_head == "qa" and model.cfg.num_labels == 2
    tokens = np.random.default_rng(15).integers(0, 99, (2, 10))
    ours = _engine(model, params).classify(tokens).numpy()
    with torch.no_grad():
        out = hf(_t(tokens))
    np.testing.assert_allclose(ours[..., 0], out.start_logits.numpy(), **TOL)
    np.testing.assert_allclose(ours[..., 1], out.end_logits.numpy(), **TOL)


# ------------------------------------------------------ against the JAX one

JAX_CASES = [
    ("BertForPreTraining", _bert_cfg, "fp32"),
    ("RobertaForMaskedLM", _roberta_cfg, "bf16"),
    ("DistilBertForMaskedLM", _distil_cfg, "fp32"),
    ("RobertaForSequenceClassification",
     lambda: _roberta_cfg(num_labels=3), "bf16"),
]
_DT = {"fp32": (torch.float32, jnp.float32),
       "bf16": (torch.bfloat16, jnp.bfloat16)}


@pytest.mark.parametrize("cls_name,cfg_fn,dt", JAX_CASES)
def test_encoder_import_matches_jax(tmp_path_factory, cls_name, cfg_fn, dt):
    """The loaded tree bit-equal to the JAX load's, encoder_config_from_hf
    field for field, and EncoderLM.apply (and its heads) within 1e-5 of
    the JAX model's on the same weights."""
    torch.manual_seed(20)
    hf = getattr(transformers, cls_name)(cfg_fn()).eval()
    path = _save(hf, tmp_path_factory, cls_name)
    tdt, jdt = _DT[dt]
    tm, tp = tconv.load_hf_checkpoint(path, param_dtype=tdt, device="cpu")
    jm, jp = jconv.load_hf_checkpoint(path, param_dtype=jdt)
    tc, jc = dataclasses.asdict(tm.cfg), dataclasses.asdict(jm.cfg)
    assert tc.pop("dtype") == torch.float32 and jc.pop("dtype") == jnp.float32
    assert tc == jc
    t = dict(tconv._flat(params_to_numpy(tp)))
    j = dict(tconv._flat(jax.tree.map(
        lambda x: np.asarray(x).astype(np.float32), jp)))
    assert sorted(t) == sorted(j)
    for k in t:
        assert np.array_equal(t[k].view(np.uint32), j[k].view(np.uint32)), k
    # the forward on the fp32 params of the same load
    _, tp32 = tconv.load_hf_checkpoint(path, param_dtype=torch.float32,
                                       device="cpu")
    _, jp32 = jconv.load_hf_checkpoint(path, param_dtype=jnp.float32)
    rng = np.random.default_rng(20)
    tokens = rng.integers(2, tm.cfg.vocab_size, (2, 9))
    mask = np.ones((2, 9), np.int64)
    mask[1, 6:] = 0
    with torch.no_grad():
        th, tpool = tm.apply(tp32, _t(tokens), _t(mask))
    jh, jpool = jm.apply(jp32, jnp.asarray(tokens, jnp.int32),
                         jnp.asarray(mask, jnp.int32))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-5,
                               rtol=1e-5)
    assert (tpool is None) == (jpool is None)
    if tpool is not None:
        np.testing.assert_allclose(tpool.numpy(), np.asarray(jpool),
                                   atol=1e-5, rtol=1e-5)
    if tm.cfg.with_mlm_head:
        with torch.no_grad():
            ours = tm.mlm_logits(tp32, th).numpy()
        np.testing.assert_allclose(ours, np.asarray(jm.mlm_logits(jp32, jh)),
                                   atol=1e-5, rtol=1e-5)
    if tm.cfg.num_labels:
        with torch.no_grad():
            ours = tm.classify(tp32, _t(tokens), _t(mask)).numpy()
        theirs = np.asarray(jm.classify(jp32, jnp.asarray(tokens, jnp.int32),
                                        jnp.asarray(mask, jnp.int32)))
        np.testing.assert_allclose(ours, theirs, atol=1e-5, rtol=1e-5)
