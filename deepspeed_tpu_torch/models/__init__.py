"""Model definitions (counterpart of ``deepspeed_tpu/models``): the causal
transformer's presets by name, ``build_model``, the BERT-family encoder,
and the HF checkpoint import (``convert.py``)."""

import dataclasses

from .transformer import (  # noqa: F401
    BLOOM_560M,
    FALCON_7B,
    GPT2_125M,
    GPTJ_6B,
    LLAMA2_7B,
    LLAMA2_70B,
    MISTRAL_7B,
    OPT_1B3,
    PHI_2,
    PYTHIA_1B4,
    QWEN2_7B,
    TINY_TEST,
    CausalLM,
    TransformerConfig,
)

from .encoder import (  # noqa: F401
    BERT_BASE,
    BERT_LARGE,
    EncoderConfig,
    EncoderLM,
)

from .convert import (  # noqa: F401
    config_from_hf,
    encoder_config_from_hf,
    from_pretrained,
    is_hf_checkpoint,
    load_hf_checkpoint,
    model_from_checkpoint,
)

MODEL_CONFIGS = {
    "gpt2-125m": GPT2_125M,
    "llama2-7b": LLAMA2_7B,
    "llama2-70b": LLAMA2_70B,
    "mistral-7b": MISTRAL_7B,
    "qwen2-7b": QWEN2_7B,
    "opt-1.3b": OPT_1B3,
    "gpt-j-6b": GPTJ_6B,
    "phi-2": PHI_2,
    "pythia-1.4b": PYTHIA_1B4,
    "bloom-560m": BLOOM_560M,
    "falcon-7b": FALCON_7B,
    "tiny": TINY_TEST,
}


def build_model(name_or_config, **overrides) -> CausalLM:
    """A CausalLM from a registered name or a TransformerConfig."""
    if isinstance(name_or_config, TransformerConfig):
        cfg = name_or_config
    else:
        cfg = MODEL_CONFIGS[name_or_config]
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return CausalLM(cfg)
