"""A model family of the tests' own: GPT-2 under other key names (those of
Hugging Face's newer configurations), mapped onto the ``gpt2`` family of
the same checkout. A configuration of this family holds no GPT-2 key, so a
run of it shows that the harness reads none."""

from pathlib import Path

from portbench.spec import load_family

GPT2 = load_family("gpt2", Path(__file__).resolve().parents[3]).model
KEYS = {"hidden_size": "n_embd", "num_hidden_layers": "n_layer",
        "num_attention_heads": "n_head", "max_position_embeddings": "n_positions",
        "layer_norm_eps": "layer_norm_epsilon"}


def as_gpt2(config: dict) -> dict:
    return {KEYS.get(k, k): v for k, v in config.items()}


def context_rows(config):
    return config["max_position_embeddings"]


def make_weights(config, seed, device):
    return GPT2.make_weights(as_gpt2(config), seed, device)


def Reference(weights, config, precision=None):  # noqa: N802
    return GPT2.Reference(weights, as_gpt2(config), precision)


def token_flops(config, attended):
    return GPT2.token_flops(as_gpt2(config), attended)


def prompt_flops(config, start, n):
    return GPT2.prompt_flops(as_gpt2(config), start, n)


def decode_attention_lane(config, old_rows):
    return GPT2.decode_attention_lane(as_gpt2(config), old_rows)


def qmm_call(config, body, k, n, rows):
    return GPT2.qmm_call(as_gpt2(config), body, k, n, rows)
