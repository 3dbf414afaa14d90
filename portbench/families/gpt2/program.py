"""GPT-2 in the program: the system under test built from the seed's weights.

``zig_gpt2_tpu_torch.runtime.batcher.ContinuousBatcher`` with the program's
defaults (no ``ZG2_*`` switch is set here) over the configuration's
``GPTConfig``; the weights quantized by the program's ``quantize_params``
where the configuration says INT4, and prepared by the batcher's
constructor.
"""

from __future__ import annotations

from zig_gpt2_tpu_torch.config import GPTConfig
from zig_gpt2_tpu_torch.models import gpt2
from zig_gpt2_tpu_torch.quant.quantize import quantize_params
from zig_gpt2_tpu_torch.runtime.batcher import ContinuousBatcher


def model_config(config: dict) -> GPTConfig:
    return GPTConfig(vocab_size=config["vocab_size"], context_size=config["n_positions"],
                     n_layers=config["n_layer"], n_heads=config["n_head"],
                     n_embed=config["n_embd"], layer_norm_eps=config["layer_norm_epsilon"])


def build(config: dict, weights: dict, traffic, sampling, device, on_token):
    if config["weights"] == "int4":
        weights = quantize_params(weights, "int4")
    elif config["weights"] != "float":
        raise ValueError(f"unknown weights {config['weights']!r}")
    return ContinuousBatcher(
        model_config(config), weights, batch_size=traffic.batch, sampling=sampling,
        kv_quant="int8" if config["kv_cache"] == "int8" else None, on_token=on_token,
        device=device)


def model_module():
    return gpt2
