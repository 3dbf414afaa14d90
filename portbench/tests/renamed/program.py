"""The program for the tests' ``renamed`` family: the port's GPT-2, its
``GPTConfig`` read from the renamed keys."""

from zig_gpt2_tpu_torch.config import GPTConfig
from zig_gpt2_tpu_torch.models import gpt2
from zig_gpt2_tpu_torch.runtime.batcher import ContinuousBatcher


def build(config, weights, traffic, sampling, device, on_token):
    if (config["weights"], config["kv_cache"]) != ("float", "float"):
        raise ValueError("the renamed family serves float weights and a float cache")
    model = GPTConfig(vocab_size=config["vocab_size"],
                      context_size=config["max_position_embeddings"],
                      n_layers=config["num_hidden_layers"],
                      n_heads=config["num_attention_heads"], n_embed=config["hidden_size"],
                      layer_norm_eps=config["layer_norm_eps"])
    return ContinuousBatcher(model, weights, batch_size=traffic.batch, sampling=sampling,
                             on_token=on_token, device=device)


def model_module():
    return gpt2
