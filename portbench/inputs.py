"""The model's weights, made from the seed on the device: the input that the
program and the reference both receive.

GPT-2's initialization (N(0, ``initializer_range``) for every weight and
both embeddings, the residual projections scaled by 1/sqrt(2 L); LayerNorm
gains 1, biases 0),
one draw per stacked leaf from a generator on the device, in the dtype the
configuration serves. The tree has the program's layout: linears (in, out),
every block leaf stacked on a leading layer axis, Q/K/V apart.
"""

from __future__ import annotations

import torch

from portbench.traffic import seed_words

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def dtype_of(config: dict) -> torch.dtype:
    return _DTYPES[config["weight_dtype"]]


def make_weights(config: dict, seed: int, device) -> dict:
    L, E = config["n_layer"], config["n_embd"]
    V, P = config["vocab_size"], config["n_positions"]
    dtype = dtype_of(config)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed_words(seed)[0])

    std0 = config["initializer_range"]

    def normal(shape, std=std0):
        t = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
        return t.mul_(std).to(dtype)

    def const(value, *shape):
        return torch.full(shape, value, device=device, dtype=dtype)

    proj = std0 / (2.0 * L) ** 0.5

    def linear(k, n, std=std0):
        return {"w": normal((L, k, n), std), "b": const(0.0, L, n)}

    return {
        "wte": normal((V, E)),
        "wpe": normal((P, E)),
        "blocks": {
            "ln_1": {"w": const(1.0, L, E), "b": const(0.0, L, E)},
            "attn": {"wq": linear(E, E), "wk": linear(E, E), "wv": linear(E, E),
                     "c_proj": linear(E, E, proj)},
            "ln_2": {"w": const(1.0, L, E), "b": const(0.0, L, E)},
            "mlp": {"c_fc": linear(E, 4 * E), "c_proj": linear(4 * E, E, proj)},
        },
        "ln_f": {"w": const(1.0, E), "b": const(0.0, E)},
    }
