"""The model's weights, made from the seed on the device: the input that the
program and the reference both receive. Each model family draws its own
(``make_weights`` in ``portbench/families/<model_type>/model.py``), in the
dtype the configuration serves, on the device, in a few large calls.
"""

from __future__ import annotations

from portbench.spec import family


def make_weights(config: dict, seed: int, device) -> dict:
    return family(config).model.make_weights(config, seed, device)
