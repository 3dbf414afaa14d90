"""How ``correct`` is decided: the served tokens against the plain reference.

Once the window has closed and the program's state is freed, a sample of
the requests finished by then is drawn from the seed (the request with
the most served tokens always in it, then others until the mix's
``check.tokens`` served tokens or ``check.requests`` requests). The
configuration's family's plain reference (``Reference`` in
``portbench/families/<model_type>/model.py``, float32, over the weights the
family draws from the seed) runs once over each prompt with its served
tokens. At each position the gap is how far the served
token's logit lies below the reference's best: 0 where it is the
reference's argmax, small where a near-tie flipped on the program's
rounding (the traffic is greedy, so each served token is the program's
argmax). A cell's limits file names the numbers it compares: the widest
gap, or the mean gap per served token where the widest does not separate
from the control.

The control puts the reference in the program's place at the precision
one step below the configuration's (``control_precision``; the same
reference's ``at``, sharing its weights): at each position the token it
puts first, read by the float32 reference's gap.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from portbench import inputs
from portbench.reference import Reference
from portbench.traffic import seed_words


def sample(done: list, check: dict, seed: int) -> list:
    """The finished requests to check: the longest, then others in an order
    drawn from the seed, up to the mix's ``check`` counts."""
    if not done:
        return []
    rng = np.random.default_rng(seed_words(seed, 5))
    longest = max(range(len(done)), key=lambda i: (len(done[i].tokens), -i))
    picked, tokens = [done[longest]], len(done[longest].tokens)
    for i in rng.permutation(len(done)):
        if tokens >= check["tokens"] or len(picked) >= check["requests"]:
            break
        if i != longest:
            picked.append(done[i])
            tokens += len(done[i].tokens)
    return picked


def _positions(ref, rec, device) -> torch.Tensor:
    """(m, V) reference logits at the positions that chose the m served tokens."""
    n = len(rec.req.prompt)
    ids = torch.tensor(rec.req.prompt + rec.tokens[:-1], dtype=torch.long, device=device)
    return ref.logits(ids, rec.float_rows, n - 1)


def _stats(best: torch.Tensor, logits: torch.Tensor, tokens: torch.Tensor) -> tuple:
    """(widest gap, gap sum, positions not the reference's argmax) of the
    tokens chosen at each position, by the reference's ``logits``."""
    gap = best - logits.gather(1, tokens[:, None])[:, 0]
    return float(gap.max()), float(gap.sum()), int((gap > 0).sum())


def gaps(config: dict, seed: int, picked: list, device,
         control: Optional[str] = None) -> dict:
    """The compared numbers over every position of ``picked``: the widest
    served-token gap (``logit_gap``), the mean gap per served token
    (``logit_gap_mean``) and the share of served tokens that are not the
    reference's argmax (``flipped_share``); with ``control``, the same of
    the tokens the control puts first (``control_*``)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    weights = inputs.make_weights(config, seed, device)
    ref = Reference(weights, config)
    low = ref.at(control) if control else None
    del weights
    sums = {"program": [0.0, 0.0, 0], "control": [0.0, 0.0, 0]}
    compared = 0

    def add(key, stats):
        acc = sums[key]
        acc[0], acc[1], acc[2] = max(acc[0], stats[0]), acc[1] + stats[1], acc[2] + stats[2]

    for rec in picked:
        logits = _positions(ref, rec, device)
        best = logits.max(-1).values
        served = torch.tensor(rec.tokens, dtype=torch.long, device=device)
        add("program", _stats(best, logits, served))
        compared += len(rec.tokens)
        if low is not None:
            add("control", _stats(best, logits, _positions(low, rec, device).argmax(-1)))
    out = {"tokens_compared": compared, "requests_compared": len(picked)}
    for key, prefix in (("program", ""), ("control", "control_")):
        if key == "control" and low is None:
            continue
        widest, total, flipped = sums[key]
        out.update({prefix + "logit_gap": widest,
                    prefix + "logit_gap_mean": total / max(compared, 1),
                    prefix + "flipped_share": flipped / max(compared, 1)})
    return out


def judge(readings: dict, limits: dict) -> List[dict]:
    """Each compared number beside its limit, [{name, value, limit, ok}]:
    every number the cell's limits file names (the served tokens compared
    are held to at least ``tokens_compared_min``)."""
    rows = []
    for name, limit in limits.items():
        if name == "tokens_compared_min":
            value = readings["tokens_compared"]
            rows.append({"name": "tokens_compared", "value": value, "limit": limit,
                         "ok": value >= limit})
        else:
            value = readings[name]
            rows.append({"name": name, "value": value, "limit": limit, "ok": value <= limit})
    return rows


def judge_control(readings: dict, limits: dict) -> List[dict]:
    """The control's numbers (``control_*``) judged as the program's are:
    a program computing at the control's precision would be judged so."""
    own = {k[len("control_"):]: v for k, v in readings.items() if k.startswith("control_")}
    own["tokens_compared"] = readings["tokens_compared"]
    return judge(own, limits)
