"""Model FLOPs from a configuration's shapes: the work the algorithm
needs, whatever implements it.  A multiply-add counts 2; only matrix
products count (attention's score and value products among them).

Per configuration (``of``):

* ``act``: one policy forward to act in one env-step (the heads the
  action and the stored value read);
* ``value``: one value forward (the TimeLimit bootstrap of a truncated
  env, the last value of a rollout);
* ``update_row``: one batch row of one update: the loss's forwards and
  their backward (weights and inputs; no input gradient of a first layer
  that reads the observation);
* ``greedy``: one forward to act in evaluation (no value head).
"""

from __future__ import annotations

from typing import Dict


def _mlp(config: dict) -> Dict[str, float]:
    p = config["policy"]
    widths = [p["obs_dim"], *p["hidden"]]
    torso = sum(a * b for a, b in zip(widths, widths[1:]))
    d = widths[-1]
    logits, value = d * sum(p["heads"]), d * p["value_head"]
    fwd = torso + logits + value
    first = widths[0] * widths[1]
    return {"act": 2.0 * fwd, "value": 2.0 * (torso + value),
            "update_row": 2.0 * (3 * fwd - first),
            "greedy": 2.0 * (torso + logits)}


def _gpt(config: dict) -> Dict[str, float]:
    p, L = config["policy"], config["learner"]
    C, na, nc = p["n_embd"], p["num_actions"], p["num_colors"]
    h, w = p["grid"]
    P = h * w
    nf = max(C // 8, 1)

    def trunk(T):
        per_token = 12 * C * C            # qkv, proj, the MLP
        attn = 2 * T * T * C              # scores and values
        return p["n_layer"] * (T * per_token + attn)

    def head(tokens, out):
        return tokens * (2 * C * C + C * out)

    T = 2 * P + 1 + na + 1
    op = head(na, 1)
    box = head(1, 4 * p["bbox_bins"])     # the chosen op's token
    crit = head(1, 1)
    act = trunk(T) + op + box + crit
    value = trunk(T) + crit
    update = act                          # the loss's evaluate pass
    if L.get("aux_coeff", 0.0) > 0.0:
        update += (trunk(T + 2) + 4 * 2 * nf * C + head(1, 1) + head(1, 1)
                   + head(P, nc))
    return {"act": 2.0 * act, "value": 2.0 * value,
            "update_row": 2.0 * 3 * update,
            "greedy": 2.0 * (trunk(T) + op + box)}


def of(config: dict) -> Dict[str, float]:
    return {"fc_policy": _mlp, "color_eq_gpt": _gpt}[config["kind"]](config)
