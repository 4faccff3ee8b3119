"""Plain PyTorch reference of the ``lc-moe`` configuration: a transformer
classifier over one raw EEG recording (B, T, C) whose feed-forward layers
are a Mixture of Experts with top-k routing and a per-expert capacity.

Equations (per the JAX package's ``models/long_context.py`` and
``ops/moe.py``, the GShard/Switch formulation): a Dense embedding of each
time step, the sinusoidal table, ``layers`` pre-norm blocks (x += MHA(LN
x); x += MoE(LN x)), a final LayerNorm, the mean over time, GELU of a
Dense, and a head of Dense → LayerNorm → GELU → Dense.

The MoE here is written with gathers, not with the dense (S, E, C)
dispatch: the router's softmax in f32; each token's top-k experts, ties to
the lower index; gates renormalised over the k (the raw probability for
k = 1); each expert's queue filled choice-major (every token's first
choice before any second choice), in token order, up to the capacity
ceil(S·cf/E) (at most S), later entries dropped; each kept (token, choice)
row computed by its expert's GELU MLP and added with its gate; the
load-balance loss E·Σ_e f_e·p_e over the first choices and the mean
probabilities, times ``aux_weight``. Attention computes every score.
"""

from __future__ import annotations

import torch

from portbench.reference import plain


def capacity(tokens: int, cf: float, experts: int) -> int:
    return min(max(1, int(-(-tokens * cf // experts))), tokens)


def moe(p, name, x, experts: int, top_k: int, cf: float, aux_weight: float):
    """(y, scaled aux loss) of the MoE layer on x (B, T, D)."""
    B, T, D = x.shape
    xs = x.reshape(B * T, D)
    S = xs.shape[0]
    logits = xs.float() @ p[f"{name}.router.weight"].float().t()
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_i = top_p[:, :top_k], top_i[:, :top_k]
    gates = top_p if top_k == 1 else top_p / top_p.sum(-1, keepdim=True)
    C = capacity(S, cf, experts)
    y = torch.zeros_like(xs)
    for e in range(experts):
        rows, gate = [], []
        filled = 0
        for j in range(top_k):                      # choice-major queue
            hit = torch.nonzero(top_i[:, j] == e).flatten()
            take = hit[:max(0, C - filled)]
            filled += len(take)
            rows.append(take)
            gate.append(gates[take, j])
        rows, gate = torch.cat(rows), torch.cat(gate)
        if len(rows) == 0:
            continue
        h = plain.gelu(xs[rows] @ p[f"{name}.w1"][e] + p[f"{name}.b1"][e])
        out = h @ p[f"{name}.w2"][e] + p[f"{name}.b2"][e]
        y = y.index_add(0, rows, out * gate[:, None].to(out.dtype))
    first = torch.zeros(S, experts, device=x.device).scatter_(
        1, top_i[:, :1], 1.0)
    aux = experts * (first.mean(0) * probs.mean(0)).sum()
    return y.reshape(B, T, D), aux_weight * aux


def make_forward(model: dict, moe_cfg: dict):
    hidden, heads = model["hidden_dim"], model["num_heads"]
    layers = model["num_layers"]

    def forward(p, inputs):
        x = inputs["erp"]
        B, T, C = x.shape
        x = plain.dense(p, "embed", x)
        x = x + plain.position_table(T, hidden, x.device)[None]
        aux = 0.0
        for i in range(layers):
            b = f"block_{i}"
            h = plain.layer_norm(p, f"{b}.norm1", x)
            x = x + plain.attention(p, f"{b}.attn", h, h, h, heads, 0.0, False)
            h = plain.layer_norm(p, f"{b}.norm2", x)
            y, a = moe(p, f"{b}.moe", h, model["num_experts"],
                       model["moe_top_k"], moe_cfg["capacity_factor"],
                       moe_cfg["aux_weight"])
            x = x + y
            aux = aux + a
        pooled = plain.layer_norm(p, "final_ln", x).mean(dim=1)
        feat = plain.gelu(plain.dense(p, "pool_proj", pooled))
        h = plain.gelu(plain.layer_norm(
            p, "classifier.hidden.ln_0",
            plain.dense(p, "classifier.hidden.dense_0", feat)))
        return plain.dense(p, "classifier.out", h), aux

    return forward


def train_steps(config: dict, params0, batches, hyper, seeds, device):
    return plain.train_steps(make_forward(config["model"], config["moe"]),
                             params0, batches, hyper, seeds, device)
