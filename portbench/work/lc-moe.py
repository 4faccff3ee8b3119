"""The operations one recording of the ``lc-moe`` configuration needs in a
forward, from its shapes. The Mixture of Experts counts the router and the
routed rows' expert products, top-k rows a token, never a dense
dispatch's zeros."""

from __future__ import annotations

from portbench.work import common


def forward_flops(config: dict, T: int) -> float:
    m, moe = config["model"], config["moe"]
    d, heads = m["hidden_dim"], m["num_heads"]
    tokens = T // m["patch"]
    ff = moe["dim_feedforward"]
    flops = common.dense(tokens, m["patch"] * m["in_channels"], d)
    per_layer = (common.mha_forward(1, tokens, tokens, d, heads)
                 + common.dense(tokens, d, m["num_experts"])
                 + m["moe_top_k"] * (common.dense(tokens, d, ff)
                                     + common.dense(tokens, ff, d)))
    flops += m["num_layers"] * per_layer
    flops += common.dense(1, d, d)                                 # pool_proj
    flops += common.dense(1, d, d // 2) + common.dense(1, d // 2,
                                                       m["num_classes"])
    return flops
