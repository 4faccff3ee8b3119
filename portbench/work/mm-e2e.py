"""The operations one subject of the ``mm-e2e`` configuration needs in a
forward, from its shapes: the convolutions (the multi-scale one as its
three branches of 3, 5 and 7 taps), the transformer blocks with every
attention score, the cross-attentions, the MLPs and the heads."""

from __future__ import annotations

from portbench.work import common


def _block(T: int, d: int, heads: int) -> float:
    return (common.mha_forward(1, T, T, d, heads)
            + common.dense(T, d, 4 * d) + common.dense(T, 4 * d, d))


def _fusion(m: int, d: int) -> float:
    return common.dense(1, m * d, d) + common.dense(1, d, m)


def forward_flops(config: dict, T: int) -> float:
    m = config["model"]
    d, heads, L = m["eeg_hidden_dim"], m["num_heads"], m["num_transformer_layers"]
    fd, bd, nc = m["fmri_hidden_dim"], m["bridge_dim"], m["num_classes"]
    erp = (common.conv1d(1, T, m["erp_channels"], 64, 7)
           + common.conv1d(1, T, 64, 128, 5)
           + common.conv1d(1, T // 2, 128, d, 3)
           + L * _block(T // 2, d, heads) + common.dense(1, d, d))
    pw = (common.conv1d(1, T, m["pw_channels"], 64, 3 + 5 + 7)
          + common.conv1d(1, T, 192, d, 1)
          + L * _block(T, d, heads) + common.dense(1, d, d))
    conn = common.dense(1, m["conn_features"], 256) + common.dense(1, 256, d)
    cross = common.mha_forward(1, 1, 3, d, heads)
    eeg_head = (common.dense(1, d, d) + common.dense(1, d, d // 2)
                + common.dense(1, d // 2, nc))
    fmri = (common.dense(1, m["activation_features"], 2 * fd)
            + common.dense(1, m["connectivity_features"], 2 * fd)
            + 2 * common.dense(1, 2 * fd, fd)
            + common.dense(1, 2 * fd, fd)                   # fusion MLP
            + common.dense(1, fd, fd // 2) + common.dense(1, fd // 2, nc))
    bridge = (common.dense(1, d, bd) + common.dense(1, fd, bd)
              + common.mha_forward(1, 1, 2, bd, heads) + _fusion(2, bd)
              + common.dense(1, bd, bd // 2) + common.dense(1, bd // 2, nc))
    return erp + pw + conn + cross + _fusion(3, d) + eeg_head + fmri + bridge
