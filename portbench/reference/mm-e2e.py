"""Plain PyTorch reference of the ``mm-e2e`` configuration, the fused
EEG + fMRI classifier (``MultimodalEndToEnd`` at its defaults), written
from the reference study's equations (SURVEY.md §1, the V4 net of
``EEG_CODE/crossmodal_v4_enhancements.py``, the fMRI fusion net of
``fMRI_CODE/run_fmri_v11.py`` and the bridge of ``_test_bridge.py``):

- ERP (B, T, 18): three Conv1d + BatchNorm + GELU blocks (k 7, 5, 3; a
  time max-pool of 2 after the second), the sinusoidal table, two pre-norm
  transformer blocks (GELU FFN of 4·d), the mean over time, GELU of a
  Dense.
- PW (B, T, 75): three parallel convolutions of widths 3, 5 and 7 (64
  features each) + BatchNorm + GELU, a k = 1 Conv block to d, the table,
  two transformer blocks, the mean, GELU of a Dense.
- CONN (B, 459): an MLP 459 → 256 → d with BatchNorm, GELU.
- Cross-attention of the ERP embedding over [ERP, PW, CONN]; a learned
  fusion of the three: ½·softmax(w/τ) + ½·softmax(gate(concat)/τ) over
  the modalities (the gate with dropout 0.2); the EEG head (its output is
  not used by the bridge, but its dropout draws are).
- fMRI: activation (90) and connectivity (64) MLPs (→ 128 → 64, BatchNorm,
  ReLU), a softmax pair of scalar weights, a fusion MLP to 64 and a head
  (drawn, not used).
- The bridge: each embedding to 128 (Dense, LayerNorm, GELU), the EEG one
  attending over both, a learned fusion of two, then Dense → LayerNorm →
  ReLU → Dense to the two logits.

Dropout (0.3, the gates' 0.2) draws from the default generator of the
device in the order of these equations, on tensors of the program's shapes
and layouts, so that a seeded generator gives both sides the same masks
(``plain`` says why). Attention computes every score; in evaluation there
is no dropout and BatchNorm uses the running statistics.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference import plain


def _conv_block(p, name, x, k, rate, train):
    """Conv1d ('same') + BatchNorm + GELU on (B, T, C), then dropout."""
    y = F.conv1d(x.transpose(1, 2), p[f"{name}.conv.weight"],
                 padding=k // 2) + p[f"{name}.conv.bias"][:, None]
    y = plain.gelu(plain.batch_norm(p, f"{name}.bn", y, train))
    return plain.dropout(y.transpose(1, 2), rate, train)


def _pool(x):
    return F.max_pool1d(x.transpose(1, 2), 2).transpose(1, 2)


def _block(p, name, x, heads, rate, train):
    h = plain.layer_norm(p, f"{name}.norm1", x)
    y = plain.attention(p, f"{name}.attn", h, h, h, heads, rate, train)
    x = x + plain.dropout(y, rate, train)
    h = plain.layer_norm(p, f"{name}.norm2", x)
    h = plain.dropout(plain.gelu(plain.dense(p, f"{name}.ffn1", h)), rate,
                      train)
    y = plain.dense(p, f"{name}.ffn2", h)
    return x + plain.dropout(y, rate, train)


def _temporal(p, name, x, m, train):
    rate, d = m["dropout"], m["eeg_hidden_dim"]
    x = plain.dropout(x + plain.position_table(x.shape[1], d, x.device)[None],
                      rate, train)
    for i in range(m["num_transformer_layers"]):
        x = _block(p, f"{name}.transformer_{i}", x, m["num_heads"], rate,
                   train)
    x = plain.gelu(plain.dense(p, f"{name}.proj", x.mean(dim=1)))
    return plain.dropout(x, rate, train)


def _erp(p, x, m, train):
    rate, n = m["dropout"], "eeg.erp_encoder"
    x = _conv_block(p, f"{n}.conv1", x, 7, rate, train)
    x = _conv_block(p, f"{n}.conv2", x, 5, 0.0, train)
    x = plain.dropout(_pool(x), rate, train)
    x = _conv_block(p, f"{n}.conv3", x, 3, rate, train)
    return _temporal(p, n, x, m, train)


def _pw(p, x, m, train):
    rate, n = m["dropout"], "eeg.pw_encoder"
    kernel = p[f"{n}.multiscale.kernel"]            # (7, C_in, 3·64)
    f = kernel.shape[2] // 3
    xt = x.transpose(1, 2)
    branches = []
    for b, width in enumerate((3, 5, 7)):
        lo = 3 - width // 2
        w = kernel[lo:lo + width, :, b * f:(b + 1) * f].permute(2, 1, 0)
        branches.append(F.conv1d(xt, w, padding=width // 2))
    y = torch.cat(branches, dim=1) + p[f"{n}.multiscale.bias"][:, None]
    y = plain.gelu(plain.batch_norm(p, f"{n}.multiscale.bn", y, train))
    x = _conv_block(p, f"{n}.fuse", y.transpose(1, 2), 1, rate, train)
    return _temporal(p, n, x, m, train)


def _mlp(p, name, x, n_layers, rate, act, train):
    for i in range(n_layers):
        x = plain.dense(p, f"{name}.dense_{i}", x)
        x = act(plain.batch_norm(p, f"{name}.bn_{i}", x, train))
        x = plain.dropout(x, rate, train)
    return x


def _fusion(p, name, feats, train):
    stacked = torch.stack(feats, dim=1)
    temp = p[f"{name}.temperature"]
    static = plain.softmax(p[f"{name}.fusion_logits"] / temp)
    gate = plain.gelu(plain.dense(p, f"{name}.gate1", torch.cat(feats, -1)))
    gate = plain.dense(p, f"{name}.gate2", plain.dropout(gate, 0.2, train))
    combined = 0.5 * static[None] + 0.5 * plain.softmax(gate / temp)
    return (stacked * combined[..., None]).sum(dim=1)


def make_forward(m: dict, train: bool):
    rate, heads = m["dropout"], m["num_heads"]
    relu = torch.relu

    def forward(p, inputs):
        erp = _erp(p, inputs["erp"], m, train)
        pw = _pw(p, inputs["pw"], m, train)
        conn = _mlp(p, "eeg.conn_encoder.mlp",
                    inputs["conn"].reshape(len(inputs["conn"]), -1), 2, rate,
                    plain.gelu, train)
        stack = torch.stack([erp, pw, conn], dim=1)
        enhanced = plain.attention(p, "eeg.cross_attn", erp[:, None], stack,
                                   stack, heads, rate, train)
        eeg = _fusion(p, "eeg.fusion", [enhanced[:, 0], pw, conn], train)
        head = _mlp(p, "eeg.classifier.hidden", eeg, 2, rate, plain.gelu,
                    train)
        plain.dense(p, "eeg.classifier.out", head)   # drawn, not used
        act = _mlp(p, "fmri.activation_encoder.mlp", inputs["activation"], 2,
                   rate, relu, train)
        con = _mlp(p, "fmri.connectivity_encoder.mlp",
                   inputs["connectivity"], 2, rate, relu, train)
        w = plain.softmax(torch.cat([p["fmri.activation_weight"],
                                     p["fmri.connectivity_weight"]]), dim=0)
        fmri = _mlp(p, "fmri.fusion", torch.cat([act * w[0], con * w[1]],
                                                dim=-1), 1, rate, relu, train)
        fmri_head = plain.dropout(relu(plain.dense(p, "fmri.head.dense",
                                                   fmri)), rate, train)
        plain.dense(p, "fmri.head.out", fmri_head)   # drawn, not used
        e = plain.dropout(plain.gelu(plain.layer_norm(
            p, "bridge.eeg_proj.ln", plain.dense(p, "bridge.eeg_proj.dense",
                                                 eeg))), rate, train)
        f = plain.dropout(plain.gelu(plain.layer_norm(
            p, "bridge.fmri_proj.ln", plain.dense(p, "bridge.fmri_proj.dense",
                                                  fmri))), rate, train)
        seq = torch.stack([e, f], dim=1)
        att = plain.attention(p, "bridge.cross_attn", e[:, None], seq, seq,
                              heads, rate, train)
        fused = _fusion(p, "bridge.fusion", [att[:, 0], f], train)
        x = relu(plain.layer_norm(p, "bridge.cls_ln",
                                  plain.dense(p, "bridge.cls_dense", fused)))
        return plain.dense(p, "bridge.cls_out",
                           plain.dropout(x, rate, train)), None

    return forward


def train_steps(config: dict, params0, batches, hyper, seeds, device):
    return plain.train_steps(make_forward(config["model"], True), params0,
                             batches, hyper, seeds, device)


@torch.no_grad()
def serve_probs(config: dict, members, rows: dict, block: int = 64):
    """The ensemble's mean probabilities over ``rows`` (z-scored ERP and
    PW), each member's eval forward and softmax, in blocks of rows.
    ``members`` is a list of per-member tensors by name (weights and
    running statistics)."""
    forward = make_forward(config["model"], False)
    n = len(next(iter(rows.values())))
    out = []
    for s in range(0, n, block):
        inputs = {k: v[s:s + block] for k, v in rows.items()}
        inputs["erp"] = plain.zscore(inputs["erp"])
        inputs["pw"] = plain.zscore(inputs["pw"])
        probs = [torch.softmax(forward(p, inputs)[0].float(), dim=-1)
                 for p in members]
        out.append(torch.stack(probs).mean(0))
    return torch.cat(out)
