"""Builds the ``lc-moe`` configuration in the port: ``LongContextClassifier``
with the Mixture-of-Experts blocks of ``lc-moe.json``, weights from the seed,
and a cohort of raw recordings on the card."""

from __future__ import annotations

import torch

from portbench.harness.weights import init_from_seed


def skeleton(config: dict, device) -> torch.nn.Module:
    from multimodal_eeg_fmri_tpu_torch.models import LongContextClassifier

    return LongContextClassifier(**config["model"], device=device)


def build(config: dict, device, generator: torch.Generator) -> torch.nn.Module:
    """The model, its MoE layers checked against the file's ``moe`` group
    (the class takes them from its blocks' defaults)."""
    model = skeleton(config, device)
    moe = config["moe"]
    for name, m in model.named_modules():
        if type(m).__name__ == "MoEFFN":
            got = {"capacity_factor": m.capacity_factor,
                   "aux_weight": m.aux_weight,
                   "dim_feedforward": m.w1.shape[2]}
            if got != moe:
                raise ValueError(f"{name}: MoE settings {got} are not the "
                                 f"configuration's {moe}")
    init_from_seed(model, generator)
    return model


@torch.no_grad()
def cohort(config: dict, n: int, T: int, generator: torch.Generator,
           device) -> dict:
    """n subjects, half of each class, every modality drawn at once from
    the generator and shifted by 0.3 with its class (the class signal)."""
    label = torch.arange(n, device=device) % 2
    out = {}
    for key, shape in config["inputs"].items():
        dims = [T if d == "T" else d for d in shape]
        shift = 0.3 * label.view(n, *([1] * len(dims)))
        out[key] = torch.randn(n, *dims, generator=generator,
                               device=device) + shift
    out["label"] = label
    out["weight"] = torch.ones(n, device=device)
    return out
