"""Builds the ``mm-e2e`` configuration in the port: ``MultimodalEndToEnd``
with the widths of ``mm-e2e.json``, weights from the seed, and a cohort of
synthetic subjects on the card."""

from __future__ import annotations

import torch

from portbench.harness.weights import init_from_seed


def skeleton(config: dict, device) -> torch.nn.Module:
    from multimodal_eeg_fmri_tpu_torch.models import MultimodalEndToEnd

    return MultimodalEndToEnd(**config["model"], device=device)


def build(config: dict, device, generator: torch.Generator) -> torch.nn.Module:
    model = skeleton(config, device)
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
