"""A flat-vector AdamW (PyTorch). Counterpart of
``multimodal_eeg_fmri_tpu/ops/optim.py``.

The parameter tree (a dict, list or tuple of tensors, nested as deep as
it likes) is flattened into one vector, updated with a handful of
elementwise ops and unflattened, as the JAX package's ``ravel_pytree``
version does. It is an exact AdamW reference with plain-function state,
not the train step's optimizer: ``TrainStep`` keeps ``torch.optim.AdamW``.

Semantics match ``torch.optim.AdamW``: decoupled weight decay applied to
every parameter, bias-corrected moments (the corrections in float64, as
torch takes them, where the JAX package's are f32), the clip by global
norm on the raw gradient. ``lr`` and ``weight_decay`` are runtime scalars
(a float or a 0-d tensor); the state lives on the parameters' device.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Tuple

import torch
from torch.utils import _pytree as pytree


class FusedAdamWState(NamedTuple):
    mu: torch.Tensor     # (P,) first moment
    nu: torch.Tensor     # (P,) second moment
    count: torch.Tensor  # () int32 step


def _ravel(tree: Any) -> Tuple[torch.Tensor, Callable[[torch.Tensor], Any]]:
    """(one flat vector of every leaf, in their common dtype; the function
    that cuts such a vector back into the tree)."""
    leaves, spec = pytree.tree_flatten(tree)
    dtype = leaves[0].dtype
    for x in leaves[1:]:
        dtype = torch.promote_types(dtype, x.dtype)
    flat = torch.cat([x.reshape(-1).to(dtype) for x in leaves])
    sizes = [x.numel() for x in leaves]

    def unravel(vec: torch.Tensor) -> Any:
        parts = vec.split(sizes)
        return pytree.tree_unflatten(
            [p.reshape(x.shape).to(x.dtype) for p, x in zip(parts, leaves)],
            spec)

    return flat, unravel


def init_fused_adamw(params: Any) -> FusedAdamWState:
    flat, _ = _ravel(params)
    return FusedAdamWState(
        mu=torch.zeros_like(flat),
        nu=torch.zeros_like(flat),
        count=torch.zeros((), dtype=torch.int32, device=flat.device),
    )


@torch.no_grad()
def fused_adamw_step(
    params: Any,
    grads: Any,
    state: FusedAdamWState,
    lr,
    weight_decay,
    grad_clip: float = 0.0,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
) -> Tuple[Any, FusedAdamWState]:
    """One AdamW step over the flattened parameter vector.
    Returns (new_params, new_state); the inputs are left as they are."""
    flat_p, unravel = _ravel(params)
    flat_g, _ = _ravel(grads)
    flat_g = flat_g.to(flat_p.dtype)

    if grad_clip and grad_clip > 0:
        gnorm = torch.sqrt(torch.sum(flat_g * flat_g))
        flat_g = flat_g * torch.clamp(grad_clip / torch.clamp(gnorm,
                                                              min=1e-12),
                                      max=1.0)

    count = state.count + 1
    mu = b1 * state.mu + (1.0 - b1) * flat_g
    nu = b2 * state.nu + (1.0 - b2) * flat_g * flat_g
    # the bias corrections in float64, as torch.optim.AdamW takes them: in
    # f32 (the JAX package's), 1 - b2^t carries b2's rounding, 1.3e-5 of
    # its value at t = 1, and moves every update by 6e-6 of itself
    c = count.to(torch.float64)
    mu_hat = mu / (1.0 - torch.pow(b1, c)).to(flat_p.dtype)
    nu_hat = nu / (1.0 - torch.pow(b2, c)).to(flat_p.dtype)

    update = mu_hat / (torch.sqrt(nu_hat) + eps) + weight_decay * flat_p
    new_flat = flat_p - lr * update
    return unravel(new_flat), FusedAdamWState(mu=mu, nu=nu, count=count)
