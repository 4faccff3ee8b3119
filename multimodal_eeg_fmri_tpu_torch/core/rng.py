"""Seeds and named generator streams (PyTorch). Counterpart of
``multimodal_eeg_fmri_tpu/core/rng.py``.

Where the JAX package derives keys with ``jax.random.fold_in``, the port
derives 63-bit seeds with ``fold_in`` below (a SHA-256 of the two numbers)
and turns a seed into a ``torch.Generator`` where a consumer draws. A seed
fixes a generator's stream on one device type; the CPU's generator and the
card's draw different numbers from the same seed, so what must agree across
devices (initial weights) is drawn on the CPU.

``training_key`` is the root of a run's training randomness: a generator on
the card, where PyTorch's generator is Philox already.
"""

from __future__ import annotations

import hashlib
import random
from typing import Dict, Union

import numpy as np
import torch

_SEED_MASK = (1 << 63) - 1


def fold_in(seed: int, data: int) -> int:
    """A seed derived from ``seed`` and ``data``: fixed by the pair,
    unrelated to either for any other pair."""
    digest = hashlib.sha256(
        int(seed).to_bytes(16, "little", signed=True)
        + int(data).to_bytes(16, "little", signed=True)).digest()
    return int.from_bytes(digest[:8], "little") & _SEED_MASK


def as_seed(rng: Union[int, torch.Generator]) -> int:
    """The seed an int or a generator stands for: a generator stands for
    the seed it was made with (``initial_seed()``), as a JAX key stands for
    its value, whatever it has drawn since."""
    if isinstance(rng, torch.Generator):
        return rng.initial_seed()
    if isinstance(rng, (int, np.integer)) and not isinstance(rng, bool):
        return int(rng)
    raise TypeError(f"a seed must be an int or a torch.Generator, got "
                    f"{type(rng).__name__}")


def generator(seed: int, device=None) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` (default the CPU) seeded with
    ``seed``."""
    return torch.Generator(device=device or "cpu").manual_seed(int(seed))


def seed_everything(seed: int) -> torch.Generator:
    """Seed Python's ``random``, numpy's global state and torch's default
    generators (CPU and every card), and return a CPU ``torch.Generator``
    seeded with ``seed``, the root of the run's explicit streams."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return generator(seed)


def training_key(seed: int, device="cuda") -> torch.Generator:
    """The root generator for TRAINING randomness (shuffles, augmentation;
    ``fit`` takes it as its generator) on ``device``, the card unless the
    caller asks for the CPU: seeded with ``fold_in(seed,
    _stable_hash("training"))``, a stream apart from ``generator(seed)``'s,
    as the JAX package's ``rbg`` key is apart from ``key(seed)``.

    The JAX package swaps XLA's default threefry for its ``rbg`` generator
    here, a speed trick for the TPU; that generator has no counterpart, and
    none is needed: the card's generator is counter-based Philox, fast
    whatever the shape. Deterministic per (seed, device type); its numbers
    are not the JAX package's (another generator)."""
    from multimodal_eeg_fmri_tpu_torch.data.arrays import model_device

    return generator(fold_in(seed, _stable_hash("training")),
                     model_device(device))


class RngStream:
    """Named, replay-stable generator streams.

    ``stream.next("dropout")`` returns a fresh generator each call;
    generators of different names are independent; the sequence for a given
    name depends only on (root seed, name, call index), so runs replay
    exactly regardless of interleaving with other streams. The root is an
    int or a generator (its ``initial_seed()``)."""

    def __init__(self, root: Union[int, torch.Generator]):
        self._root = as_seed(root)
        self._counters: Dict[str, int] = {}

    def next(self, name: str, device=None) -> torch.Generator:
        idx = self._counters.get(name, 0)
        self._counters[name] = idx + 1
        named = fold_in(self._root, _stable_hash(name))
        return generator(fold_in(named, idx), device)

    def fold(self, name: str) -> "RngStream":
        """Child stream for a sub-scope (e.g. per fold)."""
        return RngStream(fold_in(self._root, _stable_hash(name)))


def _stable_hash(name: str) -> int:
    """Deterministic 31-bit hash (python's hash() is salted per process)."""
    h = 2166136261
    for ch in name.encode():
        h = (h ^ ch) * 16777619 & 0xFFFFFFFF
    return h & 0x7FFFFFFF


def device_generator(device) -> torch.Generator:
    """The default generator of ``device`` (dropout draws from it)."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.default_generators[
            device.index if device.index is not None
            else torch.cuda.current_device()]
    return torch.default_generator
