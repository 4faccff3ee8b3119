"""Inference path (PyTorch). Counterpart of ``Predictor`` in
``multimodal_eeg_fmri_tpu/serving.py``: a fixed-batch predictor that pads
any request to whole batches by repeating row 0, runs the model in eval mode
under ``torch.inference_mode()``, and returns f32 probabilities (or logits),
with an optional temperature applied before the softmax.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch import nn

from multimodal_eeg_fmri_tpu_torch.data.arrays import as_tensor
from multimodal_eeg_fmri_tpu_torch.train.fit import RESERVED_KEYS


class Predictor:
    """Fixed-batch predictor over a model whose weights are loaded. The
    model is put in eval mode; inputs go to the device of its parameters."""

    def __init__(self, model: nn.Module, batch_size: int = 8,
                 preprocess: Optional[Callable] = None,
                 return_probs: bool = True,
                 temperature: Optional[float] = None):
        if temperature is not None and temperature <= 0:
            raise ValueError(f"temperature must be > 0, got {temperature}")
        self.model = model.eval()
        self.batch_size = batch_size
        # read-only after construction, as in the JAX Predictor
        self.temperature = (float(temperature) if temperature is not None
                            else None)
        self._preprocess = preprocess
        self._return_probs = return_probs
        self.device = next(model.parameters()).device

    def _forward(self, inputs: Dict[str, torch.Tensor]) -> torch.Tensor:
        with torch.inference_mode():
            if self._preprocess is not None:
                inputs = {**inputs, **self._preprocess(inputs)}
            logits = self.model(**inputs).logits.float()
            if self.temperature is not None:
                logits = logits / self.temperature
            if self._return_probs:
                return torch.softmax(logits, dim=-1)
            return logits

    def _pad(self, inputs: Dict[str, np.ndarray]):
        n = len(next(iter(inputs.values())))
        chunks = []
        for start in range(0, n, self.batch_size):
            chunk = {k: np.asarray(v)[start:start + self.batch_size]
                     for k, v in inputs.items()}
            m = len(next(iter(chunk.values())))
            if m < self.batch_size:
                chunk = {k: np.concatenate(
                    [v, np.repeat(v[:1], self.batch_size - m, axis=0)])
                    for k, v in chunk.items()}
            chunks.append((chunk, m))
        return chunks

    def _to_device(self, chunk: Dict[str, np.ndarray]):
        """The chunk on the model's device; float64 becomes float32, as
        the JAX ``Predictor``'s ``jnp.asarray`` makes it."""
        return {k: as_tensor(v, self.device) for k, v in chunk.items()}

    def __call__(self, **inputs) -> np.ndarray:
        """Predict for any number of rows, in batches of ``batch_size``."""
        inputs = {k: v for k, v in inputs.items() if k not in RESERVED_KEYS}
        outs = [self._forward(self._to_device(chunk)).cpu().numpy()[:m]
                for chunk, m in self._pad(inputs)]
        return np.concatenate(outs, axis=0)

    def benchmark(self, example: Dict[str, np.ndarray], warmup: int = 3,
                  iters: int = 30) -> Dict[str, float]:
        """Latency percentiles of one batch, host clock around a forward
        that ends in ``torch.cuda.synchronize()`` on a CUDA device."""
        dev = self._to_device({k: np.asarray(v)[: self.batch_size]
                               for k, v in example.items()
                               if k not in RESERVED_KEYS})
        cuda = self.device.type == "cuda"

        def run():
            self._forward(dev)
            if cuda:
                torch.cuda.synchronize(self.device)

        for _ in range(warmup):
            run()
        times = []
        for _ in range(iters):
            t0 = time.perf_counter()
            run()
            times.append((time.perf_counter() - t0) * 1000.0)
        a = np.asarray(times)
        return {"p50_ms": float(np.percentile(a, 50)),
                "p95_ms": float(np.percentile(a, 95)),
                "mean_ms": float(a.mean()),
                "batch_size": self.batch_size,
                "device": (torch.cuda.get_device_name(self.device) if cuda
                           else str(self.device))}
