"""Layer spans from outside the program: ``record_function`` annotations
opened and closed by module hooks.

The configuration names the layers to span by the class of their module
(``"spans": {"attention": "MultiHeadAttention", "moe": "MoEFFN"}``). Each
such module gets a forward pre-hook and a forward hook (the span
``portbench.span/<label>/fwd``) and, in training, a full backward pre-hook
and a full backward hook (``.../bwd``), which run on the autograd thread
that launches the backward's kernels. ``on_call(label, module, args)``
sees every forward's inputs, from which the work of the call is counted by
its shapes. No span is added inside the program, and the hooks exist only
while the traced sub-window runs.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Callable, Dict, Iterable, Optional

import torch
from torch.autograd.profiler import record_function

from portbench.harness.trace import SPAN


class Spans:
    def __init__(self, roots: Iterable[torch.nn.Module],
                 classes: Dict[str, str], backward: bool,
                 on_call: Optional[Callable] = None):
        self.roots = list(roots)
        self.classes = classes              # label -> module class name
        self.backward = backward
        self.on_call = on_call
        self._handles = []
        self._open = defaultdict(list)      # (id(module), phase) -> stack

    def _enter(self, label, module, phase):
        rf = record_function(f"{SPAN}{label}/{phase}")
        rf.__enter__()
        self._open[(id(module), phase)].append(rf)

    def _exit(self, module, phase):
        stack = self._open[(id(module), phase)]
        if stack:
            stack.pop().__exit__(None, None, None)

    def install(self) -> "Spans":
        by_class = {cls: label for label, cls in self.classes.items()}
        for root in self.roots:
            for module in root.modules():
                label = by_class.get(type(module).__name__)
                if label is None:
                    continue

                def pre(mod, args, label=label):
                    if self.on_call is not None:
                        self.on_call(label, mod, args)
                    self._enter(label, mod, "fwd")

                def post(mod, args, out):
                    self._exit(mod, "fwd")

                self._handles.append(module.register_forward_pre_hook(pre))
                self._handles.append(module.register_forward_hook(post))
                if self.backward:
                    def bpre(mod, grad_out, label=label):
                        self._enter(label, mod, "bwd")

                    def bpost(mod, grad_in, grad_out):
                        self._exit(mod, "bwd")

                    self._handles.append(
                        module.register_full_backward_pre_hook(bpre))
                    self._handles.append(
                        module.register_full_backward_hook(bpost))
        return self

    def remove(self) -> None:
        for h in self._handles:
            h.remove()
        self._handles.clear()
        for stack in self._open.values():
            while stack:
                stack.pop().__exit__(None, None, None)

    def __enter__(self):
        return self.install()

    def __exit__(self, *exc):
        self.remove()
        return False
