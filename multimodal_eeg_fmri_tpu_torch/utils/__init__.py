"""Tree helpers over modules, state dicts and nested tensors
(``utils/tree.py``)."""

from multimodal_eeg_fmri_tpu_torch.utils.tree import (
    cast_floating,
    count_parameters,
    tree_size_bytes,
)

__all__ = ["cast_floating", "count_parameters", "tree_size_bytes"]
