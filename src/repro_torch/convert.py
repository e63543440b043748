"""Parameters of the JAX package into the port.

``params_from_jax`` takes a JAX parameter tree given as numpy arrays (for
example ``jax.tree.map(np.asarray, params)``) and returns the port's nested
dict of tensors on ``device``, with the same structure and dtypes — bf16
included, which ``torch.from_numpy`` cannot read directly (numpy's bf16 is
the ``ml_dtypes`` extension type; it is reinterpreted bit for bit).
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np

from repro_torch.core import tree
from repro_torch.device import as_tensor, resolve_device


def params_from_jax(tree_of_numpy: Any,
                    device: Optional[Any] = None) -> Any:
    """numpy tree (JAX structure) -> tensor tree on ``device`` (None means
    ``cuda:0``, as for every entry point of the port)."""
    dev = resolve_device(device)
    return tree.map(lambda x: as_tensor(np.array(x, copy=True), dev),
                    tree_of_numpy)
