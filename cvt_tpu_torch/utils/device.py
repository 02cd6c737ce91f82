"""Where the port's entry points put their tensors.

Every public constructor, `train`, `load` and `convert.*_from_numpy`
takes `device=None` and resolves it here: the card unless the caller asks
for the CPU, by `device="cpu"` or by passing tensors that lie there.
Nothing falls back to the CPU when there is no card.
"""

from __future__ import annotations

import torch


def resolve_device(device=None, like=None) -> torch.device:
    """An explicit `device` wins; otherwise the device of `like` when it
    is a tensor (CPU tensors ask for the CPU); otherwise the card. A card
    without an index is the current one. Raises RuntimeError when the
    answer is a card and there is none."""
    if device is None and isinstance(like, torch.Tensor):
        return like.device
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError('no CUDA device: pass device="cpu" to run on '
                           'the CPU')
    return dev if dev.index is not None else torch.device(
        "cuda", torch.cuda.current_device())
