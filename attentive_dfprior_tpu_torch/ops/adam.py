"""Per-leaf lazy Adam on parameter trees.

The port of the JAX package's ``ops/adam.py`` (``adam_update``, ref:
ops/adam.py:92-129), itself torch.optim.Adam's arithmetic with one
difference that matters for parity with the reference's per-frame optimizer
(ref: src/Mapper.py:374-401):

  - A leaf whose gradient is exactly zero everywhere (or has no gradient:
    ``None`` counts as all-zero) is untouched this step: its step counter,
    moments and value stay as they are. torch.optim.Adam would step every
    leaf that has a ``.grad``.
  - A leaf with a nonzero gradient advances its step counter even when its
    learning rate is 0 (the JAX mapper differentiates every leaf and zeroes
    only the rate, ref: slam/mapper.py:299).

``lazy=False`` is the port of the JAX package's ``DFPRIOR_ADAM_LAZY=0``
(ref: ops/adam.py:45-52, 99-104): every leaf counts as touched in every
step, a missing gradient as all-zero, so every step counter advances.

The update is branch-free on the device (no host sync per leaf) and in
place under ``torch.no_grad()``: the JAX package donated these buffers. It
makes no copy from the host (the bias-correction bases are constants made
once per device, the learning rates floats or device tensors), so a CUDA
graph can capture it (``utils/step_graph.py``); ``adam_reset`` zeroes a
state in place, a fresh state for a new frame at the same addresses.
"""

from __future__ import annotations

from typing import Any, List, NamedTuple, Optional

import torch

from attentive_dfprior_tpu_torch.utils.device import device_constant
from attentive_dfprior_tpu_torch.utils.tree import tree_leaves, tree_map


class AdamState(NamedTuple):
    step: Any  # tree of int32 scalars per leaf (like params)
    m: Any
    v: Any


def adam_init(params: Any) -> AdamState:
    return AdamState(
        step=tree_map(lambda p: torch.zeros((), dtype=torch.int32, device=p.device), params),
        m=tree_map(lambda p: torch.zeros_like(p, memory_format=torch.contiguous_format).detach(), params),
        v=tree_map(lambda p: torch.zeros_like(p, memory_format=torch.contiguous_format).detach(), params),
    )


@torch.no_grad()
def adam_reset(state: AdamState) -> None:
    """Zero ``state`` in place: ``adam_init``'s values at the same addresses."""
    for t in tree_leaves(state.step) + tree_leaves(state.m) + tree_leaves(state.v):
        t.zero_()


@torch.no_grad()
def adam_update(
    params: Any,
    grads: Any,
    state: AdamState,
    lr_tree: Any,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    lazy: bool = True,
) -> None:
    """One Adam step, in place on ``params`` and ``state``.

    Args:
        params: tree of tensors.
        grads: matching tree (or flat list in leaf order) of gradients;
            ``None`` entries count as all-zero.
        state: AdamState from adam_init.
        lr_tree: matching tree of float learning rates (or 0-d tensors on
            the parameters' device).
        lazy: the per-leaf rule above; False steps every leaf.
    """
    ps: List[torch.Tensor] = tree_leaves(params)
    gs: List[Optional[torch.Tensor]] = grads if isinstance(grads, list) else tree_leaves(grads)
    ss, ms, vs = tree_leaves(state.step), tree_leaves(state.m), tree_leaves(state.v)
    lrs = tree_leaves(lr_tree)
    for p, g, s, m, v, lr in zip(ps, gs, ss, ms, vs, lrs):
        if g is None:
            if lazy:
                continue
            g = torch.zeros_like(p)
        touched = torch.any(g != 0) if lazy else torch.ones((), dtype=torch.bool, device=p.device)
        s.add_(touched.to(torch.int32))
        m.copy_(torch.where(touched, b1 * m + (1 - b1) * g, m))
        v.copy_(torch.where(touched, b2 * v + (1 - b2) * (g * g), v))
        tf = s.to(torch.float32)
        bc1 = torch.clamp(1.0 - torch.pow(device_constant(b1, torch.float32, tf.device), tf), min=1e-12)
        bc2 = torch.clamp(1.0 - torch.pow(device_constant(b2, torch.float32, tf.device), tf), min=1e-12)
        step = lr * (m / bc1) / (torch.sqrt(v / bc2) + eps)
        p.copy_(torch.where(touched, p - step, p))
