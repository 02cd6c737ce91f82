"""ArcFace metric-learning trainer: additive-angular-margin softmax
(counterpart of `cvt_tpu.train.arcface`).

Reference: pytorch_arcloss/ ships only the LMDB data plumbing for an
ArcFace-style embedding trainer (image2lmdb/main.py builds the loader);
the model/loss the plumbing feeds is the standard ArcFace head. Here: an
MLP/linear encoder producing L2-normalized embeddings, an angular-margin
classification head, a train step (autograd in place of
`jax.value_and_grad`, a torch optimizer in place of optax), and a
data-parallel step in which every rank holds the whole parameters and
one all_reduce over the mesh's 'dp' group averages the gradients.

ArcFace logits (Deng et al., CVPR'19): for the true class,
cos(theta + m) scaled by s; other classes keep s*cos(theta).

The parameters are a plain dict of tensors in `cvt_tpu`'s layout:
{'layers': [{'w': [din, dout], 'b': [dout]}, ...], 'head': [E, C]}, used
as `x @ w + b`, so `convert.arcface_from_numpy` carries `cvt_tpu`'s
parameters across unchanged. The products are float32 and run at full
precision while TF32 is off for matrix products (PyTorch's default).

What differs from `cvt_tpu`:
  * `create_state` draws its initialisation from a `torch.Generator`,
    whose bits cannot equal `jax.random`'s;
  * an optimizer is bound to its tensors, so `create_state` takes a
    factory over the parameter list (default `torch.optim.Adam(p,
    lr=1e-3)`, the update of `optax.adam(1e-3)`), `train_step` updates
    the parameters in place, and `ArcFaceState.opt_state` is the
    optimizer's live state;
  * the margin enters at the target column only (a gather and a scatter
    over [B] entries): the same logits as `cvt_tpu`'s one-hot blend of
    two [B, C] arrays, which would take the arccos of all B x C cosines.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Sequence

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh

from cvt_tpu_torch.ops.linalg import l2_normalize
from cvt_tpu_torch.utils.device import resolve_device

OptimizerFactory = Callable[[list], torch.optim.Optimizer]


@dataclass
class ArcFaceState:
    """Training state: encoder params, class weights, optimizer state."""

    params: Any                 # {'layers': [{'w','b'}...], 'head': W}
    opt_state: Any              # the optimizer's state (a live mapping)
    step: int = 0


def parameters(params) -> list:
    """The parameter tensors in a fixed order: each layer's w, b, then the
    head."""
    out = []
    for lyr in params["layers"]:
        out += [lyr["w"], lyr["b"]]
    return out + [params["head"]]


def _device(params) -> torch.device:
    return params["head"].device


def _init_mlp(gen: torch.Generator, dims: Sequence[int], device):
    layers = []
    for din, dout in zip(dims[:-1], dims[1:]):
        w = torch.randn((din, dout), generator=gen, device=gen.device,
                        dtype=torch.float32) * math.sqrt(2.0 / din)
        layers.append({"w": w.to(device),
                       "b": torch.zeros((dout,), dtype=torch.float32,
                                        device=device)})
    return layers


def _encode(layers, x):
    h = x
    for i, lyr in enumerate(layers):
        h = h @ lyr["w"] + lyr["b"]
        if i < len(layers) - 1:
            h = F.relu(h)
    return l2_normalize(h)


def _inputs(params, x, y=None):
    dev = _device(params)
    x = torch.as_tensor(x, dtype=torch.float32).to(dev)
    if y is None:
        return x
    return x, torch.as_tensor(y).to(device=dev, dtype=torch.int64)


@torch.no_grad()
def embed(params, x) -> torch.Tensor:
    """Inference path: [B, D_in] -> L2-normalized [B, D_emb], on the
    parameters' device (numpy goes there)."""
    return _encode(params["layers"], _inputs(params, x))


def arcface_logits(params, x, y, *, scale: float = 30.0,
                   margin: float = 0.5) -> torch.Tensor:
    """[B, C] margin-adjusted scaled cosine logits."""
    x, y = _inputs(params, x, y)
    emb = _encode(params["layers"], x)                   # [B, E] unit
    w = l2_normalize(params["head"], dim=0)              # [E, C] unit cols
    cos = torch.clamp(emb @ w, -1.0 + 1e-7, 1.0 - 1e-7)  # [B, C]
    cos_t = torch.gather(cos, 1, y[:, None])             # [B, 1] targets
    theta = torch.arccos(cos_t)
    # easy-margin guard: only add margin while theta + m stays in [0, pi]
    margined = torch.where(theta + margin < math.pi, torch.cos(theta + margin),
                           cos_t - margin * math.sin(margin))
    return scale * torch.scatter(cos, 1, y[:, None], margined)


def arcface_loss(params, x, y, *, scale: float = 30.0,
                 margin: float = 0.5) -> torch.Tensor:
    x, y = _inputs(params, x, y)
    logits = arcface_logits(params, x, y, scale=scale, margin=margin)
    return F.cross_entropy(logits, y)


def state_from_params(params, optimizer: OptimizerFactory | None = None,
                      ) -> tuple[ArcFaceState, torch.optim.Optimizer]:
    """A training state over existing parameters (e.g. carried from
    `cvt_tpu` by `convert.arcface_from_numpy`): marks them as requiring
    gradients and binds the optimizer (a factory over the parameter list;
    default Adam, lr 1e-3) to them."""
    leaves = parameters(params)
    for p in leaves:
        p.requires_grad_(True)
    if optimizer is None:
        opt = torch.optim.Adam(leaves, lr=1e-3)
    else:
        opt = optimizer(leaves)
    return ArcFaceState(params, opt.state), opt


def create_state(generator, *, dim_in: int, num_classes: int,
                 dim_emb: int = 128, hidden: Sequence[int] = (),
                 optimizer: OptimizerFactory | None = None, device=None,
                 ) -> tuple[ArcFaceState, torch.optim.Optimizer]:
    """Initialize encoder (dim_in -> hidden... -> dim_emb) + head [E, C]
    on `device` (the card unless asked for the CPU). `generator` is a
    torch.Generator or an int seed (a CPU generator, so a seed gives the
    same parameters on every device)."""
    dev = resolve_device(device)
    gen = generator
    if not isinstance(gen, torch.Generator):
        gen = torch.Generator().manual_seed(int(generator))
    layers = _init_mlp(gen, [dim_in, *hidden, dim_emb], dev)
    head = torch.randn((dim_emb, num_classes), generator=gen,
                       device=gen.device, dtype=torch.float32) * 0.01
    return state_from_params({"layers": layers, "head": head.to(dev)},
                             optimizer)


def train_step(state: ArcFaceState, x, y,
               optimizer: torch.optim.Optimizer, *,
               scale: float = 30.0, margin: float = 0.5,
               ) -> tuple[ArcFaceState, torch.Tensor]:
    """One optimizer step on the batch (x [B, D], y [B]; numpy goes to the
    parameters' device). The parameters are updated in place; returns the
    state with its step counted and the batch's mean loss (before the
    update, as `cvt_tpu` returns it)."""
    optimizer.zero_grad(set_to_none=True)
    loss = arcface_loss(state.params, x, y, scale=scale, margin=margin)
    loss.backward()
    optimizer.step()
    return (ArcFaceState(state.params, optimizer.state, state.step + 1),
            loss.detach())


def make_sharded_train_step(mesh: DeviceMesh | None,
                            optimizer: torch.optim.Optimizer, *,
                            axis: str = "dp", scale: float = 30.0,
                            margin: float = 0.5, device=None):
    """Data-parallel train step over the mesh's `axis` group.

    Every rank holds the whole parameters (the same on every rank) and
    calls step(state, x, y) with ITS OWN shard of the batch (x
    [B_r, D], y [B_r]), as `parallel.sharded_kmeans_step` takes its
    shard. The local loss and gradients, each weighted by B_r, go into
    one all_reduce(SUM) over `mesh.get_group(axis)`; dividing by the
    summed B gives the whole batch's mean loss and gradient on every rank
    (the psum of `cvt_tpu`'s jit), and every rank then takes the same
    optimizer step. Returns step(state, x, y) -> (state, global mean loss).

    mesh None starts a 1-rank group (`parallel.init_distributed(device=
    device)`: NCCL on the card, gloo for device="cpu") and takes a mesh of
    `axis` over every rank. `optimizer` is this rank's optimizer over the
    state's parameters (`create_state`'s second result)."""
    from cvt_tpu_torch.parallel.mesh import make_mesh, mesh_device
    if mesh is None:
        from cvt_tpu_torch.parallel.serving import init_distributed
        init_distributed(device=device)
        mesh = make_mesh({axis: dist.get_world_size()})
    group = mesh.get_group(axis)
    dev = mesh_device(mesh)

    def step(state: ArcFaceState, x, y
             ) -> tuple[ArcFaceState, torch.Tensor]:
        if _device(state.params).type != dev.type:
            raise ValueError(f"parameters on {_device(state.params)}, mesh "
                             f"on {dev}")
        optimizer.zero_grad(set_to_none=True)
        x, y = _inputs(state.params, x, y)
        loss = arcface_loss(state.params, x, y, scale=scale, margin=margin)
        loss.backward()
        leaves = parameters(state.params)
        n = float(x.shape[0])
        buf = torch.cat([p.grad.reshape(-1) * n for p in leaves]
                        + [loss.detach().reshape(1) * n,
                           torch.tensor([n], device=loss.device)])
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
        total = buf[-1]
        off = 0
        for p in leaves:
            k = p.numel()
            p.grad.copy_((buf[off:off + k] / total).reshape(p.shape))
            off += k
        optimizer.step()
        return (ArcFaceState(state.params, optimizer.state, state.step + 1),
                buf[-2] / total)

    return step
