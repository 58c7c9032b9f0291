"""Expert parallelism: top-1 mixture of experts with all-to-all dispatch
(counterpart of heat_tpu/parallel/expert.py).

One expert per shard of the 'ep' axis. Tokens are routed top-1, packed
into fixed per-destination buffers (capacity = the shard's token count, so
nothing is ever dropped), exchanged with one ``alltoall``, transformed by
the receiving shard's expert, exchanged back with another and unpacked to
their order, each scaled by its router probability (the Switch-Transformer
data path). Over a mesh whose ranks span processes each process routes its
ranks' rows through its ranks' experts, and the output is joined in every
process.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..core import communication
from ..core.communication import MeshCommunication
from ..nn import _init
from ._mesh import Mesh, axis_comm
from .pipeline import tree_map

__all__ = ["MoELayer", "moe_apply"]


def _route(logits: torch.Tensor):
    """Top-1 routing of one shard's tokens: the expert of each, its gate
    (router probability) and its slot ``expert · t + rank among the
    tokens of that expert``."""
    t, n_exp = logits.shape
    probs = torch.softmax(logits, dim=-1)
    assign = logits.argmax(dim=-1)
    gate = probs.gather(1, assign[:, None])[:, 0]
    rank = F.one_hot(assign, n_exp).cumsum(dim=0) - 1
    slot = assign * t + rank.gather(1, assign[:, None])[:, 0]
    return gate, slot


def moe_apply(
    expert_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    expert_params: Any,
    router_weights: torch.Tensor,
    x: torch.Tensor,
    mesh: Union[Mesh, MeshCommunication],
    axis: str = "ep",
) -> torch.Tensor:
    """Route the tokens ``x (n, d)``, cut by rows over ``mesh``'s ``axis``,
    through one expert per shard.

    ``expert_params`` is a tree of tensors with a leading expert axis of
    size E, the axis' size; expert e's slice moves to shard e's device.
    ``router_weights (d, E)`` is replicated. Returns (n, d) on x's device,
    each token scaled by its router probability (straight-through top-1).
    """
    comm = axis_comm(mesh, axis)
    n_exp = comm.size
    if x.shape[0] % n_exp:
        raise ValueError(f"token count {x.shape[0]} not divisible by {n_exp} experts")
    t, d = x.shape[0] // n_exp, x.shape[1]
    ranks, devices = list(comm.local_ranks), comm.local_devices
    held = list(zip(ranks, devices))
    # this process's ranks' rows and experts, and the router on each rank
    xs = communication.take_blocks(comm, x, [t] * n_exp, 0, held, range(n_exp))
    routers = communication.share(comm, {"router": router_weights}, [("router", r) for r in range(n_exp)],
                                  {"router": tuple(router_weights.shape)})

    cuts = {}

    def mine(a, i):
        # each leaf cut once: its experts of this process's ranks
        if id(a) not in cuts:
            cuts[id(a)] = [b[0] for b in communication.take_blocks(comm, a, [1] * n_exp, 0, held, range(n_exp))]
        return cuts[id(a)][i]

    experts = [tree_map(lambda a, i=i: mine(a, i), expert_params) for i in range(len(ranks))]
    routes, dispatch = [], []
    for xr, router, dev in zip(xs, routers, devices):
        xr = xr.to(dev)
        gate, slot = _route(xr @ router)
        routes.append((gate, slot))
        # block j of the buffer goes to shard j; capacity t never overflows
        dispatch.append(xr.new_zeros(n_exp * t, d).index_copy(0, slot, xr).view(n_exp, t, d))
    received = communication.all_to_all(comm, dispatch, 0, 0)
    transformed = [
        expert_fn(params, r.reshape(n_exp * t, d)).reshape(n_exp, t, d) for params, r in zip(experts, received)
    ]
    back = communication.all_to_all(comm, transformed, 0, 0)
    out = [b.reshape(n_exp * t, d)[slot] * gate[:, None] for b, (gate, slot) in zip(back, routes)]
    return communication.join_blocks(comm, out, ranks, [t] * n_exp, 0, range(n_exp), x.device)


class MoELayer(nn.Module):
    """A bank of E expert MLPs and a router, applied through
    :func:`moe_apply` when given a mesh, or densely (the oracle path)
    without one.

    The router (features, E) and the expert kernels ``wi`` (E, features,
    hidden) and ``wo`` (E, hidden, features) are lecun-normal, as flax
    draws them (the expert axis counts into the fan-in).
    """

    def __init__(self, n_experts: int, hidden: int, features: int, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = _init.torch_device(device)
        generator = _init.generator(generator, device)

        def draw(*shape):
            fan_in = shape[-2] * (shape[0] if len(shape) == 3 else 1)
            return nn.Parameter(_init.lecun_normal_(torch.empty(shape, device=device), fan_in, generator))

        self.router = draw(features, n_experts)
        self.wi = draw(n_experts, features, hidden)
        self.wo = draw(n_experts, hidden, features)

    @staticmethod
    def expert_fn(p, x: torch.Tensor) -> torch.Tensor:
        wi, wo = p
        return F.gelu(x @ wi, approximate="tanh") @ wo

    def forward(self, x: torch.Tensor, mesh: Optional[Union[Mesh, MeshCommunication]] = None,
                axis: str = "ep") -> torch.Tensor:
        if mesh is not None:
            return moe_apply(self.expert_fn, (self.wi, self.wo), self.router, x, mesh, axis)
        # dense oracle: every token through its argmax expert, locally
        logits = x @ self.router
        probs = torch.softmax(logits, dim=-1)
        assign = logits.argmax(dim=-1)
        gate = probs.gather(1, assign[:, None])[:, 0]
        per_expert = F.gelu(torch.einsum("td,edh->teh", x, self.wi), approximate="tanh")
        outs = torch.einsum("teh,ehd->ted", per_expert, self.wo)
        picked = outs.gather(1, assign[:, None, None].expand(-1, 1, outs.shape[2]))[:, 0]
        return picked * gate[:, None]
