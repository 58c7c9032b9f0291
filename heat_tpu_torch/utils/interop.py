"""Carry state into the port from numpy arrays: a distributed array, a
fitted KMeans (for example one fitted by heat_tpu, exported with numpy),
the variables of a flax ``MultiHeadAttention``, ``TransformerLM``, ``MLP``,
``SimpleCNN``, ``ResNet``, ``TPMLPBlock`` or ``MoELayer``, or any tree of
arrays (per-stage pipeline parameters).

The model loaders take the model's other fields as keywords, ``dtype``
among them: the parameters load as float32 whatever the model's dtype, as
flax keeps them."""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

from ..cluster.kmeans import KMeans
from ..core import factories
from ..core.communication import MeshCommunication
from ..core.dndarray import DNDarray
from ..nn import _init
from ..nn.attention import MultiHeadAttention
from ..nn.models import MLP, BasicBlock, Bottleneck, ResNet, SimpleCNN, TransformerLM
from ..parallel.expert import MoELayer
from ..parallel.pipeline import tree_map
from ..parallel.tensor import TPMLPBlock

__all__ = [
    "dndarray_from_numpy",
    "kmeans_from_state",
    "mha_from_flax",
    "transformer_lm_from_flax",
    "mlp_from_flax",
    "simple_cnn_from_flax",
    "resnet_from_flax",
    "tp_mlp_block_from_flax",
    "moe_layer_from_flax",
    "tree_from_numpy",
]


def dndarray_from_numpy(
    arr: np.ndarray, split: Optional[int] = None, comm: Optional[MeshCommunication] = None
) -> DNDarray:
    """A DNDarray holding ``arr`` with the given split, on ``comm``'s devices
    (the default mesh if None). The dtype is kept."""
    return factories.array(np.asarray(arr), split=split, comm=comm)


def kmeans_from_state(
    state: Mapping, comm: Optional[MeshCommunication] = None
) -> KMeans:
    """A fitted :class:`KMeans` from its state: ``cluster_centers_`` (k, f)
    and ``labels_`` (n,) arrays, ``inertia_``, ``n_iter_`` and
    ``n_clusters``. Its ``predict`` works at once; the labels are split
    along the samples."""
    k = int(state["n_clusters"])
    centers = np.asarray(state["cluster_centers_"])
    if centers.shape[0] != k:
        raise ValueError(f"cluster_centers_ holds {centers.shape[0]} rows, not n_clusters={k}")
    est = KMeans(n_clusters=k)
    est._cluster_centers = dndarray_from_numpy(centers, None, comm)
    est._labels = dndarray_from_numpy(np.asarray(state["labels_"]).astype(np.int64), 0, comm)
    est._inertia = float(state["inertia_"])
    est._n_iter = int(state["n_iter_"])
    return est


def _copy(param: torch.Tensor, value) -> None:
    value = torch.from_numpy(np.array(value, dtype=np.float32))
    if tuple(value.shape) != tuple(param.shape):
        raise ValueError(f"flax parameter of shape {tuple(value.shape)} for {tuple(param.shape)}")
    param.copy_(value)


def _load_dense(layer: torch.nn.Linear, params: Mapping) -> None:
    """A flax Dense/DenseGeneral kernel (in..., out...) into ``nn.Linear``,
    whose weight is (out, in)."""
    kernel = np.asarray(params["kernel"])
    _copy(layer.weight, kernel.reshape(layer.in_features, layer.out_features).T)
    _copy(layer.bias, np.asarray(params["bias"]).reshape(-1))


def _load_norm(layer: torch.nn.LayerNorm, params: Mapping) -> None:
    _copy(layer.weight, params["scale"])
    _copy(layer.bias, params["bias"])


def _load_mha(mha: MultiHeadAttention, params: Mapping) -> None:
    for name in ("query", "key", "value", "out"):
        _load_dense(getattr(mha, name), params[name])


def mha_from_flax(params: Mapping, **config) -> MultiHeadAttention:
    """A :class:`~heat_tpu_torch.nn.MultiHeadAttention` holding the weights of
    a flax ``heat_tpu.nn.MultiHeadAttention``: ``params`` is its parameter
    tree as nested dicts of numpy arrays (``query``/``key``/``value`` with
    kernel (dim, H, Dh) and bias (H, Dh), ``out`` with kernel (H, Dh, dim)
    and bias (dim,)). ``config`` holds the module's other fields (``causal``,
    ``backend``, ``attention_fn``, ``device``); the widths come from the
    kernels."""
    dim, heads, head_dim = np.shape(params["query"]["kernel"])
    mha = MultiHeadAttention(heads, dim, qkv_features=heads * head_dim, **config)
    with torch.no_grad():
        _load_mha(mha, params)
    return mha


def transformer_lm_from_flax(params: Mapping, **config) -> TransformerLM:
    """A :class:`~heat_tpu_torch.nn.TransformerLM` holding the weights of a
    flax ``heat_tpu.nn.TransformerLM``, from its parameter tree as nested
    dicts of numpy arrays, for example
    ``jax.tree_util.tree_map(np.asarray, variables["params"])``. ``config``
    holds the fields the tree does not give (``causal``, ``attention_fn``,
    ``device``); vocab, dim, depth, heads and max_len come from the tree.

    The tree's top-level ``LayerNorm_0`` is the final norm and its ``Dense_0``
    the head; in ``TransformerBlock_i``, ``LayerNorm_0``/``LayerNorm_1`` are
    the two norms, ``MultiHeadAttention_0`` the attention and
    ``Dense_0``/``Dense_1`` the MLP."""
    vocab, dim = np.shape(params["Embed_0"]["embedding"])
    max_len = np.shape(params["Embed_1"]["embedding"])[0]
    depth = sum(1 for name in params if name.startswith("TransformerBlock_"))
    heads = np.shape(params["TransformerBlock_0"]["MultiHeadAttention_0"]["query"]["kernel"])[1]
    model = TransformerLM(vocab=vocab, dim=dim, depth=depth, heads=heads, max_len=max_len, **config)
    with torch.no_grad():
        _copy(model.embed.weight, params["Embed_0"]["embedding"])
        _copy(model.pos_embed.weight, params["Embed_1"]["embedding"])
        for i, block in enumerate(model.blocks):
            p = params[f"TransformerBlock_{i}"]
            _load_norm(block.norm1, p["LayerNorm_0"])
            _load_mha(block.attn, p["MultiHeadAttention_0"])
            _load_norm(block.norm2, p["LayerNorm_1"])
            _load_dense(block.fc1, p["Dense_0"])
            _load_dense(block.fc2, p["Dense_1"])
        _load_norm(model.norm, params["LayerNorm_0"])
        _load_dense(model.head, params["Dense_0"])
    return model


def _load_conv(layer: torch.nn.Conv2d, params: Mapping) -> None:
    """A flax Conv kernel (kh, kw, in, out) into ``nn.Conv2d``, whose weight
    is (out, in, kh, kw)."""
    _copy(layer.weight, np.asarray(params["kernel"]).transpose(3, 2, 0, 1))
    if layer.bias is not None:
        _copy(layer.bias, params["bias"])


def _load_batch_norm(layer: _init.BatchNorm, params: Mapping, stats: Mapping) -> None:
    _copy(layer.weight, params["scale"])
    _copy(layer.bias, params["bias"])
    _copy(layer.running_mean, stats["mean"])
    _copy(layer.running_var, stats["var"])


def _numbered(tree: Mapping, prefix: str):
    """The entries ``prefix_0``, ``prefix_1``... of a flax tree, in order."""
    return [tree[f"{prefix}_{i}"] for i in range(sum(1 for k in tree if k.startswith(prefix + "_")))]


def mlp_from_flax(params: Mapping, **config) -> MLP:
    """A :class:`~heat_tpu_torch.nn.MLP` holding the weights of a flax
    ``heat_tpu.nn.MLP``, from its parameter tree (``Dense_0``...) as nested
    dicts of numpy arrays; the widths come from the kernels, ``config``
    holds ``device``."""
    denses = _numbered(params, "Dense")
    features = [np.shape(d["kernel"])[1] for d in denses]
    model = MLP(features, in_features=np.shape(denses[0]["kernel"])[0], **config)
    with torch.no_grad():
        for layer, p in zip(model.layers, denses):
            _load_dense(layer, p)
    return model


def simple_cnn_from_flax(params: Mapping, **config) -> SimpleCNN:
    """A :class:`~heat_tpu_torch.nn.SimpleCNN` holding the weights of a flax
    ``heat_tpu.nn.SimpleCNN`` (``Conv_0``, ``Conv_1``, ``Dense_0``,
    ``Dense_1``); ``config`` holds ``device``."""
    model = SimpleCNN(
        np.shape(params["Dense_1"]["kernel"])[1],
        in_channels=np.shape(params["Conv_0"]["kernel"])[2],
        flat_features=np.shape(params["Dense_0"]["kernel"])[0],
        **config,
    )
    with torch.no_grad():
        _load_conv(model.conv1, params["Conv_0"])
        _load_conv(model.conv2, params["Conv_1"])
        _load_dense(model.fc1, params["Dense_0"])
        _load_dense(model.fc2, params["Dense_1"])
    return model


def resnet_from_flax(variables: Mapping, **config) -> ResNet:
    """A :class:`~heat_tpu_torch.nn.ResNet` holding the weights and the
    BatchNorm running averages of a flax ``heat_tpu.nn.ResNet``, from
    ``variables`` = {"params": ..., "batch_stats": ...} as nested dicts of
    numpy arrays. The block kind, the stages, the filters, the input
    channels and the classes come from the tree; ``config`` holds
    ``device``.

    In ``BasicBlock_i``/``Bottleneck_i``, ``Conv_j``/``BatchNorm_j`` are the
    convolutions and norms in call order, and the one after them, where
    present, the projection of the shortcut."""
    params, stats = variables["params"], variables["batch_stats"]
    kind = "Bottleneck" if "Bottleneck_0" in params else "BasicBlock"
    block = Bottleneck if kind == "Bottleneck" else BasicBlock
    blocks = _numbered(params, kind)
    block_stats = _numbered(stats, kind)
    filters = [np.shape(b["Conv_0"]["kernel"])[3] for b in blocks]
    stage_sizes = [1]
    for prev, cur in zip(filters[:-1], filters[1:]):
        if cur == prev:
            stage_sizes[-1] += 1
        else:
            stage_sizes.append(1)
    stem = np.shape(params["Conv_0"]["kernel"])
    model = ResNet(
        stage_sizes, block, num_classes=np.shape(params["Dense_0"]["kernel"])[1],
        num_filters=stem[3], in_channels=stem[2], **config,
    )
    with torch.no_grad():
        _load_conv(model.stem, params["Conv_0"])
        _load_batch_norm(model.stem_norm, params["BatchNorm_0"], stats["BatchNorm_0"])
        for mod, p, s in zip(model.blocks, blocks, block_stats):
            n = len(mod.convs)
            if (mod.proj is not None) != (f"Conv_{n}" in p):
                raise ValueError(f"the flax block {sorted(p)} does not match {mod}")
            for j, (conv, norm) in enumerate(zip(mod.convs, mod.norms)):
                _load_conv(conv, p[f"Conv_{j}"])
                _load_batch_norm(norm, p[f"BatchNorm_{j}"], s[f"BatchNorm_{j}"])
            if mod.proj is not None:
                _load_conv(mod.proj, p[f"Conv_{n}"])
                _load_batch_norm(mod.proj_norm, p[f"BatchNorm_{n}"], s[f"BatchNorm_{n}"])
        _load_dense(model.head, params["Dense_0"])
    return model


def _unbox(value):
    """The array inside a flax ``Partitioned`` box (a leaf made by
    ``nn.with_partitioning``), or the value itself."""
    return value.unbox() if hasattr(value, "unbox") else value


def _load_blocks(layer, blocks, value, dim: int) -> None:
    """A flax kernel into the port's blocks of it, cut along ``dim`` by the
    layer's widths: the blocks of this process's ranks of the layer's line."""
    value = np.asarray(_unbox(value))
    parts = np.split(value, np.cumsum(layer.widths)[:-1], axis=dim)
    ranks = range(len(parts)) if layer.comm is None else layer.comm.local_ranks
    for block, r in zip(blocks, ranks):
        _copy(block, parts[r])


def tp_mlp_block_from_flax(params: Mapping, **config) -> TPMLPBlock:
    """A :class:`~heat_tpu_torch.parallel.TPMLPBlock` holding the weights of a
    flax ``heat_tpu.parallel.TPMLPBlock``, read through the ``Partitioned``
    boxes of its sharded kernels: ``up`` and ``down`` with kernel and bias.
    ``config`` holds ``comm`` (the 'tp' line the kernels are cut over) and
    ``device``; the widths come from the kernels."""
    in_features, hidden = np.shape(_unbox(params["up"]["kernel"]))
    features = np.shape(_unbox(params["down"]["kernel"]))[1]
    block = TPMLPBlock(hidden, features, in_features, **config)
    with torch.no_grad():
        _load_blocks(block.up, block.up.kernel, params["up"]["kernel"], 1)
        _load_blocks(block.up, block.up.bias, params["up"]["bias"], 0)
        _load_blocks(block.down, block.down.kernel, params["down"]["kernel"], 0)
        _copy(block.down.bias, _unbox(params["down"]["bias"]))
    return block


def moe_layer_from_flax(params: Mapping, **config) -> MoELayer:
    """A :class:`~heat_tpu_torch.parallel.MoELayer` holding the router and
    the expert kernels (``router``, ``wi``, ``wo``) of a flax
    ``heat_tpu.parallel.MoELayer``; ``config`` holds ``device``."""
    n_experts, features, hidden = np.shape(params["wi"])
    layer = MoELayer(n_experts, hidden, features, **config)
    with torch.no_grad():
        for name in ("router", "wi", "wo"):
            _copy(getattr(layer, name), params[name])
    return layer


def tree_from_numpy(tree, device=None):
    """Nested dicts, lists and tuples of numpy arrays as the same tree of
    tensors on ``device`` (None: the default device), dtypes kept; for
    example the per-stage parameters of
    :func:`~heat_tpu_torch.parallel.pipeline_stage_params`."""
    device = _init.torch_device(device)
    return tree_map(lambda a: torch.from_numpy(np.array(a)).to(device), tree)
