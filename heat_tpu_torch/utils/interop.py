"""Carry state into the port from numpy arrays: a distributed array, a
fitted KMeans (for example one fitted by heat_tpu, exported with numpy), or
the parameters of a flax ``MultiHeadAttention`` or ``TransformerLM``."""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

from ..cluster.kmeans import KMeans
from ..core import factories
from ..core.communication import MeshCommunication
from ..core.dndarray import DNDarray
from ..nn.attention import MultiHeadAttention
from ..nn.models import TransformerLM

__all__ = ["dndarray_from_numpy", "kmeans_from_state", "mha_from_flax", "transformer_lm_from_flax"]


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
