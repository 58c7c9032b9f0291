"""heat_tpu_torch.parallel against heat_tpu.parallel (after
tests/test_parallel.py): tensor, pipeline and expert parallelism on the
tests' CPU mesh (``HEAT_TPU_TEST_DEVICES`` shards), each against heat_tpu's
on the JAX CPU mesh of the same size and against its dense oracle.

Tolerances are tests/test_parallel.py's: 1e-5 for the tensor-parallel
block and the pipeline, 1e-4 for the mixture of experts (float32 sums in
another order), 1e-6 relative on the dp×tp loss and 1e-5 on its
gradients. Where the reference's HLO check counts the collectives XLA
emitted, a counting mesh counts the port's. Inputs are made with numpy
from a seed.
"""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh
from jax.sharding import NamedSharding, PartitionSpec

import heat_tpu_torch as ht
from heat_tpu.parallel import expert as ref_expert
from heat_tpu.parallel import pipeline as ref_pipeline
from heat_tpu.parallel import tensor as ref_tensor
from heat_tpu_torch import parallel
from heat_tpu_torch.core.communication import MeshCommunication
from heat_tpu_torch.utils.interop import moe_layer_from_flax, tp_mlp_block_from_flax, tree_from_numpy
from torch_counting import CountingMesh

P = ht.communication._cpu_mesh_size()
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _on_cpu():
    ht.use_device("cpu")
    yield
    ht.use_device(None)


def _jax_mesh(name, p=P):
    return JaxMesh(np.array(jax.devices()[:p]), (name,))


def _normal(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ---------------------------------------------------------------------------
# tensor parallelism
# ---------------------------------------------------------------------------
def test_tp_mlp_matches_dense_and_heat_tpu_with_one_allreduce():
    model = ref_tensor.TPMLPBlock(hidden=8 * P, features=8)
    x = _normal((4, 8), seed=0)
    variables = model.init(jax.random.PRNGKey(1), jnp.asarray(x))
    dense = np.asarray(model.apply(variables, jnp.asarray(x)))
    with _jax_mesh("tp"):
        sharded = np.asarray(jax.jit(model.apply)(variables, jnp.asarray(x)))
    comm = CountingMesh([CPU] * P)
    tp = tp_mlp_block_from_flax(variables["params"], comm=comm, device="cpu")
    assert len(tp.up.kernel) == len(tp.down.kernel) == P
    with torch.no_grad():
        got = tp(torch.from_numpy(x))
        oracle = tp_mlp_block_from_flax(variables["params"], device="cpu")(torch.from_numpy(x))
    # the Megatron pattern: the row layer's sum is the only collective, and
    # nothing is gathered, neither activations nor kernels
    assert comm.calls == {"allreduce": 1}
    for want in (dense, sharded, oracle.numpy()):
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_column_then_row_shapes():
    comm = ht.get_comm()
    x = torch.from_numpy(_normal((3, 6), seed=2))
    col = parallel.ColumnParallelDense(6, 4 * P, comm=comm, generator=torch.Generator().manual_seed(3))
    h = col(x)
    # the column output stays sharded: one (3, 4) block per shard
    assert [tuple(b.shape) for b in h] == [(3, 4)] * P
    row = parallel.RowParallelDense(4 * P, 6, comm=comm, generator=torch.Generator().manual_seed(4))
    y = row(h)
    assert y.shape == (3, 6)
    with torch.no_grad():
        kernel_in = torch.cat(list(col.kernel), dim=1)
        kernel_out = torch.cat(list(row.kernel), dim=0)
        want = (x @ kernel_in + torch.cat(list(col.bias))) @ kernel_out + row.bias
    torch.testing.assert_close(y.detach(), want, rtol=1e-5, atol=1e-5)
    # a replicated activation is cut by the row layer itself
    torch.testing.assert_close(row(torch.cat(h, dim=1)).detach(), y.detach(), rtol=0, atol=0)


def test_tp_widths_need_not_divide_the_mesh():
    p = max(P, 2)
    comm = MeshCommunication([CPU] * p)
    block = parallel.TPMLPBlock(2 * p + 1, 5, 3, comm=comm, generator=torch.Generator().manual_seed(5))
    assert sum(k.shape[1] for k in block.up.kernel) == 2 * p + 1
    dense = parallel.TPMLPBlock(2 * p + 1, 5, 3, generator=torch.Generator().manual_seed(5))
    x = torch.from_numpy(_normal((4, 3), seed=6))
    with torch.no_grad():
        for mine, full, dim in ((block.up.kernel, dense.up.kernel, 1), (block.down.kernel, dense.down.kernel, 0)):
            torch.testing.assert_close(torch.cat(list(mine), dim=dim), full[0], rtol=0, atol=0)
        torch.testing.assert_close(block(x), dense(x), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("p", [4, 8])
def test_dp_tp_train_step_matches_dense_oracle(p, monkeypatch):
    dp, tp = p // 2, 2
    mesh = parallel.make_mesh([("dp", dp), ("tp", tp)], devices=[CPU] * p)
    model = ref_tensor.TPMLPBlock(hidden=4 * tp, features=6)
    x, y = _normal((4 * dp, 6), seed=7), _normal((4 * dp, 6), seed=8)
    variables = model.init(jax.random.PRNGKey(2), jnp.asarray(x))
    plain = jax.tree.map(lambda l: l.unbox() if hasattr(l, "unbox") else l, variables["params"],
                         is_leaf=lambda l: hasattr(l, "unbox"))

    def loss_fn(params, xb, yb):
        return jnp.mean((model.apply({"params": params}, xb) - yb) ** 2)

    ref_loss, ref_grads = jax.value_and_grad(loss_fn)(plain, jnp.asarray(x), jnp.asarray(y))

    calls = collections.Counter()
    for verb in ("allreduce", "allgather"):
        def counted(self, *args, _verb=verb, _inner=getattr(MeshCommunication, verb), **kwargs):
            calls[_verb] += 1
            return _inner(self, *args, **kwargs)
        monkeypatch.setattr(MeshCommunication, verb, counted)
    # the block cuts its kernels over 'tp' and the batch's rows over 'dp'
    block = tp_mlp_block_from_flax(variables["params"], comm=mesh, device="cpu")
    out = block(torch.from_numpy(x))
    loss = ((out - torch.from_numpy(y)) ** 2).mean()
    loss.backward()
    # one allreduce on each dp row's tp line; nothing gathered
    assert calls == {"allreduce": dp}
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-6)
    grads = {
        "up": {"kernel": torch.cat([k.grad for k in block.up.kernel], 1),
               "bias": torch.cat([b.grad for b in block.up.bias])},
        "down": {"kernel": torch.cat([k.grad for k in block.down.kernel], 0), "bias": block.down.bias.grad},
    }
    for name in ("up", "down"):
        for leaf in ("kernel", "bias"):
            np.testing.assert_allclose(grads[name][leaf].numpy(), np.asarray(ref_grads[name][leaf]), atol=1e-5)
    with torch.no_grad():
        for param in block.parameters():
            param -= 0.1 * param.grad
    # the tp kernels keep their blocks through the update
    assert [tuple(k.shape) for k in block.up.kernel] == [(6, 4)] * tp
    assert [tuple(k.shape) for k in block.down.kernel] == [(4, 6)] * tp


def test_make_mesh():
    mesh = parallel.make_mesh([("dp", 2), ("tp", 3)], devices=[CPU] * 6)
    assert mesh.shape == {"dp": 2, "tp": 3} and mesh.size == 6
    assert [c.size for c in mesh.comms("tp")] == [3, 3] and [c.size for c in mesh.comms("dp")] == [2, 2, 2]
    assert parallel.make_mesh([("x", P)]).size == P  # the default mesh's devices
    with pytest.raises(ValueError, match="need 4 devices"):
        parallel.make_mesh([("dp", 2), ("tp", 2)], devices=[CPU] * 3)
    with pytest.raises(ValueError, match="no axis"):
        mesh.comms("pp")


# ---------------------------------------------------------------------------
# pipeline parallelism
# ---------------------------------------------------------------------------
def _stages(p, d=6, seed=0):
    rng = np.random.default_rng(seed)
    return [
        {"w": (rng.standard_normal((d, d)) * 0.3).astype(np.float32),
         "b": (rng.standard_normal(d) * 0.1).astype(np.float32)}
        for _ in range(p)
    ]


@pytest.mark.parametrize("microbatches", [None, 3])
def test_pipeline_matches_sequential_and_heat_tpu(microbatches):
    stage_params = _stages(P, seed=9)
    m = microbatches or P
    x = _normal((4 * m, 6), seed=10)
    want = ref_pipeline.pipeline_apply(
        lambda sp, a: jnp.tanh(a @ sp["w"] + sp["b"]), ref_pipeline.pipeline_stage_params(stage_params),
        jnp.asarray(x), _jax_mesh("pp"), axis="pp", n_microbatches=microbatches,
    )
    comm = CountingMesh([CPU] * P)
    stacked = parallel.pipeline_stage_params(tree_from_numpy(stage_params, device="cpu"))
    got = parallel.pipeline_apply(
        lambda sp, a: torch.tanh(a @ sp["w"] + sp["b"]), stacked, torch.from_numpy(x), comm,
        n_microbatches=microbatches,
    )
    sequential = torch.from_numpy(x)
    for sp in tree_from_numpy(stage_params, device="cpu"):
        sequential = torch.tanh(sequential @ sp["w"] + sp["b"])
    assert got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(got.numpy(), sequential.numpy(), atol=1e-5)
    # M + P - 1 ticks, one hop each; the last stage's outputs broadcast once
    assert comm.calls == {"ppermute": m + P - 1, "bcast": 1}


def test_pipeline_on_a_named_mesh_axis():
    mesh = parallel.make_mesh([("dp", 2), ("pp", 2)], devices=[CPU] * 4)
    stage_params = tree_from_numpy(_stages(2, seed=11), device="cpu")
    x = torch.from_numpy(_normal((8, 6), seed=12))
    got = parallel.pipeline_apply(lambda sp, a: a @ sp["w"], parallel.pipeline_stage_params(stage_params), x, mesh)
    torch.testing.assert_close(got, x @ stage_params[0]["w"] @ stage_params[1]["w"], rtol=1e-5, atol=1e-5)


def test_pipeline_microbatch_validation():
    stacked = parallel.pipeline_stage_params([{"w": torch.eye(2)} for _ in range(P)])
    with pytest.raises(ValueError, match="microbatches"):
        parallel.pipeline_apply(lambda sp, a: a @ sp["w"], stacked, torch.zeros(3 * P + 1, 2),
                                parallel.make_mesh([("pp", P)]), n_microbatches=3 * P)


# ---------------------------------------------------------------------------
# expert parallelism
# ---------------------------------------------------------------------------
def test_moe_matches_dense_oracle_and_heat_tpu():
    model = ref_expert.MoELayer(n_experts=P, hidden=8, features=4)
    x = _normal((8 * P, 4), seed=13)
    variables = model.init(jax.random.PRNGKey(6), jnp.asarray(x))
    dense = np.asarray(model.apply(variables, jnp.asarray(x)))
    mesh = _jax_mesh("ep")
    xs = jax.device_put(jnp.asarray(x), NamedSharding(mesh, PartitionSpec("ep", None)))
    sharded = np.asarray(model.apply(variables, xs, mesh=mesh))
    layer = moe_layer_from_flax(_numpy(variables["params"]), device="cpu")
    comm = CountingMesh([CPU] * P)
    with torch.no_grad():
        got = layer(torch.from_numpy(x), mesh=comm)
        oracle = layer(torch.from_numpy(x))
    assert comm.calls == {"alltoall": 2}  # the dispatch and the return trip
    for want in (dense, sharded, oracle.numpy()):
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


def test_moe_capacity_contract():
    # capacity is the shard's token count: even when every token picks one
    # expert nothing is dropped, and the result is the dense oracle's
    p = max(P, 2)
    d, hidden = 4, 6
    rng = np.random.default_rng(1)
    router = rng.standard_normal((d, p)).astype(np.float32)
    wi = rng.standard_normal((p, d, hidden)).astype(np.float32)
    wo = rng.standard_normal((p, hidden, d)).astype(np.float32)
    x = np.abs(_normal((2 * p, d), seed=14))
    mesh = parallel.make_mesh([("ep", p)], devices=[CPU] * p)
    layer = parallel.MoELayer(p, hidden, d, device="cpu")
    with torch.no_grad():
        layer.router.copy_(torch.from_numpy(router))
        layer.wi.copy_(torch.from_numpy(wi))
        layer.wo.copy_(torch.from_numpy(wo))
        out = layer(torch.from_numpy(x), mesh=mesh)
        assert out.shape == x.shape and torch.isfinite(out).all()
        layer.router[:, 0] = 10.0  # positive tokens: expert 0 wins every one
        crowded = layer(torch.from_numpy(x), mesh=mesh)
        torch.testing.assert_close(crowded, layer(torch.from_numpy(x)), rtol=1e-5, atol=1e-5)
    if p == P:
        jmesh = _jax_mesh("ep")
        xs = jax.device_put(jnp.asarray(x), NamedSharding(jmesh, PartitionSpec("ep", None)))
        want = ref_expert.moe_apply(ref_expert.MoELayer.expert_fn, (jnp.asarray(wi), jnp.asarray(wo)),
                                    jnp.asarray(router), xs, jmesh, "ep")
        np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=1e-4)
    with pytest.raises(ValueError, match="not divisible"):
        layer(torch.zeros(2 * p + 1, d), mesh=mesh)


def test_parallel_namespace():
    import heat_tpu.parallel as ref_parallel

    assert ht.parallel is parallel
    # every name heat_tpu.parallel exports, and the port's Mesh
    assert set(parallel.__all__) == set(ref_parallel.__all__) | {"Mesh"}
    assert all(hasattr(parallel, name) for name in parallel.__all__)
