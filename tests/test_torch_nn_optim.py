"""heat_tpu_torch's training stack against heat_tpu's on the CPU mesh of the
tests (``HEAT_TPU_TEST_DEVICES`` shards, 8 by default): the optimizer shim
against optax, ``DataParallel`` and ``DASO`` against the JAX package's from
the same flax variables, and the surface ported from test_nn_optim.py.

Tolerances:
* the shim optimizers against optax over 10 steps: 1e-6, relative and
  absolute (the same float32 rule; XLA's and torch's rsqrt and fused
  multiply-adds round the last bit otherwise);
* ``DataParallel`` against heat_tpu over 5 steps on a ragged batch: 1e-4 on
  losses, parameters and BatchNorm averages (float32 sums over the batch and
  the mesh in other orders);
* ``DASO`` per replica: one bfloat16 unit in the last place of each
  tensor's largest entry, 2^-8·max|w|. Each merge rounds the global mean to
  bfloat16 once (the sum of bfloat16 values in float32, as XLA's
  ``pmean`` of bfloat16 does), so a float32 difference of one ulp before a
  merge may flip one rounding, and nothing more.
Inputs are made with numpy from a seed.
"""

import sys
import threading
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

import heat_tpu as ref
import heat_tpu_torch as ht
from heat_tpu_torch.core.communication import MeshCommunication
from heat_tpu_torch.utils.interop import mlp_from_flax, resnet_from_flax, transformer_lm_from_flax

P = ht.communication._cpu_mesh_size()
SEED = 20261017
OPT_TOL = dict(rtol=1e-6, atol=1e-6)
DP_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True)
def _on_cpu():
    ht.use_device("cpu")
    yield
    ht.use_comm(None)
    ht.use_device(None)


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _classification(n, f=6, classes=3, seed=SEED):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((classes, f)).astype(np.float32) * 2
    y = rng.integers(0, classes, n).astype(np.int32)
    x = centers[y] + rng.standard_normal((n, f)).astype(np.float32) * 0.5
    return x.astype(np.float32), y


def _mesh(p):
    return MeshCommunication([torch.device("cpu")] * p)


# ---------------------------------------------------------------------------
# the optimizer shim against optax
# ---------------------------------------------------------------------------
SHIM_CASES = [
    ("SGD", (0.1,), {}),
    ("SGD", (0.1,), {"momentum": 0.9}),
    ("SGD", (0.1,), {"momentum": 0.9, "nesterov": True}),
    ("Adam", (1e-2,), {}),
    ("AdamW", (1e-2,), {}),
    ("AdamW", (1e-2,), {"weight_decay": 0.1, "b1": 0.8}),
    ("Adagrad", (0.1,), {}),
    ("RMSprop", (1e-2,), {}),
    ("RMSprop", (1e-2,), {"centered": True, "momentum": 0.9, "bias_correction": True}),
    ("RMSprop", (1e-2,), {"eps_in_sqrt": False, "momentum": 0.5, "nesterov": True, "initial_scale": 0.1}),
    ("Adadelta", (), {}),
    ("Adadelta", (0.5,), {"rho": 0.8, "weight_decay": 0.01}),
]


@pytest.mark.parametrize("name,args,kwargs", SHIM_CASES, ids=lambda v: str(v))
def test_shim_optimizer_matches_optax(name, args, kwargs):
    rng = np.random.default_rng(SEED)
    start = {"w": rng.standard_normal((4, 3)).astype(np.float32), "b": rng.standard_normal(3).astype(np.float32)}
    noise = [{k: rng.standard_normal(v.shape).astype(np.float32) for k, v in start.items()} for _ in range(10)]

    tx = getattr(optax, name.lower())(*args, **kwargs)
    params = {k: jnp.asarray(v) for k, v in start.items()}
    state = tx.init(params)
    mine = {k: torch.from_numpy(v.copy()) for k, v in start.items()}
    opt = getattr(ht.optim, name)(*args, **kwargs)(list(mine.values()))
    for step in noise:
        # gradient of a loss whose curvature depends on the parameters
        grads = {k: params[k] ** 3 - params[k] + step[k] for k in params}
        updates, state = tx.update(grads, state, params)
        params = optax.apply_updates(params, updates)
        for k, p in mine.items():
            p.grad = p**3 - p + torch.from_numpy(step[k])
        opt.step()
    for k in start:
        np.testing.assert_allclose(mine[k].numpy(), np.asarray(params[k]), **OPT_TOL, err_msg=k)


def test_optim_shim_names():
    assert ht.optim.SparseAdam is torch.optim.SparseAdam  # falls back to torch.optim
    with pytest.raises(AttributeError, match="heat_tpu_torch.optim"):
        ht.optim.NotAnOptimizer
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ht.optim.LBFGS(1.0)
    # optax's defaults where torch's differ
    w = [torch.zeros(2, requires_grad=True)]
    assert ht.optim.AdamW(1e-3)(w).defaults["weight_decay"] == 1e-4
    assert ht.optim.Adagrad(0.1)(w).defaults["initial_accumulator_value"] == 0.1
    assert ht.optim.RMSprop(0.1)(w).defaults["decay"] == 0.9
    assert ht.optim.Adadelta()(w).defaults["lr"] is None


def test_nn_shim():
    assert ht.nn.Linear is torch.nn.Linear and ht.nn.DataParallel is ht.nn.data_parallel.DataParallel
    assert ht.nn.functional.relu is F.relu
    assert ht.nn.functional.func_getattr("softmax") is F.softmax
    with pytest.raises(AttributeError):
        ht.nn.functional.not_a_function


# ---------------------------------------------------------------------------
# DataParallel against heat_tpu's: 5 steps on a ragged batch of 10 rows
# ---------------------------------------------------------------------------
def _close(a, b, label):
    np.testing.assert_allclose(a, b, **DP_TOL, err_msg=label)


def _check_state(port_model, expected_model):
    want = expected_model.state_dict()
    got = port_model.state_dict()
    assert got.keys() == want.keys()
    for k in want:
        _close(got[k].numpy(), want[k].numpy(), k)


def test_data_parallel_mlp_adam_matches_heat_tpu():
    x, y = _classification(10)
    theirs = ref.nn.DataParallel(ref.nn.MLP(features=(16, 3)), optimizer=ref.optim.Adam(1e-2))
    theirs.init(0, x[:2])
    mine = ht.nn.DataParallel(mlp_from_flax(_numpy(theirs.params["params"]), device="cpu"),
                              optimizer=ht.optim.Adam(1e-2))
    mine.init(0, x[:2])
    assert len(mine.replicas) == P
    for step in range(5):
        _close(mine.train_step(x, y), theirs.train_step(x, y), f"loss of step {step}")
    _check_state(mine.module, mlp_from_flax(_numpy(theirs.params["params"]), device="cpu"))
    for replica in mine.replicas[1:]:  # every replica took the same step
        for a, b in zip(replica.parameters(), mine.module.parameters()):
            assert torch.equal(a, b)
    _close(mine(x).detach().numpy(), np.asarray(theirs(x)), "forward")


def test_data_parallel_resnet_sgd_matches_heat_tpu(block="Bottleneck"):
    # the global batch's BatchNorm: per-shard statistics give another loss
    # from the first step on a ragged mesh (BasicBlock's forward is held
    # in test_torch_models.py and its lockstep by the stress test below)
    rng = np.random.default_rng(SEED)
    x = rng.standard_normal((10, 8, 8, 3)).astype(np.float32)
    y = rng.integers(0, 4, 10).astype(np.int32)
    model = ref.nn.ResNet(stage_sizes=(1, 1), block=getattr(ref.nn.models, block), num_classes=4, num_filters=8)
    theirs = ref.nn.DataParallel(model, optimizer=ref.optim.SGD(0.05))
    theirs.init(0, x[:2])
    variables = lambda: {"params": _numpy(theirs.params), "batch_stats": _numpy(theirs.state["batch_stats"])}
    mine = ht.nn.DataParallel(resnet_from_flax(variables(), device="cpu"), optimizer=ht.optim.SGD(0.05))
    mine.init(0, x[:2])
    for step in range(5):
        _close(mine.train_step(x, y), theirs.train_step(x, y), f"loss of step {step}")
    _check_state(mine.module, resnet_from_flax(variables(), device="cpu"))
    _close(mine(x).detach().numpy(), np.asarray(theirs(x)), "forward")


def _shift_loss_flax(logits, labels):
    return optax.softmax_cross_entropy_with_integer_labels(logits[:, :-1], labels[:, 1:]).mean()


def _shift_loss(logits, labels):
    return F.cross_entropy(logits[:, :-1].reshape(-1, logits.shape[-1]), labels[:, 1:].reshape(-1).long())


def test_data_parallel_transformer_shift_loss_matches_heat_tpu():
    toks = np.random.default_rng(SEED).integers(0, 17, (10, 12)).astype(np.int32)
    config = dict(vocab=17, dim=16, depth=1, heads=2, max_len=32)
    # SGD: the key bias's gradient is rounding noise (softmax ignores a
    # shift of every score in a row), which Adam would scale up to its rate
    theirs = ref.nn.DataParallel(ref.nn.TransformerLM(**config), optimizer=optax.sgd(0.5),
                                 loss_fn=_shift_loss_flax)
    theirs.init(0, toks[:2])
    mine = ht.nn.DataParallel(transformer_lm_from_flax(_numpy(theirs.params["params"]), device="cpu"),
                              optimizer=ht.optim.SGD(0.5), loss_fn=_shift_loss)
    mine.init(0, toks[:2])
    for step in range(5):
        _close(mine.train_step(toks, toks), theirs.train_step(toks, toks), f"loss of step {step}")
    _check_state(mine.module, transformer_lm_from_flax(_numpy(theirs.params["params"]), device="cpu"))


def _bn_net(seed=0):
    return ht.nn.ResNet((1,), num_classes=3, num_filters=4, device="cpu",
                        generator=torch.Generator().manual_seed(seed))


def test_lockstep_under_thread_stress_equals_one_shard():
    # 16 shards, more threads than cores, a short switch interval: a lost
    # or crossed statistic would break the equality with one shard
    rng = np.random.default_rng(SEED)
    x = rng.standard_normal((37, 4, 4, 3)).astype(np.float32)
    y = rng.integers(0, 3, 37).astype(np.int32)
    one = ht.nn.DataParallel(_bn_net(), comm=_mesh(1)).init(0, x[:2])
    many = ht.nn.DataParallel(_bn_net(), comm=_mesh(16)).init(0, x[:2])
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for _ in range(3):
            _close(many.train_step(x, y), one.train_step(x, y), "loss")
    finally:
        sys.setswitchinterval(interval)
    _check_state(many.module, one.module)


def test_lockstep_failure_is_raised_not_hung():
    class Fails(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.net = _bn_net()

        def forward(self, x, train=False):
            if train and x.shape[0] == 1:
                raise ValueError("shard of one row")
            return self.net(x, train)

    dp = ht.nn.DataParallel(Fails(), comm=_mesh(3)).init(0, np.ones((2, 4, 4, 3), np.float32))
    done = []
    t = threading.Thread(target=lambda: done.append(pytest.raises(ValueError, dp.train_step,
                                                                  np.ones((7, 4, 4, 3), np.float32),
                                                                  np.zeros(7, np.int32))))
    t.start()
    t.join(timeout=60)
    assert not t.is_alive() and done and "one row" in str(done[0].value)


def test_data_parallel_dndarray_input_equals_arrays():
    x, y = _classification(13)
    a = ht.nn.DataParallel(ht.nn.MLP((8, 3), device="cpu")).init(1, x[:4])
    b = ht.nn.DataParallel(ht.nn.MLP((8, 3), device="cpu")).init(1, x[:4])
    for _ in range(2):
        la = a.train_step(ht.array(x, split=0), ht.array(y, split=0))
        lb = b.train_step(x, y)
        assert la == pytest.approx(lb, rel=1e-6)
    assert a.train_step(ht.array(x), torch.from_numpy(y)) == pytest.approx(b.train_step(x, y), rel=1e-6)


def test_data_parallel_trains_and_round_trips():
    # reference test_nn_optim.py::test_mlp_trains
    x, y = _classification(128, f=8, classes=4, seed=1)
    dp = ht.nn.DataParallel(ht.nn.MLP(features=(32, 4), device="cpu"), optimizer=ht.optim.Adam(5e-3))
    dp.init(0, x[:8])
    first = dp.train_step(x, y)
    for _ in range(40):
        last = dp.train_step(x, y)
    assert last < first * 0.5
    assert (dp(x).argmax(1).numpy() == y).mean() > 0.8

    full = dp.state_dict()
    again = ht.nn.DataParallel(ht.nn.MLP(features=(32, 4), device="cpu"), optimizer=ht.optim.Adam(5e-3))
    again.init(0, x[:8]).load_state_dict(full)
    torch.testing.assert_close(again(x[:4]), dp(x[:4]))
    assert again.train_step(x, y) == pytest.approx(dp.train_step(x, y), rel=1e-6)

    bare = ht.nn.DataParallel(ht.nn.MLP(features=(32, 4), device="cpu"), optimizer=ht.optim.Adam(5e-3))
    bare.init(0, x[:8]).load_state_dict(full["params"])  # the optimizer restarts
    assert all(not opt.state for opt in bare.optimizers)
    torch.testing.assert_close(bare(x[:4]), dp(x[:4]))
    with pytest.raises(KeyError):
        bare.load_state_dict({"nope": torch.zeros(1)})


def test_data_parallel_errors_and_seed():
    x, y = _classification(8)
    with pytest.raises(RuntimeError, match="init"):
        ht.nn.DataParallel(ht.nn.MLP(device="cpu")).train_step(x, y)
    with pytest.raises(RuntimeError, match="init"):
        ht.nn.DataParallel(ht.nn.MLP(device="cpu"))(x)
    # the first (lazy) layer is drawn from the seed given to init
    a = ht.nn.DataParallel(ht.nn.MLP((4, 2), device="cpu")).init(3, x[:2])
    b = ht.nn.DataParallel(ht.nn.MLP((4, 2), device="cpu")).init(3, x[:2])
    c = ht.nn.DataParallel(ht.nn.MLP((4, 2), device="cpu")).init(4, x[:2])
    assert torch.equal(a.module.layers[0].weight, b.module.layers[0].weight)
    assert not torch.equal(a.module.layers[0].weight, c.module.layers[0].weight)


def test_data_parallel_rebind_carries_the_state():
    x, y = _classification(12)
    dp = ht.nn.DataParallel(_bn_net(), comm=_mesh(4), optimizer=ht.optim.SGD(0.1, momentum=0.9))
    rng = np.random.default_rng(SEED)
    imgs = rng.standard_normal((12, 4, 4, 3)).astype(np.float32)
    dp.init(0, imgs[:2])
    dp.train_step(imgs, y)
    one = ht.nn.DataParallel(_bn_net(), comm=_mesh(1), optimizer=ht.optim.SGD(0.1, momentum=0.9))
    one.init(0, imgs[:2]).load_state_dict(dp.state_dict())
    dp.rebind(_mesh(2))
    assert len(dp.replicas) == 2
    _close(dp.train_step(imgs, y), one.train_step(imgs, y), "loss after rebind")
    _check_state(dp.module, one.module)


# ---------------------------------------------------------------------------
# DASO against heat_tpu's, per replica
# ---------------------------------------------------------------------------
def _within_one_bf16_ulp(got: torch.Tensor, want: np.ndarray, label: str):
    bound = 2.0**-8 * np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=bound, err_msg=label)


def _check_replicas(mine, theirs, rebuild):
    params = _numpy(theirs.params)
    stats = _numpy(theirs.state) if theirs.state is not None else None
    for r, replica in enumerate(mine.replicas):
        expected = rebuild(jax.tree_util.tree_map(lambda a: a[r], params),
                           None if stats is None else jax.tree_util.tree_map(lambda a: a[r], stats))
        want = expected.state_dict()
        got = replica.state_dict()
        assert got.keys() == want.keys()
        for k in want:
            _within_one_bf16_ulp(got[k], want[k].numpy(), f"replica {r}: {k}")


def _daso_pair(module, port_module, x0, rebuild, **kwargs):
    nodes = 2 if P % 2 == 0 else 1
    config = dict(total_epochs=5, warmup_epochs=1, cooldown_epochs=1, nodes=nodes, local_skip_factor=1)
    config.update(kwargs)
    theirs = ref.optim.DASO(ref.optim.SGD(0.1), **config)
    theirs.add_model(module, 0, x0)
    mine = ht.optim.DASO(ht.optim.SGD(0.1), **config)
    first = jax.tree_util.tree_map(lambda a: np.asarray(a)[0], theirs.params)
    mine.add_model(port_module(first, theirs), 0, x0)
    return mine, theirs


def _run_epochs(mine, theirs, x, y, rebuild, epochs=5, batch=None):
    batch = batch or 2 * P
    for epoch in range(epochs):
        for b in range(0, len(x), batch):
            a = mine.step(x[b:b + batch], y[b:b + batch])
            c = theirs.step(x[b:b + batch], y[b:b + batch])
            np.testing.assert_allclose(a, c, rtol=1e-3, err_msg=f"loss, epoch {epoch}")
        _check_replicas(mine, theirs, rebuild)
        mine.epoch_loss_logic(a)
        theirs.epoch_loss_logic(c)
        assert (mine.global_skip, mine.local_skip, mine._solo_steps) == (
            theirs.global_skip, theirs.local_skip, theirs._solo_steps)


def test_daso_mlp_matches_heat_tpu_per_replica():
    # warmup (epoch 0), cycling with solo batches (epochs 1-3), cooldown (4)
    x, y = _classification(8 * P)
    rebuild = lambda p, s: mlp_from_flax(p["params"], device="cpu")
    mine, theirs = _daso_pair(ref.nn.MLP(features=(16, 3)), rebuild, x[:P], rebuild)
    _run_epochs(mine, theirs, x, y, rebuild)
    assert mine._solo_steps == 9  # 3 of every 4 batches while cycling
    np.testing.assert_allclose(mine(x).detach().numpy(), np.asarray(theirs(x)), rtol=1e-3, atol=1e-3)


def test_daso_resnet_batch_stats_match_heat_tpu_per_replica():
    rng = np.random.default_rng(SEED)
    x = rng.standard_normal((4 * P, 4, 4, 3)).astype(np.float32)
    y = rng.integers(0, 3, 4 * P).astype(np.int32)
    rebuild = lambda p, s: resnet_from_flax({"params": p, "batch_stats": s["batch_stats"]}, device="cpu")
    mine, theirs = _daso_pair(
        ref.nn.ResNet(stage_sizes=(1,), num_classes=3, num_filters=4),
        lambda v, t: rebuild(v, jax.tree_util.tree_map(lambda a: np.asarray(a)[0], t.state)),
        x[:P], rebuild, total_epochs=3,
    )
    _run_epochs(mine, theirs, x, y, rebuild, epochs=3)


def test_daso_validation_and_remainder():
    with pytest.raises(TypeError):
        ht.optim.DASO(ht.optim.SGD(0.1), total_epochs=1.5)
    with pytest.raises(ValueError):
        ht.optim.DASO(ht.optim.SGD(0.1), total_epochs=2, nodes=P + 1)
    with pytest.raises(ValueError):
        ht.optim.DASO(ht.optim.SGD(0.1), total_epochs=2, warmup_epochs=-1)
    daso = ht.optim.DASO(ht.optim.SGD(0.1), total_epochs=2)
    assert daso.nodes * daso.ici_size == P and daso.nodes == (2 if P % 2 == 0 and P > 1 else 1)
    with pytest.raises(RuntimeError, match="add_model"):
        daso.step(np.ones((4, 2), np.float32), np.zeros(4, np.int32))
    daso = ht.optim.DASO(ht.optim.SGD(0.1), total_epochs=2, comm=_mesh(4), nodes=2)
    daso.add_model(ht.nn.MLP((4, 2), device="cpu"), 0, np.ones((4, 3), np.float32))
    with pytest.raises(ValueError, match="smaller"):
        daso.step(np.ones((3, 3), np.float32), np.zeros(3, np.int32))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        daso.step(np.ones((9, 3), np.float32), np.zeros(9, np.int32))
        daso.step(np.ones((9, 3), np.float32), np.zeros(9, np.int32))
    assert sum("dropping the last 1" in str(w.message) for w in caught) == 1


def test_daso_collectives_by_step_type():
    # synced: params, grads (and stats) over each group; solo: none; the
    # merge: one allreduce of the whole mesh
    calls = []

    class Counting(MeshCommunication):
        def allreduce(self, shards, op="sum"):
            calls.append(self.size)
            return super().allreduce(shards, op)

        def sub(self, ranks):
            return Counting([self.devices[r] for r in ranks])

    daso = ht.optim.DASO(ht.optim.SGD(0.1), total_epochs=3, comm=Counting([torch.device("cpu")] * 4),
                         nodes=2, warmup_epochs=0, cooldown_epochs=0)
    daso.add_model(_bn_net(), 0, np.ones((4, 4, 4, 3), np.float32))
    daso.global_skip, daso.local_skip, daso.batches_to_wait = 2, 2, 1
    x, y = np.ones((8, 4, 4, 3), np.float32), np.zeros(8, np.int32)
    daso.step(x, y)  # batch 0: synced, no merge
    assert calls == [2] * 6
    calls.clear()
    daso.step(x, y)  # batch 1: solo, no merge
    assert calls == [] and daso._solo_steps == 1
    daso.step(x, y)  # batch 2: synced, then the merge after it
    assert calls == [2] * 6 + [4]


def test_daso_state_dicts_and_rebind():
    x, y = _classification(16)
    daso = ht.optim.DASO(ht.optim.Adam(1e-2), total_epochs=4, comm=_mesh(4), nodes=2,
                         warmup_epochs=0, cooldown_epochs=0, local_skip_factor=1)
    daso.add_model(_bn_net(), 0, np.ones((4, 4, 4, 3), np.float32))
    imgs = np.random.default_rng(SEED).standard_normal((16, 4, 4, 3)).astype(np.float32)
    daso.global_skip, daso.local_skip, daso.batches_to_wait = 4, 2, 1  # solo batches, no merge
    for _ in range(3):
        daso.step(imgs, y)
    sd = daso.state_dict()
    assert sd["params"]["head.weight"].shape == (4, 3, 4)
    assert sd["state"]["stem_norm.running_var"].shape == (4, 4)
    assert sd["schedule"]["current_batch"] == 3
    twin = ht.optim.DASO(ht.optim.Adam(1e-2), total_epochs=4, comm=_mesh(4), nodes=2,
                         warmup_epochs=0, cooldown_epochs=0, local_skip_factor=1)
    twin.add_model(_bn_net(1), 0, np.ones((4, 4, 4, 3), np.float32)).load_state_dict(sd)
    assert twin.step(imgs, y) == pytest.approx(daso.step(imgs, y), rel=1e-6)
    for a, b in zip(twin.replicas, daso.replicas):
        for pa, pb in zip(a.parameters(), b.parameters()):
            assert torch.equal(pa, pb)

    merged = daso.elastic_state_dict()
    assert merged["params"]["head.weight"].shape == (3, 4)
    daso.rebind(_mesh(3))
    assert (daso.nodes, daso.ici_size, len(daso.replicas)) == (1, 3, 3)
    for replica in daso.replicas:
        torch.testing.assert_close(replica.head.weight, merged["params"]["head.weight"])
    assert np.isfinite(daso.step(imgs[:15], y[:15]))


# ---------------------------------------------------------------------------
# the rest of the surface, from test_nn_optim.py
# ---------------------------------------------------------------------------
def test_plateau_detector():
    det = ht.optim.DetectMetricPlateau(patience=2, threshold=0.1, threshold_mode="rel")
    assert not det.test_if_improving(1.0)
    assert not det.test_if_improving(0.8)
    assert not det.test_if_improving(0.6)
    assert not det.test_if_improving(0.6)
    assert not det.test_if_improving(0.6)
    assert det.test_if_improving(0.6)
    det2 = ht.optim.DetectMetricPlateau()
    det2.set_state(det.get_state())
    assert det2.best == det.best and det2.get_state() == det.get_state()
    det.reset()
    assert det.num_bad_epochs == 0
    maxi = ht.optim.DetectMetricPlateau(mode="max", patience=0, threshold=0.5, threshold_mode="abs")
    assert not maxi.test_if_improving(1.0) and maxi.test_if_improving(1.2)
    with pytest.raises(ValueError):
        ht.optim.DetectMetricPlateau(mode="sideways")
    with pytest.raises(ValueError):
        ht.optim.DetectMetricPlateau(threshold_mode="diagonal")


def test_dp_optimizer_wrapper():
    opt = ht.optim.DataParallelOptimizer(ht.optim.SGD(0.5))
    params = {"w": torch.ones(3)}
    assert isinstance(opt.init(params), torch.optim.SGD)
    new = opt.step({"w": torch.ones(3)}, params)
    np.testing.assert_allclose(new["w"].numpy(), 0.5)
    opt.zero_grad()
    assert params["w"].grad is None
    with pytest.raises(ValueError):
        opt.step({"v": torch.ones(3)}, {"v": torch.ones(3)})
    with pytest.raises(TypeError):
        ht.optim.DataParallelOptimizer(ht.optim.SGD(0.5), blocking="yes")
    with pytest.raises(RuntimeError):
        ht.optim.DataParallelOptimizer(ht.optim.SGD(0.5)).step({}, {})


def test_data_parallel_multigpu_binds_daso():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((8 * P, 6)).astype(np.float32)
    y = (x[:, 0] > 0).astype(np.int32)
    daso = ht.optim.DASO(ht.optim.SGD(0.05), total_epochs=2, warmup_epochs=1, cooldown_epochs=1)
    model = ht.nn.DataParallelMultiGPU(ht.nn.MLP(features=(8, 2), device="cpu"), optimizer=daso,
                                       sample_input=x[:P])
    assert model.daso is daso and model.comm is daso.comm
    assert np.isfinite(model.step(x[: 2 * P], y[: 2 * P]))
    assert model(x[: 2 * P]).shape == (2 * P, 2)
    model.rebind(_mesh(2))
    assert model.comm.size == 2 and len(daso.replicas) == 2
    with pytest.raises(ValueError, match="sample_input"):
        ht.nn.DataParallelMultiGPU(ht.nn.MLP(features=(8, 2), device="cpu"), optimizer=daso)


def test_data_parallel_multigpu_without_daso_steps_as_data_parallel():
    # heat_tpu's step here calls DataParallel.step, which does not exist
    # (AttributeError); the port's step is train_step (ROADMAP queue C)
    x, y = _classification(12)
    plain = ht.nn.DataParallelMultiGPU(ht.nn.MLP(features=(8, 3), device="cpu"), optimizer=ht.optim.SGD(0.05))
    assert plain.daso is None
    with pytest.raises(RuntimeError, match="init"):
        plain.step(x, y)
    plain.init(0, x[:2])
    twin = ht.nn.DataParallel(ht.nn.MLP(features=(8, 3), device="cpu"), optimizer=ht.optim.SGD(0.05))
    twin.init(0, x[:2])
    assert plain.step(x, y) == pytest.approx(twin.train_step(x, y), rel=1e-6)
    torch.testing.assert_close(plain(x), twin(x))
    theirs = ref.nn.DataParallelMultiGPU(ref.nn.MLP(features=(8, 3)), optimizer=ref.optim.SGD(0.05))
    theirs.init(0, x[:2])
    with pytest.raises(AttributeError):
        theirs.step(x, y)


def test_readme_deep_learning_snippet():
    rng = np.random.default_rng(SEED)
    X = rng.standard_normal((4 * P, 8, 8, 3)).astype(np.float32)
    y = rng.integers(0, 10, 4 * P).astype(np.int32)
    dp = ht.nn.DataParallel(ht.nn.MLP(features=(128, 10)), optimizer=ht.optim.Adam(1e-3))
    dp.init(0, X[:2])
    assert np.isfinite(dp.train_step(X, y))
    daso = ht.optim.DASO(local_optimizer=ht.optim.SGD(0.1), total_epochs=90)
    daso.add_model(ht.nn.ResNet(stage_sizes=(2, 2, 2, 2), num_classes=10, num_filters=4), 0, X[:2])
    loss = daso.step(X, y)
    daso.epoch_loss_logic(loss)
    assert np.isfinite(loss) and daso.epoch == 1
