"""heat_tpu_torch.nn's models against heat_tpu.nn's from the same flax
variables, on the CPU, and the port's model surface: TransformerLM, MLP,
SimpleCNN and the ResNets (both block kinds).

The JAX side runs the Pallas kernel in interpret mode or the dense
default; the port runs ``flash_attention(impl="pallas")``, which on the CPU
is the kernel's plain version, or its own dense default. Logits agree
within 1e-4: the same float32 math, summed in another order. The CNNs' logits, in eval
mode and in train mode, and the BatchNorm running averages a train-mode
pass leaves behind agree within 1e-4 too. Tokens and images are made with
numpy from a seed.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import heat_tpu.nn as ref_nn
import heat_tpu_torch as ht
from heat_tpu.ops.flash import flash_attention_tpu
from heat_tpu_torch.nn import attention
from heat_tpu_torch.ops import flash
from heat_tpu_torch.utils.interop import (
    mlp_from_flax,
    resnet_from_flax,
    simple_cnn_from_flax,
    transformer_lm_from_flax,
)

CONFIG = dict(vocab=31, dim=32, depth=2, heads=4, max_len=64)
TOL = 1e-4


@pytest.fixture(autouse=True)
def _on_cpu():
    ht.use_device("cpu")
    yield
    ht.use_device(None)


def _tokens(batch, seq, seed):
    return np.random.default_rng(seed).integers(0, CONFIG["vocab"], (batch, seq)).astype(np.int32)


def _flax_lm(tokens, attention_fn=None, causal=True, seed=0):
    model = ref_nn.TransformerLM(**CONFIG, causal=causal, attention_fn=attention_fn)
    variables = model.init(jax.random.PRNGKey(seed), jnp.asarray(tokens))
    logits = np.asarray(model.apply(variables, jnp.asarray(tokens)))
    return jax.tree_util.tree_map(np.asarray, variables["params"]), logits


PALLAS_INTERPRET = partial(flash_attention_tpu, interpret=True)
KERNEL = partial(attention.flash_attention, impl="pallas")


@pytest.mark.parametrize(
    "jax_attention,port_attention",
    [(PALLAS_INTERPRET, KERNEL), (None, KERNEL), (None, None)],
    ids=["pallas-kernel", "dense-kernel", "dense-dense"],
)
@pytest.mark.parametrize("seq", [40, 64])
def test_logits_match_heat_tpu(jax_attention, port_attention, seq):
    tokens = _tokens(2, seq, seed=seq)
    params, want = _flax_lm(tokens, jax_attention)
    model = transformer_lm_from_flax(params, attention_fn=port_attention, device="cpu")
    before = flash.LAUNCHES
    with torch.no_grad():
        got = model(torch.from_numpy(tokens).long())
    assert flash.LAUNCHES == before  # CPU tensors never launch the kernel
    assert got.shape == (2, seq, CONFIG["vocab"]) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_non_causal_logits_match_heat_tpu():
    tokens = _tokens(1, 24, seed=1)
    params, want = _flax_lm(tokens, PALLAS_INTERPRET, causal=False, seed=1)
    model = transformer_lm_from_flax(params, causal=False, attention_fn=KERNEL, device="cpu")
    with torch.no_grad():
        got = model(torch.from_numpy(tokens).long())
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_kernel_path_gradients_match_dense_path():
    tokens = torch.from_numpy(_tokens(1, 16, seed=2)).long()
    grads = []
    for fn in (KERNEL, None):
        model = ht.nn.TransformerLM(**CONFIG, attention_fn=fn, device="cpu",
                                    generator=torch.Generator().manual_seed(3))
        model(tokens).square().mean().backward()
        grads.append([p.grad for p in model.parameters()])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=TOL, atol=TOL)


def test_initializers_follow_flax():
    dim = 256
    model = ht.nn.TransformerLM(vocab=512, dim=dim, depth=1, heads=4, max_len=128, device="cpu")
    block = model.blocks[0]
    # Embed: normal, variance 1/dim
    assert abs(model.embed.weight.std().item() * dim**0.5 - 1) < 0.02
    # Dense kernels: lecun normal, truncated at two standard deviations
    for layer, fan_in in [(block.attn.query, dim), (block.attn.out, dim), (block.fc2, 4 * dim)]:
        w = layer.weight
        assert abs(w.std().item() * fan_in**0.5 - 1) < 0.03
        assert w.abs().max().item() <= 2 / fan_in**0.5 / 0.87962566103423978 + 1e-6
        assert (layer.bias == 0).all()
    assert (block.norm1.weight == 1).all() and (block.norm1.bias == 0).all()
    assert block.norm1.eps == 1e-6
    # the same generator seed gives the same model
    a = ht.nn.TransformerLM(**CONFIG, device="cpu", generator=torch.Generator().manual_seed(5))
    b = ht.nn.TransformerLM(**CONFIG, device="cpu", generator=torch.Generator().manual_seed(5))
    for pa, pb in zip(a.parameters(), b.parameters()):
        assert torch.equal(pa, pb)


def test_over_length_sequence_raises():
    model = ht.nn.TransformerLM(**CONFIG, device="cpu")
    with pytest.raises(ValueError, match="exceeds max_len"):
        model(torch.zeros(1, CONFIG["max_len"] + 1, dtype=torch.long))


def test_bfloat16_model_is_not_ported():
    with pytest.raises(NotImplementedError, match="bfloat16"):
        ht.nn.TransformerLM(**CONFIG, dtype=torch.bfloat16, device="cpu")
    with pytest.raises(NotImplementedError, match="bfloat16"):
        ht.nn.TransformerBlock(32, dtype=torch.bfloat16, device="cpu")


def test_no_device_means_the_gpu_and_raises_without_cuda():
    ht.use_device(None)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ht.nn.TransformerLM(**CONFIG)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ht.nn.MultiHeadAttention(4, 32)
    model = ht.nn.TransformerLM(**CONFIG, device="cpu")
    assert all(p.device.type == "cpu" for p in model.parameters())


def test_nn_namespace():
    assert ht.nn.TransformerLM is ht.nn.models.TransformerLM
    assert ht.nn.flash_attention is attention.flash_attention
    assert ht.nn.Linear is torch.nn.Linear  # falls back to torch.nn
    with pytest.raises(AttributeError, match="heat_tpu_torch.nn"):
        ht.nn.NoSuchLayer
    assert ht.ops.flash_attention_kernel is flash.flash_attention_kernel


# ---------------------------------------------------------------------------
# MLP, SimpleCNN and the ResNets against flax from the same variables
# ---------------------------------------------------------------------------
def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _images(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _perturbed(variables, seed):
    """The variables with every BatchNorm scale, bias and running average
    drawn at random, so that the eval pass and the zero-scale norms are
    tested too."""
    rng = np.random.default_rng(seed)

    def draw(path, value):
        value = np.asarray(value)
        name = jax.tree_util.keystr(path)
        if "BatchNorm" not in name:
            return value
        if name.endswith("['var']"):
            return rng.uniform(0.5, 2.0, value.shape).astype(np.float32)
        return rng.normal(0.0, 0.5, value.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, variables)


@pytest.mark.parametrize("features", [(16, 4), (32, 16, 3)])
def test_mlp_logits_match_flax(features):
    x = _images((6, 4, 5), seed=11)
    model = ref_nn.MLP(features=features)
    variables = model.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = np.asarray(model.apply(variables, jnp.asarray(x)))
    port = mlp_from_flax(_numpy(variables["params"]), device="cpu")
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("shape", [(3, 8, 8), (3, 6, 10, 2)], ids=["gray", "two-channel"])
def test_simple_cnn_logits_match_flax(shape):
    x = _images(shape, seed=12)
    model = ref_nn.SimpleCNN(num_classes=5)
    variables = model.init(jax.random.PRNGKey(1), jnp.asarray(x))
    want = np.asarray(model.apply(variables, jnp.asarray(x)))
    port = simple_cnn_from_flax(_numpy(variables["params"]), device="cpu")
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def _state_of(variables):
    """The port model's state dict, built from flax variables."""
    return {k: v.numpy() for k, v in resnet_from_flax(variables, device="cpu").state_dict().items()}


@pytest.mark.parametrize("block", ["BasicBlock", "Bottleneck"])
def test_resnet_matches_flax_in_eval_and_train_mode(block):
    x = _images((5, 8, 8, 3), seed=13)
    model = ref_nn.ResNet(stage_sizes=(1, 1), block=getattr(ref_nn.models, block), num_classes=4, num_filters=8)
    variables = _perturbed(model.init(jax.random.PRNGKey(2), jnp.asarray(x)), seed=14)
    port = resnet_from_flax(variables, device="cpu")
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(model.apply(variables, jnp.asarray(x))), rtol=TOL, atol=TOL)

    want, updated = model.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    with torch.no_grad():
        got = port(torch.from_numpy(x), train=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    expected = _state_of({"params": variables["params"], "batch_stats": _numpy(updated["batch_stats"])})
    state = {k: v.numpy() for k, v in port.state_dict().items()}
    assert state.keys() == expected.keys()
    for key in state:
        np.testing.assert_allclose(state[key], expected[key], rtol=TOL, atol=TOL, err_msg=key)


def test_resnet_layout_follows_the_flax_tree():
    model = ht.nn.ResNet50(num_classes=10, device="cpu")
    assert [len(s) for s in (model.blocks,)] == [16]
    assert sum(p.numel() for p in model.parameters()) == 23_520_842
    first = model.blocks[0]
    assert first.proj is not None and first.convs[2].out_channels == 256
    assert (first.norms[2].weight == 0).all() and (first.norms[0].weight == 1).all()
    assert first.norms[0].momentum == 0.99 and first.norms[0].eps == 1e-5
    # the stride sits on the 3x3 convolution and the projection
    assert model.blocks[3].convs[1].stride == (2, 2) and model.blocks[3].proj.stride == (2, 2)
    r18 = ht.nn.ResNet18(device="cpu")
    assert [b.proj is not None for b in r18.blocks] == [False, False, True, False, True, False, True, False]


def test_cnn_initializers_follow_flax():
    model = ht.nn.ResNet((1,), num_filters=64, device="cpu", generator=torch.Generator().manual_seed(4))
    w = model.blocks[0].convs[0].weight  # 3x3, 64 -> 64: fan_in 576
    assert abs(w.std().item() * 576**0.5 - 1) < 0.03
    assert w.abs().max().item() <= 2 / 576**0.5 / 0.87962566103423978 + 1e-6
    assert model.blocks[0].convs[0].bias is None
    cnn = ht.nn.SimpleCNN(device="cpu")
    assert (cnn.conv1.bias == 0).all() and cnn.conv1.padding == (1, 1)


def test_lazy_layers_draw_at_the_first_input():
    mlp = ht.nn.MLP((8, 3), device="cpu", generator=torch.Generator().manual_seed(0))
    assert isinstance(mlp.layers[0], torch.nn.LazyLinear)
    out = mlp(torch.ones(2, 5, 2))
    assert out.shape == (2, 3) and type(mlp.layers[0]) is torch.nn.Linear
    assert mlp.layers[0].in_features == 10 and mlp.layers[0].generator is None
    cnn = ht.nn.SimpleCNN(num_classes=7, device="cpu")
    assert cnn(torch.ones(2, 6, 6)).shape == (2, 7) and cnn.fc1.in_features == 64 * 9


def test_cnns_raise_on_bfloat16():
    for make in (ht.nn.MLP, ht.nn.SimpleCNN, ht.nn.ResNet18, ht.nn.ResNet50):
        with pytest.raises(NotImplementedError, match="bfloat16"):
            make(dtype=torch.bfloat16, device="cpu")
