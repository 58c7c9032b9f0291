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

The bfloat16 models (flax's ``dtype``) are held to flax's bfloat16 models
from the same variables within 4 bfloat16 ulps of the output's largest
entry, 4·2⁻⁸·max|ref|: both round every product and activation to bfloat16,
at other points (torch adds a Dense bias inside the product, XLA after
it; torch's gelu rounds once), and each lies within ~3 ulps of the
float32 model (flax's bfloat16 TransformerLM measured at 2.1–3.2, the
port against it at 1.5–2.5 over four seeds). Their ``DataParallel`` steps
against heat_tpu's, over two steps: losses within one bfloat16 ulp,
2⁻⁸·|loss|, and every parameter and running average within one bfloat16
ulp of the model's largest weight (the gradients differ by a few bfloat16
ulps of their scale; a step moves a weight by lr times that). Since a
float32 model lies within that whole-model bound too, each Dense, Conv and
LayerNorm of a bfloat16 model is also held to flax's layer on the input it
saw, within one bfloat16 spacing of each entry, a bound that the same
layer multiplying in float32 fails.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import optax
import torch.nn.functional as F

import heat_tpu as ref
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
    assert out.shape == (2, 3) and type(mlp.layers[0]) is ht.nn._init.Dense  # a torch.nn.Linear
    assert mlp.layers[0].in_features == 10 and mlp.layers[0].generator is None
    cnn = ht.nn.SimpleCNN(num_classes=7, device="cpu")
    assert cnn(torch.ones(2, 6, 6)).shape == (2, 7) and cnn.fc1.in_features == 64 * 9


# ---------------------------------------------------------------------------
# the bfloat16 model dtype, against flax's bfloat16 models
# ---------------------------------------------------------------------------
BF16 = 2.0**-8
BF16_ULPS = 4


def _within_bf16_ulps(got: torch.Tensor, want: np.ndarray, ulps: float = BF16_ULPS):
    want = np.asarray(want, np.float32)
    bound = ulps * BF16 * np.abs(want).max()
    np.testing.assert_allclose(got.detach().float().numpy(), want, rtol=0, atol=bound)


@pytest.mark.parametrize(
    "jax_attention,port_attention", [(PALLAS_INTERPRET, KERNEL), (None, None)], ids=["kernel", "dense"]
)
@pytest.mark.parametrize("seed", [0, 1])
def test_bfloat16_transformer_lm_matches_flax(jax_attention, port_attention, seed):
    tokens = _tokens(2, 40, seed=seed)
    model = ref_nn.TransformerLM(**CONFIG, dtype=jnp.bfloat16, attention_fn=jax_attention)
    variables = model.init(jax.random.PRNGKey(seed), jnp.asarray(tokens))
    want = model.apply(variables, jnp.asarray(tokens))
    port = transformer_lm_from_flax(_numpy(variables["params"]), dtype=torch.bfloat16,
                                    attention_fn=port_attention, device="cpu")
    with torch.no_grad():
        got = port(torch.from_numpy(tokens).long())
    assert got.dtype == torch.float32 and want.dtype == jnp.float32  # the head computes in float32
    _within_bf16_ulps(got, want)


def _dtypes_of_outputs(model, x, kinds):
    """The output dtypes of the submodules of the given kinds in a forward."""
    seen = []
    hooks = [m.register_forward_hook(lambda m, i, o: seen.append(o.dtype))
             for m in model.modules() if isinstance(m, kinds)]
    with torch.no_grad():
        out = model(x)
    for h in hooks:
        h.remove()
    return seen, out


def test_bfloat16_models_keep_float32_parameters_and_heads():
    lm = ht.nn.TransformerLM(**CONFIG, dtype=torch.bfloat16, device="cpu")
    assert all(p.dtype == torch.float32 for p in lm.parameters())
    seen, logits = _dtypes_of_outputs(lm, torch.zeros(1, 8, dtype=torch.long),
                                      (ht.nn.TransformerBlock, ht.nn.MultiHeadAttention))
    assert seen and set(seen) == {torch.bfloat16} and logits.dtype == torch.float32
    resnet = ht.nn.ResNet18(num_classes=3, dtype=torch.bfloat16, device="cpu")
    assert all(t.dtype == torch.float32 for t in resnet.state_dict().values())
    seen, logits = _dtypes_of_outputs(resnet, torch.zeros(2, 8, 8, 3), ht.nn.models.BasicBlock)
    assert len(seen) == 8 and set(seen) == {torch.bfloat16} and logits.dtype == torch.float32
    for make in (ht.nn.MLP, ht.nn.SimpleCNN):  # flax's MLP and SimpleCNN return their dtype
        model = make(dtype=torch.bfloat16, device="cpu")
        assert model(torch.zeros(2, 8, 8)).dtype == torch.bfloat16
        assert all(p.dtype == torch.float32 for p in model.parameters())
    for make in (ht.nn.TransformerLM, ht.nn.MLP, ht.nn.ResNet18):
        with pytest.raises(NotImplementedError, match="float16"):
            make(dtype=torch.float16, device="cpu")


@pytest.mark.parametrize("features", [(16, 4), (32, 16, 3)])
def test_bfloat16_mlp_matches_flax(features):
    x = _images((6, 4, 5), seed=15)
    model = ref_nn.MLP(features=features, dtype=jnp.bfloat16)
    variables = model.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = model.apply(variables, jnp.asarray(x))
    port = mlp_from_flax(_numpy(variables["params"]), dtype=torch.bfloat16, device="cpu")
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    _within_bf16_ulps(got, want)


def test_bfloat16_simple_cnn_matches_flax():
    x = _images((3, 8, 8), seed=16)
    model = ref_nn.SimpleCNN(num_classes=5, dtype=jnp.bfloat16)
    variables = model.init(jax.random.PRNGKey(1), jnp.asarray(x))
    want = model.apply(variables, jnp.asarray(x))
    port = simple_cnn_from_flax(_numpy(variables["params"]), dtype=torch.bfloat16, device="cpu")
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert got.dtype == torch.bfloat16
    _within_bf16_ulps(got, want)


def test_bfloat16_resnet18_matches_flax_in_eval_and_train_mode():
    # ResNet-18's stages (2, 2, 2, 2) of BasicBlocks at 8 filters
    x = _images((5, 8, 8, 3), seed=17)
    model = ref_nn.ResNet(stage_sizes=(2, 2, 2, 2), block=ref_nn.models.BasicBlock, num_classes=4,
                          num_filters=8, dtype=jnp.bfloat16)
    variables = _perturbed(jax.jit(model.init)(jax.random.PRNGKey(3), jnp.asarray(x)), seed=18)
    port = resnet_from_flax(variables, dtype=torch.bfloat16, device="cpu")
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    # eager, as the port runs: under jit XLA keeps fused bfloat16 chains in
    # float32 and lands ~9 ulps away from the op-by-op rounding
    _within_bf16_ulps(got, model.apply(variables, jnp.asarray(x)))
    want, updated = model.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    with torch.no_grad():
        got = port(torch.from_numpy(x), train=True)
    _within_bf16_ulps(got, want)
    expected = _state_of({"params": variables["params"], "batch_stats": _numpy(updated["batch_stats"])})
    state = {k: v.numpy() for k, v in port.state_dict().items()}
    assert all(v.dtype == np.float32 for v in state.values())  # float32 running averages
    for key in state:
        if "running" in key:
            _within_bf16_ulps(torch.from_numpy(state[key]), expected[key])


def _jnp(t: torch.Tensor):
    return jnp.asarray(t.detach().float().numpy(), jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32)


def _flax_layer(module, x: torch.Tensor, dtype) -> np.ndarray:
    """flax's Dense, Conv or LayerNorm with ``module``'s parameters,
    computing in ``dtype``, applied to ``x`` (NCHW for a Conv, as the port's)."""
    import flax.linen as fnn

    params = {name: p.detach().numpy() for name, p in module.named_parameters()}
    if isinstance(module, torch.nn.Linear):
        params["kernel"] = params.pop("weight").T
        layer = fnn.Dense(module.out_features, use_bias=module.bias is not None, dtype=dtype)
        return np.asarray(layer.apply({"params": params}, _jnp(x)), np.float32)
    if isinstance(module, torch.nn.Conv2d):
        params["kernel"] = params.pop("weight").transpose(2, 3, 1, 0)
        layer = fnn.Conv(module.out_channels, module.kernel_size, module.stride,
                         padding=[(q, q) for q in module.padding], use_bias=module.bias is not None, dtype=dtype)
        return np.asarray(layer.apply({"params": params}, _jnp(x.permute(0, 2, 3, 1))), np.float32).transpose(0, 3, 1, 2)
    params["scale"] = params.pop("weight")
    return np.asarray(fnn.LayerNorm(epsilon=module.eps, dtype=dtype).apply({"params": params}, _jnp(x)), np.float32)


def _float32_then_cast(module, x: torch.Tensor) -> np.ndarray:
    """The control: the layer's product in float32, cast to bfloat16 after."""
    x = x.detach().float()
    if isinstance(module, torch.nn.Linear):
        y = F.linear(x, module.weight, module.bias)
    else:
        y = F.conv2d(x, module.weight, module.bias, module.stride, module.padding)
    return y.bfloat16().float().detach().numpy()


def _bf16_ulps(got: np.ndarray, want: np.ndarray) -> float:
    """The largest |got - want| in bfloat16 spacings of each entry of
    ``want`` (entries below 2^-10 of the largest count at that size)."""
    size = np.maximum(np.abs(want), 2.0**-10 * np.abs(want).max()).astype(np.float32)
    return float((np.abs(got - want) / (np.spacing(size) * 2.0**16)).max())


BF16_MODELS = {
    "TransformerLM": (lambda g: ht.nn.TransformerLM(**CONFIG, dtype=torch.bfloat16, device="cpu", generator=g),
                      lambda: torch.from_numpy(_tokens(2, 40, seed=19)).long(), {"head"}),
    "MLP": (lambda g: ht.nn.MLP((32, 16, 3), dtype=torch.bfloat16, device="cpu", generator=g),
            lambda: torch.from_numpy(_images((6, 4, 5), seed=20)), set()),
    "SimpleCNN": (lambda g: ht.nn.SimpleCNN(num_classes=5, dtype=torch.bfloat16, device="cpu", generator=g),
                  lambda: torch.from_numpy(_images((3, 8, 8), seed=21)), set()),
    "ResNet18": (lambda g: ht.nn.ResNet18(num_classes=4, num_filters=8, dtype=torch.bfloat16, device="cpu",
                                          generator=g),
                 lambda: torch.from_numpy(_images((2, 8, 8, 3), seed=22)), {"head"}),
}


@pytest.mark.parametrize("name", list(BF16_MODELS))
def test_bfloat16_layers_follow_flax_cast_rules(name):
    """Each Dense, Conv and LayerNorm of a bfloat16 model, on the input it
    saw in the model's forward, against flax's layer of the same kind and
    parameters: the output's dtype flax's (float32 in the heads), and within
    one bfloat16 spacing of each entry (the port's layers match flax's bit
    for bit here). A model that multiplied in float32 and cast its outputs
    to bfloat16 (the control) misses that bound in every bfloat16 layer, by
    3 to 78 spacings where the product cancels; the whole-model bound
    above cannot tell the two apart."""
    make, data, heads = BF16_MODELS[name]
    model = make(torch.Generator().manual_seed(7))
    kinds = (torch.nn.Linear, torch.nn.Conv2d, torch.nn.LayerNorm)
    seen = []
    hooks = [m.register_forward_hook(lambda m, args, out, n=n: seen.append((n, m, args[0], out)))
             for n, m in model.named_modules() if isinstance(m, kinds)]
    with torch.no_grad():
        model(data())
    for h in hooks:
        h.remove()
    assert len(seen) == sum(isinstance(m, kinds) for m in model.modules())
    for layer, module, x, out in seen:
        head = layer in heads
        assert out.dtype == (torch.float32 if head else torch.bfloat16), layer
        want = _flax_layer(module, x, jnp.float32 if head else jnp.bfloat16)
        got = out.float().numpy()
        if head:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * np.abs(want).max())
            continue
        assert _bf16_ulps(got, want) <= 1, layer
        if not isinstance(module, torch.nn.LayerNorm):
            assert _bf16_ulps(_float32_then_cast(module, x), want) > 1, layer


# ---------------------------------------------------------------------------
# DataParallel steps of bfloat16 models against heat_tpu's
# ---------------------------------------------------------------------------
def _shift_loss_flax(logits, labels):
    return optax.softmax_cross_entropy_with_integer_labels(logits[:, :-1], labels[:, 1:]).mean()


def _shift_loss(logits, labels):
    return F.cross_entropy(logits[:, :-1].reshape(-1, logits.shape[-1]), labels[:, 1:].reshape(-1).long())


def _check_bf16_step(mine, theirs, x, y, expected):
    for step in range(2):
        got, want = mine.train_step(x, y), theirs.train_step(x, y)
        assert abs(got - want) <= BF16 * abs(want), f"loss of step {step}: {got} vs {want}"
    want = expected().state_dict()
    state = mine.module.state_dict()
    bound = BF16 * max(t.abs().max().item() for t in want.values())
    for key in want:
        np.testing.assert_allclose(state[key].numpy(), want[key].numpy(), rtol=0, atol=bound, err_msg=key)


def test_data_parallel_bfloat16_transformer_step_matches_heat_tpu():
    toks = np.random.default_rng(20261017).integers(0, 17, (10, 12)).astype(np.int32)
    config = dict(vocab=17, dim=16, depth=1, heads=2, max_len=32)
    theirs = ref.nn.DataParallel(ref_nn.TransformerLM(**config, dtype=jnp.bfloat16), optimizer=optax.sgd(0.5),
                                 loss_fn=_shift_loss_flax)
    theirs.init(0, toks[:2])
    port = transformer_lm_from_flax(_numpy(theirs.params["params"]), dtype=torch.bfloat16, device="cpu")
    mine = ht.nn.DataParallel(port, optimizer=ht.optim.SGD(0.5), loss_fn=_shift_loss).init(0, toks[:2])
    _check_bf16_step(mine, theirs, toks, toks,
                     lambda: transformer_lm_from_flax(_numpy(theirs.params["params"]), device="cpu"))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_data_parallel_kernel_transformer_step_matches_heat_tpu(dtype):
    # the port's blocks through the kernel's autograd function (its plain
    # version on the CPU; the scan path in the backward) on the tests' mesh,
    # heat_tpu's through dense attention: the same math
    toks = np.random.default_rng(20261018).integers(0, 17, (8, 12)).astype(np.int32)
    config = dict(vocab=17, dim=16, depth=1, heads=2, max_len=32)
    theirs = ref.nn.DataParallel(ref_nn.TransformerLM(**config, dtype=getattr(jnp, dtype)),
                                 optimizer=optax.sgd(0.5), loss_fn=_shift_loss_flax)
    theirs.init(0, toks[:2])
    port = transformer_lm_from_flax(_numpy(theirs.params["params"]), dtype=getattr(torch, dtype),
                                    attention_fn=KERNEL, device="cpu")
    mine = ht.nn.DataParallel(port, optimizer=ht.optim.SGD(0.5), loss_fn=_shift_loss).init(0, toks[:2])
    expected = lambda: transformer_lm_from_flax(_numpy(theirs.params["params"]), device="cpu")
    if dtype == "bfloat16":
        _check_bf16_step(mine, theirs, toks, toks, expected)
        return
    for step in range(2):
        np.testing.assert_allclose(mine.train_step(toks, toks), theirs.train_step(toks, toks), rtol=TOL, atol=TOL)
    want, state = expected().state_dict(), mine.module.state_dict()
    for key in want:
        np.testing.assert_allclose(state[key].numpy(), want[key].numpy(), rtol=TOL, atol=TOL, err_msg=key)


def test_data_parallel_bfloat16_resnet18_step_matches_heat_tpu():
    # the whole batch's BatchNorm statistics in float32 over the mesh
    rng = np.random.default_rng(20261017)
    x = rng.standard_normal((10, 8, 8, 3)).astype(np.float32)
    y = rng.integers(0, 4, 10).astype(np.int32)
    model = ref_nn.ResNet(stage_sizes=(2, 2, 2, 2), block=ref_nn.models.BasicBlock, num_classes=4,
                          num_filters=8, dtype=jnp.bfloat16)
    theirs = ref.nn.DataParallel(model, optimizer=ref.optim.SGD(0.05))
    theirs.init(0, x[:2])

    def variables():
        return {"params": _numpy(theirs.params), "batch_stats": _numpy(theirs.state["batch_stats"])}

    port = resnet_from_flax(variables(), dtype=torch.bfloat16, device="cpu")
    mine = ht.nn.DataParallel(port, optimizer=ht.optim.SGD(0.05)).init(0, x[:2])
    _check_bf16_step(mine, theirs, x, y, lambda: resnet_from_flax(variables(), device="cpu"))
