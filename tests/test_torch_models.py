"""heat_tpu_torch.nn.TransformerLM against heat_tpu.nn.TransformerLM from the
same flax parameters, on the CPU, and the port's model surface.

The JAX side runs the Pallas kernel in interpret mode or the dense
default; the port runs ``flash_attention(impl="pallas")``, which on the CPU
is the kernel's plain version, or its own dense default. Logits agree
within 1e-4: the same float32 math, summed in another order. Tokens are
made with numpy from a seed.
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
from heat_tpu_torch.utils.interop import transformer_lm_from_flax

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
