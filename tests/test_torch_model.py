"""The port's ``TransformerLM`` against the JAX ``TransformerLM``.

One JAX param tree (``model.init`` from a seed) is bridged into the
port's ``state_dict``; the same numpy tokens then go through both. All in
f32 on the CPU: logits agree within atol/rtol 1e-4 (two frameworks' f32
matmuls over two layers), KV pools within 1e-5. The JAX side runs its
Pallas kernels under ``interpret=True``; the port's wrappers run their
plain twins on CPU tensors.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.models import transformer as jtf
from kubeflow_tpu_torch.models import transformer as ttf
from kubeflow_tpu_torch.models.bridge import (
    params_to_state_dict,
    state_dict_to_params,
)

KW = dict(vocab_size=97, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
          d_ff=128, max_seq_len=128)
TOL = dict(atol=1e-4, rtol=1e-4)


def _jax(**over):
    return _jax_cached(tuple(sorted(over.items())))


@functools.lru_cache(maxsize=None)
def _jax_cached(over):
    """(cfg, jitted apply, numpy params) for one config."""
    over = dict(over)
    cfg = jtf.TransformerConfig(
        **{**KW, **over}, dtype=jnp.float32, interpret_kernels=True
    )
    model = jtf.TransformerLM(cfg)
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    apply = jax.jit(model.apply, static_argnames=(
        "page_size", "paged_attn_impl", "kv_quant"))
    return cfg, apply, jax.tree_util.tree_map(np.asarray, params["params"])


def _port(params, **over):
    model = ttf.TransformerLM(ttf.TransformerConfig(**{**KW, **over}),
                              device="cpu")
    model.load_state_dict(params_to_state_dict(params))
    return model.eval()


def _paths(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _paths(v, prefix + (k,))
        else:
            yield prefix + (k,), v


# ------------------------------------------------------------------ bridge

@pytest.mark.parametrize("use_rope", [True, False], ids=["rope", "learned_pos"])
def test_bridge_round_trips_every_param_path(use_rope):
    _, _, params = _jax(use_rope=use_rope)
    sd = params_to_state_dict(params)
    model = ttf.TransformerLM(
        ttf.TransformerConfig(**KW, use_rope=use_rope), device="cpu"
    )
    # strict load: the bridge names exactly the port's parameters
    model.load_state_dict(sd, strict=True)
    assert set(sd) == set(model.state_dict())
    assert ("pos_embedding" in sd) == (not use_rope)
    back = state_dict_to_params(model.state_dict())
    want = dict(_paths(params))
    got = dict(_paths(back))
    assert set(got) == set(want)
    for path, arr in want.items():
        np.testing.assert_array_equal(got[path], arr, err_msg="/".join(path))
    # flax Dense kernels are (in, out); nn.Linear weights (out, in)
    q = params["layers_0"]["attn"]["q_proj"]["kernel"]
    np.testing.assert_array_equal(sd["layers.0.attn.q_proj.weight"].numpy(), q.T)


def test_bridge_rejects_experts_and_unknown_paths():
    _, _, params = _jax()
    moe = dict(params)
    moe["layers_1"] = dict(params["layers_1"], experts={
        "router_kernel": np.zeros((64, 4), np.float32)})
    with pytest.raises(NotImplementedError, match="MoE"):
        params_to_state_dict(moe)
    with pytest.raises(ValueError, match="unknown param path"):
        params_to_state_dict(dict(params, extra={"kernel": np.zeros((2, 2))}))


# ---------------------------------------------------------- no-cache forward

FORWARD_CASES = [
    ("causal_flash", dict(), False),
    ("window_flash", dict(attn_window=5), False),
    ("mha_flash", dict(n_kv_heads=None), False),
    ("segments_flash", dict(), True),
    ("causal_reference", dict(attn_impl="reference"), False),
    ("window_segments_reference", dict(attn_impl="reference", attn_window=7), True),
    ("learned_positions", dict(use_rope=False), False),
]


@pytest.mark.parametrize("name,over,seg", FORWARD_CASES,
                         ids=[c[0] for c in FORWARD_CASES])
def test_no_cache_logits_match_jax(name, over, seg):
    _, japply, params = _jax(**over)
    tmodel = _port(params, **over)
    rng = np.random.default_rng(sum(map(ord, name)))
    tokens = rng.integers(0, KW["vocab_size"], size=(2, 32)).astype(np.int32)
    ids = None
    if seg:
        ids = np.zeros((2, 32), np.int32)
        ids[0, 12:] = 1
        ids[1, 20:] = 1
    want = japply(
        {"params": params}, jnp.asarray(tokens),
        segment_ids=None if ids is None else jnp.asarray(ids),
    )
    with torch.inference_mode():
        got = tmodel(
            torch.from_numpy(tokens).long(),
            segment_ids=None if ids is None else torch.from_numpy(ids),
        )
    assert got.dtype == torch.float32 and got.shape == (2, 32, KW["vocab_size"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ------------------------------------------------------------- paged branch

PAGE, POOL = 16, 8 * 16
TABLE = np.array([[3, 1, 0, 0], [2, 5, 0, 0]], np.int32)


@pytest.mark.parametrize("impl", ["gather", "kernel"])
@pytest.mark.parametrize("quant", ["none", "int8"])
def test_paged_prefill_and_decode_match_jax(impl, quant):
    """One prefill piece (row 1 padded: its pad positions write to the
    scratch page) and one decode step through the paged branch: logits,
    the pool after each call, and for int8 the codes and scales."""
    jcfg, japply, params = _jax()
    tmodel = _port(params)
    jcache = jtf.init_paged_kv_cache(jcfg, POOL, kv_quant=quant)
    tcache = ttf.init_paged_kv_cache(tmodel.cfg, POOL, kv_quant=quant,
                                     device="cpu")
    rng = np.random.default_rng(11)
    lens = np.array([8, 5])
    prompt = rng.integers(2, KW["vocab_size"], size=(2, 8)).astype(np.int32)
    pos_p = np.broadcast_to(np.arange(8), (2, 8)).astype(np.int32)
    ok_p = np.arange(8)[None, :] < lens[:, None]
    step = rng.integers(2, KW["vocab_size"], size=(2, 1)).astype(np.int32)
    pos_d = lens[:, None].astype(np.int32)
    ok_d = np.ones((2, 1), bool)

    kw = dict(page_size=PAGE, paged_attn_impl=impl, kv_quant=quant)
    for toks, pos, ok in ((prompt, pos_p, ok_p), (step, pos_d, ok_d)):
        want, jcache = japply(
            {"params": params}, jnp.asarray(toks), cache=jcache,
            positions=jnp.asarray(pos), page_table=jnp.asarray(TABLE),
            page_write_ok=jnp.asarray(ok), **kw,
        )
        with torch.inference_mode():
            got, tcache = tmodel(
                torch.from_numpy(toks).long(), cache=tcache,
                positions=torch.from_numpy(pos).long(),
                page_table=torch.from_numpy(TABLE),
                page_write_ok=torch.from_numpy(ok), **kw,
            )
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        for layer in jcache:
            for name, arr in jcache[layer].items():
                a, b = tcache[layer][name].numpy(), np.asarray(arr)
                assert a.dtype == b.dtype, (layer, name)
                if a.dtype == np.int8:
                    # the codes of k/v computed by two frameworks' matmuls:
                    # a value within ~1e-6 of a rounding half may land one
                    # code apart, nothing more
                    diff = np.abs(a.astype(np.int32) - b.astype(np.int32))
                    assert diff.max() <= 1 and (diff > 0).mean() < 1e-3
                else:
                    np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-5,
                                               err_msg=f"{layer}/{name}")


# ------------------------------------------------------ f32 master weights

def test_param_dtype_f32_holds_master_weights_and_casts_per_call():
    """``param_dtype=torch.float32`` with bf16 compute keeps every
    parameter in f32 after ``load_state_dict`` (the flax ``Dense`` layout)
    and gives the default (bf16-stored) layout's logits: the cast to bf16
    happens per call instead of once, the same rounding either way, so
    the logits agree to bf16 tolerance (both compute in bf16)."""
    _, _, params = _jax()
    sd = params_to_state_dict(params)
    cfg = ttf.TransformerConfig(**KW, dtype=torch.bfloat16)
    master = ttf.TransformerLM(cfg, device="cpu", param_dtype=torch.float32)
    master.load_state_dict(sd)
    assert {p.dtype for p in master.parameters()} == {torch.float32}
    served = ttf.TransformerLM(cfg, device="cpu")
    served.load_state_dict(sd)
    assert served.layers[0].attn.q_proj.weight.dtype == torch.bfloat16
    assert served.ln_f.scale.dtype == torch.float32
    tokens = torch.from_numpy(
        np.random.default_rng(3).integers(0, KW["vocab_size"], (2, 16)))
    with torch.inference_mode():
        a, b = master(tokens), served(tokens)
    assert a.dtype == b.dtype == torch.float32
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-2, rtol=2e-2)
    # a weight update lands on the f32 master, below a bf16 ulp of it
    w = master.layers[0].attn.q_proj.weight
    with torch.no_grad():
        before = w.clone()
        w.add_(1e-6 * torch.sign(w))
    assert (w != before).all()


# ------------------------------------------------------ loss and gradients

LOSS_CASES = [
    ("gqa_flash", dict()),
    ("window_flash", dict(attn_window=9)),
    ("mha_flash", dict(n_kv_heads=None)),
]


@pytest.mark.parametrize("name,over", LOSS_CASES, ids=[c[0] for c in LOSS_CASES])
def test_loss_and_gradients_match_jax(name, over):
    """``make_loss_fn``'s loss and accuracy and every parameter's gradient
    (bridged back with ``state_dict_to_params``) against
    ``jax.value_and_grad`` of the JAX ``make_loss_fn`` on the same params
    and batch. Both sides run flash attention: JAX its Pallas kernels in
    interpret mode (16-wide blocks, so several tiles), the port its
    autograd function on the CPU twins. f32, atol/rtol 1e-4."""
    from kubeflow_tpu_torch.data import TokenLMDataset

    jcfg = jtf.TransformerConfig(**{**KW, **over}, dtype=jnp.float32,
                                 interpret_kernels=True, attn_block_q=16,
                                 attn_block_k=16)
    jmodel = jtf.TransformerLM(jcfg)
    _, _, params = _jax(**over)
    batch = TokenLMDataset(vocab_size=KW["vocab_size"], seq_len=48).batch(
        2, step=sum(map(ord, name)))
    jloss = jtf.make_loss_fn(jmodel)
    (want, jaux), jgrads = jax.value_and_grad(jloss, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, params),
        {k: jnp.asarray(v) for k, v in batch.items()}, None)

    model = ttf.TransformerLM(ttf.TransformerConfig(**{**KW, **over}),
                              device="cpu", param_dtype=torch.float32)
    model.load_state_dict(params_to_state_dict(params))
    loss, aux = ttf.make_loss_fn()(
        model, {k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), **TOL)
    np.testing.assert_allclose(aux["lm_loss"].item(), float(jaux["lm_loss"]), **TOL)
    assert aux["accuracy"].item() == float(jaux["accuracy"])
    grads = state_dict_to_params(
        {n: p.grad for n, p in model.named_parameters()})
    want_g = dict(_paths(jax.tree_util.tree_map(np.asarray, jgrads)))
    got_g = dict(_paths(grads))
    assert set(got_g) == set(want_g)
    for path, g in want_g.items():
        np.testing.assert_allclose(got_g[path], g, **TOL, err_msg="/".join(path))
