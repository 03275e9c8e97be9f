"""The port's BERT (``kubeflow_tpu_torch/models/bert.py``, its bridge,
HF conversion and WordPiece tokenizer) against the JAX package's.

The same numpy inputs and bridged weights go through the JAX
``BertForMaskedLM`` / ``BertForSequenceClassification`` and the port's,
at ``bert_tiny`` width (4 layers, 8 heads of 16). Tolerances:

- f32: ``F32_ATOL`` = 2e-5 absolute on logits and hidden states of
  magnitude up to about 5: the two frameworks sum in other orders, and
  nothing else differs;
- bf16 hidden states: ``BF16_ATOL`` = 0.08 absolute on LayerNorm outputs
  of magnitude up to about 5 (a bf16 ulp there is 2**-6 = 0.016): each
  projection rounds its product to bf16 at other places in the two
  frameworks; the JAX bf16 model itself sits about 0.02 from its f32 run.

The flash path runs the JAX Pallas kernel in interpret mode and the
port's flash wrapper, which on a CPU tensor runs the kernel's plain twin.
"""

from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.models import convert as jconvert
from kubeflow_tpu.models.bert import BertEncoder as JaxEncoder
from kubeflow_tpu.models.bert import BertForMaskedLM as JaxMLM
from kubeflow_tpu.models.bert import BertForSequenceClassification as JaxCls
from kubeflow_tpu.models.bert import bert_tiny as jax_bert_tiny
from kubeflow_tpu.serve.model import BucketSpec as JaxBuckets
from kubeflow_tpu.serve.runtimes import BertRuntimeModel as JaxBertRuntime
from kubeflow_tpu.serve.tokenizer import WordPieceTokenizer as JaxWordPiece
from kubeflow_tpu_torch.models import convert
from kubeflow_tpu_torch.models.bert import (
    BertConfig,
    BertForMaskedLM,
    BertForSequenceClassification,
    bert_tiny,
    init_bert_weights,
)
from kubeflow_tpu_torch.models.bridge import (
    bert_params_to_state_dict,
    bert_state_dict_to_params,
)
from kubeflow_tpu_torch.serve.model import BucketSpec
from kubeflow_tpu_torch.serve.runtimes import BertRuntimeModel, SimpleTokenizer
from kubeflow_tpu_torch.serve.tokenizer import WordPieceTokenizer

F32_ATOL = 2e-5
BF16_ATOL = 0.08
V = 1024  # bert_tiny's vocab


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread: the module shares the CPU with concurrent
    test processes, some of them timing-bound."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _inputs(B, S, seed=0, masked=True, types=True):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, V, (B, S)).astype(np.int32)
    mask = np.ones((B, S), np.int32)
    if masked:  # ragged valid lengths, one row a single token
        for b in range(1, B):
            mask[b, max(1, S - 5 * b):] = 0
    tt = np.zeros((B, S), np.int32)
    if types:
        tt[:, S // 2:] = 1
    return ids, mask, tt


def _perturbed_params(module, ids, seed=1):
    """JAX init, then every leaf moved by N(0, 0.05): biases, norm
    offsets and scales all differ from their init and must carry."""
    params = module.init(jax.random.PRNGKey(0), ids)["params"]
    leaves, tree = jax.tree_util.tree_flatten(params)
    rng = np.random.default_rng(seed)
    leaves = [np.asarray(a) + 0.05 * rng.standard_normal(a.shape).astype(np.float32)
              for a in leaves]
    return jax.tree_util.tree_unflatten(tree, leaves)


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _port(cls, cfg, params, **kw):
    m = cls(cfg, device="cpu", **kw)
    m.load_state_dict(bert_params_to_state_dict(params))
    return m.eval()


MLM_CASES = [
    ("full", dict(B=2, S=16, masked=False, types=False)),
    ("padded", dict(B=3, S=16)),
    ("padded_s32", dict(B=4, S=32)),
]


@pytest.mark.parametrize("name,kw", MLM_CASES, ids=[c[0] for c in MLM_CASES])
def test_mlm_and_encoder_match_jax_reference_f32(name, kw):
    ids, mask, tt = _inputs(**kw)
    jm = JaxMLM(jax_bert_tiny(attn_impl="reference"))
    params = _perturbed_params(jm, ids)
    want = np.asarray(jm.apply({"params": params}, ids, mask, tt))
    tm = _port(BertForMaskedLM, bert_tiny(attn_impl="reference"), params)
    with torch.no_grad():
        got = tm(*_t(ids, mask, tt)).numpy()
        seq, pooled = tm.encoder(*_t(ids, mask, tt))
    np.testing.assert_allclose(got, want, rtol=0, atol=F32_ATOL)
    jseq, jpooled = JaxEncoder(jax_bert_tiny(attn_impl="reference")).apply(
        {"params": params["encoder"]}, ids, mask, tt)
    np.testing.assert_allclose(seq.numpy(), np.asarray(jseq), rtol=0, atol=F32_ATOL)
    np.testing.assert_allclose(pooled.numpy(), np.asarray(jpooled), rtol=0,
                               atol=F32_ATOL)


def test_classifier_matches_jax_reference_f32():
    ids, mask, tt = _inputs(3, 16)
    jm = JaxCls(jax_bert_tiny(attn_impl="reference"), num_classes=3)
    params = _perturbed_params(jm, ids)
    want = np.asarray(jm.apply({"params": params}, ids, mask, tt))
    tm = _port(BertForSequenceClassification, bert_tiny(attn_impl="reference"),
               params, num_classes=3)
    with torch.no_grad():
        got = tm(*_t(ids, mask, tt)).numpy()
    assert got.dtype == np.float32 and got.shape == (3, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=F32_ATOL)


FLASH_CASES = [("s32", 32), ("ragged_s48", 48)]


@pytest.mark.parametrize("name,S", FLASH_CASES, ids=[c[0] for c in FLASH_CASES])
def test_flash_path_matches_jax_pallas_interpret(name, S):
    """``attn_impl="flash"`` on both sides: the JAX Pallas forward in
    interpret mode against the port's flash wrapper (its twin on the
    CPU), non-causal with the padding mask as segment ids."""
    ids, mask, tt = _inputs(3, S, seed=2)
    jm = JaxMLM(jax_bert_tiny(attn_impl="flash", interpret_kernels=True))
    params = _perturbed_params(jm, ids)
    want = np.asarray(jm.apply({"params": params}, ids, mask, tt))
    tm = _port(BertForMaskedLM, bert_tiny(attn_impl="flash"), params)
    with torch.no_grad():
        got = tm(*_t(ids, mask, tt)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=F32_ATOL)


@pytest.mark.parametrize("impl", ["reference", "flash"])
def test_bf16_hidden_states_match_jax(impl):
    """bf16: the residual stream after each LayerNorm is f32 on both
    sides (flax LayerNorm promotes), the projections round to bf16."""
    ids, mask, tt = _inputs(2, 16, seed=3)
    jcfg = jax_bert_tiny(attn_impl="reference", dtype=jnp.bfloat16)
    params = _perturbed_params(JaxEncoder(jcfg), ids)
    jseq, jpooled = JaxEncoder(jcfg).apply({"params": params}, ids, mask, tt)
    tm = _port(BertForMaskedLM, bert_tiny(attn_impl=impl, dtype=torch.bfloat16),
               {"encoder": params, **_head_params()})
    with torch.no_grad():
        seq, pooled = tm.encoder(*_t(ids, mask, tt))
    assert seq.dtype == torch.float32 and jseq.dtype == jnp.float32
    assert pooled.dtype == torch.bfloat16 and jpooled.dtype == jnp.bfloat16
    np.testing.assert_allclose(seq.numpy(), np.asarray(jseq), rtol=0, atol=BF16_ATOL)
    np.testing.assert_allclose(pooled.float().numpy(),
                               np.asarray(jpooled.astype(jnp.float32)),
                               rtol=0, atol=BF16_ATOL)


def _head_params(H=128):
    """An MLM head of zeros and ones, for tests that read the encoder."""
    return {"mlm_transform": {"kernel": np.zeros((H, H), np.float32),
                              "bias": np.zeros(H, np.float32)},
            "mlm_ln": {"scale": np.ones(H, np.float32),
                       "bias": np.zeros(H, np.float32)},
            "unembed": {"kernel": np.zeros((H, V), np.float32),
                        "bias": np.zeros(V, np.float32)}}


def test_mask_and_token_types_change_the_answer_as_in_jax():
    """The JAX ``tests/test_serve.py`` check: a half mask and token types
    each change the logits, on both sides alike."""
    ids = np.array([[101, 7, 8, 9, 10, 11, 12, 102]], np.int32)
    full = np.ones((1, 8), np.int32)
    half = np.array([[1, 1, 1, 1, 0, 0, 0, 0]], np.int32)
    types = np.array([[0, 0, 0, 0, 1, 1, 1, 1]], np.int32)
    zeros = np.zeros_like(ids)
    jm = JaxMLM(jax_bert_tiny(attn_impl="reference"))
    params = _perturbed_params(jm, ids)
    tm = _port(BertForMaskedLM, bert_tiny(), params)
    outs = {}
    for name, (m, t) in {"full": (full, zeros), "half": (half, zeros),
                         "types": (full, types)}.items():
        want = np.asarray(jm.apply({"params": params}, ids, m, t))
        with torch.no_grad():
            got = tm(*_t(ids, m, t)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=F32_ATOL)
        outs[name] = got
    assert np.abs(outs["full"] - outs["half"]).max() > 1e-2
    assert np.abs(outs["full"] - outs["types"]).max() > 1e-2
    # the valid positions of a half-masked row see only themselves
    with torch.no_grad():
        alone = tm(*_t(ids[:, :4], full[:, :4], zeros[:, :4])).numpy()
    np.testing.assert_allclose(outs["half"][:, :4], alone, rtol=0, atol=F32_ATOL)


@pytest.mark.parametrize("kind", ["mlm", "classifier", "encoder"])
def test_bridge_round_trip(kind):
    ids = np.zeros((1, 8), np.int32)
    jcfg = jax_bert_tiny(attn_impl="reference")
    module = {"mlm": JaxMLM(jcfg), "classifier": JaxCls(jcfg, num_classes=3),
              "encoder": JaxEncoder(jcfg)}[kind]
    params = jax.tree_util.tree_map(
        np.asarray, module.init(jax.random.PRNGKey(0), ids)["params"])
    sd = bert_params_to_state_dict(params)
    port = {"mlm": BertForMaskedLM(bert_tiny(), device="cpu"),
            "classifier": BertForSequenceClassification(bert_tiny(), 3, device="cpu"),
            "encoder": BertForMaskedLM(bert_tiny(), device="cpu").encoder}[kind]
    assert set(sd) == set(port.state_dict())  # key for key, nothing left over
    port.load_state_dict(sd)
    back = bert_state_dict_to_params(port.state_dict())
    flat = jax.tree_util.tree_leaves_with_path(params)
    assert len(flat) == len(jax.tree_util.tree_leaves(back))
    for path, leaf in flat:
        node = back
        for k in path:
            node = node[k.key]
        np.testing.assert_array_equal(node, leaf)


def test_bridge_rejects_unknown_paths():
    with pytest.raises(ValueError, match="unknown param path"):
        bert_params_to_state_dict({"encoder": {"mystery": {"kernel": np.zeros((2, 2))}}})
    with pytest.raises(ValueError, match="unknown param path"):
        bert_params_to_state_dict({"encoder": {"layers_0": {"mlp": {
            "up_proj": {"kernel": np.zeros((2, 2))}}}}})
    with pytest.raises(ValueError, match="unknown state_dict key"):
        bert_state_dict_to_params({"encoder.ln_f.scale": torch.ones(2)})


# ------------------------------------------------------------- HF checkpoints

HF_CONFIG = {"vocab_size": V, "hidden_size": 128, "num_hidden_layers": 4,
             "num_attention_heads": 8, "intermediate_size": 256,
             "max_position_embeddings": 512, "type_vocab_size": 2,
             "layer_norm_eps": 1e-12}


def _hf_state(seed=0, *, pooler=True, head=True, decoder_bias=False):
    """A ``BertForMaskedLM``-style HF state dict of seeded random arrays
    (``bert.``-prefixed, with the ``position_ids`` buffer HF saves)."""
    rng = np.random.default_rng(seed)
    H, I, P = 128, 256, 512
    shapes = {
        "embeddings.word_embeddings.weight": (V, H),
        "embeddings.position_embeddings.weight": (P, H),
        "embeddings.token_type_embeddings.weight": (2, H),
        "embeddings.LayerNorm.weight": (H,), "embeddings.LayerNorm.bias": (H,),
    }
    for i in range(4):
        p = f"encoder.layer.{i}"
        for n in ("attention.self.query", "attention.self.key",
                  "attention.self.value", "attention.output.dense"):
            shapes[f"{p}.{n}.weight"], shapes[f"{p}.{n}.bias"] = (H, H), (H,)
        for n in ("attention.output.LayerNorm", "output.LayerNorm"):
            shapes[f"{p}.{n}.weight"], shapes[f"{p}.{n}.bias"] = (H,), (H,)
        shapes[f"{p}.intermediate.dense.weight"] = (I, H)
        shapes[f"{p}.intermediate.dense.bias"] = (I,)
        shapes[f"{p}.output.dense.weight"] = (H, I)
        shapes[f"{p}.output.dense.bias"] = (H,)
    if pooler:
        shapes["pooler.dense.weight"], shapes["pooler.dense.bias"] = (H, H), (H,)
    state = {f"bert.{k}": torch.from_numpy(
        (0.05 * rng.standard_normal(s) + (1.0 if k.endswith("LayerNorm.weight") else 0.0)
         ).astype(np.float32)) for k, s in shapes.items()}
    state["bert.embeddings.position_ids"] = torch.arange(P)[None]
    if head:
        for k, s in {"cls.predictions.transform.dense.weight": (H, H),
                     "cls.predictions.transform.dense.bias": (H,),
                     "cls.predictions.transform.LayerNorm.weight": (H,),
                     "cls.predictions.transform.LayerNorm.bias": (H,),
                     "cls.predictions.decoder.weight": (V, H),
                     "cls.predictions.bias": (V,)}.items():
            state[k] = torch.from_numpy(
                (0.05 * rng.standard_normal(s)).astype(np.float32))
        if decoder_bias:
            state["cls.predictions.decoder.bias"] = state["cls.predictions.bias"] + 1
    return state


def write_hf_dir(path, state, *, vocab=None, lower=None):
    path.mkdir(parents=True, exist_ok=True)
    (path / "config.json").write_text(json.dumps(HF_CONFIG))
    torch.save(state, str(path / "pytorch_model.bin"))
    if vocab is not None:
        (path / "vocab.txt").write_text("\n".join(vocab) + "\n")
    if lower is not None:
        (path / "tokenizer_config.json").write_text(
            json.dumps({"do_lower_case": lower}))
    return path


HF_CASES = [
    ("mlm", dict()),
    ("mlm_decoder_bias", dict(decoder_bias=True)),
    ("bare_encoder", dict(head=False)),
]


@pytest.mark.parametrize("name,kw", HF_CASES, ids=[c[0] for c in HF_CASES])
def test_hf_dir_conversion_equals_jax_convert_then_bridge(name, kw, tmp_path):
    d = write_hf_dir(tmp_path / "hf", _hf_state(**kw, pooler=name != "mlm"))
    assert convert.is_hf_bert_dir(d) and not convert.is_hf_bert_dir(tmp_path)
    assert not convert.is_hf_bert_dir(None)
    cfg, sd = convert.load_bert_mlm_dir(d)
    jcfg, jparams = jconvert.load_bert_mlm_dir(d)
    want = bert_params_to_state_dict(jparams)
    assert set(sd) == set(want)
    for k in want:
        torch.testing.assert_close(sd[k], want[k], rtol=0, atol=0)
    for f in ("vocab_size", "hidden_size", "num_layers", "num_heads",
              "intermediate_size", "max_position", "type_vocab_size",
              "layer_norm_eps"):
        assert getattr(cfg, f) == getattr(jcfg, f)
    ecfg, esd = convert.load_bert_dir(d)
    _, jenc = jconvert.load_bert_dir(d)
    ewant = bert_params_to_state_dict(jenc)
    assert ecfg == cfg and set(esd) == set(ewant)
    for k in ewant:
        torch.testing.assert_close(esd[k], ewant[k], rtol=0, atol=0)
    if name == "mlm":  # converted weights give the JAX model's logits
        ids, mask, tt = _inputs(2, 16, seed=4)
        jm = JaxMLM(jax_bert_tiny(attn_impl="reference"))
        jfull = jax.tree_util.tree_map(
            np.asarray, jm.init(jax.random.PRNGKey(0), ids)["params"])
        # the checkpoint has no pooler: it keeps the fresh init
        merged = {**jfull, **jparams, "encoder": {**jfull["encoder"],
                                                  **jparams["encoder"]}}
        want_logits = np.asarray(jm.apply({"params": merged}, ids, mask, tt))
        tm = BertForMaskedLM(bert_tiny(), device="cpu")
        tm.load_state_dict(bert_params_to_state_dict(merged))
        with torch.no_grad():
            got = tm(*_t(ids, mask, tt)).numpy()
        np.testing.assert_allclose(got, want_logits, rtol=0, atol=F32_ATOL)


def test_hf_dir_missing_pieces_raise(tmp_path):
    state = _hf_state()
    del state["bert.encoder.layer.2.output.dense.bias"]
    d = write_hf_dir(tmp_path / "hf", state)
    with pytest.raises(KeyError):
        convert.load_bert_mlm_dir(d)
    with pytest.raises(KeyError):
        jconvert.load_bert_mlm_dir(d)
    (d / "pytorch_model.bin").unlink()
    with pytest.raises(FileNotFoundError):
        convert.load_bert_dir(d)


@pytest.mark.parametrize("lower", [None, False], ids=["default_uncased", "cased"])
def test_runtime_serves_an_hf_dir_like_the_jax_runtime(lower, tmp_path):
    """``storage_path`` = an HF directory: its config, converted weights
    and ``vocab.txt`` (cased as ``tokenizer_config.json`` says) give the
    JAX runtime's predictions. The pooler, absent from the checkpoint,
    keeps each side's fresh init; the MLM answer does not read it."""
    vocab = VOCAB + [f"w{i}" for i in range(V - len(VOCAB))]
    d = write_hf_dir(tmp_path / "hf", _hf_state(pooler=False), vocab=vocab,
                     lower=lower)
    jrt = JaxBertRuntime("b", str(d), buckets=JaxBuckets((1, 4), (16,)),
                         attn_impl="reference")
    trt = BertRuntimeModel("b", str(d), buckets=BucketSpec((1, 4), (16,)),
                           device="cpu")
    assert isinstance(trt.tokenizer, WordPieceTokenizer)
    assert trt.tokenizer.do_lower_case == (lower is None)
    assert trt.config.num_layers == 4 and trt.config.vocab_size == V
    jrt.load()
    trt.load()
    payload = {"instances": ["The Cat sat on the mat.", "the cats sat, Paris",
                             {"input_ids": [2, 5, 6, 3]}]}
    for rt in (jrt, trt):
        rt.out = rt.postprocess(rt.predict(rt.preprocess(payload)))
    assert trt.out == jrt.out
    # no vocab.txt: the hash tokenizer at the config's vocab size
    assert isinstance(BertRuntimeModel("b", None, config=bert_tiny(),
                                       device="cpu").tokenizer, SimpleTokenizer)


# ------------------------------------------------------------------ tokenizer

VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "the", "cat", "##s",
         "sat", "on", "mat", ".", ",", "!", "un", "##believ", "##able", "naive",
         "cafe", "The", "Cat", "中", "文", "is", "capital", "of", "paris", "##ian",
         "a", "b", "?"]
TEXTS = ["The cats sat on the mat.", "Unbelievable!", "naïve café, the cat",
         "中文 is the capital of Parisian", "the [MASK] sat", "a\tb\n?",
         "x" * 120, "", "   ", "The Cat sat", "cats​\x00sat"]


@pytest.mark.parametrize("lower", [True, False], ids=["uncased", "cased"])
def test_wordpiece_matches_jax_tokenizer(lower, tmp_path):
    path = tmp_path / "vocab.txt"
    path.write_text("\n".join(VOCAB) + "\n")
    tok = WordPieceTokenizer(str(path), do_lower_case=lower)
    jtok = JaxWordPiece(str(path), do_lower_case=lower)
    assert tok.vocab == jtok.vocab and tok.vocab_size == jtok.vocab_size
    for text in TEXTS:
        assert tok.tokenize(text) == jtok.tokenize(text), text
        ids = tok.encode(text)
        assert ids == jtok.encode(text), text
        assert tok.encode(text, "the cat") == jtok.encode(text, "the cat")
        assert tok.decode(ids) == jtok.decode(ids)
    with pytest.raises(ValueError, match="required token"):
        WordPieceTokenizer({"[UNK]": 0})


# --------------------------------------------------------------------- config

def test_config_validation_and_limits():
    with pytest.raises(ValueError, match="attn_impl"):
        BertConfig(attn_impl="ring")
    with pytest.raises(ValueError, match="divisible"):
        BertConfig(hidden_size=100, num_heads=12)
    cfg = bert_tiny(max_position=16)
    acfg = cfg.attention_cfg()
    assert (acfg.causal, acfg.use_rope, acfg.n_heads, acfg.head_dim) == (False, False, 8, 16)
    m = init_bert_weights(BertForMaskedLM(cfg, device="cpu"), 0)
    with pytest.raises(ValueError, match="max_position"):
        m(torch.zeros((1, 17), dtype=torch.int32))


def test_fresh_init_is_seeded():
    def sd(seed):
        return init_bert_weights(BertForMaskedLM(bert_tiny(), device="cpu"),
                                 seed).state_dict()

    a, b, c = sd(0), sd(0), sd(1)
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
    assert not torch.equal(a["encoder.embed.embedding"], c["encoder.embed.embedding"])
    assert torch.equal(a["encoder.ln_embed.scale"], torch.ones(128))
    assert torch.equal(a["unembed.bias"], torch.zeros(V))
    # serving layout: projections stored in the compute dtype, the rest f32
    m = BertForMaskedLM(bert_tiny(dtype=torch.bfloat16), device="cpu")
    assert m.encoder.layers[0].up_proj.weight.dtype == torch.bfloat16
    assert m.encoder.layers[0].ln1.scale.dtype == torch.float32
    assert m.unembed.weight.dtype == torch.float32
    assert m.encoder.embed.embedding.dtype == torch.float32
