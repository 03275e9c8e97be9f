"""Tensor-parallel serving: the port's ``LMEngine(mesh=)`` against the JAX TP engine.

The JAX side runs first, in this process, on 4 of the 8 CPU devices: the
config, weights (``PRNGKey(1)``), prompts (``default_rng(31)``) and engine
knobs of JAX ``tests/test_engine.py:743`` and
``tests/test_engine_paged.py:332``, a ``(data=2, model=2)`` mesh with
``transformer_rules(fsdp=False)``, dense and paged. Then one gloo world of
4 CPU ranks (``tests/torch_worlds.py``) runs the port over
``MeshSpec(data=2, model=2)`` on the bridged weights: rank 0 leads, the
others follow its device programs, every rank holds its shard of the
weights and of the KV cache (2 of 4 heads). No JAX compile runs while the
ranks are up.

Greedy f32 token streams must be identical to the JAX TP engine's, dense
and paged (the paged kernel's plain twin on the CPU); the engine features
(int8 KV, chunked prefill, the prefix cache, both pipeline depths, seeded
sampling, bf16) must give the port's one-rank engine's streams on the
same weights. Speculative decoding (K=4, on prompts that repeat a motif)
must give the JAX TP K=4 engine's streams and the port's one-rank K=0
engine's; an MoE model (every second block) the JAX engine's. The JAX
TP engine lays out an MoE model only over a mesh that names the
``expert`` axis (its rules put the expert dim there), so its MoE side
runs over ``(data=2, expert=1, model=2)``: the same 4 devices, and the
port's ``MeshSpec(data=2, model=2)``, whose axes not named are size 1.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import torch_worlds as tw

CFG = dict(vocab_size=96, d_model=32, n_layers=2, n_heads=4, d_ff=64,
           causal=True, max_seq_len=256, attn_impl="reference")
EOS = 1
MAX_NEW = 10
#: a bf16 near tie: a few bf16 steps of the logits' size (about 2 here)
NEAR_TIE_BF16 = 0.05
SPEC = dict(data=2, model=2)
ENGINE = dict(max_batch=2, max_seq=64, chunk_steps=2, prefill_buckets=(32,),
              eos_id=EOS)
PAGED = dict(ENGINE, kv_pool_tokens=16 * 16, page_size=16)
#: the engine features: prompts of 20-40 tokens over a shared 32-token
#: prefix, so chunked pieces and prefix hits both occur
FEATURES = dict(max_batch=2, max_seq=96, chunk_steps=2, prefill_buckets=(64,),
                eos_id=EOS, kv_pool_tokens=16 * 24, page_size=16)
FEATURE_RUNS = [
    ("int8_chunked_prefix_kernel", dict(
        FEATURES, kv_quant="int8", prefill_chunk=16, prefix_cache_entries=4,
        paged_attn_impl="kernel")),
    ("chunked_prefix_gather_depth0", dict(
        FEATURES, prefill_chunk=16, prefix_cache_entries=4, pipeline_depth=0)),
    ("seeded_kernel", dict(FEATURES, paged_attn_impl="kernel",
                           sample=dict(temperature=0.8, seed=7))),
    ("bf16_kernel_burst", dict(FEATURES, paged_attn_impl="kernel",
                               dtype="bfloat16", concurrent=True)),
    ("dense_burst_depth0", dict(
        {k: v for k, v in FEATURES.items()
         if k not in ("kv_pool_tokens", "page_size")},
        pipeline_depth=0, concurrent=True)),
]
STREAM_RUNS = [
    ("dense", dict(ENGINE)),
    ("dense_depth0", dict(ENGINE, pipeline_depth=0)),
    ("paged_gather", dict(PAGED)),
    ("paged_kernel", dict(PAGED, paged_attn_impl="kernel")),
    ("paged_kernel_depth0", dict(PAGED, paged_attn_impl="kernel",
                                 pipeline_depth=0)),
]


#: speculative decoding: K=4 against the one-rank engine at K=0
SPEC_NEW = 16
SPEC_RUNS = [
    (f"spec_{name}", dict(kw, spec_draft_tokens=4,
                          one_rank=dict(spec_draft_tokens=0)))
    for name, kw in (
        ("dense", ENGINE),
        ("dense_depth0", dict(ENGINE, pipeline_depth=0)),
        ("paged_gather", PAGED),
        ("paged_gather_depth0", dict(PAGED, pipeline_depth=0)),
        ("paged_kernel", dict(PAGED, paged_attn_impl="kernel")),
        ("paged_kernel_depth0", dict(PAGED, paged_attn_impl="kernel",
                                     pipeline_depth=0)),
    )
]
#: an MoE block every second layer, at this file's width
MOE = dict(moe_every=2, moe=dict(num_experts=4, expert_dim=64, top_k=2))
MOE_CFG = dict(CFG, **MOE)
MOE_RUNS = [
    ("moe_dense", dict(ENGINE)),
    ("moe_dense_depth0", dict(ENGINE, pipeline_depth=0)),
    ("moe_paged_gather", dict(PAGED)),
    ("moe_paged_kernel_depth0", dict(PAGED, paged_attn_impl="kernel",
                                     pipeline_depth=0)),
]


def _prompts():
    rng = np.random.default_rng(31)
    return [[int(x) for x in rng.integers(2, 96, size=rng.integers(4, 20))]
            for _ in range(3)]


def _feature_prompts():
    rng = np.random.default_rng(5)
    shared = [int(x) for x in rng.integers(2, 96, size=32)]
    return [shared + [int(x) for x in rng.integers(2, 96, size=n)]
            for n in (3, 8, 1, 5)]


def _motif_prompts():
    """Prompts that repeat a 5-token motif, so the drafter matches."""
    rng = np.random.default_rng(3)
    return [([int(x) for x in rng.integers(2, 96, size=5)] * 6)[: 14 + 3 * i]
            for i in range(3)]


def _jax_side():
    """The JAX plain and TP engines' streams, dense and paged, K=0 and
    K=4, of the dense model and of the MoE model, and both models'
    weights bridged for the port."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from kubeflow_tpu.models.transformer import TransformerConfig, TransformerLM
    from kubeflow_tpu.parallel.expert import MoEConfig
    from kubeflow_tpu.parallel.sharding import transformer_rules
    from kubeflow_tpu.serve.engine import LMEngine
    from kubeflow_tpu_torch.models.bridge import params_to_state_dict

    def serve(model, cfg, params, kw, runs):
        eng = LMEngine(model, cfg, params, **kw).start()
        try:
            return [[eng.submit(ids, max_new_tokens=n) for ids in prompts]
                    for prompts, n in runs]
        finally:
            eng.stop()

    def weights(cfg):
        model = TransformerLM(cfg)
        params = model.init(jax.random.PRNGKey(1),
                            jnp.zeros((1, 8), jnp.int32))["params"]
        sd = {k: v.numpy() for k, v in params_to_state_dict(
            jax.tree_util.tree_map(np.asarray, params)).items()}
        return model, params, sd

    cfg = TransformerConfig(**CFG, dtype=jnp.float32)
    model, params, sd = weights(cfg)
    devs = np.asarray(jax.devices()[:4])
    mesh = Mesh(devs.reshape(2, 2), ("data", "model"))
    tp = dict(mesh=mesh, rules=transformer_rules(fsdp=False))
    base, motif = (_prompts(), MAX_NEW), (_motif_prompts(), SPEC_NEW)
    out = {}
    out["plain"], out["plain_motif"] = serve(model, cfg, params, ENGINE,
                                             [base, motif])
    out["dense"], = serve(model, cfg, params, dict(ENGINE, **tp), [base])
    out["paged"], = serve(model, cfg, params, dict(PAGED, **tp), [base])
    for name, kw in (("spec_dense", ENGINE), ("spec_paged", PAGED)):
        out[name], = serve(model, cfg, params,
                           dict(kw, spec_draft_tokens=4, **tp), [motif])

    mcfg = TransformerConfig(**CFG, moe_every=MOE["moe_every"],
                             moe=MoEConfig(**MOE["moe"]), dtype=jnp.float32)
    mmodel, mparams, sd_moe = weights(mcfg)
    out["moe_plain"], = serve(mmodel, mcfg, mparams, ENGINE, [base])
    try:
        serve(mmodel, mcfg, mparams, dict(ENGINE, **tp), [base])
        out["moe_tp_2axis_error"] = None
    except ValueError as e:
        out["moe_tp_2axis_error"] = str(e)
    etp = dict(tp, mesh=Mesh(devs.reshape(2, 1, 2),
                             ("data", "expert", "model")))
    out["moe_dense"], = serve(mmodel, mcfg, mparams, dict(ENGINE, **etp), [base])
    out["moe_paged"], = serve(mmodel, mcfg, mparams, dict(PAGED, **etp), [base])
    # the cached forward's logits: a prefill, then a token a step
    from kubeflow_tpu.models.transformer import init_kv_cache

    tokens, steps = _moe_forward_inputs()
    cache = init_kv_cache(mcfg, tokens.shape[0], tokens.shape[1] + steps.shape[1])
    logits, cache = mmodel.apply({"params": mparams}, jnp.asarray(tokens),
                                 cache=cache, cache_index=0)
    out["moe_logits"] = [np.asarray(logits)]
    for i in range(steps.shape[1]):
        logits, cache = mmodel.apply(
            {"params": mparams}, jnp.asarray(steps[:, i:i + 1]), cache=cache,
            cache_index=tokens.shape[1] + i)
        out["moe_logits"].append(np.asarray(logits))
    return out, sd, sd_moe


def _moe_forward_inputs():
    """A 3-row batch of 16-token prompts and 4 decode tokens a row."""
    rng = np.random.default_rng(9)
    return (rng.integers(2, 96, size=(3, 16)).astype(np.int32),
            rng.integers(2, 96, size=(3, 4)).astype(np.int32))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import os

    prev = os.environ.get("KFT_NO_COMPILATION_CACHE")
    os.environ["KFT_NO_COMPILATION_CACHE"] = "1"
    try:
        jax_streams, sd, sd_moe = _jax_side()
    finally:
        if prev is None:
            del os.environ["KFT_NO_COMPILATION_CACHE"]
        else:
            os.environ["KFT_NO_COMPILATION_CACHE"] = prev
    prompts = _prompts()
    cases = [
        ("streams", dict(fn="tp_serve", spec=SPEC, cfg=CFG, sd=sd,
                         prompts=prompts, max_new=MAX_NEW, runs=STREAM_RUNS)),
        ("features", dict(fn="tp_serve", spec=SPEC, cfg=CFG, sd=sd,
                          prompts=_feature_prompts(), max_new=12,
                          runs=FEATURE_RUNS)),
        ("refusals", dict(fn="tp_refusals", spec=SPEC, cfg=CFG, sd=sd,
                          kw=PAGED)),
        ("http", dict(fn="tp_http", spec=SPEC, cfg=CFG, sd=sd,
                      model_kw=dict(PAGED, paged_attn_impl="kernel"),
                      prompts=prompts, max_new=MAX_NEW)),
        ("cuts", dict(fn="tp_cuts", spec=SPEC, cfg=CFG, sd=sd)),
        ("spec", dict(fn="tp_serve", spec=SPEC, cfg=CFG, sd=sd,
                      prompts=_motif_prompts(), max_new=SPEC_NEW,
                      runs=SPEC_RUNS)),
        ("moe", dict(fn="tp_serve", spec=SPEC, cfg=MOE_CFG, sd=sd_moe,
                     prompts=prompts, max_new=MAX_NEW, runs=MOE_RUNS)),
        # a 1-token match drafts often; a 4x sharper head accepts some
        ("draws", dict(fn="tp_draws", spec=SPEC, cfg=CFG,
                       sd=dict(sd, **{"unembed.weight": 4 * sd["unembed.weight"]}),
                       kw=dict(PAGED, paged_attn_impl="kernel",
                               spec_draft_tokens=4, spec_ngram=1),
                       prompts=_motif_prompts(), max_new=SPEC_NEW,
                       temperature=0.8)),
        ("cuts_moe", dict(fn="tp_cuts", spec=SPEC, cfg=MOE_CFG, sd=sd_moe)),
        ("moe_forward", dict(fn="tp_moe_forward", spec=SPEC, cfg=MOE_CFG,
                             sd=sd_moe, tokens=_moe_forward_inputs()[0],
                             steps=_moe_forward_inputs()[1])),
        ("drop_race", dict(fn="tp_drop_race", spec=SPEC, cfg=CFG, sd=sd,
                           kw=dict(FEATURES, prefill_chunk=16,
                                   prefix_cache_entries=4),
                           prompts=_feature_prompts()[:3], max_new=6)),
        # last: every rank ends its process group in it
        ("follower_dies", dict(fn="tp_follower_dies", spec=SPEC, cfg=CFG,
                               sd=sd, kw=dict(PAGED, max_seq=128),
                               prompts=prompts[:2], max_new=80, victim=1,
                               after=3)),
    ]
    return {"jax": jax_streams, "prompts": prompts, "sd": sd,
            "torch": tw.world(4, cases, tmp_path_factory.mktemp("tp_world"))}


def _ranks(runs, name):
    ranks = runs["torch"][name]
    for i, r in enumerate(ranks):
        assert not isinstance(r, tw.RaisedInRank), f"{name}: rank {i} raised {r!r}"
    return ranks


def test_jax_tp_engines_agree_with_the_plain_one(runs):
    """The reference's own claim, the ground the comparison stands on."""
    j = runs["jax"]
    assert j["dense"] == j["plain"] and j["paged"] == j["plain"]


def test_jax_tp_engines_serve_spec_and_moe_as_the_plain_one(runs):
    """The reference's K=4 TP engines give its plain engine's greedy
    streams, and its MoE TP engines (over a mesh with an ``expert`` axis)
    its plain MoE engine's; over ``(data, model)`` alone its rules name an
    axis the mesh lacks (ROADMAP queue 3)."""
    j = runs["jax"]
    assert j["spec_dense"] == j["spec_paged"] == j["plain_motif"]
    assert j["moe_dense"] == j["moe_paged"] == j["moe_plain"]
    assert "expert" in j["moe_tp_2axis_error"]


@pytest.mark.parametrize("name", [r[0] for r in SPEC_RUNS])
def test_tp_spec_streams_match_the_jax_tp_engine(runs, name):
    """K=4 over the mesh: the JAX TP K=4 engine's greedy streams (dense
    or paged), the port's one-rank K=0 engine's, drafts proposed and
    accepted, and every rank following every program."""
    ranks = _ranks(runs, "spec")
    got = ranks[0][name]
    want = runs["jax"]["spec_paged" if "paged" in name else "spec_dense"]
    assert got["tokens"] == want
    assert got["one_rank"] == want
    assert got["stats"]["spec_accepted"] > 0
    assert got["stats"]["spec_proposed"] >= got["stats"]["spec_accepted"]
    assert all(r[name]["records"] == got["records"] > 0 for r in ranks)
    for r in ranks[1:]:
        assert r[name]["tokens"] is None


@pytest.mark.parametrize("name", [r[0] for r in MOE_RUNS])
def test_tp_moe_streams_match_the_jax_engine(runs, name):
    """An MoE model over the mesh: the JAX MoE engines' greedy streams and
    the port's one-rank engine's; each rank holds its half of the
    experts' FFN columns and routes the whole batch, as one rank does."""
    ranks = _ranks(runs, "moe")
    got = ranks[0][name]
    assert got["tokens"] == runs["jax"]["moe_plain"]
    assert got["one_rank"] == runs["jax"]["moe_plain"]
    assert all(r[name]["records"] == got["records"] > 0 for r in ranks)
    assert all(r[name]["kv_heads"] == 2 for r in ranks)


def test_tp_moe_cached_forward_matches_the_jax_one(runs):
    """The MoE model's cached forward over the mesh, every rank: the JAX
    cached forward's logits (f32, within 1e-5) through a prefill and four
    decode steps, and the one-rank port's drops call for call. The whole
    batch is one token group, so capacity counts each token once: counted
    once a ``data`` replica, the drops (which occur here) would differ."""
    ranks = _ranks(runs, "moe_forward")
    want = runs["jax"]["moe_logits"]
    one = ranks[0]["one_rank"]
    assert any(d > 0 for d in one["dropped"])
    for r in ranks:
        assert r["dropped"] == one["dropped"]
        assert len(r["logits"]) == len(want)
        for got, ref in zip(r["logits"], want):
            np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


def test_tp_spec_sampling_draws_agree_on_every_rank(runs):
    """Unseeded temperature-0.8 K=4 sampling, three requests at once: the
    accept and resample draws come from each rank's own generator, and
    every rank emits (and writes KV for) the leader's tokens, program
    for program."""
    ranks = _ranks(runs, "draws")
    lead = ranks[0]
    # drafts both accepted and rejected: both draws ran
    stats = lead["stats"]
    assert stats["spec_proposed"] > stats["spec_accepted"] > 0
    assert all(len(t) > 0 for t in lead["streams"])
    assert sum(op == "chunk" for op, *_ in lead["emitted"]) > 0
    for r in ranks[1:]:
        assert r["records"] == lead["records"]
        assert r["emitted"] == lead["emitted"]


def test_tp_cuts_join_back_for_an_moe_model(runs):
    """The MoE model's cut: the experts' FFN over ``model`` (no ``expert``
    axis in the serving mesh), the router whole; joining the cuts gives
    back the bridged weights on every rank."""
    ranks = _ranks(runs, "cuts_moe")
    for r in ranks:
        assert r["equal"], r["unequal"]
        assert r["split"] > 0


def test_engine_model_reserves_dense_spec_headroom_under_a_mesh():
    """``LMEngineModel(mesh=)`` in dense mode reserves the K verify slots
    in ``max_seq``, as one rank does."""
    from kubeflow_tpu_torch.core.mesh import MeshSpec
    from kubeflow_tpu_torch.models.transformer import TransformerConfig
    from kubeflow_tpu_torch.serve.engine import LMEngineModel

    for mesh in (None, MeshSpec(**SPEC)):
        lm = LMEngineModel("lm", config=TransformerConfig(**CFG), device="cpu",
                           prefill_buckets=(32,), max_new_tokens=10,
                           spec_draft_tokens=4, mesh=mesh, watchdog=False)
        assert lm._engine_config.max_seq == 32 + 10 + 4


@pytest.mark.parametrize("name", [r[0] for r in STREAM_RUNS])
def test_tp_greedy_streams_match_the_jax_tp_engine(runs, name):
    ranks = _ranks(runs, "streams")
    got = ranks[0][name]
    want = runs["jax"]["paged" if name.startswith("paged") else "dense"]
    assert got["tokens"] == want
    assert got["one_rank"] == want
    # each rank holds 2 of the 4 kv heads and followed every program
    assert all(r[name]["kv_heads"] == 2 for r in ranks)
    assert all(r[name]["records"] == got["records"] > 0 for r in ranks)
    for r in ranks[1:]:
        assert r[name]["tokens"] is None


def _bf16_margins(sd, prompts, want, got):
    """For each row where two bf16 streams part, the one-rank bf16 model's
    logit gap between the two tokens at the first divergence."""
    from kubeflow_tpu_torch.models import transformer as ttf

    model = ttf.TransformerLM(ttf.TransformerConfig(**CFG, dtype=torch.bfloat16),
                              device="cpu")
    model.load_state_dict({k: torch.tensor(v) for k, v in sd.items()})
    gaps = []
    for ids, a, b in zip(prompts, want, got):
        j = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if j is None:
            assert len(a) == len(b)
            continue
        with torch.no_grad():
            lg = model(torch.tensor([ids + a[:j]]))[0, -1].float()
        gaps.append(abs(float(lg[a[j]] - lg[b[j]])))
    return gaps


@pytest.mark.parametrize("name", [r[0] for r in FEATURE_RUNS])
def test_tp_engine_features_match_one_rank(runs, name):
    got = _ranks(runs, "features")[0][name]
    kw = dict(FEATURE_RUNS)[name]
    if kw.get("dtype") == "bfloat16":
        # the sums over 'model' round differently from one rank's: bf16
        # streams may part, but only at a near tie of the one-rank model
        gaps = _bf16_margins(runs["sd"], _feature_prompts(), got["one_rank"],
                             got["tokens"])
        assert all(g <= NEAR_TIE_BF16 for g in gaps), gaps
    else:
        assert got["tokens"] == got["one_rank"]
    assert all(len(t) > 0 for t in got["tokens"])
    if kw.get("prefix_cache_entries"):
        assert got["stats"]["prefix_hits"] >= 2
    if kw.get("prefill_chunk"):
        assert got["stats"]["prefill_pieces"] > len(_feature_prompts())
    if kw.get("kv_quant") == "int8":
        # the error is summed over every rank's heads: the one-rank figure
        err, one = (got["overlap"]["kv_quant_error"],
                    got["one_rank_overlap"]["kv_quant_error"])
        assert 0.0 < err < 0.05
        np.testing.assert_allclose(err, one, rtol=1e-5)


def test_tp_engine_refuses_item_14_and_follower_submits(runs):
    ranks = _ranks(runs, "refusals")
    lead = ranks[0]
    for what in ("prefill_span", "prepare_kv_span", "export_prefix_entries",
                 "import_prefix_entries"):
        kind, msg = lead[what]
        assert kind == "NotImplementedError" and "queue 1 item 14" in msg, what
    assert len(lead["served"]) > 0
    for r in ranks[1:]:
        kind, msg = r["submit"]
        assert kind == "RuntimeError" and "submit on rank 0" in msg


def test_lm_engine_model_serves_tp_over_http_on_the_leader(runs):
    ranks = _ranks(runs, "http")
    assert ranks[0]["tokens"] == runs["jax"]["paged"]
    assert all(r["loaded"] for r in ranks[1:])


def test_a_dead_follower_fails_the_leaders_requests(runs):
    ranks = _ranks(runs, "follower_dies")
    assert ranks[1]["died"] == "rank 1 dies"
    lead = ranks[0]
    assert lead["hung"] == 0
    assert len(lead["errors"]) == 2, lead
    # within the group's timeout (60 s in the test worlds), through the
    # engine's fatal path: a later submit would find the engine dead
    assert all(sec < 60 for _, _, sec in lead["errors"].values()), lead
    assert lead["fatal"] != "None"


def test_kv_heads_not_divisible_raises_the_jax_text():
    """GQA with 1 kv head over model=2: both engines raise the same
    ValueError before any device work (no process group needed)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh as JaxMesh

    from kubeflow_tpu.models.transformer import TransformerConfig, TransformerLM
    from kubeflow_tpu.parallel.sharding import transformer_rules
    from kubeflow_tpu.serve.engine import LMEngine as JaxEngine
    from kubeflow_tpu_torch.core.mesh import Mesh, MeshSpec
    from kubeflow_tpu_torch.models import transformer as ttf
    from kubeflow_tpu_torch.serve.engine import LMEngine

    kw = dict(CFG, n_kv_heads=1)
    jcfg = TransformerConfig(**kw, dtype=jnp.float32)
    jmodel = TransformerLM(jcfg)
    params = jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(1), jnp.zeros((1, 8), jnp.int32)))
    params = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                    params)["params"]
    mesh = JaxMesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
    with pytest.raises(ValueError) as want:
        JaxEngine(jmodel, jcfg, params, mesh=mesh,
                  rules=transformer_rules(fsdp=False), **ENGINE)
    tmodel = ttf.TransformerLM(ttf.TransformerConfig(**kw), device="cpu")
    with pytest.raises(ValueError) as got:
        LMEngine(tmodel, mesh=Mesh(MeshSpec(**SPEC), 0, device="cpu"), **ENGINE)
    assert str(got.value) == str(want.value)
    assert "kv_heads 1 must be divisible by the mesh 'model' axis size 2" in str(got.value)


def test_rules_without_a_mesh_are_refused():
    from kubeflow_tpu_torch.models import transformer as ttf
    from kubeflow_tpu_torch.parallel.sharding import transformer_rules
    from kubeflow_tpu_torch.serve.engine import LMEngine

    tmodel = ttf.TransformerLM(ttf.TransformerConfig(**CFG), device="cpu")
    with pytest.raises(ValueError, match="pass mesh= too"):
        LMEngine(tmodel, rules=transformer_rules(fsdp=False), **ENGINE)


def test_tp_cuts_join_back_to_the_bridged_weights(runs):
    """Cutting the bridged full weights by ``transformer_rules(fsdp=False)``
    over the world's mesh and joining the cuts again gives back the full
    state dict on every rank."""
    ranks = _ranks(runs, "cuts")
    for r in ranks:
        assert r["equal"], r["unequal"]
        assert r["split"] > 0


def test_a_prefix_drop_between_a_hit_and_its_implant(runs):
    """Another thread drops the prefix cache after the leader's lookup hit
    and before its implant: the implant still reads the entry on every
    rank (the drop runs later, at the same point of every rank's program
    stream), the streams are the one-rank engine's under the same drop,
    and every rank ends with the same stored keys."""
    ranks = _ranks(runs, "drop_race")
    lead = ranks[0]
    assert lead["dropped"] and lead["dropped"][0] >= 1, lead
    assert lead["hits"] >= 1
    assert lead["tokens"] == lead["one_rank"]
    assert lead["one_rank_dropped"] == lead["dropped"]
    assert all(len(t) > 0 for t in lead["tokens"])
    for r in ranks[1:]:
        assert r["keys"] == lead["keys"]


def test_engines_refuse_weights_cut_for_another_layout():
    """A TP engine cuts the caller's model in place. A model cut for one
    layout is refused by a one-rank engine and by a TP engine of other
    rules or another mesh (before any process group is needed)."""
    from kubeflow_tpu_torch.core.mesh import Mesh, MeshSpec
    from kubeflow_tpu_torch.models import transformer as ttf
    from kubeflow_tpu_torch.parallel.sharding import (
        shard_module, split_parameters, transformer_rules)
    from kubeflow_tpu_torch.serve.engine import LMEngine

    def cut(spec, rules):
        model = ttf.TransformerLM(ttf.TransformerConfig(**CFG), device="cpu")
        shard_module(model, rules(model), Mesh(MeshSpec(**spec), 0, device="cpu"))
        return model

    whole = ttf.TransformerLM(ttf.TransformerConfig(**CFG), device="cpu")
    assert split_parameters(whole) == []
    # a one-rank mesh cuts nothing: its model serves on one rank
    LMEngine(cut(dict(data=1), transformer_rules(fsdp=False)), **ENGINE)
    tp = cut(SPEC, transformer_rules(fsdp=False))
    assert "layers.0.attn.q_proj.weight" in split_parameters(tp)
    with pytest.raises(ValueError, match="cut over a mesh"):
        LMEngine(tp, **ENGINE)
    trained = cut(dict(fsdp=2, model=2), transformer_rules())
    with pytest.raises(ValueError, match="cut for another layout"):
        LMEngine(trained, mesh=Mesh(MeshSpec(**SPEC), 0, device="cpu"), **ENGINE)
    with pytest.raises(ValueError, match="cut for another layout"):
        LMEngine(tp, mesh=Mesh(MeshSpec(**SPEC), 1, device="cpu"), **ENGINE)


def test_engines_refuse_moe_weights_cut_for_another_layout():
    """An MoE model cut by the serving rules splits its experts' FFN over
    ``model`` and keeps the router whole; a one-rank engine refuses it,
    and a TP engine refuses the MoE model cut by the training rules."""
    from kubeflow_tpu_torch.core.mesh import Mesh, MeshSpec
    from kubeflow_tpu_torch.models import transformer as ttf
    from kubeflow_tpu_torch.parallel.expert import MoEConfig
    from kubeflow_tpu_torch.parallel.sharding import (
        shard_module, split_parameters, transformer_rules)
    from kubeflow_tpu_torch.serve.engine import LMEngine

    def cut(spec, rules):
        model = ttf.TransformerLM(ttf.TransformerConfig(
            **CFG, moe_every=MOE["moe_every"], moe=MoEConfig(**MOE["moe"])),
            device="cpu")
        shard_module(model, rules(model), Mesh(MeshSpec(**spec), 0, device="cpu"))
        return model

    tp = cut(SPEC, transformer_rules(fsdp=False))
    split = split_parameters(tp)
    assert {"layers.1.experts.up_kernel", "layers.1.experts.down_kernel"} <= set(split)
    assert "layers.1.experts.router_kernel" not in split
    assert tp.layers[1].experts.up_kernel.shape == (4, CFG["d_model"], 32)
    with pytest.raises(ValueError, match="cut over a mesh"):
        LMEngine(tp, **ENGINE)
    trained = cut(dict(fsdp=2, model=2), transformer_rules())
    with pytest.raises(ValueError, match="cut for another layout"):
        LMEngine(trained, mesh=Mesh(MeshSpec(**SPEC), 0, device="cpu"), **ENGINE)
