"""PyTorch port, the serve mesh (``serving/shard.py``; the engine's ``mesh=``; the serving
programs' ``tp`` axis in ``models/lm.py``; ``serve_loadgen --shard``), against the JAX
package's single-chip engine and the port's unsharded engine.

One gloo world of 4 on the CPU (the port's launcher, one thread a rank) serves on
``build_serve_mesh(tp=2, dp=2)`` (global rank r where JAX device r sits in the ``(dp, tp)``
array), while this process runs the JAX references:

(a) the greedy streams of the JAX mesh matrix (``mha``, ``gqa`` with 2 KV heads,
    ``int8_kv``, ``spec_ngram``) and ``paged`` (the plain paged-decode path) and ``w8``, on
    the JAX tests' workloads (``SMALL``, 8 requests of seed 7; ``mha`` also 6 of seed 13),
    equal to the JAX single-chip engine's and the port's unsharded engine's, token for
    token; the ranks' host ledgers agree (``check_replicas``);
(b) a prefix-cache hit under the mesh, contiguous (an entry holds each rank's heads,
    installed into a slot of either group) and paged (a hit from another group's pages is
    a miss), against the unsharded engine;
(c) each serving program's log-probs and written K/V rows on a rank's own slots and heads
    against the unsharded program on the same state, within f32 atol 1e-5 (a row-parallel
    projection sums its ranks' partial products in another order);
(d) the per-chip byte accounting: 4 rows, the KV rows sum to the unsharded total, and
    params + KV per rank <= the unsharded / 1.8; the unsharded one-row document;
(e) the ``Server`` on rank 0 over ``MeshLeader``, the other ranks following, with its
    telemetry stream;
plus ``validate_engine_mesh``'s refusals and ``parse_shard_spec`` against the JAX
package's.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csed_514_project_distributed_training_using_pytorch_tpu.models import lm as jax_lm
from csed_514_project_distributed_training_using_pytorch_tpu.serving import (
    ContinuousBatchingEngine as JaxEngine,
)
from csed_514_project_distributed_training_using_pytorch_tpu.serving import (
    Request as JaxRequest,
)
from csed_514_project_distributed_training_using_pytorch_tpu.serving import (
    shard as jax_shard,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.models import lm
from csed_514_project_distributed_training_using_pytorch_tpu_torch.models.transformer import (
    params_from_jax,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.parallel.mesh import (
    ProcessGrid,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.serving import (
    ContinuousBatchingEngine,
    shard,
)

import torch_port_fleet as fleet

SMALL = dict(vocab_size=9, seq_len=16, embed_dim=32, num_layers=2, num_heads=4)
LOGIT_ATOL = 1e-5
# name -> (parameters, model kwargs, engine kwargs, requests, seed): the JAX mesh matrix
# (tests/test_shard_serve.py) and the port's paged and w8 paths
VARIANTS = {
    "mha": ("mha", {}, {}, 8, 7),
    "gqa": ("gqa", {"num_kv_heads": 2}, {}, 8, 7),
    "int8_kv": ("mha", {}, {"kv_dtype": "int8"}, 8, 7),
    "spec_ngram": ("mha", {}, {"spec": "ngram", "spec_k": 4}, 8, 7),
    "paged": ("mha", {}, {"kv_layout": "paged", "page_size": 4}, 8, 7),
    "w8": ("mha", {}, {"quant_policy": "w8"}, 8, 7),
    "mha_n6": ("mha", {}, {}, 6, 13),
}
PROGRAMS = ("decode", "prefill", "verify", "paged_decode", "paged_prefill", "paged_verify")

CHILD = '''
import json
from {pkg}.models import lm
from {pkg}.parallel import mesh
from {pkg}.serving import ContinuousBatchingEngine, Request, Server, shard
base = {base!r}
SMALL = {small!r}
out = {{}}


def load(name):
    d = np.load(base + "/" + name + ".npz")
    return {{k: torch.from_numpy(d[k]) for k in d.files}}


def workload(model, n, seed):
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        plen = int(rng.integers(0, model.seq_len // 2))
        reqs.append(Request(prompt=rng.integers(0, 8, size=plen).astype(np.int32),
                            max_new_tokens=int(rng.integers(1, model.seq_len)),
                            request_id=i))
    return reqs


def tokens(e, reqs):
    return {{c.request.request_id: c.tokens.tolist() for c in e.run(reqs)}}


def box(tree, rows, heads):
    return {{n: {{k: x[rows][:, :, heads].clone() for k, x in layer.items()}}
            for n, layer in tree.items()}}


def tree_err(a, b):
    return max((a[n][k].float() - b[n][k].float()).abs().max().item()
               for n in a for k in a[n])


with mesh.cluster("cpu"):
    sm = shard.build_serve_mesh(2, 2)
    for name, (pname, model_kw, engine_kw, n, seed) in {variants!r}.items():
        model = lm.TransformerLM(**SMALL, **model_kw)
        params = load(pname)
        want = tokens(ContinuousBatchingEngine(model, params, num_slots=4, device="cpu",
                                               **engine_kw), workload(model, n, seed))
        e = ContinuousBatchingEngine(model, params, num_slots=4, device="cpu", mesh=sm,
                                     **engine_kw)
        got = tokens(e, workload(model, n, seed))
        out[name] = {{"got": got, "want": want, "ledger": shard.check_replicas(e)}}

    model, params = lm.TransformerLM(**SMALL), load("mha")
    prompt = np.random.default_rng(3).integers(0, 8, size=10).astype(np.int32)
    reqs = lambda ids: [Request(prompt=prompt.copy(), max_new_tokens=4, request_id=i)
                        for i in ids]
    for layout, kw in (("contiguous", {{}}), ("paged", {{"kv_layout": "paged",
                                                          "page_size": 4}})):
        res = {{}}
        for label, m in (("single", None), ("sharded", sm)):
            e = ContinuousBatchingEngine(model, params, num_slots=2, prefix_cache_entries=4,
                                         device="cpu", mesh=m, **kw)
            streams = {{**tokens(e, reqs([0])), **tokens(e, reqs([1])),
                        **tokens(e, reqs([2, 3]))}}
            res[label] = {{"streams": streams, "hits": e.prefix_cache.stats()["hits"],
                          "prefill_tokens": e.prefill_tokens}}
        out["prefix_" + layout] = res

    out["bytes"] = {{"single": ContinuousBatchingEngine(model, params, num_slots=4,
                                                        device="cpu").byte_accounting(),
                     "sharded": ContinuousBatchingEngine(model, params, num_slots=4,
                                                         device="cpu",
                                                         mesh=sm).byte_accounting()}}
    # each rank's planes are the local boxes of the JAX specs over the unsharded planes
    boxes = []
    for kw, specs_of, whole in (
            ({{}}, shard.cache_pspecs, lm.init_cache(model, 4, kv_dtype="int8")),
            ({{"kv_layout": "paged", "page_size": 4}}, shard.pool_pspecs,
             lm.init_page_pool(model, 18, page_size=4, kv_dtype="int8"))):
        e = ContinuousBatchingEngine(model, params, num_slots=4, device="cpu", mesh=sm,
                                     kv_dtype="int8", **kw)
        for n, layer in specs_of(whole).items():
            for k, spec in layer.items():
                mine = shard.local_box(whole[n][k].shape, spec, sm)
                boxes.append(tuple(e._cache[n][k].shape) ==
                             tuple(b.stop - b.start for b in mine))
    all_boxes = [None] * 4
    torch.distributed.all_gather_object(all_boxes, all(boxes) and len(boxes) == 16)
    out["boxes"] = all_boxes

    # each program on this rank's slots and heads against the unsharded one
    g, mi = sm.data.index, sm.model.index
    rows, heads = slice(2 * g, 2 * g + 2), slice(2 * mi, 2 * mi + 2)
    lparams = shard.param_shardings(params, sm)
    gen = torch.Generator().manual_seed(11)
    errs = {{}}
    cache = lm.init_cache(model, 4)
    prompt_buf = torch.randint(0, 8, (4, 16), generator=gen, dtype=torch.int32)
    for s in range(4):
        lm.prefill_chunk(model, params, cache, prompt_buf, s, 0, 8, True, chunk=8)
    loc = box(cache, rows, heads)
    lm.prefill_chunk(model, params, cache, prompt_buf, 2 * g + 1, 8, 4, False, chunk=4)
    lm.prefill_chunk(model, lparams, loc, prompt_buf[rows], 1, 8, 4, False, chunk=4,
                     tp=sm.model)
    errs["prefill"] = tree_err(loc, box(cache, rows, heads))
    ids = torch.randint(0, 8, (4,), generator=gen)
    t = torch.tensor([8, 9, 10, 12], dtype=torch.int32)
    _, lp = lm.decode_step_slots(model, params, cache, ids, t)
    _, lpl = lm.decode_step_slots(model, lparams, loc, ids[rows], t[rows], tp=sm.model)
    errs["decode"] = max((lpl - lp[rows]).abs().max().item(),
                         tree_err(loc, box(cache, rows, heads)))
    draft = torch.randint(0, 8, (4, 3), generator=gen)
    _, lp = lm.verify_chunk(model, params, cache, ids, t + 1, draft, k=3)
    _, lpl = lm.verify_chunk(model, lparams, loc, ids[rows], t[rows] + 1, draft[rows], k=3,
                             tp=sm.model)
    errs["verify"] = max((lpl - lp[rows]).abs().max().item(),
                         tree_err(loc, box(cache, rows, heads)))
    # paged: each dp group's page range (its null page first), pools filled at random
    ps, per = 4, 9
    pool = lm.init_page_pool(model, 2 * per, page_size=ps)
    for layer in pool.values():
        for x in layer.values():
            x.copy_(torch.randn(x.shape, generator=gen))
    table = torch.tensor([[(s // 2) * per + 1 + 4 * (s % 2) + j for j in range(4)]
                          for s in range(4)], dtype=torch.int32)
    lpool = {{n: {{k: x[per * g:per * g + per][:, :, heads].clone() for k, x in layer.items()}}
             for n, layer in pool.items()}}
    ltable = (table[rows] - per * g).contiguous()
    pbox = lambda: {{n: {{k: x[per * g:per * g + per][:, :, heads] for k, x in layer.items()}}
                    for n, layer in pool.items()}}
    lm.paged_prefill_chunk(model, params, pool, table, prompt_buf, 2 * g, 0, 8, chunk=8)
    lm.paged_prefill_chunk(model, lparams, lpool, ltable, prompt_buf[rows], 0, 0, 8, chunk=8,
                           tp=sm.model)
    errs["paged_prefill"] = tree_err(lpool, pbox())
    _, lp = lm.paged_decode_step_slots(model, params, pool, table, ids, t)
    _, lpl = lm.paged_decode_step_slots(model, lparams, lpool, ltable, ids[rows], t[rows],
                                        tp=sm.model)
    errs["paged_decode"] = max((lpl - lp[rows]).abs().max().item(), tree_err(lpool, pbox()))
    _, lp = lm.paged_verify_chunk(model, params, pool, table, ids, t + 1, draft, k=3)
    _, lpl = lm.paged_verify_chunk(model, lparams, lpool, ltable, ids[rows], t[rows] + 1,
                                   draft[rows], k=3, tp=sm.model)
    errs["paged_verify"] = max((lpl - lp[rows]).abs().max().item(), tree_err(lpool, pbox()))
    all_errs = [None] * 4
    torch.distributed.all_gather_object(all_errs, errs)
    out["programs"] = all_errs

    # the Server on rank 0 over the leader; the other ranks follow
    e = ContinuousBatchingEngine(model, params, num_slots=4, device="cpu", mesh=sm,
                                 kv_layout="paged", page_size=4)
    if RANK == 0:
        server = Server(shard.MeshLeader(e), telemetry=base + "/serve_mesh.jsonl").start()
        futs = [server.submit(r.prompt, max_new_tokens=r.max_new_tokens)
                for r in workload(model, 8, 7)]
        comps = [f.result(timeout=120) for f in futs]
        server.stop(timeout=120)
        server.engine.close()
        out["server"] = {{str(i): c.tokens.tolist() for i, c in enumerate(comps)}}
    else:
        shard.follow(e)
    out["server_ledger"] = shard.check_replicas(e)
if RANK == 0:
    json.dump(out, open(base + "/mesh.json", "w"))
'''


def _jax_params(**model_kw):
    model = jax_lm.TransformerLM(**{**SMALL, **model_kw})
    ids = jnp.zeros((1, model.seq_len), jnp.int32)
    return model, model.init({"params": jax.random.PRNGKey(0)}, ids)["params"]


def _workload(n, seed, seq_len=SMALL["seq_len"]):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        plen = int(rng.integers(0, seq_len // 2))
        out.append((rng.integers(0, 8, size=plen).astype(np.int32),
                    int(rng.integers(1, seq_len))))
    return out


def _jax_tokens(engine, work):
    reqs = [JaxRequest(prompt=p, max_new_tokens=n, request_id=i)
            for i, (p, n) in enumerate(work)]
    return {str(c.request.request_id): np.asarray(c.tokens).tolist()
            for c in engine.run(reqs)}


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """The world-4 fleet (started first, from the JAX package's initial parameters) and
    the JAX references, computed while it serves."""
    base = tmp_path_factory.mktemp("serve_mesh")
    jax_models = {}
    for name, kw in (("mha", {}), ("gqa", {"num_kv_heads": 2})):
        model, params = _jax_params(**kw)
        jax_models[name] = (model, params)
        np.savez(base / f"{name}.npz",
                 **{k: p.numpy() for k, p in params_from_jax(params).items()})
    f = fleet.Fleets(base, {"mesh": (CHILD.format(pkg=fleet.PKG, base=str(base), small=SMALL,
                                                  variants=VARIANTS), 4)})
    try:
        refs = {}
        for name, (pname, _, engine_kw, n, seed) in VARIANTS.items():
            model, params = jax_models[pname]
            refs[name] = _jax_tokens(JaxEngine(model, params, num_slots=4, **engine_kw),
                                     _workload(n, seed))
        model, params = jax_models["mha"]
        prompt = np.random.default_rng(3).integers(0, 8, size=10).astype(np.int32)
        oracle = JaxEngine(model, params, num_slots=2, prefix_cache_entries=4)
        refs["prefix"] = {**_jax_tokens(oracle, [(prompt, 4)])}
        f.get("mesh")
        with open(base / "mesh.json") as fh:
            yield json.load(fh), refs, base
    finally:
        f.close()


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_sharded_engine_streams_equal_jax_and_unsharded(served, variant):
    out, refs, _ = served
    row = out[variant]
    assert row["got"] == row["want"], f"{variant}: sharded vs the port's unsharded engine"
    assert row["got"] == refs[variant], f"{variant}: sharded vs the JAX single-chip engine"
    assert row["ledger"]["finished"] == VARIANTS[variant][3]
    if variant == "spec_ngram":
        assert row["ledger"]["decode_calls"] == 0 and row["ledger"]["verify_calls"]


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_sharded_prefix_cache_hit(served, layout):
    out, refs, _ = served
    res = out["prefix_" + layout]
    assert res["sharded"]["streams"] == res["single"]["streams"]
    # every request is the oracle's one stream (the JAX engine, sequentially)
    assert {s == refs["prefix"]["0"] for s in res["sharded"]["streams"].values()} == {True}
    if layout == "contiguous":
        # [1] hits [0]'s entry in slot 0; [2] and [3] hit it in both groups' slots (the
        # entry holds each rank's heads, broadcast over the data axis)
        assert res["sharded"]["hits"] == res["single"]["hits"] == 3
        assert res["sharded"]["prefill_tokens"] == res["single"]["prefill_tokens"]
    else:
        # a paged entry lives in its group's pages: slot 1 (the other group) finds it and
        # prefills all the same, and its own entry is then found by the last lookup
        assert res["single"]["hits"] == 3 and res["sharded"]["hits"] == 4
        assert res["sharded"]["prefill_tokens"] > res["single"]["prefill_tokens"]


@pytest.mark.parametrize("program", PROGRAMS)
def test_program_log_probs_and_rows_within_tolerance(served, program):
    out, _, _ = served
    errs = [rank[program] for rank in out["programs"]]
    assert max(errs) <= LOGIT_ATOL, f"{program}: max |diff| by rank {errs}"


def test_sharded_byte_accounting_sums_per_chip_rows(served):
    out, _, _ = served
    single, acct = out["bytes"]["single"], out["bytes"]["sharded"]
    assert acct["mesh"]["tp"] == 2 and acct["mesh"]["dp"] == 2
    assert sorted(acct["per_chip"]) == ["0", "1", "2", "3"]
    assert sum(r["kv_bytes"] for r in acct["per_chip"].values()) == single["kv_bytes_resident"]
    assert all(r["params_bytes"] < single["params_bytes"] for r in acct["per_chip"].values())
    assert acct["params_kv_bytes_per_chip_max"] <= (
        single["params_bytes"] + single["kv_bytes_resident"]) / 1.8
    assert acct["slots_at_budget"] >= single["slots_at_budget"]
    assert set(acct) == set(single)


def test_each_ranks_planes_are_the_local_boxes_of_the_specs(served):
    out, _, _ = served
    assert out["boxes"] == [True] * 4


def test_unsharded_byte_accounting_one_row_pin():
    """The unsharded document: one per-chip row equal to the logical totals, in the JAX
    engine's keys and numbers."""
    model = lm.TransformerLM(**SMALL)
    acct = ContinuousBatchingEngine(model, model.init(torch.Generator().manual_seed(0)),
                                    num_slots=4, device="cpu").byte_accounting()
    assert acct["mesh"] is None and len(acct["per_chip"]) == 1
    row = next(iter(acct["per_chip"].values()))
    assert row["params_bytes"] == acct["params_bytes"]
    assert row["kv_bytes"] == acct["kv_bytes_resident"]
    assert row["prompt_bytes"] == acct["prompt_bytes"]
    assert acct["bytes_per_chip_max"] == row["total_bytes"]
    assert (acct["params_kv_bytes_per_chip_max"]
            == acct["params_bytes"] + acct["kv_bytes_resident"])
    jax_model, jax_params = _jax_params()
    ref = JaxEngine(jax_model, jax_params, num_slots=4).byte_accounting()
    assert set(acct) == set(ref)
    for key in ("params_bytes", "kv_bytes_resident", "prompt_bytes", "decode_bytes_per_step",
                "slots_at_budget", "bytes_per_chip_max", "params_kv_bytes_per_chip_max"):
        assert acct[key] == ref[key], key


def test_server_over_the_leader_serves_the_engine_streams(served):
    out, _, base = served
    assert out["server"] == out["paged"]["want"]
    assert out["server_ledger"]["finished"] == 8
    kinds = [json.loads(line)["event"] for line in open(base / "serve_mesh.jsonl")]
    assert kinds[:2] == ["manifest", "serve_config"] and kinds.count("serve") == 8
    summary = json.loads(open(base / "serve_mesh.jsonl").read().splitlines()[-1])
    assert summary["event"] == "serve_summary" and len(summary["bytes"]["per_chip"]) == 4


def test_validate_engine_mesh_refusals_match_jax(devices8):
    gqa = lm.TransformerLM(**SMALL, num_kv_heads=2)
    jax_gqa, _ = _jax_params(num_kv_heads=2)
    one = ProcessGrid("data=1,model=1")
    for tp, dp, slots, match in ((4, 1, 4, "num_kv_heads"), (1, 2, 3, "num_slots")):
        with pytest.raises(ValueError, match=match) as ours:
            shard.validate_engine_mesh(gqa, slots, shard.ServeMesh(grid=one, tp=tp, dp=dp))
        with pytest.raises(ValueError, match=match) as theirs:
            jax_shard.validate_engine_mesh(jax_gqa, slots,
                                           jax_shard.build_serve_mesh(tp=tp, dp=dp))
        assert str(ours.value) == str(theirs.value)
    shard.validate_engine_mesh(gqa, 4, shard.ServeMesh(grid=one, tp=2, dp=2))


@pytest.mark.parametrize("spec", ["", "tp=2", "tp=2,dp=4", "dp=2, tp=2", "tp=0", "tp=x",
                                  "pp=2", "tp"])
def test_parse_shard_spec_matches_jax(spec):
    try:
        want = jax_shard.parse_shard_spec(spec)
    except ValueError as e:
        with pytest.raises(ValueError) as ours:
            shard.parse_shard_spec(spec)
        assert str(ours.value) == str(e)
        return
    assert shard.parse_shard_spec(spec) == want


def test_plane_specs_are_the_jax_boxes():
    model = lm.TransformerLM(**SMALL)
    cache = lm.init_cache(model, 4, kv_dtype="int8")
    pool = lm.init_page_pool(model, 8, page_size=4, kv_dtype="int8")
    assert shard.cache_pspecs(cache)["block_0"] == {
        "k": ("data", None, "model", None), "v": ("data", None, "model", None),
        "k_scale": ("data", None, "model"), "v_scale": ("data", None, "model")}
    assert shard.pool_pspecs(pool)["block_1"]["k"] == ("data", None, "model", None)
    planes = {n: {k: x[0] for k, x in layer.items()} for n, layer in cache.items()}
    assert shard.plane_pspecs(planes)["block_0"]["k_scale"] == (None, "model")
    sm = shard.ServeMesh(grid=ProcessGrid("data=2,model=2", rank=3, world=4), tp=2, dp=2)
    assert shard.local_box((4, 16, 4, 8), ("data", None, "model", None), sm) == (
        slice(2, 4), slice(0, 16), slice(2, 4), slice(0, 8))


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads for this module's torch work: the suite runs several workers
    on the host's cores, and torch's default of one thread a core each oversubscribes it."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)
