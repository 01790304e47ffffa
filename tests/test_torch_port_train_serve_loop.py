"""PyTorch port, the train→serve promotion loop (``<port>/train_serve_loop.py``) against the
JAX package's ``tools/train_serve_loop.py``, part by part, and its resume and data-wait
legs end to end on the CPU.

(a) ``Scorers``: on one JAX-layout checkpoint (JAX ``TransformerLM`` parameters at a tiny
    width, made from a numpy seed) the port's ``decode_nll`` gate NLL and its sampled-token
    NLL equal the JAX ``Scorers``' within ``SCORE_ATOL``;
    a ``Scorers`` given a model and eval rows (no corpus read) scores as the corpus one;
(b) ``publish_corrupted`` writes the JAX tool's file, byte for byte, for the same source
    and seed, and the same manifest entry but its ``unix_time``;
(c) ``train_argv`` is the JAX one but for the package name and ``--device``;
(d) ``Traffic`` against a scripted router counts ok, finishes, errors and lost as the JAX
    one does; ``_fleet_checkpoint`` reads the same path;
(e) the resume leg (2 epochs straight against 1 + resume) and the data-wait leg run end to
    end on the corpus fixture at a tiny width: bitwise, digests equal, data wait measured,
    the goodput segments summing to the wall;
(f) without a card the tool's default ``--device cuda`` raises before any work.
"""

import argparse
import importlib.util
import json
import os
import pathlib
import shutil
import threading
import types
from concurrent.futures import Future

import numpy as np
import pytest
import torch

from csed_514_project_distributed_training_using_pytorch_tpu_torch import train_serve_loop
from csed_514_project_distributed_training_using_pytorch_tpu_torch.models import lm
from csed_514_project_distributed_training_using_pytorch_tpu_torch.train import lm as lm_train
from csed_514_project_distributed_training_using_pytorch_tpu_torch.train.step import (
    create_train_state,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils import (
    checkpoint,
    config,
)

ROOT = pathlib.Path(__file__).resolve().parent.parent
FIXTURE = ROOT / "tests" / "fixtures" / "corpus_tiny"
JAX_PKG = "csed_514_project_distributed_training_using_pytorch_tpu"
PORT_PKG = "csed_514_project_distributed_training_using_pytorch_tpu_torch"
WIDTHS = dict(embed_dim=16, num_layers=1, num_heads=2)
# decode_nll is a mean of 16 x 64 per-token log-probs, each computed on its own (the KV
# rows are the same projections in both packages): XLA and torch differ only in the order
# of f32 sums, about 1e-7 relative an operation, so the mean (about 5) agrees to ~1e-6.
SCORE_ATOL = 1e-5


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_train_serve_loop", ROOT / "tools" / "train_serve_loop.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_tool():
    return _jax_tool()


def _args(**kw) -> argparse.Namespace:
    return argparse.Namespace(**{**dict(corpus=str(FIXTURE), batch_size=16, device="cpu",
                                        gate_eval_rows=16), **WIDTHS, **kw})


@pytest.fixture(scope="module")
def jax_checkpoint(tmp_path_factory):
    """JAX ``TransformerLM`` parameters at the tiny widths, every leaf moved by a seeded
    N(0, 0.3) draw (so the model is far from uniform), saved by the JAX package."""
    import jax
    import jax.numpy as jnp

    from csed_514_project_distributed_training_using_pytorch_tpu.models import lm as jax_lm
    from csed_514_project_distributed_training_using_pytorch_tpu.utils import (
        checkpoint as jax_checkpoint,
    )

    model = jax_lm.TransformerLM(vocab_size=257, seq_len=64, **WIDTHS)
    params = model.init({"params": jax.random.PRNGKey(5)},
                        jnp.zeros((1, 64), jnp.int32))["params"]
    rng = np.random.default_rng(22)
    params = jax.tree_util.tree_map(
        lambda p: (np.asarray(p) + rng.normal(0.0, 0.3, p.shape)).astype(np.float32), params)
    path = str(tmp_path_factory.mktemp("ckpt") / "params.msgpack")
    jax_checkpoint.save_params(path, params)
    return path


def test_scorers_agree_with_the_jax_scorers(jax_tool, jax_checkpoint):
    want = jax_tool.Scorers(_args())
    got = train_serve_loop.Scorers(_args())
    assert (got.seq_len, got.vocab) == (want.seq_len, want.vocab) == (64, 256)
    np.testing.assert_array_equal(got.eval_tokens, want.eval_tokens)
    nll_jax, nll_port = want.nll(jax_checkpoint), got.nll(jax_checkpoint)
    assert abs(nll_port - nll_jax) <= SCORE_ATOL and nll_jax > 1.0, (nll_port, nll_jax)
    rows = np.random.default_rng(3).integers(0, 256, (5, 64)).astype(np.int32)
    samples = [{"tokens": r.tolist()} for r in rows] + [{"tokens": [1, 2, 3]}]
    s_jax = want.sample_nll(samples, jax_checkpoint)
    s_port = got.sample_nll(samples, jax_checkpoint)
    assert abs(s_port - s_jax) <= SCORE_ATOL, (s_port, s_jax)
    assert got.sample_nll(samples[-1:], jax_checkpoint) is None \
        is want.sample_nll(samples[-1:], jax_checkpoint)
    assert got.perf(jax_checkpoint) > 0.0
    assert got.nll(jax_checkpoint) == nll_port          # the cached params, the same bits


def test_scorers_take_a_model_and_eval_rows(jax_tool, jax_checkpoint):
    """The form a caller serving its own LM uses: ``args`` gives only the device, and the
    model and rows it passes are scored as the corpus ones, the same bits."""
    by_corpus = train_serve_loop.Scorers(_args())
    model = lm.TransformerLM(vocab_size=257, seq_len=64, **WIDTHS)
    rows = by_corpus.eval_tokens.astype(np.int64)
    given = train_serve_loop.Scorers(argparse.Namespace(device="cpu"), model=model,
                                     eval_rows=rows)
    assert (given.seq_len, given.vocab) == (64, 256) and given.model is model
    np.testing.assert_array_equal(given.eval_tokens, by_corpus.eval_tokens)
    assert given.nll(jax_checkpoint) == by_corpus.nll(jax_checkpoint)
    assert abs(given.nll(jax_checkpoint) - jax_tool.Scorers(_args()).nll(jax_checkpoint)) \
        <= SCORE_ATOL
    samples = [{"tokens": r.tolist()} for r in rows[:3]]
    assert given.sample_nll(samples, jax_checkpoint) == \
        by_corpus.sample_nll(samples, jax_checkpoint)
    with pytest.raises(ValueError, match="together"):
        train_serve_loop.Scorers(argparse.Namespace(device="cpu"), model=model)
    with pytest.raises(ValueError, match="want"):
        train_serve_loop.Scorers(argparse.Namespace(device="cpu"), model=model,
                                 eval_rows=rows[:, :32])


def _source_state(path: str) -> None:
    """A full train state (params, AdamW moments, step) of the tiny corpus LM, saved by the
    port in the JAX layout."""
    cfg = config.LMConfig(**WIDTHS)
    model = lm.TransformerLM(vocab_size=257, seq_len=64, **WIDTHS)
    state = create_train_state(model, torch.Generator().manual_seed(4),
                               optimizer=lm_train.lm_optimizer(cfg))
    checkpoint.save_train_state(path, state._replace(step=torch.tensor(36)))


@pytest.mark.parametrize("seed", [17, 29])
def test_publish_corrupted_writes_the_jax_tools_bytes(tmp_path, jax_tool, seed):
    src = str(tmp_path / "incumbent.msgpack")
    _source_state(src)
    stores = {}
    for who, tool in (("jax", jax_tool), ("port", train_serve_loop)):
        store = tmp_path / who
        store.mkdir()
        (store / "manifest.json").write_text(json.dumps({"version": 1, "entries": [
            {"file": "ckpt_00000036.msgpack", "step": 36, "sha256": "", "bytes": 0,
             "unix_time": 1.0}]}))
        path = tool.publish_corrupted(str(store), src, step=1036, seed=seed)
        assert os.path.basename(path) == "ckpt_00001036.msgpack"
        stores[who] = store
    blob = (stores["port"] / "ckpt_00001036.msgpack").read_bytes()
    assert blob == (stores["jax"] / "ckpt_00001036.msgpack").read_bytes()
    entries = {who: json.loads((s / "manifest.json").read_text())["entries"]
               for who, s in stores.items()}
    for rows in entries.values():
        assert rows[-1].pop("unix_time") > 1.0
    assert entries["port"] == entries["jax"]
    assert entries["port"][-1]["health"] == {"clean": True, "anomalies": 0, "skipped": 0,
                                             "step": 1036}
    # the noise reached every params leaf and nothing else
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils import _msgpack

    def leaves(node, prefix=""):
        if isinstance(node, dict):
            for key, val in node.items():
                yield from leaves(val, f"{prefix}/{key}")
        else:
            yield prefix, node

    before = dict(leaves(_msgpack.from_bytes(open(src, "rb").read())))
    after = dict(leaves(_msgpack.from_bytes(blob)))
    assert sorted(after) == sorted(before)
    for key, leaf in before.items():
        moved = np.abs(after[key] - leaf).mean()
        assert moved > 0.5 if key.startswith("/params/") else moved == 0, key


@pytest.mark.parametrize("kw", [
    dict(epochs=1, results_dir="/w/train", telemetry="/w/a.jsonl"),
    dict(epochs=4, results_dir="/w/train", telemetry="/w/b.jsonl",
         resume_from="/w/train/checkpoints/ckpt_00000013.msgpack", throttle=0.2),
    dict(epochs=3, results_dir="/w/full", guard=False),
    dict(epochs=2, results_dir="/w/thr", telemetry="/o/t.jsonl", throttle=0.05,
         guard=False, keep=2, seed=5),
], ids=["initial", "continue", "resume", "throttled"])
def test_train_argv_is_the_jax_one_but_package_and_device(jax_tool, kw):
    args = _args(embed_dim=64, num_layers=2, num_heads=4, batch_size=64, device="cuda")
    got = train_serve_loop.train_argv(args, **kw)
    want = jax_tool.train_argv(args, **kw)
    i = got.index("--device")
    assert got[i + 1] == "cuda"
    assert got[:i] + got[i + 2:] == [w.replace(JAX_PKG, PORT_PKG) for w in want]
    assert got[2] == f"{PORT_PKG}.train.lm"


class ScriptedRouter:
    """Answers ``submit`` by the prompt's first token: 0 ok, 1 a ``timeout`` finish, 2
    raises at submit, 3 a future that fails; sets the traffic's stop event after
    ``limit`` submits."""

    def __init__(self, limit: int):
        self.limit, self.calls, self.traffic = limit, 0, None

    def submit(self, prompt, *, max_new_tokens, timeout_s):
        self.calls += 1
        if self.calls >= self.limit:
            self.traffic.stop_ev.set()
        kind = int(prompt[0])
        if kind == 2:
            raise RuntimeError("queue full")
        fut = Future()
        if kind == 3:
            fut.set_exception(RuntimeError("replica lost"))
        else:
            fut.set_result(types.SimpleNamespace(ok=kind == 0,
                                                 finish="ok" if kind == 0 else "timeout"))
        return fut


def test_traffic_counts_as_the_jax_traffic(jax_tool):
    prompts = [np.array([k, 7], np.int32) for k in (0, 0, 1, 0, 2, 0, 3)]
    tallies = []
    for tool in (jax_tool, train_serve_loop):
        router = ScriptedRouter(limit=40)
        traffic = tool.Traffic(router, prompts, concurrency=4, max_new=3, timeout_s=5.0)
        router.traffic = traffic
        traffic.start()
        traffic.join(60.0)                 # ends once the router has set the stop event
        traffic.halt()
        assert not traffic.is_alive()
        tallies.append((router.calls, traffic.ok, traffic.finishes, traffic.errors,
                        traffic.lost))
    assert tallies[1] == tallies[0]
    calls, ok, finishes, errors, lost = tallies[1]
    assert calls == 40 and ok == finishes["ok"] > 0 and finishes["timeout"] > 0
    assert lost == errors + finishes["timeout"] and errors > 0


def test_fleet_checkpoint_is_the_jax_ones(jax_tool):
    for command in (["-m", "x", "--checkpoint", "/s/ckpt_00000026.msgpack", "--seed", "0"],
                    ["-m", "x", "--checkpoint"], ["-m", "x"]):
        router = types.SimpleNamespace(_command=command)
        assert train_serve_loop._fleet_checkpoint(router) == \
            jax_tool._fleet_checkpoint(router)


def test_resume_and_data_wait_legs_on_the_cpu(tmp_path, monkeypatch):
    """The legs' trainer processes without matplotlib (a package on their path that
    raises ImportError, a case ``utils/plotting.py`` handles by writing no plot): the
    sample grids are not what the legs check, and drawing them took about half of each
    process's seconds here."""
    stub = tmp_path / "no_matplotlib" / "matplotlib"
    stub.mkdir(parents=True)
    (stub / "__init__.py").write_text("raise ImportError('left out of this test')\n")
    existing = os.environ.get("PYTHONPATH", "")
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(filter(None, [str(stub.parent),
                                                                     existing])))
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    corpus = tmp_path / "corpus"
    shutil.copytree(FIXTURE, corpus)
    args = _args(corpus=str(corpus), work_dir=str(tmp_path / "work"),
                 resume_total_epochs=2, resume_split_epochs=1, throttle_epochs=1,
                 throttle_s=0.02)
    out = tmp_path / "out"
    out.mkdir()
    threads = {}

    def leg(name, fn, *a):
        threads[name] = fn(*a)

    # the two legs share nothing but the corpus: run them side by side
    t = threading.Thread(target=leg, args=("data", train_serve_loop.run_data_wait_leg,
                                           args, str(out)))
    t.start()
    leg("resume", train_serve_loop.run_resume_leg, args)
    t.join()
    resume, data = threads["resume"], threads["data"]
    assert resume["bitwise_identical"] and resume["stream_digests_match"], resume
    assert list(resume["digests_resumed"]) == [1] and resume["resume_cursor"]["epoch"] == 1
    assert data["data_wait_positive"] and data["sums_to_wall_1pct"], data
    report = json.loads((out / "goodput.json").read_text())
    assert report["segments"]["data_wait_s"] == data["data_wait_s"]


def test_default_device_needs_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_serve_loop.main(["--quick", "--out-dir", str(tmp_path / "o"),
                               "--work-dir", str(tmp_path / "w")])
    assert not os.listdir(tmp_path / "w")          # nothing ran before the refusal
